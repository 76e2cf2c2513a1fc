"""Median pruner: optuna.MedianPruner semantics (a copy of
``hhrs_tpu/hpo/pruner.py``, which the port does not import; the reference
study's pruner — train.py:236-238 calls trial.report + should_prune each epoch).

A running trial is pruned at step s if its intermediate value is worse
than the median of the intermediate values other completed trials reported
at the same step, after warmup allowances.
"""

from __future__ import annotations

import numpy as np


class MedianPruner:
    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(
        self,
        step: int,
        value: float,
        completed_intermediates: list,  # list of {step: value} for completed trials
        all_intermediates: list | None = None,  # unused: optuna's median pruner
        # compares against COMPLETED trials only
    ) -> bool:
        if step < self.n_warmup_steps:
            return False
        if len(completed_intermediates) < self.n_startup_trials:
            return False
        # NaN-safe: a completed trial that posted a NaN at this step (e.g.
        # diverged then recovered) must not disable pruning forever —
        # optuna uses nanpercentile for the same reason.
        at_step = [
            im[step] for im in completed_intermediates
            if step in im and not np.isnan(im[step])
        ]
        if not at_step:
            return False
        return value > float(np.median(at_step))


class SuccessiveHalvingPruner:
    """ASHA-style successive halving (optuna.SuccessiveHalvingPruner's
    asynchronous semantics, adapted to this study's per-epoch reports).

    Rungs sit at resources ``min_resource · reduction_factor^k`` epochs
    (resource = step + 1). When a trial completes a rung, it survives only
    if its best-so-far value is within the top ``1/reduction_factor``
    fraction of every trial's best-so-far value AT that rung — pruned,
    running, and completed trials all contribute evidence (asynchronous
    halving never waits for a full cohort). Off-rung steps never prune.

    Versus the reference's MedianPruner (which needs completed-trial
    medians and so barely fires early in a sweep), halving starts cutting
    as soon as ``reduction_factor`` trials have touched a rung — the
    aggressive-throughput pruner for vectorized sweeps (``--vectorize``)
    where whole lanes ride the program anyway and early tells free lanes
    for the next round.
    """

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3):
        if min_resource < 1 or reduction_factor < 2:
            raise ValueError("min_resource >= 1 and reduction_factor >= 2 required")
        self.min_resource = min_resource
        self.reduction_factor = reduction_factor

    def _is_rung(self, resource: int) -> bool:
        r = self.min_resource
        while r < resource:
            r *= self.reduction_factor
        return r == resource

    def should_prune(
        self,
        step: int,
        value: float,
        completed_intermediates: list,
        all_intermediates: list | None = None,
    ) -> bool:
        resource = step + 1
        if not self._is_rung(resource):
            return False
        evidence = (
            all_intermediates if all_intermediates is not None
            else completed_intermediates
        )
        # each trial's best-so-far at this rung (same convention as the
        # ``value`` argument, which Trial.should_prune pre-reduces to best)
        bests = []
        for im in evidence:
            vals = [v for s, v in im.items() if s <= step and not np.isnan(v)]
            if len([s for s in im if s <= step]) >= resource and vals:
                bests.append(min(vals))
        if len(bests) < self.reduction_factor:
            return False  # not enough rung evidence to pick a top fraction
        bests.sort()
        keep = max(1, -(-len(bests) // self.reduction_factor))  # ceil(n/η)
        return value > bests[keep - 1]


class NopPruner:
    def should_prune(self, step, value, completed_intermediates,
                     all_intermediates=None) -> bool:
        return False
