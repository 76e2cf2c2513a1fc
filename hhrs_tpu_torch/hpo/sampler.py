"""Samplers: random + univariate TPE (a copy of ``hhrs_tpu/hpo/sampler.py``,
which the port does not import: the same numpy draws in the same order, so
the same seed and history give the same proposals bit for bit).

TPE (Bergstra et al. 2011, "Algorithms for Hyper-Parameter Optimization"):
split completed trials at the γ-quantile of the objective into good (l) and
bad (g) sets, fit a Parzen (Gaussian-kernel) density to each — per
dimension, in unit space — and pick the candidate maximizing l(x)/g(x).
This mirrors optuna's independent-TPE default closely enough to reproduce
the reference study's behavior (reference train.py:303-316 uses the
default TPESampler).
"""

from __future__ import annotations

import math

import numpy as np

from hhrs_tpu_torch.hpo.space import Dim


class RandomSampler:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def sample(self, space: dict, history: list) -> dict:
        return {name: dim.sample(self.rng) for name, dim in space.items()}


class TPESampler:
    def __init__(
        self,
        seed: int = 0,
        n_startup_trials: int = 10,
        n_candidates: int = 24,
        gamma: float = 0.25,
    ):
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma

    def sample(self, space: dict, history: list) -> dict:
        """history: list of (params_dict, objective_value) for completed trials."""
        done = [(p, v) for p, v in history if v is not None and math.isfinite(v)]
        if len(done) < self.n_startup_trials:
            return {name: dim.sample(self.rng) for name, dim in space.items()}

        done.sort(key=lambda t: t[1])
        n_good = max(1, int(self.gamma * len(done)))
        good = [p for p, _ in done[:n_good]]
        bad = [p for p, _ in done[n_good:]] or good

        out = {}
        for name, dim in space.items():
            gu = np.asarray([dim.to_unit(p[name]) for p in good if name in p])
            bu = np.asarray([dim.to_unit(p[name]) for p in bad if name in p])
            if gu.size == 0:
                out[name] = dim.sample(self.rng)
                continue
            out[name] = self._sample_dim(dim, gu, bu)
        return out

    def _sample_dim(self, dim: Dim, good_u: np.ndarray, bad_u: np.ndarray):
        # Parzen bandwidth: Scott-ish rule with a floor so early densities
        # stay exploratory.
        bw_g = max(good_u.std() * good_u.size ** -0.2, 0.08)
        bw_b = max(bad_u.std() * bad_u.size ** -0.2, 0.08) if bad_u.size else 1.0

        # Candidates drawn from the good-set mixture (plus a uniform tail
        # for exploration), scored by the density ratio.
        centers = good_u[self.rng.integers(0, good_u.size, self.n_candidates)]
        cands = np.clip(centers + self.rng.normal(0, bw_g, self.n_candidates), 0, 1)
        cands = np.concatenate([cands, self.rng.uniform(0, 1, max(self.n_candidates // 4, 1))])

        def log_density(xs, centers_, bw):
            if centers_.size == 0:
                return np.zeros_like(xs)
            d = (xs[:, None] - centers_[None, :]) / bw
            return np.log(np.mean(np.exp(-0.5 * d * d), axis=1) / bw + 1e-12)

        score = log_density(cands, good_u, bw_g) - log_density(cands, bad_u, bw_b)
        return dim.from_unit(float(cands[int(np.argmax(score))]))
