"""Study: trial lifecycle + crash-safe resumable journal (a copy of
``hhrs_tpu/hpo/study.py``, which the port does not import; a journal either
package writes resumes in the other).

Mirrors the optuna surface the reference uses (train.py:303-325):
``load-or-create study → study.optimize(objective, n_trials) →
study.best_params / best_value``, with per-epoch ``trial.report(value,
step)`` + ``trial.should_prune()`` inside the objective.

Persistence is an append-only JSONL journal (one record per completed /
pruned / failed trial, fsync'd) instead of the reference's joblib pickle —
a crash mid-trial loses only that trial, and resuming is replaying the
file. If optuna is importable, ``backend="optuna"`` wraps it instead.
"""

from __future__ import annotations

import json
import logging
import math
import os

from hhrs_tpu_torch.hpo.pruner import MedianPruner
from hhrs_tpu_torch.hpo.sampler import TPESampler

log = logging.getLogger(__name__)


class TrialPruned(Exception):
    pass


class Trial:
    def __init__(self, number: int, space: dict, params: dict, study: "Study"):
        self.number = number
        self._space = space
        self.params = params
        self._study = study
        self.intermediates: dict = {}
        self.user_attrs: dict = {}
        self._last_step = -1

    # optuna-compatible suggest API: values were pre-sampled jointly by the
    # sampler; suggest_* just reads them (and validates the name).
    def _get(self, name):
        if name not in self.params:
            raise KeyError(f"param {name!r} not in search space")
        return self.params[name]

    def suggest_categorical(self, name, choices=None):
        return self._get(name)

    def suggest_int(self, name, low=None, high=None, step=1):
        return int(self._get(name))

    def suggest_float(self, name, low=None, high=None, log=False):
        return float(self._get(name))

    def report(self, value: float, step: int) -> None:
        self.intermediates[step] = float(value)
        self._last_step = step
        # Under the real-optuna backend, forward the TRUE per-step value at
        # report time so optuna's stored intermediate curves are faithful
        # (best-over-steps is optuna's own pruner semantics, not ours to
        # pre-apply — see should_prune below for the built-in path).
        fwd = getattr(self._study, "_report_to_backend", None)
        if fwd is not None:
            fwd(float(value), step)

    def should_prune(self) -> bool:
        if self._last_step < 0:
            return False
        # optuna MedianPruner semantics: the trial's BEST intermediate so
        # far (minimize direction) is compared against the median, so a
        # trial that already posted a good epoch is not pruned on a later
        # regression. A NaN ANYWHERE (diverged trial) prunes IMMEDIATELY —
        # optuna does the same; letting it run would burn epochs until
        # early-stop and poison future medians. (min() alone is
        # order-dependent: min(0.65, nan) returns 0.65, so a trial that
        # diverged AFTER a finite first epoch would never be caught.)
        if any(math.isnan(v) for v in self.intermediates.values()):
            return True
        best = min(self.intermediates.values())
        return self._study._pruner.should_prune(
            self._last_step,
            best,
            [t["intermediates_by_step"] for t in self._study.trials if t["state"] == "complete"],
            # richer evidence for rung-based pruners (SuccessiveHalving):
            # pruned and failed trials' curves count at the rungs they
            # reached, and so do the RUNNING siblings of a vectorized
            # round (asked-but-untold) — asynchronous halving never waits
            # for completions, which is exactly what lets lanes prune each
            # other mid-round and free lanes for reclamation
            all_intermediates=[
                t["intermediates_by_step"] for t in self._study.trials
                if t.get("intermediates_by_step")
            ] + [
                # the candidate ITSELF is part of its rung cohort (optuna's
                # ASHA semantics): excluding it computed the survival
                # quantile over n-1 entries, wrongly killing the
                # second-best of 3 at eta=2 and never firing with exactly
                # eta trials at a rung (r4 review finding)
                dict(t.intermediates)
                for t in getattr(self._study, "_in_flight", [])
                if t.intermediates
            ],
        )

    def set_user_attr(self, key: str, value) -> None:
        self.user_attrs[key] = value
        fwd = getattr(self._study, "_set_user_attr", None)
        if fwd is not None:  # optuna backend: persist on the real trial
            fwd(key, value)


class Study:
    def __init__(
        self,
        journal_path: str | None = None,
        sampler=None,
        pruner=None,
        seed: int = 0,
        direction: str = "minimize",
    ):
        assert direction == "minimize", "only minimize is used by this workload"
        self.journal_path = journal_path
        self.sampler = sampler or TPESampler(seed=seed)
        self._pruner = pruner if pruner is not None else MedianPruner()
        self.trials: list[dict] = []
        self._in_flight: list = []  # asked-but-untold Trial objects
        if journal_path and os.path.exists(journal_path):
            self._load()
            log.info("resumed study from %s: %d prior trials", journal_path, len(self.trials))
        self._next_number = len(self.trials)

    # -- persistence ------------------------------------------------------
    def _load(self) -> None:
        with open(self.journal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    log.warning("skipping corrupt journal line (torn write)")
                    continue
                rec["intermediates_by_step"] = {
                    int(k): (float("nan") if v is None else v)
                    for k, v in rec.get("intermediates", {}).items()
                }
                self.trials.append(rec)

    def _append(self, rec: dict) -> None:
        if not self.journal_path:
            return
        os.makedirs(os.path.dirname(self.journal_path) or ".", exist_ok=True)
        with open(self.journal_path, "a") as f:
            f.write(json.dumps({k: v for k, v in rec.items() if k != "intermediates_by_step"}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- optimization -----------------------------------------------------
    def _history(self) -> list:
        """Sampler evidence. Completed trials contribute their value; PRUNED
        trials contribute their best intermediate — without this, TPE never
        accumulates "bad" evidence in pruning-heavy regions and keeps
        re-proposing them (optuna's TPE uses pruned trials the same way)."""
        history = []
        for t in self.trials:
            if t["state"] == "complete":
                history.append((t["params"], t.get("value")))
            elif t["state"] == "pruned":
                vals = [v for v in t.get("intermediates_by_step", {}).values()
                        if not math.isnan(v)]
                if vals:
                    history.append((t["params"], min(vals)))
        return history

    def ask(self, space: dict, k: int = 1, shared: tuple = (),
            fixed: dict | None = None) -> list[Trial]:
        """Propose ``k`` trials from the current evidence (ask/tell API —
        the vectorized-HPO driver asks a batch, runs same-architecture
        groups in one vmapped program, then tells each result). Siblings
        of one batch are sampled from the same history, like optuna's
        parallel ask().

        ``fixed``: params PINNED to given values in every proposed trial,
        with the rest sampled conditionally from the same history (the
        sampler is univariate, so this is the exact conditional proposal).
        The lane-reclamation path uses this to refill a dead lane of a
        running vectorized group: the group's architecture dims are fixed,
        the vmapped scalars are fresh proposals.

        ``shared``: param names sampled ONCE per batch — trial 0's values
        are copied into every sibling. The vectorized driver shares the
        shape-affecting dims (hpo/vectorized.ARCH_KEYS) so all k trials
        land in ONE vmapped group: with independent sampling the reference
        space's ~15k architecture combinations make same-arch collisions
        vanishingly rare and every group degenerates to a singleton. The
        sampler is univariate (TPE per dimension), so fixing some dims and
        sampling the rest from the same history is exactly the conditional
        proposal; the trade (one architecture evidence point per round
        instead of k) is the standard batched-HPO trade."""
        history = self._history()
        fixed = fixed or {}
        unknown = set(fixed) - set(space)
        if unknown:
            raise ValueError(f"fixed params not in space: {sorted(unknown)}")
        out = []
        free_space = {n: d for n, d in space.items() if n not in fixed}
        scalar_space = {n: d for n, d in free_space.items() if n not in shared}
        base = None
        for i in range(k):
            if i == 0 or not shared:
                sampled = self.sampler.sample(free_space, history)
                base = sampled
            else:
                scalars = self.sampler.sample(scalar_space, history)
                sampled = {n: (base[n] if n in shared else scalars[n])
                           for n in free_space}
            params = {n: (fixed[n] if n in fixed else sampled[n]) for n in space}
            out.append(Trial(self._next_number, space, params, self))
            self._next_number += 1
        self._in_flight.extend(out)
        return out

    def tell(self, trial: Trial, state: str, value=None, error: str | None = None) -> dict:
        """Record one asked trial's outcome ('complete'|'pruned'|'failed');
        appends to the journal and returns the record."""
        rec = {"number": trial.number, "params": trial.params, "state": state}
        if state == "complete":
            v = float(value)
            if math.isfinite(v):
                rec["value"] = v
            else:
                # never-finite val loss: record as failed — inf/nan as a
                # "complete" value is useless to minimize over and
                # json.dumps would emit non-standard Infinity tokens
                rec.update(state="failed", value=None,
                           error=f"non-finite objective ({v})")
        else:
            rec["value"] = None
            if error is not None:
                rec["error"] = error
        # journal field must stay STRICT JSON (json.dumps would emit the
        # non-standard NaN/Infinity tokens otherwise — same reason the
        # non-finite objective above becomes 'failed'); non-finite
        # intermediates round-trip as null → nan (see _load)
        rec["intermediates"] = {
            str(k): (v if math.isfinite(v) else None)
            for k, v in trial.intermediates.items()
        }
        rec["intermediates_by_step"] = dict(trial.intermediates)
        rec["user_attrs"] = trial.user_attrs
        self._in_flight = [t for t in self._in_flight if t is not trial]
        self.trials.append(rec)
        self._append(rec)
        return rec

    def optimize(self, objective, space: dict, n_trials: int, callbacks=()) -> None:
        """Run until the study holds ``n_trials`` total (resume-aware)."""
        while len(self.trials) < n_trials:
            trial = self.ask(space)[0]
            # tell() runs OUTSIDE the objective's try: a journal-append
            # failure must propagate, not be caught as an objective error
            # and double-record the trial under the same number.
            try:
                value = float(objective(trial))
            except TrialPruned:
                rec = self.tell(trial, "pruned")
            except Exception as e:  # noqa: BLE001 — a failed trial must not kill the study
                log.exception("trial %d failed", trial.number)
                rec = self.tell(trial, "failed", error=repr(e))
            else:
                rec = self.tell(trial, "complete", value)
            for cb in callbacks:
                cb(self, rec)
            if rec["state"] == "complete":
                log.info(
                    "trial %d complete: value %.5f (best %.5f)",
                    trial.number, rec["value"], self.best_value,
                )

    # -- results ----------------------------------------------------------
    @property
    def completed(self) -> list[dict]:
        return [t for t in self.trials if t["state"] == "complete"]

    @property
    def best_trial(self) -> dict:
        done = self.completed
        if not done:
            raise ValueError("no completed trials")
        return min(done, key=lambda t: t["value"])

    @property
    def best_params(self) -> dict:
        return self.best_trial["params"]

    @property
    def best_value(self) -> float:
        return self.best_trial["value"]


def create_study(journal_path=None, seed=0, backend="auto", **kwargs):
    """Load-or-create. backend='optuna' (or 'auto' with optuna installed
    and HHRS_HPO_OPTUNA=1) wraps a real optuna study via OptunaStudyAdapter."""
    if backend == "optuna" or (
        backend == "auto" and os.environ.get("HHRS_HPO_OPTUNA") == "1"
    ):
        try:
            return OptunaStudyAdapter(journal_path, seed=seed)
        except ImportError:
            if backend == "optuna":
                raise
            log.warning("optuna not installed; using built-in study")
    return Study(journal_path, seed=seed, **kwargs)


class OptunaStudyAdapter:
    """Thin adapter so the same objective runs on real optuna when present."""

    def __init__(self, journal_path, seed=0):
        import optuna  # gated: an optional dependency

        storage = None
        if journal_path:
            storage = optuna.storages.JournalStorage(
                optuna.storages.journal.JournalFileBackend(journal_path + ".optuna")
            )
        self._study = optuna.create_study(
            study_name="hhrs_dcn", storage=storage, load_if_exists=True,
            direction="minimize", sampler=optuna.samplers.TPESampler(seed=seed),
            pruner=optuna.pruners.MedianPruner(),
        )

    @staticmethod
    def _suggest_params(otrial, space: dict) -> dict:
        params = {}
        for name, dim in space.items():
            if dim.kind == "categorical":
                params[name] = otrial.suggest_categorical(name, list(dim.choices))
            elif dim.kind == "int":
                params[name] = otrial.suggest_int(name, int(dim.low), int(dim.high), step=dim.step)
            elif dim.log:
                params[name] = otrial.suggest_float(name, dim.low, dim.high, log=True)
            else:
                params[name] = otrial.suggest_float(
                    name, dim.low, dim.high, step=dim.step or None
                )
        return params

    def ask(self, space: dict, k: int = 1, shared: tuple = (),
            fixed: dict | None = None) -> list[Trial]:
        """Batch proposal through real optuna's ask() (vectorized HPO).

        ``shared`` dims are fixed to trial 0's values for the siblings via
        ``enqueue_trial`` with partial params (optuna samples the rest) —
        the same arch-major batching as the built-in Study.ask. ``fixed``
        pins params in EVERY proposed trial (lane reclamation), via the
        same enqueue mechanism."""
        fixed = fixed or {}
        out = []
        base = None
        for i in range(k):
            pin = dict(fixed)
            if i > 0 and shared and base is not None:
                pin.update({n: base[n] for n in shared})
            if pin:
                self._study.enqueue_trial(pin, skip_if_exists=False)
            otrial = self._study.ask()
            params = self._suggest_params(otrial, space)
            if i == 0:
                base = params
            shim = Trial(otrial.number, space, params, _OptunaShimStudy(otrial))
            shim._otrial = otrial
            out.append(shim)
        return out

    def tell(self, trial: Trial, state: str, value=None, error: str | None = None) -> dict:
        import math as _math

        import optuna

        otrial = trial._otrial
        if state == "complete" and value is not None and _math.isfinite(float(value)):
            self._study.tell(otrial, float(value))
        elif state == "pruned":
            self._study.tell(otrial, state=optuna.trial.TrialState.PRUNED)
        else:
            state = "failed"
            self._study.tell(otrial, state=optuna.trial.TrialState.FAIL)
        return {"number": trial.number, "params": trial.params, "state": state,
                "value": float(value) if state == "complete" else None,
                "user_attrs": trial.user_attrs}

    def optimize(self, objective, space: dict, n_trials: int, callbacks=()) -> None:
        import optuna

        def wrapped(otrial):
            params = self._suggest_params(otrial, space)
            shim = Trial(otrial.number, space, params, _OptunaShimStudy(otrial))
            try:
                return objective(shim)
            except TrialPruned:
                raise optuna.TrialPruned()

        # Resume-aware (run until the study HOLDS n_trials, matching the
        # built-in Study) and failure-isolated (a failed trial is recorded,
        # not fatal to the remaining sweep).
        remaining = max(0, n_trials - len(self._study.trials))
        if remaining:
            self._study.optimize(wrapped, n_trials=remaining, catch=(Exception,))

    @property
    def best_params(self):
        return self._study.best_params

    @property
    def best_value(self):
        return self._study.best_value

    @property
    def trials(self):
        # t.state.name (not str(t.state)) → 'COMPLETE', matching the
        # built-in Study's 'complete'/'pruned'/'failed' vocabulary.
        return [
            {"number": t.number, "params": t.params, "state": t.state.name.lower(),
             "value": t.value, "user_attrs": dict(t.user_attrs)}
            for t in self._study.trials
        ]


class _OptunaShimStudy:
    """Routes Trial.report/should_prune through the real optuna trial."""

    def __init__(self, otrial):
        self._otrial = otrial
        self.trials = []
        # Trial.report forwards each true per-step value here; the pruner
        # then only ASKS optuna (which applies its own best-over-steps
        # PercentilePruner semantics to the faithfully recorded curve).
        self._report_to_backend = otrial.report
        self._set_user_attr = otrial.set_user_attr

        class _P:
            def __init__(self, ot):
                self._ot = ot

            def should_prune(self, step, value, completed,
                             all_intermediates=None):
                # evidence kwargs are for the built-in pruners; the real
                # optuna backend keeps its own trial history
                return self._ot.should_prune()

        self._pruner = _P(otrial)
