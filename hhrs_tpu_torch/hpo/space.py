"""Search-space declaration (a copy of ``hhrs_tpu/hpo/space.py``, which the
port does not import).

A space is a dict name → ``Dim``. ``reference_search_space`` reproduces the
reference's Optuna space exactly (reference train.py:179-193): embedding
dim, hidden width, cross/res depth, dropout, log-uniform lr/weight-decay,
batch size, optimizer family, and the plateau-scheduler knobs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Dim:
    kind: str  # 'categorical' | 'int' | 'float'
    choices: tuple = ()
    low: float = 0.0
    high: float = 1.0
    step: float = 1  # int step, or float-grid step (0 = continuous)
    log: bool = False

    def _quantize(self, v: float) -> float:
        if self.kind == "float" and self.step and not self.log:
            # optuna suggest_float(step=...) semantics: snap to the grid
            v = self.low + round((v - self.low) / self.step) * self.step
            return float(min(max(v, self.low), self.high))
        return float(v)

    def sample(self, rng) -> object:
        if self.kind == "categorical":
            return self.choices[rng.integers(0, len(self.choices))]
        if self.kind == "int":
            n = (int(self.high) - int(self.low)) // int(self.step) + 1
            return int(self.low) + int(self.step) * int(rng.integers(0, n))
        if self.log:
            return float(math.exp(rng.uniform(math.log(self.low), math.log(self.high))))
        return self._quantize(rng.uniform(self.low, self.high))

    def to_unit(self, v) -> float:
        """Map a value into [0,1] for the TPE kernel density."""
        if self.kind == "categorical":
            return self.choices.index(v) / max(len(self.choices) - 1, 1)
        if self.log:
            return (math.log(v) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low)
            )
        return (float(v) - self.low) / (self.high - self.low)

    def from_unit(self, u: float) -> object:
        u = min(max(u, 0.0), 1.0)
        if self.kind == "categorical":
            return self.choices[round(u * (len(self.choices) - 1))]
        if self.kind == "int":
            raw = self.low + u * (self.high - self.low)
            k = round((raw - self.low) / self.step)
            k = min(max(k, 0), int((self.high - self.low) // self.step))
            return int(self.low + k * self.step)  # always ON the step grid
        if self.log:
            return float(
                math.exp(math.log(self.low) + u * (math.log(self.high) - math.log(self.low)))
            )
        return self._quantize(self.low + u * (self.high - self.low))


def categorical(*choices) -> Dim:
    return Dim(kind="categorical", choices=tuple(choices))


def int_range(low: int, high: int, step: int = 1) -> Dim:
    return Dim(kind="int", low=low, high=high, step=step)


def float_range(low: float, high: float, log: bool = False, step: float = 0) -> Dim:
    return Dim(kind="float", low=low, high=high, log=log, step=step)


def reference_search_space() -> dict:
    """The reference's 11-hyperparameter Optuna space (train.py:179-193)."""
    return {
        "emb_dim": categorical(16, 24, 32, 48, 64),
        "hidden_dim": int_range(32, 512, step=32),
        "n_cross_layers": int_range(1, 6),
        "n_res_blocks": int_range(1, 4),
        "dropout": float_range(0.1, 0.7, step=0.05),  # reference step=0.05
        "lr": float_range(1e-5, 1e-2, log=True),
        "batch_size": categorical(512, 1024, 2048, 4096),
        "weight_decay": float_range(1e-6, 1e-1, log=True),
        "optimizer": categorical("adam", "adamw"),
        "lr_plateau_patience": int_range(1, 3),
        "lr_plateau_factor": float_range(0.1, 0.5, step=0.1),  # reference step=0.1
    }
