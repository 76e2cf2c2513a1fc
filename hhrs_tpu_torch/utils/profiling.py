"""Profiling hooks (counterpart of ``hhrs_tpu/utils/profiling.py``).

* ``trace(dir)``: a context manager around ``torch.profiler.profile`` (the
  CPU, and the card where there is one) that writes a Chrome / Perfetto
  trace of everything inside it to ``dir/trace.json``;
* ``StepTimer``: host-clock per-step times with an examples/s summary
  (a copy).

The JAX module's ``start_server`` (a live ``jax.profiler`` server) and
``hlo_dump_env`` (the ``XLA_FLAGS`` that dump HLO) have no torch
counterpart and are not ported.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; on exit write ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates per-step wall times; syncing is the caller's business
    (on a card, end each step in ``torch.cuda.synchronize()`` or a value
    copied to the host, or the time is the enqueue's)."""

    def __init__(self):
        self._t0 = None
        self.times: list[float] = []

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without a prior start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None  # a second stop() must not record a stale duration
        self.times.append(dt)
        return dt

    def summary(self, examples_per_step: int | None = None) -> dict:
        if not self.times:
            return {"steps": 0}
        mean = sum(self.times) / len(self.times)
        out = {
            "steps": len(self.times),
            "mean_ms": mean * 1e3,
            "min_ms": min(self.times) * 1e3,
        }
        if examples_per_step:
            out["examples_per_s"] = examples_per_step / mean
        return out
