"""The traced window: a ``torch.profiler`` trace of the device and host
over a stretch of the run, reduced to what the per-layer metrics read.

Device activity is every event the profiler records on the card (kernels,
copies, sets). Its busy time is the union of their intervals. An idle gap
is a stretch between two of them; it is named by the innermost host span
that covers its middle: the harness's own spans (``record_function``
around each call into the program, and around each collection of the
Python collector) first, else the program's own host operations.
"""

from __future__ import annotations

import bisect
import gc
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


class Window:
    """Start and stop a profile; :meth:`reduce` gives the :class:`Trace`."""

    def __init__(self, device: torch.device):
        self.device = device
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> "Trace":
        return Trace(self.prof, self.t1 - self.t0)


class Trace:
    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():  # a range drawn on the card's row, not work on it
                    dev.append((start, start + dur, e.name()))
            elif dur > 0:
                host.append((start, start + dur, e.name(), e.is_user_annotation()))
        dev.sort()
        self.device = dev
        self.host = sorted(host)
        merged = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_ns = sum(t - s for s, t in merged)
        self.merged = merged

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def kernels(self, fragment: str) -> list:
        """Durations in seconds of the device events whose name holds ``fragment``."""
        return [(t - s) / 1e9 for s, t, n in self.device if fragment in n]

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for s, t, name in self.device:
            total[name] = total.get(name, 0) + (t - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(self.merged, self.merged[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        starts = [h[0] for h in self.host]
        out = []
        for length, s, t in gaps[:n]:
            mid = (s + t) // 2
            label = "no host span"
            best = None
            for h in self.host[:bisect.bisect_right(starts, mid)][-2000:]:
                if h[1] >= mid and (best is None or (h[3], h[0]) > (best[3], best[0])):
                    best = h
            if best is not None:
                label = ("host_span_" if best[3] else "host_op_") + _short(best[2])
            out.append([label, length / 1e9])
        return out


def _short(name: str) -> str:
    keep = "".join(c if c.isalnum() or c in "._-" else "_" for c in name)
    return keep[:64]


class GcClock:
    """Times every collection of the Python collector (``gc.callbacks``),
    by generation, and marks each as a host span while a profile runs. The
    collector's settings are left as they are."""

    def __init__(self):
        self.pauses: list = []  # (generation, seconds)
        self._t = None
        self._span = None
        self.recording = False
        self.tracing = False
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
            if self.tracing:
                self._span = record_function(f"python gc generation {info['generation']}")
                self._span.__enter__()
        else:
            if self._span is not None:
                self._span.__exit__(None, None, None)
                self._span = None
            if self.recording and self._t is not None:
                self.pauses.append((info["generation"], time.perf_counter() - self._t))

    def close(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

