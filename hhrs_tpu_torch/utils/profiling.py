"""Profiling hooks (counterpart of ``hhrs_tpu/utils/profiling.py``).

* ``trace(dir)``: a context manager around ``torch.profiler.profile`` (the
  CPU, and the card where there is one) that writes a Chrome / Perfetto
  trace of everything inside it to ``dir/trace.json`` and the counters of
  its stretch (:func:`counters`) to ``dir/counters.json``;
* ``span(name)``: a named range of the program (``record_function``)
  while a ``torch.profiler`` session records on this thread, else a shared
  no-op whose only cost is one check of the profiler's state. Spans live
  in the profiler's own timeline, which Kineto aligns with the card's
  events, so a span and the kernels it launched share one clock, and a
  child span nests inside its batch or epoch by time;
* the counter registry: ``book(name, value)`` adds to a (count, total)
  pair while a profiler records, ``count(name)`` counts a rare event (a
  kernel library built, a launch plan timed, a graph captured) at all
  times, and ``counters()`` gives a snapshot of both;
* ``device_event(device)`` and ``book_elapsed(name, start, end)``: a
  stretch of device work timed by a pair of CUDA events, recorded and
  booked only while a profiler records on a card.

A run is traced exactly when a profiler records: there is no switch. The
registry holds the bookings of the latest stretch in which a profiler
recorded; the first span, booking or count made while a profiler records,
after one made on the same thread while it did not, starts the stretch
afresh, and so does ``trace``. Names are dotted: ``serve.*``, ``train.*``, ``build.*``.

The JAX module's ``start_server`` (a live ``jax.profiler`` server) and
``hlo_dump_env`` (the ``XLA_FLAGS`` that dump HLO) have no torch
counterpart and are not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


class _Registry:
    """The process's counters (one, as the profiler is one)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live = False  # a stretch is open
        self.thread = None  # the thread whose profiler opened it
        self.stretch = 0  # stretches begun so far
        self.booked: dict = {}  # name -> [count, total], in the latest stretch
        self.counted: dict = {}  # name -> count, over the process

    def open(self, afresh: bool = False) -> None:
        with self.lock:
            if afresh or not self.live:
                self.live, self.thread = True, threading.get_ident()
                self.stretch += 1
                self.booked = {}

    def close(self) -> None:
        # _profiler_enabled() is per thread: another thread's silence ends nothing
        if self.thread == threading.get_ident():
            self.live = False

    def add(self, name: str, value: float) -> None:
        with self.lock:
            pair = self.booked.setdefault(name, [0, 0.0])
            pair[0] += 1
            pair[1] += value


_REGISTRY = _Registry()


def recording() -> bool:
    """Whether a profiler records on this thread (and the registry's
    stretch kept in step with it)."""
    if _profiler_enabled():
        if not _REGISTRY.live:
            _REGISTRY.open()
        return True
    if _REGISTRY.live:
        _REGISTRY.close()
    return False


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    records, else a shared no-op."""
    if not recording():
        return _NO_SPAN
    return record_function(name)


def book(name: str, value: float) -> None:
    """Add ``value`` to ``name``'s (count, total) in the stretch, while a
    profiler records; otherwise nothing."""
    if recording():
        _REGISTRY.add(name, value)


def count(name: str) -> None:
    """Count one rare event, at all times; while a profiler records, also
    in the stretch (as a booking of 1)."""
    on = recording()
    with _REGISTRY.lock:
        _REGISTRY.counted[name] = _REGISTRY.counted.get(name, 0) + 1
    if on:
        _REGISTRY.add(name, 1)


def device_event(device: torch.device):
    """A timing event recorded now on the current stream while a profiler
    records and ``device`` is a card, else None: one end of a stretch of
    device work that :func:`book_elapsed` books once it has finished."""
    if device.type != "cuda" or not recording():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def book_elapsed(name: str, start, end) -> None:
    """Book the milliseconds between two finished :func:`device_event`
    events; nothing where either is None."""
    if start is not None and end is not None:
        book(name, start.elapsed_time(end))


def counters() -> dict:
    """A snapshot: ``stretch`` (the stretches begun so far, 0 before any
    profiler recorded), ``booked`` (name → ``[count, total]`` of the latest
    stretch) and ``counted`` (name → the count over the process)."""
    with _REGISTRY.lock:
        return {"stretch": _REGISTRY.stretch,
                "booked": {k: list(v) for k, v in _REGISTRY.booked.items()},
                "counted": dict(_REGISTRY.counted)}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; on exit write ``log_dir/trace.json`` and
    ``log_dir/counters.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _REGISTRY.open(afresh=True)  # a stretch of its own, whichever thread opened the last one
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)
