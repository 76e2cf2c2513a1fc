"""Logging setup, a JSONL metrics sink and the serve path's latency
histogram (counterpart of ``hhrs_tpu/utils/logging.py``; its
``enable_compilation_cache`` is an XLA setting with no torch counterpart)."""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque


def setup_logging(level=logging.INFO) -> None:
    logging.basicConfig(
        level=level, format="%(asctime)s - %(levelname)s - %(name)s - %(message)s"
    )


class MetricsLogger:
    """Append-only JSONL metrics sink; cheap enough for per-step use."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, **metrics) -> None:
        metrics.setdefault("ts", time.time())
        if self._fh:
            self._fh.write(json.dumps(metrics) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class LatencyHistogram:
    """Rolling-window latency quantiles: the last ``window`` samples and a
    lifetime count. Thread-safe: handler threads ``observe`` while
    ``/metrics`` and ``/healthz`` read ``summary``. Quantiles are None (JSON
    null) before any traffic."""

    def __init__(self, window: int = 10_000):
        self.samples = deque(maxlen=window)
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.samples.append(seconds)
            self.total += 1

    def summary(self) -> dict:
        with self._lock:
            if not self.samples:
                return {"count": 0, "p50_ms": None, "p90_ms": None, "p99_ms": None}
            s = list(self.samples)  # sorted outside the lock, so a scrape never stalls observe()
            total = self.total
        s.sort()

        def q(p):
            return s[min(int(len(s) * p / 100.0), len(s) - 1)] * 1e3

        return {"count": total, "p50_ms": q(50), "p90_ms": q(90), "p99_ms": q(99)}
