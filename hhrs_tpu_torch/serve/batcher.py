"""Dynamic request batching (counterpart of ``hhrs_tpu/serve/batcher.py``).

``BatchingEngine`` wraps a RecommendationEngine: a worker thread drains a
queue (the first request blocks, then up to ``max_batch`` - 1 more are
collected within ``window_ms``), runs ``engine.recommend_many(pad_to=
max_batch)`` (one replay of bucket ``max_batch`` on a card: one upload,
one copy back for the whole batch) and resolves each caller's wait. All
other attributes delegate to the engine, so the HTTP handler takes it as
a drop-in.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

log = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("request", "event", "result", "error")

    def __init__(self, request):
        self.request = request
        self.event = threading.Event()
        self.result = None
        self.error = None


class BatchingEngine:
    def __init__(self, engine, max_batch: int = 8, window_ms: float = 2.0):
        self._engine = engine
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public surface (handler-compatible) ------------------------------
    def recommend(self, user_id: int, city: str, mode: str = "friends",
                  lambda_param: float = 0.7) -> dict:
        if self._stop.is_set():
            raise RuntimeError("BatchingEngine is closed")
        p = _Pending((user_id, city, mode, lambda_param))
        self._q.put(p)
        # Bounded waits so a dead worker or a close() race surfaces as an
        # error instead of hanging the caller forever.
        while not p.event.wait(timeout=1.0):
            if p.event.is_set():
                break
            if not self._worker.is_alive():
                raise RuntimeError("BatchingEngine worker is gone")
            # _stop set with the worker still ALIVE means close() is
            # draining: this request may be mid-flight in the batch the
            # worker is executing right now — keep waiting (close() joins
            # the worker and errors out everything left in the queue, so
            # the wait terminates either way) instead of turning an
            # about-to-succeed request into a 500.
        if p.error is not None:
            # Fresh exception per waiter: N handler threads re-raising the
            # SAME instance race on its __traceback__ (garbled 500 logs).
            raise RuntimeError(f"batched recommend failed: {p.error}") from p.error
        return p.result

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def close(self) -> None:
        """Stop the worker, fail what is still queued, then close the
        engine (on a card, free its CUDA graphs)."""
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=30)
        # Error out anything still queued so no caller hangs.
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                p.error = RuntimeError("BatchingEngine closed")
                p.event.set()
        close = getattr(self._engine, "close", None)
        if callable(close):
            close()

    # -- worker ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            batch = [first]
            deadline = self.window_s
            t0 = time.perf_counter()
            while len(batch) < self.max_batch:
                remaining = deadline - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            try:
                results = self._engine.recommend_many(
                    [p.request for p in batch], pad_to=self.max_batch
                )
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # noqa: BLE001 — propagate to every waiter
                log.exception("batched recommend failed")
                for p in batch:
                    p.error = e
            for p in batch:
                p.event.set()
