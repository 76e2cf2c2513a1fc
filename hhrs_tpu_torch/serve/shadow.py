"""Shadow serving: live traffic mirrored onto a candidate model off the
request path, with agreement statistics (counterpart of
``hhrs_tpu/serve/shadow.py``).

``ShadowEngine`` wraps the outermost stack: responses come from the
primary; each request also goes into a bounded queue (dropped and counted
when full) that one worker replays against the shadow model, recording the
Jaccard overlap of the two ranked id sets, top-1 agreement, drops and
errors (``/healthz`` ``"shadow"``, ``/metrics``). Over a mesh the shadow
engine is an engine of the primary's world (``serve/lockstep.py``): the
worker's replays take the world's lock like every other caller, and
:meth:`close` frees the shadow on every rank.
"""

from __future__ import annotations

import logging
import queue
import threading

log = logging.getLogger(__name__)

_STOP = object()


def ranked_ids(result: dict) -> list:
    return [h["hotel_id"] for h in result.get("ranked_hotels", [])]


def overlap_metrics(primary: dict, shadow: dict) -> tuple[float, bool]:
    """(jaccard overlap of ranked id sets, top-1 agreement). Two empty
    responses agree perfectly — both models say 'no candidates'."""
    a, b = ranked_ids(primary), ranked_ids(shadow)
    if not a and not b:
        return 1.0, True
    sa, sb = set(a), set(b)
    union = len(sa | sb)
    jac = (len(sa & sb) / union) if union else 1.0
    top1 = bool(a) and bool(b) and a[0] == b[0]
    return jac, top1


class ShadowEngine:
    """Tee requests to a shadow model off the request path.

    ``primary`` serves every response; ``shadow`` only ever runs on the
    worker thread. All other attributes (latency, similar_items,
    cache_stats, …) delegate to the primary.
    """

    def __init__(self, primary, shadow, *, queue_size: int = 16,
                 shadow_dir: str | None = None):
        self._primary = primary
        self._shadow = shadow
        self.shadow_dir = shadow_dir or getattr(shadow, "artifacts_dir", None)
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._lock = threading.Lock()
        self._compared = 0
        self._dropped = 0
        self._errors = 0
        self._overlap_sum = 0.0
        self._top1_agree = 0
        self._worker = threading.Thread(
            target=self._run, name="shadow-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- serving
    def recommend(self, user_id, city, rec_type, lambda_param):
        result = self._primary.recommend(user_id, city, rec_type, lambda_param)
        self._enqueue((user_id, city, rec_type, lambda_param), result)
        return result

    def recommend_many(self, requests, pad_to=None):
        results = self._primary.recommend_many(requests, pad_to=pad_to)
        for req, res in zip(requests, results):
            self._enqueue(tuple(req), res)
        return results

    def __getattr__(self, name):
        return getattr(self._primary, name)

    # -------------------------------------------------------------- shadow
    def _enqueue(self, args: tuple, primary_result: dict) -> None:
        try:
            self._q.put_nowait((args, primary_result))
        except queue.Full:
            with self._lock:
                self._dropped += 1

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                args, primary_result = item
                try:
                    shadow_result = self._shadow.recommend(*args)
                    jac, top1 = overlap_metrics(primary_result, shadow_result)
                    with self._lock:
                        self._compared += 1
                        self._overlap_sum += jac
                        self._top1_agree += int(top1)
                except Exception as e:  # noqa: BLE001 — shadow must never hurt serving
                    with self._lock:
                        self._errors += 1
                    log.warning("shadow request failed: %r (args=%s)", e, args)
            finally:
                self._q.task_done()

    def shadow_stats(self) -> dict:
        with self._lock:
            compared = self._compared
            return {
                "shadow_model": self.shadow_dir,
                "compared": compared,
                "dropped": self._dropped,
                "errors": self._errors,
                "pending": self._q.qsize(),
                "mean_overlap": (self._overlap_sum / compared) if compared else None,
                "top1_agreement": (self._top1_agree / compared) if compared else None,
            }

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until the shadow queue is empty (tests / clean shutdown);
        True iff it drained in time."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            # unfinished_tasks (not empty()): an item the worker dequeued but
            # is still replaying must count as pending
            if self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._q.put(_STOP)
        self._worker.join(timeout=5.0)
        for eng in (self._shadow, self._primary):
            close = getattr(eng, "close", None)
            if callable(close):
                close()
