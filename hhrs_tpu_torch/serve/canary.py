"""Canary serving: a sticky user-hash slice of live traffic answered by a
candidate model on the request path (counterpart of
``hhrs_tpu/serve/canary.py``; routes every user as it does).

Routing: ``crc32(str(user_id)) < fraction · 2³²`` (with a salt,
``crc32(f"{salt}:{user_id}")``), so a user always hits the same arm.
Requests without a user (``/similar_items``) stay on the primary. A canary
failure falls back to the primary and counts in ``errors``. Over a mesh both
arms are engines of one world (``serve/lockstep.py``): :meth:`close` frees
them on every rank.
"""

from __future__ import annotations

import threading
import zlib

_HASH_SPACE = 2**32


def routes_to_canary(user_id, fraction: float, salt: str = "") -> bool:
    """Sticky arm assignment: stable across processes and restarts (crc32 of
    the decimal user id — no Python hash randomization).

    With the default empty ``salt`` the slice is the SAME fixed user
    population for every rollout (that is what makes it restart-sticky with
    zero configuration) — meaning those users always bear first-exposure
    risk and any bias in that slice biases every canary evaluation. Pass a
    per-experiment ``salt`` (e.g. the candidate dir or a release id,
    ``--canary-salt``) to rotate the slice per rollout while keeping
    within-rollout stickiness."""
    key = f"{salt}:{user_id}" if salt else str(user_id)
    return zlib.crc32(key.encode()) < fraction * _HASH_SPACE


class CanaryEngine:
    """Split live traffic between ``primary`` and ``canary`` by sticky
    user-hash routing. All non-serving attributes delegate to the primary
    (which may be a SwappableEngine — the primary can hot-swap underneath
    while the canary slice stays pinned to the candidate)."""

    def __init__(self, primary, canary, fraction: float, *,
                 canary_dir: str | None = None, salt: str = ""):
        # Delegation targets FIRST: __getattr__ resolves via self._primary,
        # so any attribute access on a half-constructed instance (the
        # fraction ValueError below, unpickling) must find _primary/_canary
        # already present instead of recursing to RecursionError.
        self._primary = primary
        self._canary = canary
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1], got {fraction}")
        self.fraction = fraction
        self.salt = salt
        self.canary_dir = canary_dir or getattr(canary, "artifacts_dir", None)
        self._lock = threading.Lock()
        self._primary_served = 0
        self._canary_served = 0
        self._errors = 0

    # ------------------------------------------------------------- serving
    def recommend(self, user_id, city, rec_type, lambda_param):
        if routes_to_canary(user_id, self.fraction, self.salt):
            try:
                result = self._canary.recommend(user_id, city, rec_type,
                                                lambda_param)
                with self._lock:
                    self._canary_served += 1
                return result
            except Exception:  # noqa: BLE001 — canary must never hurt serving
                with self._lock:
                    self._errors += 1
        result = self._primary.recommend(user_id, city, rec_type, lambda_param)
        with self._lock:
            self._primary_served += 1
        return result

    def recommend_many(self, requests, pad_to=None):
        idx_c = [i for i, r in enumerate(requests)
                 if routes_to_canary(r[0], self.fraction, self.salt)]
        if not idx_c:
            out = self._primary.recommend_many(requests, pad_to=pad_to)
            with self._lock:
                self._primary_served += len(requests)
            return out
        canary_set = set(idx_c)
        idx_p = [i for i in range(len(requests)) if i not in canary_set]
        out = [None] * len(requests)
        if idx_p:
            for i, res in zip(idx_p, self._primary.recommend_many(
                    [requests[i] for i in idx_p], pad_to=pad_to)):
                out[i] = res
        try:
            canary_res = self._canary.recommend_many(
                [requests[i] for i in idx_c], pad_to=pad_to)
            with self._lock:
                self._canary_served += len(idx_c)
        except Exception:  # noqa: BLE001 — fall back to the primary
            with self._lock:
                self._errors += len(idx_c)
                self._primary_served += len(idx_c)  # answered by the primary
            canary_res = self._primary.recommend_many(
                [requests[i] for i in idx_c], pad_to=pad_to)
        for i, res in zip(idx_c, canary_res):
            out[i] = res
        with self._lock:
            self._primary_served += len(idx_p)
        return out

    def __getattr__(self, name):
        if name.startswith("_"):
            # never delegate privates: during unpickling or partial
            # construction _primary itself is absent, and delegating its
            # lookup back through __getattr__ would recurse forever
            raise AttributeError(name)
        return getattr(self._primary, name)

    # --------------------------------------------------------------- stats
    def canary_stats(self) -> dict:
        with self._lock:
            served = self._canary_served
            stats = {
                "canary_model": self.canary_dir,
                "fraction": self.fraction,
                "salt": self.salt,
                "primary_served": self._primary_served,
                "canary_served": served,
                "errors": self._errors,
            }
        lat = getattr(self._canary, "latency", None)
        if lat is not None and served:
            stats["canary_latency"] = lat.summary()
        return stats

    def close(self) -> None:
        for eng in (self._canary, self._primary):
            close = getattr(eng, "close", None)
            if callable(close):
                close()
