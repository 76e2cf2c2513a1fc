"""Response cache: identical requests skip the card (counterpart of
``hhrs_tpu/serve/cache.py``).

Everything a response depends on (reviews, social graph, model) is fixed
until a hot reload, so identical ``(user, city, mode, λ)`` requests give
identical responses and memoizing them is exact. Invalidation is by
generation: the wrapper holds the identity of the live stack (``.current``
of a SwappableEngine, else the wrapped engine) and clears itself when it
changes, so a hot swap invalidates at once. The optional TTL is an
operator's freshness knob, not a correctness mechanism. Cached responses
are shared dicts that every consumer treats as immutable.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

_NONE = object()  # cached "unknown item" marker (None itself means miss)


class CachedEngine:
    """LRU response cache wrapping any engine-like stack (plain engine,
    BatchingEngine, or SwappableEngine). Unknown attributes delegate to
    the wrapped stack, mirroring SwappableEngine's pattern."""

    def __init__(self, inner, max_entries: int = 4096, ttl_s: float = 0.0):
        import weakref

        self._inner = inner
        self._max = int(max_entries)
        self._ttl = float(ttl_s)
        self._lock = threading.Lock()
        self._cache: OrderedDict = OrderedDict()
        # Generation = IDENTITY of the live stack, held as a weakref (a
        # bare id() could be reused by a later allocation after the old
        # stack is freed, silently resurrecting stale entries). A dead
        # weakref compares `is not` to any live object, so address reuse
        # can never alias generations.
        self._weakref = weakref.ref
        self._gen_ref = weakref.ref(self._current())
        # single-flight: key -> Event of the in-progress computation, so a
        # stampede of identical misses (cold start, post-swap burst) costs
        # ONE device program instead of one per concurrent caller
        self._inflight: dict = {}
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ #

    def _current(self):
        # SwappableEngine exposes .current (the live stack); a plain engine
        # or BatchingEngine is its own generation.
        return getattr(self._inner, "current", self._inner)

    def _get(self, key):
        """Returns (cached_value_or_None, generation_object). Callers that
        miss must compute against THAT generation (they hold the only
        guaranteed-live reference to it) and hand it back to _put — closing
        the swap race where a response computed against the old model
        could otherwise be cached after the new one went live."""
        now = time.time()
        with self._lock:
            cur = self._current()
            if self._gen_ref() is not cur:  # model hot-swapped → all stale
                self._cache.clear()
                self._gen_ref = self._weakref(cur)
            entry = self._cache.get(key)
            if entry is None:
                self.misses += 1
                return None, cur
            val, ts = entry
            if self._ttl > 0 and now - ts > self._ttl:
                del self._cache[key]
                self.misses += 1
                return None, cur
            self._cache.move_to_end(key)
            self.hits += 1
            return val, cur

    def _put(self, key, val, gen):
        with self._lock:
            # cache only if the stack the response was computed against is
            # STILL the live one (gen is the object _get observed at miss
            # time; the caller's strong reference kept it un-collectable)
            if self._gen_ref() is not gen or self._current() is not gen:
                return  # raced a reload; don't cache the old model's answer
            self._cache[key] = (val, time.time())
            self._cache.move_to_end(key)
            while len(self._cache) > self._max:
                self._cache.popitem(last=False)

    # ---------------- engine surface ---------------- #

    def recommend(self, user_id: int, city: str, mode: str = "friends",
                  lambda_param: float = 0.7) -> dict:
        key = (int(user_id), city, mode, float(lambda_param))
        return self._single_flight(
            key, lambda: self._inner.recommend(user_id, city, mode, lambda_param)
        )

    def _single_flight(self, key, compute):
        """Memoized compute with stampede protection: concurrent identical
        misses elect one leader; followers wait on its Event, then re-read
        the cache. A follower whose leader failed (exception, or _put
        refused across a swap) computes for itself — correctness never
        depends on the leader."""
        val, gen = self._get(key)
        if val is not None:
            return val
        leader = False
        with self._lock:
            ev = self._inflight.get(key)
            if ev is None:
                ev = self._inflight[key] = threading.Event()
                leader = True
        if leader:
            try:
                val = compute()
                self._put(key, val, gen)
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
            return val
        ev.wait(timeout=60.0)
        val, gen = self._get(key)
        # One request = one stats event: the post-wait re-check must not
        # add a second miss (or stand as both a miss and a hit).
        with self._lock:
            self.misses -= 1
        if val is not None:
            return val
        val = compute()  # leader failed or swap raced — compute directly
        self._put(key, val, gen)
        return val

    def recommend_many(self, requests: list, pad_to: int | None = None) -> list:
        """Hits served from cache; only the misses go to the wrapped stack
        (still as ONE batched program). All-hit batches never touch the
        device."""
        keys = [(int(u), c, m, float(l)) for u, c, m, l in requests]
        looked = [self._get(k) for k in keys]
        out = [v for v, _ in looked]
        miss = [i for i, v in enumerate(out) if v is None]
        if miss:
            fresh = self._inner.recommend_many(
                [requests[i] for i in miss], pad_to=pad_to
            )
            for i, r in zip(miss, fresh):
                out[i] = r
                self._put(keys[i], r, looked[i][1])
        return out

    def similar_items(self, item_id: int, n: int = 10):
        """Deterministic like recommend (kNN over the fixed item table) —
        same memoization incl. the single-flight stampede gate; None
        (unknown item → 404) is cached via a sentinel so repeat 404s
        don't recompute."""
        key = ("sim", int(item_id), int(n))

        def compute():
            v = self._inner.similar_items(item_id, n)
            return _NONE if v is None else v

        val = self._single_flight(key, compute)
        return None if val is _NONE else val

    def cache_stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._cache), "hits": self.hits,
                    "misses": self.misses}

    def __getattr__(self, name):
        return getattr(self._inner, name)
