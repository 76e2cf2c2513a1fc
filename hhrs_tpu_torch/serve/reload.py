"""Hot reload for a live server: models (``--reload-poll-s``) and data
(``--data-poll-s``); counterpart of ``hhrs_tpu/serve/reload.py``.

``RegistryReloader`` watches the registry's active registration and swaps
in a newly activated model; ``DataReloader`` watches the data CSVs'
fingerprints and rebuilds the serving stack over the refreshed reviews.
Neither drops traffic: ``SwappableEngine`` is one attribute indirection, a
request that already holds the old stack finishes on it, and every later
one sees the new stack. The old stack is closed after a grace period
(``_defer_close``); on a card that frees its CUDA graphs, and its other
card memory goes with its last reference. A failed load logs and keeps the
current model serving: a running server never kills itself over a bad
swap.

Over a mesh (``serve.cli --mesh``) the pollers run on rank 0, and the CLI's
``build`` is a world build (``serve/lockstep.py``): every rank builds from
the frames rank 0 parsed from its snapshot, a build that fails on any rank
raises here on rank 0 after every rank discarded it, and closing an old or
discarded stack frees its engine on every rank (CLOSE).
"""

from __future__ import annotations

import logging
import threading

from hhrs_tpu_torch.db.registry import ModelRegistry

log = logging.getLogger(__name__)

# Seconds to keep the PREVIOUS engine stack alive after a swap before
# closing it: a request that grabbed the old engine just before the swap
# (or sat in the old dynamic batcher's queue) must finish on it, not get a
# "closed" error. Far beyond any request latency + batch window.
OLD_STACK_CLOSE_GRACE_S = 10.0

# Backoff after a FAILED load of a registration: a full engine build is
# seconds-to-minutes of CSV parsing + device transfers + warmup, so a
# persistently broken artifact dir must not be re-attempted every poll
# tick. A registration key change (operator fixed and re-registered)
# retries immediately; the same broken key retries after this long.
FAILED_LOAD_RETRY_S = 60.0

# Filenames the serve path reads from the data dir (reference
# main.py:242-245); the data-reload fingerprint covers exactly these.
DATA_FILES = ("hackathon_augmented_data.csv", "friendships.csv")


def _content_token(path: str, size: int, block: int = 4096) -> int:
    """crc32 over the first+last ``block`` bytes — a cheap O(1) content
    check that catches same-size in-place rewrites on filesystems with
    coarse mtime granularity (1s on some network mounts), where a
    stat-only fingerprint would miss a data drop entirely."""
    import zlib

    with open(path, "rb") as f:
        token = zlib.crc32(f.read(block))
        if size > block:
            f.seek(max(size - block, block))
            token = zlib.crc32(f.read(block), token)
    return token


def data_fingerprint(data_dir: str) -> tuple:
    """Cheap change detector over the serve-path CSVs: (name, mtime_ns,
    size, head/tail-crc) per file — an os.stat plus two 4KiB reads, never
    a full-content scan. A missing (or mid-swap unreadable) file
    fingerprints as (name, None, None, None) so appear/disappear
    transitions register as changes too.

    Writer contract: drops should APPEND rows or rename-into-place (both
    move size and/or the boundary blocks). A same-size interior-only
    rewrite that also preserves the first/last 4KiB and the mtime is the
    one remaining undetectable case — no cheap detector can close it
    without hashing full contents every poll tick."""
    import os

    fp = []
    for name in DATA_FILES:
        path = os.path.join(data_dir, name)
        try:
            st = os.stat(path)
            fp.append((name, st.st_mtime_ns, st.st_size,
                       _content_token(path, st.st_size)))
        except OSError:
            fp.append((name, None, None, None))
    return tuple(fp)


def _copy_data_files(data_dir: str, snap: str) -> None:
    """Copy the serve-path CSVs into ``snap`` (existing files only)."""
    import os
    import shutil

    for name in DATA_FILES:
        src = os.path.join(data_dir, name)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(snap, name))


def snapshot_data_dir(data_dir: str, attempts: int = 3,
                      expected_fp: tuple | None = None) -> str | None:
    """Copy the serve-path CSVs to a temp dir, retrying until one copy is
    CONSISTENT (fingerprint identical before and after the fast copy —
    the copy is milliseconds, so even a busy writer leaves gaps). Returns
    the temp dir (caller removes) or None if the files kept moving every
    attempt. ``expected_fp`` pins the snapshot to one exact fingerprint
    (the DataReloader's trigger) instead of whatever is current — a
    mismatch returns None immediately so the caller can re-debounce.
    None strictly means WRITER CHURN; a copy-time OSError (disk full,
    permissions) is logged and RAISED so callers diagnose/back off on
    the real cause instead of hunting a phantom writer.
    The toolbox for anything that must READ the live data dir while
    writers may be appending: both hot-reloaders and the
    continuous-training pipeline parse/train from such snapshots."""
    import shutil
    import tempfile

    for _ in range(attempts):
        fp = expected_fp if expected_fp is not None else data_fingerprint(data_dir)
        snap = tempfile.mkdtemp(prefix="hhrs_data_snap_")
        try:
            _copy_data_files(data_dir, snap)
        except OSError as e:
            shutil.rmtree(snap, ignore_errors=True)
            log.error("data snapshot copy failed (%s) — NOT writer churn; "
                      "check disk space/permissions", e)
            raise
        if data_fingerprint(data_dir) == fp:
            return snap
        shutil.rmtree(snap, ignore_errors=True)
        if expected_fp is not None:
            return None  # pinned fingerprint moved: caller re-debounces
    return None


class FramesCache:
    """(fingerprint → parsed frames) memo of size one, shared by both
    reloaders under the swap lock: a MODEL swap whose data fingerprint
    matches the last parse reuses those frames instead of re-paying the
    seconds-scale snapshot+parse while holding the lock."""

    def __init__(self, fp: tuple | None = None, frames: tuple | None = None):
        self.fp = fp
        self.frames = frames

    def get(self, fp: tuple):
        return self.frames if fp == self.fp and self.frames is not None else None

    def put(self, fp: tuple, frames: tuple) -> None:
        self.fp, self.frames = fp, frames


def _defer_close(old) -> None:
    """Close the previous engine stack after the swap grace period (shared
    by both reloaders): requests that grabbed the old stack right before
    the swap — or sat in its batcher queue — finish on it error-free."""

    def _close_old():
        close = getattr(old, "close", None)
        if callable(close):
            try:
                close()
            except Exception:  # old stack teardown must never hurt serving
                log.exception("closing the previous engine failed")

    t = threading.Timer(OLD_STACK_CLOSE_GRACE_S, _close_old)
    t.daemon = True
    t.start()


class SwappableEngine:
    """Forwarding proxy so the HTTP layer (and dynamic batcher) can keep a
    stable object while the engine underneath is hot-swapped."""

    def __init__(self, engine):
        self._engine = engine
        # ops visibility: how many times the stack under this holder has
        # been hot-swapped (model or data reloads), surfaced in /healthz
        self.swap_count = 0

    def swap(self, new_engine):
        """Atomically install ``new_engine``; returns the previous one."""
        old, self._engine = self._engine, new_engine
        self.swap_count += 1
        return old

    @property
    def current(self):
        return self._engine

    def __getattr__(self, name):
        # Only reached for names not defined on the proxy itself.
        return getattr(self._engine, name)


class RegistryReloader(threading.Thread):
    """Polls `registry:<db>` for a change of the active model's artifact
    dir; on change, builds a fresh engine stack and swaps it in.

    ``build`` is a callable(artifacts_dir) -> engine so the CLI decides
    the full stack (mesh / bf16 / quantized tables / warmup) once and
    reloads reproduce it. ``check_once`` is the unit-testable core; the
    thread is just check_once on a timer.
    """

    def __init__(self, holder: SwappableEngine, spec: str, build,
                 poll_s: float, current_dir: str,
                 swap_lock: threading.Lock | None = None,
                 data_dir: str | None = None, frames_loader=None,
                 frames_cache: "FramesCache | None" = None):
        super().__init__(daemon=True, name="hhrs-registry-reloader")
        self.holder = holder
        self.spec = spec
        self.build = build
        self.poll_s = poll_s
        # With both set, a model swap parses the data CSVs from a
        # CONSISTENT snapshot (build(dir, frames)) instead of reading the
        # live files mid-append — the same torn-write defense the data
        # reloader has. Without them, build(dir) reads live (test path).
        # frames_cache (shared with the DataReloader, mutated only under
        # the swap lock) skips the snapshot+parse entirely when the data
        # fingerprint hasn't moved since the last parse — the common case
        # for a model-only promotion.
        self.data_dir = data_dir
        self.frames_loader = frames_loader
        self.frames_cache = frames_cache
        # Optional back-reference set by the CLI when BOTH pollers run: a
        # model swap that parsed a FRESH data fingerprint also advances the
        # data reloader's baseline (the swapped-in stack already serves
        # that universe), so the next data tick doesn't pay a redundant
        # snapshot+parse+rebuild of an equivalent stack.
        self.data_reloader: "DataReloader | None" = None
        # Serializes build+swap against a concurrent DataReloader (the CLI
        # passes ONE lock to both): without it a registry swap landing
        # mid-data-rebuild could be overwritten by an engine built from the
        # superseded artifact dir. Builds are long (CSV parse + device
        # transfers + warmup) so the two pollers simply take turns.
        self.swap_lock = swap_lock if swap_lock is not None else threading.Lock()
        self._stop = threading.Event()
        # The swap key is (model_id, artifact_path), not the path alone: a
        # retrain exported over the SAME directory and re-registered is a
        # new model and must swap (a new snapshot gets a new model_id).
        self.current_key = (None, current_dir)
        self._failed_key = None
        self._failed_at = 0.0
        import time as _time

        # wall clock, same base as the registry's created_at column — lets
        # the adopt branch below tell a pre-boot registration (the one the
        # server loaded) from a post-boot re-registration over the same dir
        self._boot_at = _time.time()
        try:
            active, _created = self._active()
            if active[1] == current_dir:
                self.current_key = active
        except Exception:  # registry unreadable at init → first poll decides
            pass

    @property
    def current_dir(self) -> str:
        return self.current_key[1]

    def _active(self) -> tuple:
        """((model_id, artifact_path), created_at) of the active registration."""
        reg = ModelRegistry(self.spec[len("registry:"):])
        active = reg.active()
        if active is None:
            raise FileNotFoundError("no active model in registry")
        return ((active["model_id"], active["artifact_path"]),
                float(active.get("created_at") or 0.0))

    def check_once(self) -> bool:
        """One poll: swap if the active registration moved. Returns True
        iff a new model was installed. Never raises — a failed resolve or
        load keeps the current model serving."""
        import time

        try:
            new_key, created_at = self._active()
        except Exception as e:
            log.warning("registry poll failed (%s); keeping current model", e)
            return False
        if new_key == self.current_key:
            return False
        if (self.current_key[0] is None and new_key[1] == self.current_dir
                and created_at <= self._boot_at):
            # Init couldn't read the registry (transient lock) but the
            # active registration PREDATES boot and points at the dir
            # ALREADY serving — it is the registration the server loaded;
            # adopt its key instead of rebuilding the identical stack. A
            # registration CREATED AFTER boot over the same dir is a new
            # snapshot (new weights on disk) and falls through to a real
            # rebuild+swap below.
            self.current_key = new_key
            return False
        if new_key == self._failed_key and (
            time.monotonic() - self._failed_at < FAILED_LOAD_RETRY_S
        ):
            return False  # same broken registration: back off, retry later
        new_dir = new_key[1]
        log.info("registry: active model changed %s -> %s (model_id %s); loading...",
                 self.current_dir, new_dir, new_key[0])
        with self.swap_lock:
            # Fingerprint of the universe the swapped-in stack will serve
            # (when knowable): forwarded to the data reloader post-swap so
            # it doesn't redundantly rebuild an equivalent stack.
            served_fp = None
            try:
                snap, frames = None, None
                if self.frames_loader is not None and self.data_dir:
                    fp_now = data_fingerprint(self.data_dir)
                    if self.frames_cache is not None:
                        frames = self.frames_cache.get(fp_now)
                        if frames is not None:
                            served_fp = fp_now
                    if frames is None:
                        snap = snapshot_data_dir(self.data_dir)
                        if snap is None:
                            log.warning("data files kept changing during "
                                        "the snapshot; model reload falls "
                                        "back to a live read")
                try:
                    if snap is not None:
                        frames = self.frames_loader(snap)
                        # key on the SNAPSHOT's fingerprint (copy2
                        # preserves mtime/size/content) — the live dir
                        # may have moved again since
                        served_fp = data_fingerprint(snap)
                        if self.frames_cache is not None:
                            self.frames_cache.put(served_fp, frames)
                    if frames is not None:
                        new_engine = self.build(new_dir, frames)
                    else:
                        new_engine = self.build(new_dir)
                finally:
                    if snap is not None:
                        import shutil

                        shutil.rmtree(snap, ignore_errors=True)
            except Exception as e:
                log.error("hot reload of %s FAILED (%s); keeping %s (retry in %.0fs "
                          "unless the registration changes)",
                          new_dir, e, self.current_dir, FAILED_LOAD_RETRY_S)
                self._failed_key = new_key
                self._failed_at = time.monotonic()
                return False
            self._failed_key = None
            old = self.holder.swap(new_engine)
            self.current_key = new_key
            if served_fp is not None and self.data_reloader is not None:
                # The swapped-in stack serves frames(served_fp): advance
                # the data reloader's baseline under the SAME lock so its
                # next tick doesn't re-parse and re-swap an equivalent
                # universe (it still fires normally if the live files have
                # moved past served_fp).
                self.data_reloader.current_fp = served_fp
                self.data_reloader._pending = None
        _defer_close(old)
        log.info("hot reload complete: serving %s", new_dir)
        return True

    def run(self):
        while not self._stop.wait(self.poll_s):
            self.check_once()

    def stop(self):
        self._stop.set()


class DataReloader(threading.Thread):
    """Polls the data CSVs' stat fingerprints; on change, rebuilds the
    serving stack over the refreshed review universe and swaps it in.

    The reference can only pick up new reviews/friendships by restarting
    the process (CSVs read once in the startup lifespan, main.py:242-245).
    Here a refreshed data drop reaches live traffic in ~2 poll ticks with
    zero dropped requests — the same SwappableEngine swap the model
    reloader uses, so the response cache's generation handshake
    invalidates stale entries automatically.

    Mid-write defenses (a writer replacing multi-MB CSVs is not atomic
    unless it renames into place):

      * DEBOUNCE — a changed fingerprint must hold STABLE across two
        consecutive polls before a rebuild starts, so a file still being
        appended keeps deferring;
      * SNAPSHOT ISOLATION (when ``frames_loader`` is given — the
        production CLI path) — the CSVs are first COPIED to a temp dir
        with a fingerprint recheck around the (fast) copy; the
        seconds-to-minutes rebuild then reads only the immutable
        snapshot, so a writer landing mid-rebuild can never tear it.
        Without snapshot isolation the torn-read race window is the whole
        rebuild, and under sustained churn (inter-write gap < rebuild
        time) EVERY rebuild would be discarded;
      * POST-BUILD RECHECK (no-``frames_loader`` fallback) — if the
        fingerprint moved during the rebuild, the freshly built engine is
        discarded un-swapped and the new fingerprint re-enters debounce;
      * a FAILED parse/build keeps the current stack serving and backs
        off ``FAILED_LOAD_RETRY_S`` for that exact fingerprint (a further
        file change retries immediately).

    ``current_dir_fn`` supplies the artifact dir to rebuild with — the
    registry reloader's live ``current_dir`` when both pollers run, else
    the static startup dir. ``frames_loader(dir) -> frames`` parses the
    CSVs in ``dir``; when given, the engine is built via
    ``build(adir, frames)`` from the snapshot. ``check_once`` is the
    unit-testable core.
    """

    def __init__(self, holder: SwappableEngine, data_dir: str, build,
                 poll_s: float, current_dir_fn,
                 swap_lock: threading.Lock | None = None,
                 frames_loader=None, baseline_fp: tuple | None = None,
                 frames_cache: "FramesCache | None" = None):
        super().__init__(daemon=True, name="hhrs-data-reloader")
        self.holder = holder
        self.data_dir = data_dir
        self.build = build
        self.poll_s = poll_s
        self.current_dir_fn = current_dir_fn
        self.swap_lock = swap_lock if swap_lock is not None else threading.Lock()
        self.frames_loader = frames_loader
        # shared with the RegistryReloader: freshly parsed frames are
        # published here (under the swap lock) so a model-only promotion
        # right after a data reload skips its own snapshot+parse
        self.frames_cache = frames_cache
        self._stop = threading.Event()
        # baseline_fp: the fingerprint taken BEFORE the caller parsed the
        # CSVs it is currently serving. Defaulting to stat-at-construction
        # would bake a write that landed during the caller's (long) startup
        # into the baseline without ever serving it — the CLI captures the
        # fingerprint before its parse and passes it here.
        self.current_fp = (baseline_fp if baseline_fp is not None
                           else data_fingerprint(data_dir))
        self._pending = None
        self._failed_fp = None
        self._failed_at = 0.0

    def check_once(self) -> bool:
        """One poll tick. Returns True iff a rebuilt stack was swapped in.
        Never raises — any failure keeps the current stack serving."""
        import shutil
        import time

        fp = data_fingerprint(self.data_dir)
        if fp == self.current_fp:
            self._pending = None
            return False
        if fp != self._pending:
            # First sighting of this fingerprint: defer one tick so an
            # in-progress write settles before the expensive rebuild.
            self._pending = fp
            return False
        if fp == self._failed_fp and (
            time.monotonic() - self._failed_at < FAILED_LOAD_RETRY_S
        ):
            return False  # same broken data drop: back off, retry later
        log.info("data: %s changed; rebuilding the serving stack...",
                 self.data_dir)
        with self.swap_lock:
            # Resolve the artifact dir INSIDE the lock: a registry swap may
            # be completing while we blocked on it — reading the dir before
            # acquisition would rebuild from the superseded model and
            # silently demote a concurrent promotion.
            adir = self.current_dir_fn()
            snap = None
            try:
                if self.frames_loader is not None:
                    # A model swap may already have parsed exactly this
                    # fingerprint (shared FramesCache): reuse those frames
                    # and skip the snapshot+parse — the rebuild below still
                    # happens (the serving stack may predate the frames).
                    frames = (self.frames_cache.get(fp)
                              if self.frames_cache is not None else None)
                    if frames is None:
                        # pinned to the trigger fingerprint: the snapshot
                        # is exactly the state whose fingerprint we adopt
                        # below
                        snap = snapshot_data_dir(self.data_dir, attempts=1,
                                                 expected_fp=fp)
                        if snap is None:
                            log.info("data changed during the snapshot "
                                     "copy; re-polling")
                            self._pending = data_fingerprint(self.data_dir)
                            return False
                        frames = self.frames_loader(snap)
                        if self.frames_cache is not None:
                            self.frames_cache.put(fp, frames)
                    new_engine = self.build(adir, frames)
                else:
                    new_engine = self.build(adir)
            except Exception as e:
                log.error("data reload FAILED (%s); keeping the current "
                          "universe (retry in %.0fs unless the files change "
                          "again)", e, FAILED_LOAD_RETRY_S)
                self._failed_fp = fp
                self._failed_at = time.monotonic()
                return False
            finally:
                if snap is not None:
                    shutil.rmtree(snap, ignore_errors=True)
            if self.frames_loader is None:
                # No snapshot: the rebuild read the LIVE files, so a write
                # landing mid-rebuild may have torn it — discard unswapped
                # and let the new fingerprint re-debounce.
                fp2 = data_fingerprint(self.data_dir)
                if fp2 != fp:
                    log.warning("data changed again during the rebuild; "
                                "discarding and re-polling")
                    close = getattr(new_engine, "close", None)
                    if callable(close):
                        try:
                            close()
                        except Exception:
                            log.exception("closing the discarded engine failed")
                    self._pending = fp2
                    return False
            self._failed_fp = None
            old = self.holder.swap(new_engine)
            self.current_fp = fp
            self._pending = None
        _defer_close(old)
        log.info("data reload complete: serving the refreshed universe")
        return True

    def run(self):
        while not self._stop.wait(self.poll_s):
            self.check_once()

    def stop(self):
        self._stop.set()
