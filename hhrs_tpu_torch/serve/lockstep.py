"""The lockstep of a serving world: one per ``torch.distributed`` world,
shared by every mesh engine of it (``serve/engine.py``'s ``mesh``).

The JAX package drives a mesh from one controller and needs none of this.
Here every rank is a process, and a mesh engine's device calls are
collectives that every rank must make in one order. Rank 0 leads: it does
the host work, and each device call of each engine starts with a header
that rank 0 broadcasts under the world's one lock, ``[op, engine, a, b]``
int64. The other ranks run :meth:`World.follow`, one loop that dispatches
each header to the engine it names. The ops:

* ``BATCH`` (engine, Kp, graphed): the packed inputs follow, then the
  engine's bucket on every rank; ``SIMILAR`` (engine, item, n): a sharded
  similar-items query; ``NOOP``: the keep-alive an idle leader sends every
  ``KEEPALIVE_S``, inside the world's collective timeout (one thread per
  world, whatever the number of engines).
* ``BUILD`` (engine): a payload follows (``broadcast_object_list`` on the
  wire device): the artifact dir, the engine's options and the frames rank
  0 parsed (None when they are the last build's, which every rank keeps).
  No follower reads the data dir, which may have moved on. Each follower
  builds the engine on a thread of its own and goes on serving; so does
  rank 0, outside the lock (engine construction makes no collective).
* ``COMMIT`` (engine): each follower waits for its build and holds the new
  engine's tower kernel to its plain version on its rows
  (``engine.tower_check``), then one ``all_gather`` of every rank's
  ``[built and agreed, frames digest]``. The engine is kept only where
  every rank built it from frames of one digest; else every rank discards
  its copy and rank 0's :meth:`World.build` raises.
* ``CLOSE`` (engine): every rank frees that engine's graphs and drops it.
  Closing an engine never stops the world.
* ``STOP``: the world's :meth:`World.shutdown`, once (the server's, after
  its drain): every follower's loop returns.

Engine ids are handed out in the same order on every rank: an engine that
every rank constructs itself (a test, a rank function) takes the next id
in construction order; a world build takes the id rank 0 names.

Each rank counts the tower kernel's launches made inside each engine's
device calls (``World.tower_launches``, logged when the engine is freed)
and keeps each build's kernel check (``World.checks``, logged at COMMIT).

A device call that fails part way leaves the ranks out of step for good:
rank 0 logs the fault and its process exits (code 1), so that its launcher
(``parallel/distributed.py::launch`` or torchrun) stops every rank; a
follower's fault raises out of :meth:`World.follow`. A build that fails is
no such fault: it fails before COMMIT, and every rank discards.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from hhrs_tpu_torch.ops import tower
from hhrs_tpu_torch.parallel.mesh import all_gather, broadcast_object, mesh_size

log = logging.getLogger(__name__)

OP_STOP, OP_BATCH, OP_SIMILAR, OP_NOOP, OP_BUILD, OP_COMMIT, OP_CLOSE = range(7)
OP_NAMES = ("STOP", "BATCH", "SIMILAR", "NOOP", "BUILD", "COMMIT", "CLOSE")
KEEPALIVE_S = 60.0  # an idle leader's keep-alive period (the world's timeout is 600 s)

_worlds_lock = threading.Lock()


def world_of(mesh, device) -> "World":
    """The lockstep of ``mesh``'s world: one per mesh until it is shut
    down (a mesh engine built after that starts a new one, on every rank)."""
    with _worlds_lock:
        world = getattr(mesh, "_hhrs_world", None)
        if world is None or world.stopped:
            world = World(mesh, device)
            mesh._hhrs_world = world
        return world


def frames_digest(frames: tuple) -> int:
    """A 63-bit digest of the content of ``(main, friendships)`` tables:
    every column's name, type and values, in name order."""
    h = hashlib.blake2b(digest_size=8)
    for table in frames:
        h.update(b"\x1e")
        for name in sorted(table):
            col = np.asarray(table[name])
            h.update(f"{name}\x1f{col.dtype}\x1f".encode())
            if col.dtype == object:
                h.update("\x1f".join(map(repr, col.tolist())).encode())
            else:
                h.update(np.ascontiguousarray(col).tobytes())
    return int.from_bytes(h.digest(), "little") >> 1


def _kept(votes: list) -> bool:
    """COMMIT's rule: every rank built and agreed, from frames of one digest."""
    return all(ok for ok, _ in votes) and len({digest for _, digest in votes}) == 1


class _Build:
    """A follower's build of one engine, on a thread of its own."""

    def __init__(self, world: "World", engine_id: int, payload: dict, frames):
        self.engine = None
        self.digest = 0
        self._thread = threading.Thread(target=self._run, args=(world, engine_id, payload, frames),
                                        name=f"mesh-build-{engine_id}", daemon=True)
        self._thread.start()

    def _run(self, world, engine_id, payload, frames) -> None:
        try:
            if frames is None:
                raise RuntimeError("BUILD named the last build's frames, and this rank holds none")
            self.digest = frames_digest(frames)
            self.engine = world.make_engine(engine_id, payload, frames)
        except Exception:  # noqa: BLE001 — voted at COMMIT: every rank discards
            log.exception("rank %d: building engine %d (%s) failed", world.rank, engine_id, payload.get("label"))

    def result(self) -> tuple:
        self._thread.join()
        return self.engine, self.digest


class World:
    """The lockstep of every mesh engine of one world (see the module
    docstring). ``counts`` holds the headers sent (rank 0) or received
    (the others), by op name; ``labels``, ``tower_launches`` and
    ``checks`` each engine's label, the tower launches of its device calls
    on this rank, and its build's kernel check on this rank."""

    def __init__(self, mesh, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = mesh
        self.device = device
        self.rank = dist.get_rank()
        self.leader = self.rank == 0
        self.size = mesh_size(mesh)
        # headers and gloo's payloads travel on the host; NCCL's on the card
        self.wire = device if dist.get_backend() == "nccl" else torch.device("cpu")
        self.lock = threading.RLock()  # rank 0: one device call at a time, in one order
        self.counts = {name: 0 for name in OP_NAMES}
        self.labels: dict = {}
        self.tower_launches: dict = {}
        self.checks: dict = {}
        self._ids_lock = threading.Lock()
        self._engines: dict = {}  # engine id -> engine
        self._next_id = 0
        self._local = threading.local()  # the id a world build hands the engine it constructs
        self._stopped = threading.Event()
        self._last_send = time.monotonic()
        self._sent_digest = None  # rank 0: the frames every rank holds from the last build
        self._frames = None  # the others: those frames
        if self.leader and self.size > 1:
            threading.Thread(target=self._keepalive, name="mesh-keepalive", daemon=True).start()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def engine_ids(self) -> list:
        """The ids of the engines this rank holds."""
        with self._ids_lock:
            return sorted(self._engines)

    # ---- engines ----------------------------------------------------------- #

    def attach(self, engine) -> int:
        """Register a mesh engine at the end of its construction → its id."""
        with self._ids_lock:
            engine_id = getattr(self._local, "engine_id", None)
            if engine_id is None:
                engine_id = self._next_id
            self._next_id = max(self._next_id, engine_id + 1)
            self._engines[engine_id] = engine
        return engine_id

    def make_engine(self, engine_id: int, payload: dict, frames):
        """Construct engine ``engine_id`` of a world build on this rank."""
        from hhrs_tpu_torch.serve.engine import RecommendationEngine  # engine.py imports this module

        self.labels[engine_id] = payload.get("label", "engine")
        self._local.engine_id = engine_id
        try:
            with torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext():
                return RecommendationEngine.from_dirs(payload["artifacts_dir"], None, frames=frames,
                                                      device=self.device, mesh=self.mesh, **payload["options"])
        finally:
            self._local.engine_id = None

    def _drop(self, engine_id: int):
        with self._ids_lock:
            engine = self._engines.pop(engine_id, None)
        if engine is not None:
            engine._closed = True
            engine._free_graphs()
            memory = (f"; card memory allocated {torch.cuda.memory_allocated(self.device)} bytes"
                      if self.device.type == "cuda" else "")
            log.info("rank %d: freed %s engine %d; its device calls launched the tower kernel %d times%s", self.rank,
                     self.labels.get(engine_id, "engine"), engine_id, self.tower_launches.get(engine_id, 0), memory)
        return engine

    def _check(self, engine_id: int, engine) -> bool:
        """A new engine's tower kernel against its plain version on this
        rank's rows (kept in ``checks`` and logged) → whether it agrees."""
        if engine is None:
            return False
        try:
            check = engine.tower_check()
        except Exception:  # noqa: BLE001 — a vote against the engine
            log.exception("rank %d: the kernel check of engine %d failed", self.rank, engine_id)
            return False
        self.checks[engine_id] = check
        if check is None:
            return True
        log.info("rank %d: %s engine %d: tower kernel on %d rows against its plain version: max abs err %.3e, "
                 "%d outside rtol=atol=%g", self.rank, self.labels.get(engine_id, "engine"), engine_id,
                 check["rows"], check["max_abs_err"], check["outside"], tower.TOWER_TOL)
        return check["outside"] == 0

    # ---- rank 0 ------------------------------------------------------------ #

    @contextlib.contextmanager
    def lockstep(self, engine=None):
        """One device call, under the world lock; on rank 0 it raises (before
        any header goes out) once the world is shut down or ``engine`` is
        closed. A call that fails part way ends rank 0 (module docstring)."""
        with self.lock:
            if self.leader:
                if self._stopped.is_set():
                    raise RuntimeError("the mesh engine is shut down: its world was stopped")
                if engine is not None and engine._closed:
                    raise RuntimeError("the mesh engine is closed: it was shut down on every rank")
            launches = tower.tower_eval.launches
            try:
                yield
                if engine is not None:
                    self._count(engine._engine_id, launches)
            except Exception:
                if self.leader:
                    self._stopped.set()
                    log.critical("a device call of the mesh world failed part way; the ranks are out of step: "
                                 "ending rank 0 so that the launcher stops the world", exc_info=True)
                    os._exit(1)
                raise

    def _count(self, engine_id: int, launches: int) -> None:
        self.tower_launches[engine_id] = self.tower_launches.get(engine_id, 0) + tower.tower_eval.launches - launches

    def send(self, op: int, engine_id: int = 0, a: int = 0, b: int = 0) -> None:
        """Rank 0: the header of the next device call (under the lock)."""
        dist.broadcast(torch.tensor([op, engine_id, a, b], dtype=torch.int64, device=self.wire), 0)
        self.counts[OP_NAMES[op]] += 1
        self._last_send = time.monotonic()

    def _keepalive(self) -> None:
        while not self._stopped.wait(KEEPALIVE_S / 4):
            with self.lock:
                if (not self._stopped.is_set() and dist.is_initialized()
                        and time.monotonic() - self._last_send >= KEEPALIVE_S):
                    with self.lockstep():
                        self.send(OP_NOOP)

    def build(self, artifacts_dir: str, frames: tuple, *, label: str = "engine", **options):
        """Rank 0: build one mesh engine on every rank from ``frames`` (rank
        0's parse) and ``RecommendationEngine.from_dirs`` ``options`` →
        this rank's engine. Serving goes on meanwhile: the lock is held only
        to send BUILD and to vote at COMMIT. Raises, after every rank
        discarded its copy, when a rank failed or ranks built from frames
        of different digests."""
        if not self.leader:
            raise RuntimeError("rank 0 builds a world's engines; the other ranks run follow()")
        digest = frames_digest(frames)
        with self._ids_lock:
            engine_id = self._next_id
            self._next_id += 1
        payload = {"label": label, "artifacts_dir": artifacts_dir, "options": options}
        with self.lockstep():
            self.send(OP_BUILD, engine_id)
            broadcast_object(dict(payload, frames=None if digest == self._sent_digest else frames),
                             device=self.wire)
        self._sent_digest = digest
        engine = error = None
        try:
            engine = self.make_engine(engine_id, payload, frames)
        except Exception as e:  # noqa: BLE001 — voted at COMMIT, raised below
            error = e
        with self.lockstep():
            self.send(OP_COMMIT, engine_id)
            votes = self._vote(engine_id, engine, digest)
        failed = [r for r, (ok, _) in enumerate(votes) if not ok]
        if not _kept(votes):
            why = (f"failed on ranks {failed}" if failed
                   else f"built from frames of different digests {[d for _, d in votes]}")
            raise RuntimeError(f"the world's build of {label} engine {engine_id} ({artifacts_dir}) {why}; every "
                               f"rank discarded it") from error
        log.info("world build: %s engine %d (%s) on %d ranks", label, engine_id, artifacts_dir, self.size)
        return engine

    def _vote(self, engine_id: int, engine, digest: int) -> list:
        """COMMIT on every rank: each rank's ``[built and agreed, digest]``;
        an engine the vote does not keep is discarded here."""
        mine = torch.tensor([int(self._check(engine_id, engine)), digest], dtype=torch.int64, device=self.wire)
        votes = all_gather(mine).cpu().tolist()
        if not _kept(votes):
            self._drop(engine_id)
        return votes

    def close(self, engine) -> None:
        """Rank 0: free ``engine`` on every rank (CLOSE); idempotent, and
        local only once the world is shut down. The others: local only."""
        with self.lock:
            if self._drop(engine._engine_id) is None:
                engine._closed = True
                engine._free_graphs()
                return
            if self.leader and not self._stopped.is_set():
                with self.lockstep():
                    self.send(OP_CLOSE, engine._engine_id)

    def shutdown(self) -> None:
        """Rank 0: end every follower's loop (STOP, once); later device calls
        raise. The engines' graphs are freed on every rank."""
        if not self.leader:
            return
        with self.lock:
            if not self._stopped.is_set():
                self.send(OP_STOP)
                self._stopped.set()
        for engine_id in self.engine_ids():
            self._drop(engine_id)

    # ---- the other ranks ---------------------------------------------------- #

    def follow(self) -> None:
        """The loop of every rank but 0: run each device call rank 0
        announces, on the engine it names, until the world's STOP."""
        if self.leader:
            raise RuntimeError("follow() is for the ranks of a mesh world other than 0")
        builds: dict = {}
        try:
            while True:
                header = torch.empty(4, dtype=torch.int64, device=self.wire)
                dist.broadcast(header, 0)
                op, engine_id, a, b = header.tolist()
                self.counts[OP_NAMES[op]] += 1
                if op == OP_STOP:
                    return
                if op == OP_BATCH:  # counted inside, as on rank 0 (the engine's lockstep)
                    self._engine(engine_id)._mesh_batch(None, bool(b), a)
                elif op == OP_SIMILAR:
                    self._engine(engine_id)._similar_sharded(a, b)
                elif op == OP_BUILD:
                    payload = broadcast_object(None, device=self.wire)
                    if payload["frames"] is not None:
                        self._frames = payload["frames"]
                    builds[engine_id] = _Build(self, engine_id, payload, self._frames)
                elif op == OP_COMMIT:
                    self._vote(engine_id, *builds.pop(engine_id).result())
                elif op == OP_CLOSE:
                    self._drop(engine_id)
        finally:
            self._stopped.set()
            for engine_id in self.engine_ids():
                self._drop(engine_id)

    def _engine(self, engine_id: int):
        with self._ids_lock:
            engine = self._engines.get(engine_id)
        if engine is None:
            raise RuntimeError(f"rank {self.rank}: rank 0 called engine {engine_id}, which this rank does not hold "
                               f"(it holds {self.engine_ids()})")
        return engine
