"""The process world: configuration, the backend rule and a one-node launcher.

Counterpart of ``hhrs_tpu/parallel/distributed.py``. The JAX package turns
N hosts into one device view with ``jax.distributed.initialize``; here every
mesh position is a process of a ``torch.distributed`` world.

* :func:`initialize_distributed` joins a world configured by the
  environment, under the JAX wrapper's contract (``COORDINATOR_ADDRESS``,
  ``NUM_PROCESSES``, ``PROCESS_ID``) or torchrun's (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). With neither it is a single
  process and returns False; a partial configuration, and a world that does
  not form within the time limit, raise ``RuntimeError``.
* :func:`choose_backend` is the backend rule: NCCL when every rank of the
  node has a GPU of its own, gloo on the CPU or when ranks share a GPU.
  The choice is logged. An NCCL failure raises; nothing is retried on gloo.
* :func:`launch` starts a world of W ranks on this node (the ``spawn``
  start method, a ``FileStore`` rendezvous), runs one function on every
  rank and hands rank 0's return value back. A rank that fails stops the
  others and raises with its traceback; so does a world that outlives its
  time limit.
"""

from __future__ import annotations

import logging
import os
import signal
import tempfile
import threading
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from hhrs_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

WORLD_TIMEOUT_S = 600  # a collective that waits longer than this raises


def _env_int(name: str, value: int | None) -> int | None:
    if value is None and name in os.environ:
        return int(os.environ[name])
    return value


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_s: int = 300,
    device: str | torch.device | None = None,
) -> bool:
    """Join the world the environment (or the arguments) configure; True
    when a world was joined, False for a single process. The rank's device
    (``cuda`` by default, which raises without a card; the CPU only when
    asked) and the backend follow :func:`init_world`."""
    if coordinator_address is None and "COORDINATOR_ADDRESS" in os.environ:
        coordinator_address = os.environ["COORDINATOR_ADDRESS"]
    num_processes = _env_int("NUM_PROCESSES", num_processes)
    process_id = _env_int("PROCESS_ID", process_id)
    init_method = f"tcp://{coordinator_address}" if coordinator_address else None
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        # torchrun's contract: env:// joins its agent's store where there is one
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        init_method = "env://"
    num_processes = _env_int("WORLD_SIZE", num_processes)
    process_id = _env_int("RANK", process_id)

    if coordinator_address is None:
        if num_processes is not None or process_id is not None or os.environ.get("MASTER_ADDR"):
            # A partial configuration would serve alone while its peers
            # wait for it until their timeout: fail loudly instead.
            raise RuntimeError(
                "NUM_PROCESSES/PROCESS_ID (or WORLD_SIZE/RANK) configured "
                f"(n={num_processes}, id={process_id}) but no COORDINATOR_ADDRESS "
                "(or MASTER_ADDR and MASTER_PORT) — refusing to fall back to a "
                "single-process run on a multi-process launch")
        log.info("single-process run (no coordinator configured)")
        return False
    if num_processes is None or process_id is None:
        raise RuntimeError(
            f"coordinator {coordinator_address} configured without both NUM_PROCESSES and PROCESS_ID "
            f"(or WORLD_SIZE and RANK): n={num_processes}, id={process_id}")
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    device = resolve_device(device)
    try:
        init_world(process_id, num_processes, init_method, device,
                   local_rank=local_rank, local_world=local_world, timeout_s=timeout_s)
    except (RuntimeError, ValueError) as e:  # DistError is a RuntimeError
        raise RuntimeError(
            f"torch.distributed world did not form within {timeout_s}s "
            f"(coordinator={coordinator_address}, n={num_processes}, id={process_id}): {e}") from e
    return True


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every one of the node's ``local_world`` ranks has a card of
    its own; gloo on the CPU or when ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The device of a node's ``local_rank``: a card each while there are
    enough, else the cards round robin (shared)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_world(rank: int, world_size: int, init_method: str, device: str | torch.device | None = None, *,
               local_rank: int | None = None, local_world: int | None = None,
               timeout_s: int = WORLD_TIMEOUT_S) -> torch.device:
    """Join the world as ``rank`` (``init_method``: ``file://…``,
    ``tcp://host:port`` or ``env://``) on the backend :func:`choose_backend` gives, with
    the rank's device (``cuda`` by default, which raises without a card) set
    as current first → the rank's device."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world_size if local_world is None else local_world
    dev = rank_device(resolve_device(device), local_rank)
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shared = dev.type == "cuda" and backend == "gloo"
    log.info("rank %d/%d on %s: backend %s (%s)", rank, world_size, dev, backend,
             "ranks share a card" if shared else "a card each" if dev.type == "cuda" else "CPU")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **kwargs)
    return dev


# ---- the one-node launcher ------------------------------------------------ #


def _watch_parent(parent: int) -> None:
    """Exit when the launching process is gone: no rank outlives it."""
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(1)


def _rank_main(rank: int, world_size: int, init_method: str, device: str, parent: int, log_level: int,
               fn, args: tuple, results) -> None:
    from hhrs_tpu_torch.utils.logging import setup_logging

    setup_logging(log_level)
    # The launcher turns Ctrl-C into one SIGTERM to rank 0; the followers
    # stop when rank 0 tells them to.
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    try:
        init_world(rank, world_size, init_method, device)
        value = fn(*args)
        results.put((rank, "ok", value if rank == 0 else None))
    except BaseException:  # noqa: BLE001 — reported to the launcher, which raises it
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world_size: int, args: tuple = (), *, device: str | torch.device | None = None,
           timeout_s: float = 600.0, store_dir: str | None = None):
    """Run ``fn(*args)`` on every rank of a new world of ``world_size``
    processes on this node and return rank 0's value. ``fn`` must be
    importable (it is pickled by name); each rank joins the world and sets
    its device (``cuda`` by default, which raises without a card; the CPU
    only when asked) before calling it. ``store_dir`` holds the ``FileStore``
    (a temporary directory by default). SIGTERM or SIGINT to the caller is
    passed to rank 0 as one SIGTERM while the world runs."""
    import multiprocessing as mp

    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=False,
                             args=(r, world_size, init_method, str(device), os.getpid(),
                                   logging.getLogger().getEffectiveLevel(), fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        log.info("launched a world of %d ranks: pids %s", world_size, [p.pid for p in procs])
        restore = _forward_signals(procs[0])
        try:
            value = _collect(procs, results, timeout_s)
        except BaseException:
            _stop(procs, grace_s=0.0)  # the others may wait on the failed rank until their timeout
            raise
        finally:
            restore()
        _stop(procs)
        return value


def _forward_signals(leader):
    """Pass SIGTERM / SIGINT on to ``leader`` as SIGTERM (main thread only);
    returns what puts the old handlers back."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def forward(signum, frame):
        log.info("signal %d: stopping the world through rank 0", signum)
        if leader.is_alive():
            os.kill(leader.pid, signal.SIGTERM)

    old = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    return lambda: [signal.signal(s, h) for s, h in old.items()]


def _collect(procs: list, results, timeout_s: float):
    import queue

    deadline = time.monotonic() + timeout_s
    value, done = None, set()
    while len(done) < len(procs):
        try:
            rank, status, payload = results.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode not in (None, 0)]
            if dead:
                try:  # its report may still be in flight
                    rank, status, payload = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(f"rank {dead[0]} of the world exited with code "
                                       f"{procs[dead[0]].exitcode} without a report") from None
            elif time.monotonic() > deadline:
                raise TimeoutError(f"the world of {len(procs)} ranks did not finish within {timeout_s:.0f} s "
                                   f"(finished: {sorted(done)})")
            else:
                continue
        if status == "error":
            raise RuntimeError(f"rank {rank} of the world failed:\n{payload}")
        done.add(rank)
        if rank == 0:
            value = payload
    return value


def _stop(procs: list, grace_s: float = 10.0) -> None:
    """Join every rank; one still running after ``grace_s`` is terminated,
    then killed."""
    deadline = time.monotonic() + grace_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(2.0)
        if p.is_alive():
            p.kill()
            p.join(2.0)
