"""What every rank of a CPU gloo world runs for ``tests/test_torch_port_mesh_reload.py``.

Kept apart from the test module, which imports JAX: each rank imports only
torch and the port. :func:`stack_checks` runs every check of the serving
stacks over a mesh in one world, so it is spawned once per module: rank 0
builds the CLI's stack (``serve/cli.py::build_stack``) with the canary, the
shadow and both hot-reload pollers and drives it; the other rank runs the
world's follower loop. At the end every rank reports what it freed, and
rank 0 returns the answers for the test module to compare with the JAX
package's.

Test hook: rank 1 fails every build of ``spec["poison"]`` (a valid copy of
an artifact, so rank 0's build of it succeeds).
"""

from __future__ import annotations

import shutil
from pathlib import Path

import torch
import torch.distributed as dist

from hhrs_tpu_torch.data.synthetic import append_reviews
from hhrs_tpu_torch.db.registry import ModelRegistry
from hhrs_tpu_torch.parallel.mesh import make_mesh
from hhrs_tpu_torch.serve import cli, lockstep, reload

DATA_FILES = reload.DATA_FILES


def _record_drops(drops: list) -> None:
    """Log every engine this rank frees: (engine id, world stopped yet)."""
    original = lockstep.World._drop

    def drop(self, engine_id):
        engine = original(self, engine_id)
        if engine is not None:
            drops.append((engine_id, self.stopped))
        return engine

    lockstep.World._drop = drop


def _poison_rank_one(poison: str, faults: list) -> None:
    """Rank 1 fails every build of ``poison`` (logging the engine id)."""
    if dist.get_rank() != 1:
        return
    original = lockstep.World.make_engine

    def make_engine(self, engine_id, payload, frames):
        if payload["artifacts_dir"] == poison:
            faults.append(engine_id)
            raise RuntimeError("an injected build fault on rank 1")
        return original(self, engine_id, payload, frames)

    lockstep.World.make_engine = make_engine


def stack_checks(spec: dict) -> dict | None:
    """Every check of the module on this world (rank 0's answers, None on
    the other ranks). ``spec``: the artifact dirs, the data dir (a copy this
    world may append to), the registry, the requests and the new user."""
    torch.set_num_threads(1)
    reload.OLD_STACK_CLOSE_GRACE_S = 0.2
    drops, faults = [], []
    _record_drops(drops)
    _poison_rank_one(spec["poison"], faults)
    mesh = make_mesh(-1, 1, "cpu")
    world = lockstep.world_of(mesh, "cpu")
    out = None
    if dist.get_rank() != 0:
        world.follow()
    else:
        out = {}
        try:
            out = _lead(world, mesh, spec)
        finally:
            world.shutdown()
    report = {"rank": dist.get_rank(), "drops": drops, "faults": faults, "ids_after_stop": world.engine_ids(),
              "counts": dict(world.counts)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, report)
    if dist.get_rank() == 0:
        out["ranks"] = every
        return out
    return None


def _lead(world, mesh, spec: dict) -> dict:
    out: dict = {}
    args = cli.build_parser().parse_args(
        ["--artifacts", f"registry:{spec['registry']}", "--data", spec["data"], "--device", "cpu",
         "--canary", spec["canary"], "--canary-fraction", "0.5", "--shadow", spec["shadow"],
         "--reload-poll-s", "3600", "--data-poll-s", "3600", "--batch-window-ms", "0"])
    stack = cli.build_stack(args, mesh=mesh)
    shadow = stack.engine  # shadow -> canary -> holder -> engine
    holder = stack.reloader.holder
    out["startup_ids"] = world.engine_ids()
    out["engine_ids"] = {"primary": holder.current._engine_id, "canary": shadow._primary._canary._engine_id,
                         "shadow": shadow._shadow._engine_id}

    # the canary and the shadow: one request at a time, the shadow drained after each
    answers = []
    for req in spec["requests"]:
        answers.append(shadow.recommend(*req))
        shadow.drain()
    out["canary"] = answers
    out["many"] = shadow.recommend_many([tuple(r) for r in spec["many"]])
    shadow.drain()
    out["canary_stats"] = shadow.canary_stats()
    out["shadow_stats"] = shadow.shadow_stats()

    # a registry swap: the old primary closes (CLOSE) after the grace
    old_primary = holder.current._engine_id
    ModelRegistry(spec["registry"]).register("v2", spec["second"])
    out["registry_swapped"] = stack.reloader.check_once()
    out["after_registry"] = [shadow.recommend(*r) for r in spec["requests"]]
    out["registry_engine"] = holder.current._engine_id
    _wait_closed(world, old_primary)
    out["closed_after_registry"] = old_primary
    out["ids_after_registry"] = world.engine_ids()

    # a data swap over the refreshed reviews, then a copy of the data it served
    append_reviews(spec["data"], spec["new_user"], n=3, rating=9)
    old_primary = holder.current._engine_id
    out["data_swapped"] = (stack.data_reloader.check_once(), stack.data_reloader.check_once())
    served = Path(spec["served_data"])
    served.mkdir(parents=True, exist_ok=True)
    for name in DATA_FILES:
        shutil.copy2(Path(spec["data"]) / name, served / name)
    out["new_user_known"] = spec["new_user"] in {int(u) for u in holder.gen.universe.user_ids}
    out["after_data"] = [shadow.recommend(*r) for r in spec["after_data"]]
    shadow.drain()
    _wait_closed(world, old_primary)
    out["closed_after_data"] = old_primary

    # a build that fails on rank 1 only: every rank keeps the old engine
    before = holder.current._engine_id
    ModelRegistry(spec["registry"]).register("poisoned", spec["poison"])
    out["poison_swapped"] = stack.reloader.check_once()
    out["poison_id"] = world._next_id - 1
    out["poison_kept"] = holder.current._engine_id == before
    out["ids_after_poison"] = world.engine_ids()
    out["after_poison"] = [shadow.recommend(*r) for r in spec["after_data"]]

    # a torn read: the live files change during the rebuild, which is discarded
    # and closed on every rank
    base = stack.data_reloader

    def build_then_write(adir, frames=None):
        engine = base.build(adir, frames)
        append_reviews(spec["data"], spec["new_user"] + 1, n=1)
        return engine

    torn = reload.DataReloader(holder, spec["data"], build_then_write, 3600, base.current_dir_fn,
                               swap_lock=base.swap_lock)
    append_reviews(spec["data"], spec["new_user"] + 2, n=1)
    first = world._next_id
    out["torn"] = (torn.check_once(), torn.check_once())
    out["torn_built"] = list(range(first, world._next_id))
    out["torn_kept"] = holder.current._engine_id == before
    out["ids_after_torn"] = world.engine_ids()
    out["after_torn"] = [shadow.recommend(*r) for r in spec["after_data"]]

    # closing an arm: its engine goes on every rank, and the world serves on
    canary_engine = shadow._primary._canary
    canary_engine.close()
    out["closed_canary"] = canary_engine._engine_id
    out["ids_after_canary_close"] = world.engine_ids()
    out["after_canary_close"] = [shadow.recommend(*r) for r in spec["after_data"]]
    out["stats_end"] = {"canary": shadow.canary_stats(), "shadow": shadow.shadow_stats()}
    for poller in (stack.reloader, stack.data_reloader):
        poller.stop()
    stack.engine.close()
    out["ids_after_stack_close"] = world.engine_ids()
    out["counts_before_stop"] = dict(world.counts)
    return out


def _wait_closed(world, engine_id: int, timeout_s: float = 20.0) -> None:
    import time

    deadline = time.monotonic() + timeout_s
    while engine_id in world.engine_ids():
        if time.monotonic() > deadline:
            raise TimeoutError(f"engine {engine_id} was not closed within {timeout_s} s of its swap")
        time.sleep(0.05)
