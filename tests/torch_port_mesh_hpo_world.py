"""What every rank of a CPU gloo world runs for ``tests/test_torch_port_mesh_hpo.py``.

Kept apart from the test module, which imports JAX: each rank imports only
torch and the port. :func:`sharded_group_checks` runs the lane-sharded
groups, :func:`hpo_cli_rank` the HPO CLI as one rank of a world; rank 0
returns every rank's answers.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.hpo import cli as hpo_cli
from hhrs_tpu_torch.hpo.vectorized import run_group
from hhrs_tpu_torch.models.convert import flatten_tree
from hhrs_tpu_torch.train import trainer


def group_summary(results: list) -> list:
    """What a group's results hold, as plain values (bitwise comparable)."""
    return [{"history": r.history, "best_epoch": r.best_epoch, "best_val_loss": r.best_val_loss,
             "pruned": r.pruned, "final": r.final_metrics,
             "params": None if r.params is None else flatten_tree({"p": r.params, "s": r.bn_state})}
            for r in results]


def reclaiming(refills: list, prune_lane: int):
    """``(report_fns, refill_fn)`` of a reclaiming group: the trial of lane
    ``prune_lane`` prunes after epoch 0, refills come from ``refills`` in
    order (None when they run out)."""
    left = list(refills)

    def report(k):
        return lambda epoch, val_loss: k == prune_lane

    def refill_fn():
        return (left.pop(0), None) if left else None

    return report, refill_fn


def run_groups(spec: dict, shard: bool) -> dict:
    """The spec's groups, sharded over the world or not → their summaries."""
    out = {}
    for name, g in spec["groups"].items():
        report, refill_fn = reclaiming(g["refills"], g["prune_lane"]) if g["refills"] else (None, None)
        results = run_group(spec["splits"], spec["dims"], ModelConfig(**g["mcfg"]), TrainConfig(**g["tcfg"]),
                            g["trials"], report_fns=None if report is None else [report(k) for k in range(
                                len(g["trials"]))], refill_fn=refill_fn, shard_lanes=shard,
                            init_state=g.get("init"), device="cpu")
        out[name] = group_summary(results)
    return out


def sharded_group_checks(spec: dict) -> dict | None:
    """Every sharded group of the spec on this world, and a group whose size
    is not a multiple of the world's; rank 0 → every rank's answers."""
    torch.set_num_threads(1)
    mine = run_groups(spec, shard=True)
    g = next(iter(spec["groups"].values()))
    try:
        run_group(spec["splits"], spec["dims"], ModelConfig(**g["mcfg"]), TrainConfig(**g["tcfg"]),
                  g["trials"][:3], shard_lanes=True, device="cpu")
        mine["indivisible"] = None
    except ValueError as e:
        mine["indivisible"] = str(e)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every if dist.get_rank() == 0 else None


def arch_of(mcfg) -> tuple:
    return (mcfg.emb_dim, mcfg.hidden_dim, mcfg.n_cross_layers, mcfg.n_res_blocks)


def hpo_cli_rank(argv: list, inits: dict | None = None) -> list | None:
    """``hpo/cli.py::main(argv)`` as one rank of this world → on rank 0,
    every rank's exit code and study trials. With ``inits`` (``{arch_of:
    (params, bn_state)}``, JAX's initializations) every trial starts from
    its architecture's and trains at dropout 0, so its values can meet the
    JAX study's."""
    torch.set_num_threads(1)
    studies = []
    create = hpo_cli.create_study

    def keep(*args, **kwargs):
        studies.append(create(*args, **kwargs))
        return studies[-1]

    hpo_cli.create_study = keep
    if inits is not None:
        sampled, train = hpo_cli.model_cfg_from_params, trainer.train_dcn
        hpo_cli.model_cfg_from_params = lambda params, base=None: dataclasses.replace(sampled(params, base),
                                                                                      dropout=0.0)
        trainer.train_dcn = lambda splits, dims, mcfg, tcfg, **kw: train(splits, dims, mcfg, tcfg,
                                                                         init_state=inits[arch_of(mcfg)], **kw)
    rc = hpo_cli.main(argv)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"rc": rc, "trials": studies[0].trials})
    return every if dist.get_rank() == 0 else None
