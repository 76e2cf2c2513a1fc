"""Tuning over a mesh: the port's lane-sharded groups
(``run_group(shard_lanes=True)``) and ``hpo.cli --mesh`` / ``--vectorize-shard``
in gloo worlds of CPU processes, against the port's unsharded group and
study and the JAX package's sharded group and mesh study on
``tests/conftest.py``'s 8 virtual devices.

The data and architecture are ``tests/test_torch_port_hpo.py``'s (200
users, 80 items, 3,000 synthetic reviews; emb 8, hidden 32, 2 cross
layers, one residual block, batch 64). Each world size (2, 4) spawns one
world (``torch_port_mesh_hpo_world.py``) under a time limit of its own. The
bars:

* each lane of a sharded group of K = 8 (dropout on, one lane at rate 0,
  a lane pruned after epoch 0 and reclaimed twice) is the unsharded group's
  lane bit for bit: history, best epoch, final metrics and weights (every
  per-lane sum of ``hpo/vectorized.py`` is independent of K: the head's
  gradients, each lane's loss, the train loss summed in step order);
  every rank returns the same results; the head's backward
  (``LaneHead``) is autograd's of the batched product in float64;
* the sharded group at dropout 0 from JAX's initialization against JAX's
  ``shard_lanes`` group (``tests/test_hpo_vectorized.py:158``'s run): LR
  equal, best epoch equal, AUC abs 2e-3, as that test holds them; each val
  loss and the final logloss within C1's trajectory bar (rtol 2e-3 / atol
  2e-4 at epoch 0, 5e-3 after: ``tests/test_torch_port_hpo.py``'s bar for
  the port's unsharded group against JAX's) plus JAX's own gap between its
  sharded and unsharded groups on that lane and epoch, measured in the
  test. JAX's test holds that gap to rel 1e-3 on its data; on this data it
  reaches rel 2.0e-3 (lane 6, epoch 0), so the port's sharded group, which
  is its unsharded one bit for bit, cannot meet rel 1e-3 against JAX's
  sharded one; a group of 3 on the world raises JAX's ``ValueError``
  (":183", the count being the world's);
* ``hpo.cli --mesh 2x1``, 3 trials of 2 epochs: proposals bit for bit the
  JAX study's (``hpo.cli --mesh 2x1``), values (each trial at dropout 0 from
  JAX's initialization of its architecture, in both studies) at C1's bars
  (rtol 5e-3 / atol 2e-4, the later-epoch bar), one journal of 3 records,
  every rank's study the same;
* ``hpo.cli --vectorize 4 --vectorize-shard`` on 2 ranks: the journal of
  ``--vectorize 4`` in this process, values bit for bit, its ragged last
  round of 3 run unsharded.
"""

from __future__ import annotations

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.config import TrainConfig as JaxTrainConfig
from hhrs_tpu.hpo import cli as jax_hpo_cli
from hhrs_tpu.hpo.vectorized import run_group as jax_run_group
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import init_dcn
from hhrs_tpu_torch.hpo import cli as hpo_cli
from hhrs_tpu_torch.hpo.vectorized import LaneHead
from hhrs_tpu_torch.parallel import distributed
from tests.test_torch_port_hpo import TRAJECTORY, _cfgs, _trial, data_dir, port_data  # noqa: F401 — fixtures
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_port_train import REVIEWS, jax_splits, port_dims, port_splits
from tests.torch_port_mesh_hpo_world import arch_of, hpo_cli_rank, run_groups, sharded_group_checks

WORLDS = (2, 4)
WORLD_TIMEOUT_S = 300
C1_LATER = dict(rel=5e-3, abs=2e-4)
CLI = ["--device", "cpu", "train.eval_batch_size=512"]


@pytest.fixture(scope="module")
def problem(data_dir):
    csv = os.path.join(data_dir, REVIEWS)
    jsplits, art = jax_splits(csv)
    jdims = JaxModelDims.from_artifacts(art)
    splits, _ = port_splits(csv)
    masks = [_trial(1e-3 * 1.4 ** i, 1e-5, 0.0 if i == 3 else 0.1 + 0.05 * i) for i in range(8)]
    refills = [_trial(2e-3, 1e-4, 0.25), _trial(4e-3, 1e-5, 0.15)]
    zero = [_trial(1e-3 * 1.4 ** i, 1e-5 * (i + 1), 0.0, patience=i % 2) for i in range(8)]
    mkw, tkw = _cfgs(masks[0], n_epochs=3)
    zkw, ztkw = _cfgs(zero[0], n_epochs=3, seed=3)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(3))
    init = jax.tree.map(np.asarray, init_dcn(init_rng, jdims, JaxModelConfig(**zkw)))
    groups = {"masks": {"trials": masks, "mcfg": mkw, "tcfg": tkw, "refills": refills, "prune_lane": 1},
              "dropout0": {"trials": zero, "mcfg": zkw, "tcfg": ztkw, "refills": [], "prune_lane": None,
                           "init": init}}
    return {"splits": splits, "dims": port_dims(jdims), "groups": groups, "jsplits": jsplits, "jdims": jdims}


@pytest.fixture(scope="module")
def unsharded(problem):
    return run_groups(problem, shard=False)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}_ranks")
def world(request, problem, tmp_path_factory):
    n = request.param
    spec = {k: problem[k] for k in ("splits", "dims", "groups")}
    ranks = distributed.launch(sharded_group_checks, n, (spec,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                               store_dir=str(tmp_path_factory.mktemp("mesh_hpo")))
    assert len(ranks) == n
    return n, ranks


@pytest.mark.parametrize("K", [1, 4, 8])
def test_lane_head_backward_is_autograds(K):
    gen = torch.Generator().manual_seed(K)
    x, k, b = (torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
               for shape in ((K, 64, 33), (K, 33, 1), (K, 1)))
    dy = torch.randn(K, 64, 1, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(LaneHead.apply(x, k, b), (x, k, b), dy)
    want = torch.autograd.grad(torch.bmm(x, k) + b[:, None, :], (x, k, b), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(LaneHead.apply(x, k, b).detach().numpy(), (torch.bmm(x, k) + b[:, None, :])
                                  .detach().numpy())


@pytest.mark.parametrize("group", ["masks", "dropout0"])
def test_sharded_group_is_the_unsharded_group_bit_for_bit(world, unsharded, group):
    _, ranks = world
    got, want = ranks[0][group], unsharded[group]
    assert len(got) == len(want) == (10 if group == "masks" else 8)  # 8 lanes, 2 refills
    for k, (g, w) in enumerate(zip(got, want)):
        assert {n: g[n] for n in g if n != "params"} == {n: w[n] for n in w if n != "params"}, k
        assert (g["params"] is None) == (w["params"] is None), k
        for name, v in (w["params"] or {}).items():
            np.testing.assert_array_equal(g["params"][name], v, err_msg=f"lane {k} {name}")


def test_reclaimed_lanes_agree_on_every_rank(world):
    _, ranks = world
    for name in ("masks", "dropout0"):
        for r in ranks[1:]:
            assert [{k: v for k, v in x.items() if k != "params"} for x in r[name]] == \
                [{k: v for k, v in x.items() if k != "params"} for x in ranks[0][name]], name
    lanes = ranks[0]["masks"]
    assert lanes[1]["pruned"] and len(lanes[1]["history"]) == 1  # lane 1 pruned after epoch 0, then reclaimed
    assert [len(x["history"]) for x in lanes[8:]] == [3, 3]  # the two refills ran their whole budget


def test_sharded_group_meets_jax_shard_lanes_bars(world, problem, eight_devices):
    _, ranks = world
    g = problem["groups"]["dropout0"]
    run = lambda shard: jax_run_group(problem["jsplits"], problem["jdims"], JaxModelConfig(**g["mcfg"]),  # noqa
                                      JaxTrainConfig(**g["tcfg"]), g["trials"], shard_lanes=shard)
    want, whole = run(True), run(False)
    for s, b, u in zip(ranks[0]["dropout0"], want, whole):
        assert len(s["history"]) == len(b.history)
        for hs, hb, hu, bar in zip(s["history"], b.history, u.history, TRAJECTORY):
            own = abs(hb["val_loss"] - hu["val_loss"])  # JAX's sharded against its unsharded group
            assert abs(hs["val_loss"] - hb["val_loss"]) <= bar["abs"] + bar["rel"] * abs(hb["val_loss"]) + own
            assert hs["lr"] == pytest.approx(hb["lr"])
        assert s["best_epoch"] == b.best_epoch
        own = abs(b.final_metrics["val_logloss"] - u.final_metrics["val_logloss"])
        bar = TRAJECTORY[-1]
        assert abs(s["final"]["val_logloss"] - b.final_metrics["val_logloss"]) <= (
            bar["abs"] + bar["rel"] * b.final_metrics["val_logloss"] + own)
        assert s["final"]["val_auc"] == pytest.approx(b.final_metrics["val_auc"], abs=2e-3)


def test_indivisible_group_raises_as_jax(world, problem, eight_devices):
    n, ranks = world
    g = problem["groups"]["dropout0"]
    with pytest.raises(ValueError, match="multiple of the device count") as e:
        jax_run_group(problem["jsplits"], problem["jdims"], JaxModelConfig(**g["mcfg"]),
                      JaxTrainConfig(**g["tcfg"]), g["trials"][:3], shard_lanes=True)
    theirs = re.sub(r"count \d+", f"count {n}", str(e.value))
    assert all(r["indivisible"] == theirs for r in ranks)


# ---- the CLI -------------------------------------------------------------------


def _records(path) -> list:
    """A journal's records without the timings in their user attributes."""
    recs = [json.loads(line) for line in open(path).read().splitlines()]
    for r in recs:
        for k in ("examples_per_s", "group_examples_per_s"):
            r["user_attrs"].pop(k, None)
    return recs


@pytest.fixture(scope="module")
def jax_mesh_study(data_dir, tmp_path_factory):
    """JAX's ``hpo.cli --mesh 2x1``: 3 trials of 2 epochs, every trial at
    dropout 0 → (the journal's records, JAX's initialization of each
    trial's architecture)."""
    tmp = tmp_path_factory.mktemp("jax_mesh_study")
    sampled = jax_hpo_cli.model_cfg_from_params
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_hpo_cli, "model_cfg_from_params", lambda p, base=None: JaxModelConfig(
        **{**vars(sampled(p, base)), "dropout": 0.0}))
    try:
        assert jax_hpo_cli.main(["--data", data_dir, "--trials", "3", "--epochs", "2", "--journal",
                                 str(tmp / "j.jsonl"), "--out", str(tmp / "best"), "--mesh", "2x1",
                                 "train.eval_batch_size=512"]) == 0
    finally:
        mp.undo()
    records = _records(tmp / "j.jsonl")
    _, art = jax_splits(os.path.join(data_dir, REVIEWS))
    jdims = JaxModelDims.from_artifacts(art)
    inits = {}
    for r in records:
        mcfg = JaxModelConfig(**{**vars(sampled(r["params"])), "dropout": 0.0})
        init_rng, _ = jax.random.split(jax.random.PRNGKey(JaxTrainConfig().seed))
        inits[arch_of(mcfg)] = jax.tree.map(np.asarray, init_dcn(init_rng, jdims, mcfg))
    return records, inits


def test_cli_mesh_study_meets_jax(data_dir, jax_mesh_study, tmp_path, eight_devices):
    want, inits = jax_mesh_study
    journal = tmp_path / "j.jsonl"
    argv = ["--data", data_dir, "--trials", "3", "--epochs", "2", "--journal", str(journal), "--out",
            str(tmp_path / "best"), "--mesh", "2x1", *CLI]
    ranks = distributed.launch(hpo_cli_rank, 2, (argv, inits), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                               store_dir=str(tmp_path))
    got = _records(journal)  # rank 0 alone wrote it
    assert [r["number"] for r in got] == [0, 1, 2] and all(r["rc"] == 0 for r in ranks)
    assert [r["params"] for r in got] == [r["params"] for r in want]  # proposals bit for bit
    for g, w in zip(got, want):
        assert g["state"] == w["state"] == "complete"
        assert g["value"] == pytest.approx(w["value"], **C1_LATER)
    studies = [[{k: v for k, v in t.items() if k != "user_attrs"} for t in r["trials"]] for r in ranks]
    assert all(s == studies[0] for s in studies)  # every rank's study agrees
    assert [t["value"] for t in ranks[0]["trials"]] == [r["value"] for r in got]
    assert (tmp_path / "best" / "manifest.json").exists()


def test_cli_vectorize_shard_on_two_ranks_is_the_unsharded_study(data_dir, tmp_path, caplog):
    base = ["--data", data_dir, "--trials", "7", "--epochs", "2", "--vectorize", "4", *CLI]
    assert hpo_cli.main([*base, "--journal", str(tmp_path / "u.jsonl"), "--out", str(tmp_path / "u")]) == 0
    argv = [*base, "--vectorize-shard", "--journal", str(tmp_path / "s.jsonl"), "--out", str(tmp_path / "s")]
    ranks = distributed.launch(hpo_cli_rank, 2, (argv,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                               store_dir=str(tmp_path))
    assert all(r["rc"] == 0 for r in ranks)
    want = _records(tmp_path / "u.jsonl")
    assert len(want) == 7 and _records(tmp_path / "s.jsonl") == want
    assert all([t["value"] for t in r["trials"]] == [w["value"] for w in want] for r in ranks)
