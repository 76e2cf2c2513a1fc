"""Mesh training: the PyTorch port's gloo worlds of CPU processes against the
JAX package's mesh trainer on ``tests/conftest.py``'s 8 virtual devices.

The problem is ``tests/test_parallel_full_run.py``'s exchange run (256
users, 64 items, 5,000 synthetic reviews, seed 3: both big tables divide
the model axis, so the exchanges engage; the 6-row city table is sharded
at m = 2 and replicated at m = 4, the 5-row one replicated at both), with a small DCN-R (emb 8, hidden
32, one residual block, two cross layers) from one JAX init, carried into
the port by ``models/convert.py``, batch 256 with the ragged tail wrapped,
3 epochs.

Each mesh shape (2x1, 1x2, 2x2) spawns one world
(``torch_port_mesh_train_world.py`` runs every check of that shape in it)
under a time limit of its own. The bars:

* the sharding rule equals ``param_shardings``'; x0 from the default,
  psum and all_to_all exchanges is the single-device gather bit for bit,
  their table gradients are JAX's at rtol 1e-5 / atol 1e-6; the capped
  exchange's x0 and ``(dropped, total)`` are JAX's exactly at factors 1.0,
  1.25 and m;
* sync BatchNorm's output, running statistics and gradients are those of
  one BatchNorm on the concatenated rows (rtol 1e-5 / atol 1e-6);
* a run at dropout 0 meets C1's bars against JAX's mesh ``train_dcn``
  (rtol 2e-3 / atol 2e-4 at epoch 0, 5e-3 after; LR traces equal; final
  logloss and AUC at 2e-3); a run at dropout 0.3 is the port's
  single-device run at rtol 1e-4 / atol 1e-6 (the masks are the same by
  construction);
* psum and all_to_all give the default's history, capped at factor m
  all_to_all's bit for bit, capped at 1.0 JAX's per-epoch overflow;
  ``mesh_resident_data`` is streaming bit for bit; a checkpointed run
  resumed is the uninterrupted one bit for bit; every rank's history is
  the same and the replicated weights are bit-identical on every rank;
* the mesh artifact loads in JAX and is a single-device export of the
  gathered state.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.config import TrainConfig as JaxTrainConfig
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import init_dcn
from hhrs_tpu.parallel import mesh as jax_mesh
from hhrs_tpu.parallel.embedding import explicit_x0 as jax_explicit_x0
from hhrs_tpu.parallel.embedding import pad_table as jax_pad_table
from hhrs_tpu.parallel.sharding import param_shardings as jax_param_shardings
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle
from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn
from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.data.synthetic import write_synthetic_dataset
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.ops.nn import BatchNorm
from hhrs_tpu_torch.parallel import distributed
from hhrs_tpu_torch.parallel.embedding import pad_table
from hhrs_tpu_torch.parallel.mesh import make_mesh
from hhrs_tpu_torch.parallel.sharding import param_shardings
from hhrs_tpu_torch.train import cli
from hhrs_tpu_torch.train.artifacts import export_artifacts
from hhrs_tpu_torch.train.eval_retrieval import catalog_recall_at_k
from hhrs_tpu_torch.train.trainer import train_dcn
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_port_train import jax_splits, port_splits
from tests.torch_port_mesh_train_world import mesh_train_checks, one_rank_world

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((2, 1), (1, 2), (2, 2))
WORLD_TIMEOUT_S = 300  # one world: every check of its shape
MCFG = dict(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=1, dropout=0.0)
TCFG = dict(batch_size=256, n_epochs=3, seed=7, drop_remainder=False, eval_batch_size=512, early_stop_patience=10)
DROPOUT = 0.3
FIRST_EPOCH_TOL = dict(rtol=2e-3, atol=2e-4)  # C1: tests/test_parity_train.py's bar
LATER_EPOCH_TOL = dict(rtol=5e-3, atol=2e-4)  # C1 after the first epoch (tests/test_torch_port_train.py)
MESH_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_parallel_full_run.py: a mesh run against one device
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
LOOKUP_B = 64
REVIEWS = "hackathon_augmented_data.csv"


def _shape_id(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("torch_port_mesh_train")
    data = tmp / "data"
    write_synthetic_dataset(str(data), n_users=256, n_items=64, n_reviews=5000, seed=3)
    splits, preproc = port_splits(str(data / REVIEWS))
    jsplits, jart = jax_splits(str(data / REVIEWS))
    jdims = JaxModelDims.from_artifacts(jart)
    dims = ModelDims(jdims.n_users, jdims.n_items, jdims.cat_dims, jdims.n_num_features)
    assert dims.n_users % 4 == 0 and dims.n_items % 4 == 0  # the exchanges engage at m = 2 and 4
    params, bn_state = jax.tree.map(np.asarray, init_dcn(jax.random.PRNGKey(11), jdims, JaxModelConfig(**MCFG)))
    rng = np.random.default_rng(5)
    cats = [n for _, n in dims.cat_dims]
    d_in = 2 * MCFG["emb_dim"] + sum(int(n ** 0.5) + 1 for n in cats) + dims.n_num_features
    lookup = {
        "user": rng.integers(0, dims.n_users, LOOKUP_B),
        "item": np.concatenate([np.zeros(LOOKUP_B // 2, np.int64), rng.integers(0, dims.n_items, LOOKUP_B // 2)]),
        "cat": np.stack([rng.integers(0, n, LOOKUP_B) for n in cats], 1),
        "num": rng.normal(size=(LOOKUP_B, dims.n_num_features)).astype(np.float32),
        "ct": rng.normal(size=(LOOKUP_B, d_in)).astype(np.float32),
    }
    bn = {"x": rng.normal(2.0, 3.0, size=(24, 12)).astype(np.float32),
          "ct": rng.normal(size=(24, 12)).astype(np.float32)}
    spec = {"splits": splits, "dims": dims, "preproc": preproc, "init": (params, bn_state), "mcfg": MCFG,
            "tcfg": TCFG, "dropout": DROPOUT, "lookup": lookup, "bn": bn, "tmp": str(tmp)}
    return types.SimpleNamespace(tmp=tmp, data=str(data), spec=spec, splits=splits, jsplits=jsplits, dims=dims,
                                 jdims=jdims, preproc=preproc)


@pytest.fixture(scope="module", params=SHAPES, ids=_shape_id)
def world(request, problem):
    shape = request.param
    spec = dict(problem.spec, shape=shape)
    out = distributed.launch(mesh_train_checks, shape[0] * shape[1], (spec,), device="cpu",
                             timeout_s=WORLD_TIMEOUT_S, store_dir=str(problem.tmp))
    assert out["shape"] == shape
    return shape, out


@pytest.fixture(scope="module")
def jax_runs(problem):
    """JAX's mesh train_dcn at every shape from the shared init: the default
    exchange, and capped at factor 1.0 where the model axis shards."""
    out = {}
    for shape in SHAPES:
        m = jax_mesh.make_mesh(*shape)
        run = lambda **kw: jax_train_dcn(problem.jsplits, problem.jdims, JaxModelConfig(**MCFG),  # noqa: E731
                                         JaxTrainConfig(**TCFG), mesh=m, init_state=problem.spec["init"], **kw)
        out[shape] = {"default": run()}
        if shape[1] > 1:
            out[shape]["capped_1"] = run(explicit_exchange="capped", exchange_capacity_factor=1.0)
    return out


@pytest.fixture(scope="module")
def single_dropout(problem):
    """The port's single-device run at dropout 0.3 (the mesh runs' reference)."""
    return train_dcn(problem.splits, problem.dims, ModelConfig(**dict(MCFG, dropout=DROPOUT)),
                     TrainConfig(**TCFG), init_state=problem.spec["init"], device="cpu")


OPTIONS = dict(debug_nans=True, eval_every=2, eval_catalog_recall=True, moment_dtype="bfloat16")
BF16_VAL_RTOL = 1e-2  # tests/test_torch_port_train.py's bf16 bar


@pytest.fixture(scope="module")
def single_options(problem):
    """The port's single-device runs with the per-rank options, and at bf16 compute."""
    run = lambda mcfg, tcfg: train_dcn(problem.splits, problem.dims, ModelConfig(**mcfg),  # noqa: E731
                                       TrainConfig(**tcfg), init_state=problem.spec["init"], device="cpu")
    return {"options": run(MCFG, {**TCFG, **OPTIONS}), "bf16": run(dict(MCFG, compute_dtype="bfloat16"), TCFG),
            "dims": problem.dims, "splits": problem.splits}


def _val(history) -> np.ndarray:
    return np.array([h["val_loss"] for h in history])


# ---- the layout and the exchanges ------------------------------------------ #


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_sharding_rule_matches_jax(problem, shape, eight_devices):
    params = problem.spec["init"][0]
    want = jax_param_shardings(params, jax_mesh.make_mesh(*shape), "model" if shape[1] > 1 else None)
    want = {k: ("model" if s.spec and s.spec[0] == "model" else None) for k, s in flatten_tree(want).items()}
    assert param_shardings(flatten_tree(params), shape[1]) == want
    tables = {"user_embedding": problem.dims.n_users, "item_embedding": problem.dims.n_items,
              **{f"cat_embeddings.{i}": n for i, (_, n) in enumerate(problem.dims.cat_dims)}}
    assert {k for k, v in want.items() if v} == {k for k, n in tables.items() if shape[1] > 1 and n % shape[1] == 0}


@pytest.mark.parametrize("rows", [64, 61])
def test_pad_table_matches_jax(rows):
    table = np.random.default_rng(rows).normal(size=(rows, 5)).astype(np.float32)
    for shards in (1, 2, 4):
        np.testing.assert_array_equal(pad_table(torch.as_tensor(table), shards).numpy(),
                                      np.asarray(jax_pad_table(jnp.asarray(table), shards)))


def _jax_exchange(problem, shape, kind, factor):
    """JAX's x0 and table gradients of ``sum(x0 · ct)`` through ``kind`` on
    its mesh of ``shape`` (the default: the plain gather), and the capped
    exchange's counts."""
    lk = problem.spec["lookup"]
    tables = {k: problem.spec["init"][0][k] for k in ("user_embedding", "item_embedding", "cat_embeddings")}
    mesh = jax_mesh.make_mesh(*shape)

    def loss(p):
        if kind == "default":
            x0 = jnp.concatenate([p["user_embedding"][lk["user"]], p["item_embedding"][lk["item"]],
                                  *(t[lk["cat"][:, i]] for i, t in enumerate(p["cat_embeddings"])), lk["num"]], 1)
            out = (x0, None)
        else:
            out = jax_explicit_x0(mesh, p, jnp.asarray(lk["user"], jnp.int32), jnp.asarray(lk["item"], jnp.int32),
                                  jnp.asarray(lk["cat"], jnp.int32), lk["num"], kind=kind,
                                  capacity_factor=factor or 1.25)
            out = out if kind == "capped" else (out, None)
        return jnp.sum(out[0] * lk["ct"]), out

    (_, (x0, overflow)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tables)
    return np.asarray(x0), flatten_tree(jax.tree.map(np.asarray, grads)), overflow


def _port_grads(got: dict) -> dict:
    return {("cat_embeddings." + k.split(".")[1]) if k.startswith("cat_embeddings") else k: v
            for k, v in got["grads"].items()}


@pytest.mark.parametrize("kind", ["default", "psum", "all_to_all"])
def test_exact_exchanges_are_the_gather_bit_for_bit(world, problem, kind, eight_devices):
    shape, out = world
    got = out["exchange"][(kind, None)]
    lk = problem.spec["lookup"]
    init = problem.spec["init"][0]
    gather = np.concatenate([init["user_embedding"][lk["user"]], init["item_embedding"][lk["item"]],
                             *(t[lk["cat"][:, i]] for i, t in enumerate(init["cat_embeddings"])), lk["num"]], 1)
    np.testing.assert_array_equal(got["x0"], gather)
    _, want, _ = _jax_exchange(problem, shape, kind, None)
    grads = _port_grads(got)
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("factor", ["1.0", "1.25", "m"])
def test_capped_exchange_matches_jax(world, problem, factor, eight_devices):
    shape, out = world
    f = float(shape[1]) if factor == "m" else float(factor)
    got = out["exchange"][("capped", f)]
    x0, grads, overflow = _jax_exchange(problem, shape, "capped", f)
    np.testing.assert_array_equal(got["x0"], x0)
    assert got["overflow"] == [int(v) for v in np.asarray(overflow)]
    if shape[1] > 1 and factor == "1.0":
        assert got["overflow"][0] > 0  # the half-zero item ids overflow their owner's bucket
    if factor == "m":
        assert got["overflow"][0] == 0
    for k, v in _port_grads(got).items():
        np.testing.assert_allclose(v, grads[k], err_msg=k, **GRAD_TOL)


def test_sync_batchnorm_matches_one_batchnorm(world, problem):
    _, out = world
    x = torch.as_tensor(problem.spec["bn"]["x"]).requires_grad_()
    bn = BatchNorm(x.shape[1], momentum=0.1).train()
    y = bn(x)
    (y * torch.as_tensor(problem.spec["bn"]["ct"])).sum().backward()
    got = out["bn"]
    for name, want in (("y", y), ("dx", x.grad), ("dscale", bn.scale.grad), ("dbias", bn.bias.grad),
                       ("mean", bn.mean), ("var", bn.var)):
        np.testing.assert_allclose(got[name], want.detach().numpy(), err_msg=name, rtol=1e-5, atol=1e-6)


# ---- full runs ------------------------------------------------------------- #


def test_mesh_run_meets_c1_against_jax_mesh(world, jax_runs):
    shape, out = world
    got, want = out["runs"]["default"], jax_runs[shape]["default"]
    g, w = _val(got["history"]), _val(want.history)
    assert len(g) == len(w) == TCFG["n_epochs"]
    np.testing.assert_allclose(g[:1], w[:1], **FIRST_EPOCH_TOL)
    np.testing.assert_allclose(g[1:], w[1:], **LATER_EPOCH_TOL)
    assert [h["lr"] for h in got["history"]] == [h["lr"] for h in want.history]
    for k in ("val_logloss", "val_auc"):
        assert got["final"][k] == pytest.approx(want.final_metrics[k], rel=2e-3, abs=2e-3)


def test_mesh_run_at_dropout_matches_single_device(world, single_dropout):
    _, out = world
    got = out["runs"]["dropout"]["history"]
    np.testing.assert_allclose(_val(got), _val(single_dropout.history), **MESH_TOL)
    assert [h["lr"] for h in got] == [h["lr"] for h in single_dropout.history]


def test_exchanges_match_the_default(world, jax_runs):
    shape, out = world
    runs = out["runs"]
    base = _val(runs["default"]["history"])
    np.testing.assert_array_equal(_val(runs["psum"]["history"]), base)  # the default is the psum form
    np.testing.assert_allclose(_val(runs["all_to_all"]["history"]), base, **MESH_TOL)
    assert runs["capped_m"]["history"] == [dict(h, exchange_overflow=0.0) for h in runs["all_to_all"]["history"]]
    got = [h["exchange_overflow"] for h in runs["capped_1"]["history"]]
    if shape[1] == 1:  # no table shards: nothing is exchanged, nothing dropped
        assert got == [0.0] * TCFG["n_epochs"]
    else:
        assert got == [h["exchange_overflow"] for h in jax_runs[shape]["capped_1"].history]


def test_per_rank_options_run_on_a_mesh(world, single_options):
    """bf16 moments, debug_nans, eval_every and the catalog recall on the
    gathered state, against one device; bf16 compute at the bf16 bar; a
    NaN in one rank's rows raises FloatingPointError on every rank."""
    _, out = world
    got, want = out["runs"]["options"], single_options["options"]
    assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want.history] == [1, 2]
    np.testing.assert_allclose(_val(got["history"]), _val(want.history), **MESH_TOL)
    # 64 items: recall@100 is NaN on both (the whole catalog); @10 on the gathered state within 0.01
    np.testing.assert_allclose(got["final"]["catalog_recall_at_100"], want.final_metrics["catalog_recall_at_100"],
                               atol=0.01, equal_nan=True)
    gathered = dcnr_from_jax(got["params"], got["bn_state"], single_options["dims"], ModelConfig(**MCFG))
    assert catalog_recall_at_k(gathered, single_options["splits"], k=10) == pytest.approx(
        catalog_recall_at_k(want.model, single_options["splits"], k=10), abs=0.01)
    got16, want16 = out["runs"]["bf16"], single_options["bf16"]
    np.testing.assert_allclose(_val(got16["history"]), _val(want16.history), rtol=BF16_VAL_RTOL)
    assert all(r["nan_raised"] for r in out["ranks"])


def test_mesh_resident_data_is_streaming_bit_for_bit(world):
    _, out = world
    a, b = out["runs"]["resident"], out["runs"]["default"]
    assert a["history"] == b["history"] and a["final"] == b["final"]
    for k, v in flatten_tree(b["params"]).items():
        np.testing.assert_array_equal(flatten_tree(a["params"])[k], v, err_msg=k)


def test_checkpoint_resume_is_bit_exact(world):
    _, out = world
    r, full = out["runs"]["resumed"], out["runs"]["default"]
    assert r["files"] == ["epoch_000000.pt", "epoch_000001.pt", "epoch_000002.pt"]
    assert r["first"] == full["history"][:1]
    assert r["history"] == full["history"] and r["final"] == full["final"]
    for k, v in flatten_tree(full["params"]).items():
        np.testing.assert_array_equal(flatten_tree(r["params"])[k], v, err_msg=k)


def test_every_rank_agrees(world):
    shape, out = world
    ranks = out["ranks"]
    assert len(ranks) == shape[0] * shape[1]
    for name in (n for n in ranks[0] if n != "nan_raised"):
        assert all(r[name]["history"] == ranks[0][name]["history"] for r in ranks), name
        assert all(r[name]["replicated"] == ranks[0][name]["replicated"] for r in ranks), name
    m = shape[1]
    tables = {"user_embedding": 256, "item_embedding": 64, "cat_embeddings.0": 6, "cat_embeddings.1": 5}
    want_shards = {k: n // m for k, n in tables.items() if m > 1 and n % m == 0}
    assert {k: v[0] for k, v in ranks[0]["default"]["shards"].items()} == want_shards


def test_mesh_artifact_is_the_gathered_single_device_export(world, problem):
    shape, out = world
    theirs = jax_load_bundle(out["artifact"])
    got = out["runs"]["default"]
    single = problem.tmp / f"single_{_shape_id(shape)}"
    export_artifacts(str(single), got["params"], got["bn_state"], ModelConfig(**MCFG), problem.dims,
                     problem.preproc, got["final"])
    for name in ("params.msgpack", "item_embeddings.npy", "preproc.json", "manifest.json"):
        assert (single / name).read_bytes() == (Path(out["artifact"]) / name).read_bytes(), name
    want = flatten_tree(got["params"])
    for k, v in flatten_tree(theirs.params).items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)
    assert theirs.item_embeddings.shape == (problem.dims.n_items, MCFG["emb_dim"])


# ---- refusals ---------------------------------------------------------------- #


class _Mesh:
    """A stand-in for a mesh of ``data × model`` ranks: the checks that read
    only its axis sizes run before any collective."""

    def __init__(self, data: int, model: int = 1):
        self.shape = (data, model)

    def size(self, dim: int) -> int:
        return self.shape[dim]


def _error(fn) -> str:
    with pytest.raises((ValueError, NotImplementedError)) as e:
        fn()
    return str(e.value)


def test_refusals_match_jax(problem, eight_devices):
    mcfg, jm = ModelConfig(**MCFG), JaxModelConfig(**MCFG)
    bad = dict(TCFG, batch_size=255, n_epochs=1)
    cases = [
        (lambda: train_dcn(problem.splits, problem.dims, mcfg, TrainConfig(**bad), mesh=_Mesh(2), device="cpu"),
         lambda: jax_train_dcn(problem.jsplits, problem.jdims, jm, JaxTrainConfig(**bad),
                               mesh=jax_mesh.make_mesh(2, 1))),
        (lambda: train_dcn(problem.splits, problem.dims, mcfg, TrainConfig(**TCFG), explicit_exchange="psum",
                           device="cpu"),
         lambda: jax_train_dcn(problem.jsplits, problem.jdims, jm, JaxTrainConfig(**TCFG), explicit_exchange="psum")),
        (lambda: train_dcn(problem.splits, problem.dims, mcfg, TrainConfig(**TCFG), mesh=_Mesh(2),
                           explicit_exchange="bogus", device="cpu"),
         lambda: jax_train_dcn(problem.jsplits, problem.jdims, jm, JaxTrainConfig(**TCFG),
                               mesh=jax_mesh.make_mesh(2, 1), explicit_exchange="bogus")),
    ]
    for ours, theirs in cases:
        assert _error(ours) == _error(theirs)


@pytest.mark.parametrize("option", [{"lazy_table_updates": True}, {"stream_slab_steps": 2}],
                         ids=["lazy_table_updates", "stream_slab_steps"])
def test_a11b2_options_are_refused_on_a_mesh(problem, option):
    """The options once refused on a mesh (ROADMAP A11b2) run there: on a
    1x1 mesh over a world of this process, bit for bit the single-device run
    with the same option (one epoch); the 2-rank meshes are
    ``tests/test_torch_port_mesh_lazy.py``'s."""
    tcfg = TrainConfig(**{**TCFG, **option, "n_epochs": 1})
    run = lambda mesh: train_dcn(problem.splits, problem.dims, ModelConfig(**MCFG), tcfg, mesh=mesh,  # noqa: E731
                                 init_state=problem.spec["init"], device="cpu")
    with one_rank_world(str(problem.tmp)):
        got = run(make_mesh(1, 1, "cpu"))
    want = run(None)
    assert got.history == want.history and got.final_metrics == want.final_metrics
    for k, v in flatten_tree(want.params).items():
        np.testing.assert_array_equal(flatten_tree(got.params)[k], v, err_msg=k)


# ---- the CLI ------------------------------------------------------------------- #

CLI_ARGS = ["--device", "cpu", "--epochs", "2", "model.emb_dim=8", "model.hidden_dim=32", "model.n_res_blocks=1",
            "model.n_cross_layers=2", "train.batch_size=256", "train.eval_batch_size=512"]


def _metrics(path: Path) -> list:
    """A metrics log's records without their wall-clock stamps."""
    return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def cli_mesh_run(problem):
    """``train.cli --mesh 2x1 --device cpu`` from this process: a world of 2."""
    out = problem.tmp / "cli_mesh"
    metrics, db = problem.tmp / "cli_mesh.jsonl", problem.tmp / "cli_mesh.db"
    rc = cli.main(["--data", problem.data, "--out", str(out), "--mesh", "2x1", "--metrics-log", str(metrics),
                   "--register-db", str(db), *CLI_ARGS])
    return rc, out, metrics, db


def test_cli_mesh_trains_and_writes_once(cli_mesh_run):
    from hhrs_tpu_torch.db.registry import ModelRegistry

    rc, out, metrics, db = cli_mesh_run
    assert rc == 0
    bundle = jax_load_bundle(str(out))
    assert bundle.model_cfg.hidden_dim == 32 and np.isfinite(bundle.metrics["val_logloss"])
    assert [r["epoch"] for r in _metrics(metrics)] == [0, 1]  # rank 0 alone logs
    assert len(ModelRegistry(str(db)).list()) == 1  # rank 0 alone registers


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("contract", ["jax", "torchrun"])
def test_two_distributed_ranks_give_the_cli_mesh_history(problem, cli_mesh_run, contract):
    """Two subprocesses under ``--distributed`` and the environment
    contract: the world they form trains the ``--mesh 2x1`` run's history."""
    port = _free_port()
    metrics = problem.tmp / f"distributed_{contract}.jsonl"
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = str(REPO)
    procs = []
    for rank in range(2):
        world = ({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "2", "PROCESS_ID": str(rank)}
                 if contract == "jax" else
                 {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hhrs_tpu_torch.train.cli", "--data", problem.data, "--out",
             str(problem.tmp / f"distributed_{contract}"), "--distributed", "--metrics-log", str(metrics),
             *CLI_ARGS], cwd=REPO, env={**env, **world}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for p in procs:
        try:
            log, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, log[-3000:]
    assert _metrics(metrics) == _metrics(cli_mesh_run[2])


def test_cli_mesh_without_a_card_raises(problem, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data", problem.data, "--out", str(problem.tmp / "nowhere"), "--mesh", "2x1"])
    assert not torch.distributed.is_initialized()

