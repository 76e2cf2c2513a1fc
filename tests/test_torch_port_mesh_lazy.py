"""Lazy table updates and slab streaming over a training mesh: the PyTorch
port's gloo worlds of CPU processes against the port's single-device runs
and the JAX package's mesh trainer on ``tests/conftest.py``'s 8 virtual
devices.

The problem is ``tests/test_torch_port_mesh_train.py``'s (256 users, 64
items, 5,000 synthetic reviews: both big tables shard at m = 2; a small
DCN-R from one JAX init; batch 256, the ragged tail wrapped; 3 epochs).
Each mesh shape (2x1, 1x2, 2x2) spawns one world
(``torch_port_mesh_lazy_world.py`` runs every check of that shape in it)
under a time limit of its own. The bars:

* lazy at dropout 0 against JAX's mesh lazy ``train_dcn``: C1's (rtol 2e-3
  / atol 2e-4 at epoch 0, 5e-3 after; LR traces equal; final logloss and
  AUC at 2e-3);
* lazy against the port's single-device lazy run, at dropout 0 and 0.3:
  bit for bit where the data axis has one rank (1x2: a psum of a row and
  zeros is exact, the tower is the single device's), else the final val
  logloss within rel 1e-3 (``tests/test_lazy.py:217``'s bar) and every
  epoch's val loss too; the gathered lazy checkpoint has the single-device
  lazy checkpoint's keys, shapes and dtypes (bit for bit at 1x2), and a run
  resumed from it is the uninterrupted one bit for bit; a model rank never
  writes a table row outside its shard; an explicit ``all_to_all``,
  ``capped`` or ``psum`` exchange with lazy raises JAX's ``ValueError``,
  word for word;
* slabs (``stream_slab_steps=3``) are the port's streamed mesh run bit for
  bit (with ``mesh_resident_data`` too); against the port's single-device
  resident run at ``tests/test_stream_slabs.py:76``'s bar (rtol 1e-4 / atol
  1e-6, LR traces equal, tables sharded); against that JAX test's run
  (JAX's slabs on its mesh of the same shape) at C1's bars, the port's
  bar against the JAX trainer;
* every rank's histories are equal and its replicated weights bit-identical.
"""

from __future__ import annotations

import numpy as np
import pytest

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.config import TrainConfig as JaxTrainConfig
from hhrs_tpu.parallel import mesh as jax_mesh
from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn
from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.models.convert import flatten_tree
from hhrs_tpu_torch.parallel import distributed
from hhrs_tpu_torch.train.trainer import train_dcn
from tests.test_torch_port_mesh_train import (DROPOUT, FIRST_EPOCH_TOL, LATER_EPOCH_TOL, MCFG, MESH_TOL, SHAPES,
                                              TCFG, _Mesh, _error, _shape_id, _val, problem)  # noqa: F401
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture
from tests.torch_port_mesh_lazy_world import checkpoint_arrays, mesh_lazy_checks

WORLD_TIMEOUT_S = 300  # one world: every check of its shape
LAZY_REL = 1e-3  # tests/test_lazy.py:217: a mesh lazy run against one device
LAZY = {"lazy_table_updates": True}


@pytest.fixture(scope="module", params=SHAPES, ids=_shape_id)
def world(request, problem):
    shape = request.param
    spec = dict(problem.spec, shape=shape)
    out = distributed.launch(mesh_lazy_checks, shape[0] * shape[1], (spec,), device="cpu",
                             timeout_s=WORLD_TIMEOUT_S, store_dir=str(problem.tmp))
    assert out["shape"] == shape
    return shape, out


@pytest.fixture(scope="module")
def single(problem):
    """The port's single-device runs: lazy at dropout 0 and 0.3, its 1-epoch
    checkpoint, and the resident (dense) run at dropout 0."""
    def run(changes, dropout=0.0, **kw):
        return train_dcn(problem.splits, problem.dims, ModelConfig(**dict(MCFG, dropout=dropout)),
                         TrainConfig(**{**TCFG, **changes}), init_state=problem.spec["init"], device="cpu", **kw)

    ck = str(problem.tmp / "single_lazy_ck")
    run({**LAZY, "n_epochs": 1}, checkpoint_dir=ck)
    return {"lazy": run(LAZY), "lazy_dropout": run(LAZY, DROPOUT), "resident": run({}),
            "checkpoint": checkpoint_arrays(ck, 0)}


@pytest.fixture(scope="module")
def jax_runs(problem):
    """JAX's mesh train_dcn at every shape from the shared init: lazy, and
    slab-streamed (``tests/test_stream_slabs.py:76``'s run)."""
    out = {}
    for shape in SHAPES:
        m = jax_mesh.make_mesh(*shape)
        run = lambda **kw: jax_train_dcn(problem.jsplits, problem.jdims, JaxModelConfig(**MCFG),  # noqa: E731
                                         JaxTrainConfig(**{**TCFG, **kw}), mesh=m, init_state=problem.spec["init"])
        out[shape] = {"lazy": run(**LAZY), "slabs": run(stream_slab_steps=3)}
    return out


def _same(got: dict, want) -> None:
    """A world's run equals a ``TrainResult`` (or another world run) bit for bit."""
    if isinstance(want, dict):
        wh, wf, wp = want["history"], want["final"], want["params"]
    else:
        wh, wf, wp = want.history, want.final_metrics, flatten_tree(want.params)
    assert got["history"] == wh and got["final"] == wf
    assert got["params"].keys() == wp.keys()
    for k, v in wp.items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def _c1(got: list, want: list) -> None:
    g, w = _val(got), _val(want)
    assert len(g) == len(w) == TCFG["n_epochs"]
    np.testing.assert_allclose(g[:1], w[:1], **FIRST_EPOCH_TOL)
    np.testing.assert_allclose(g[1:], w[1:], **LATER_EPOCH_TOL)
    assert [h["lr"] for h in got] == [h["lr"] for h in want]


# ---- lazy table updates ------------------------------------------------------ #


def test_lazy_mesh_meets_c1_against_jax(world, jax_runs, eight_devices):
    shape, out = world
    got, want = out["lazy"], jax_runs[shape]["lazy"]
    _c1(got["history"], want.history)
    for k in ("val_logloss", "val_auc"):
        assert got["final"][k] == pytest.approx(want.final_metrics[k], rel=2e-3, abs=2e-3)


@pytest.mark.parametrize("run", ["lazy", "lazy_dropout"])
def test_lazy_mesh_against_single_device(world, single, run):
    shape, out = world
    got, want = out[run], single[run]
    if shape[0] == 1:  # no data axis: bit for bit
        _same(got, want)
        return
    np.testing.assert_allclose(_val(got["history"]), _val(want.history), rtol=LAZY_REL)
    assert got["final"]["val_logloss"] == pytest.approx(want.final_metrics["val_logloss"], rel=LAZY_REL)
    assert [h["lr"] for h in got["history"]] == [h["lr"] for h in want.history]


def test_lazy_checkpoint_is_the_single_device_one_and_resumes(world, single):
    shape, out = world
    got, want = out["checkpoint"], single["checkpoint"]
    assert got.keys() == want.keys()
    assert any(k.startswith("optimizer.m.") for k in want) and "optimizer.count" in want
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
        if shape[0] == 1:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    r = out["resumed"]
    assert r["first"] == out["lazy"]["history"][:1]
    _same(r, out["lazy"])


def test_a_model_rank_writes_only_its_shard(world):
    """One lazy step on a batch whose ids all lie in model shard 0: the
    ranks of model coordinate 1 change no row and no moment of their
    shards; those of coordinate 0 change theirs."""
    shape, out = world
    steps = [r["shard_step"] for r in out["ranks"]]
    assert all(s["rows"] == TCFG["batch_size"] for s in steps)
    if shape[1] == 1:
        assert all(not s["changed"] for s in steps)  # nothing sharded
        return
    for s in steps:
        touched = s["model_rank"] == 0
        assert "user_embedding" in s["changed"] and "item_embedding" in s["changed"]
        assert all(v == touched for v in s["changed"].values()), s
        assert all(v == touched for v in s["moments"].values()), s


@pytest.mark.parametrize("kind", ["all_to_all", "capped", "psum"])
def test_lazy_refuses_an_explicit_exchange_as_jax(problem, kind, eight_devices):
    tcfg = {**TCFG, **LAZY, "n_epochs": 1}
    ours = _error(lambda: train_dcn(problem.splits, problem.dims, ModelConfig(**MCFG), TrainConfig(**tcfg),
                                    mesh=_Mesh(2, 2), explicit_exchange=kind, device="cpu"))
    theirs = _error(lambda: jax_train_dcn(problem.jsplits, problem.jdims, JaxModelConfig(**MCFG),
                                          JaxTrainConfig(**tcfg), mesh=jax_mesh.make_mesh(2, 2),
                                          explicit_exchange=kind))
    assert ours == theirs and "mutually exclusive" in ours


# ---- slab streaming ---------------------------------------------------------- #


def test_mesh_slabs_are_the_streamed_run_bit_for_bit(world):
    _, out = world
    _same(out["slabs"], out["stream"])
    _same(out["slabs_resident"], out["slabs"])  # slabs win over mesh_resident_data, as in JAX


def test_mesh_slabs_against_one_device_and_jax(world, single, jax_runs, eight_devices):
    shape, out = world
    got = out["slabs"]["history"]
    want = single["resident"]
    np.testing.assert_allclose(_val(got), _val(want.history), **MESH_TOL)
    assert [h["lr"] for h in got] == [h["lr"] for h in want.history]
    shards = out["ranks"][0]["slabs"]["shards"]
    if shape[1] > 1:  # tables really sharded: no replicate-everything fallback
        assert shards["user_embedding"][0] == problem_rows(want, "user_embedding") // shape[1]
    else:
        assert shards == {}
    _c1(got, jax_runs[shape]["slabs"].history)


def problem_rows(result, name: str) -> int:
    return flatten_tree(result.params)[name].shape[0]


def test_every_rank_agrees(world):
    shape, out = world
    ranks = out["ranks"]
    assert len(ranks) == shape[0] * shape[1]
    for name in (n for n in ranks[0] if n != "shard_step"):
        assert all(r[name]["history"] == ranks[0][name]["history"] for r in ranks), name
        assert all(r[name]["replicated"] == ranks[0][name]["replicated"] for r in ranks), name

