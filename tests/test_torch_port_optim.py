"""The trainer's optimizer options against hhrs_tpu's (on the CPU):
``train.moment_dtype=bfloat16`` (Adam's first moment stored in bf16, with
optax's ``mu_dtype`` semantics) and ``train.lazy_table_updates``
(``train/lazy.py``: touched-row table updates).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.config import TrainConfig as JaxTrainConfig
from hhrs_tpu.data.synthetic import write_synthetic_dataset
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import init_dcn
from hhrs_tpu.train.lazy import init_lazy_opt, make_lazy_update
from hhrs_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn
from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree, jax_from_dcnr
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.train.lazy import LazyTableOptimizer, dense_parameters, unique_segments
from hhrs_tpu_torch.train.optimizers import AdamBf16Moment, make_optimizer
from hhrs_tpu_torch.train.trainer import make_train_optimizer, train_dcn, train_step
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_port_train import (LATER_EPOCH_TOL, PRE_BN_BIAS, VAL_TOL, jax_splits, np_tree, port_dims,
                                         port_splits)

BF16_ULP = 2.0 ** -7  # bf16's spacing relative to a value's leading power of two
DIMS = ModelDims(n_users=8, n_items=6, cat_dims=(("c", 3),), n_num_features=5)
JDIMS = JaxModelDims(n_users=8, n_items=6, cat_dims=(("c", 3),), n_num_features=5)
SMALL = dict(emb_dim=4, hidden_dim=16, n_cross_layers=2, n_res_blocks=1, dropout=0.0)
REVIEWS = "hackathon_augmented_data.csv"


def _batch(full_coverage: bool, B: int = 24, seed: int = 0) -> dict:
    """tests/test_lazy.py's batches: every row of every table (duplicates
    too), or rows {0, 1} / {0} / {0} only."""
    rng = np.random.default_rng(seed)
    if full_coverage:
        user = np.concatenate([np.arange(8), rng.integers(0, 8, B - 8)])
        item = np.concatenate([np.arange(6), rng.integers(0, 6, B - 6)])
        cat = np.concatenate([np.arange(3), rng.integers(0, 3, B - 3)])
    else:
        user, item, cat = rng.integers(0, 2, B), np.zeros(B, np.int64), np.zeros(B, np.int64)
    return {"user": user.astype(np.int32), "item": item.astype(np.int32), "cat": cat.astype(np.int32)[:, None],
            "num": rng.normal(size=(B, 5)).astype(np.float32), "y": rng.integers(0, 2, B).astype(np.float32)}


def _torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int32 else torch.float32) for k, v in b.items()}


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_bf16_first_moment_is_within_one_ulp_of_optax(optimizer):
    """One step from the same weights and gradients: the stored first
    moment within one bf16 ulp of optax's (mu_dtype=bfloat16), the second
    moment and the parameters at f32 rounding; then 5 steps, the moments
    stay bf16 / f32 and the parameters track optax's."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 8)).astype(np.float32)
    grads = [rng.standard_normal((64, 8)).astype(np.float32) for _ in range(5)]
    tx = jax_make_optimizer(optimizer, 1e-2, 0.1, moment_dtype="bfloat16")
    jstate, pj = tx.init(jnp.asarray(p0)), jnp.asarray(p0)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(optimizer, [pt], 1e-2, 0.1, moment_dtype="bfloat16")
    assert isinstance(opt, AdamBf16Moment)
    for i, g in enumerate(grads):
        up, jstate = tx.update(jnp.asarray(g), jstate, pj)
        pj = pj + up
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
        adam = jax.tree.leaves(jstate, is_leaf=lambda s: hasattr(s, "mu"))
        adam = next(s for s in adam if hasattr(s, "mu"))
        state = opt.state[pt]
        assert state["exp_avg"].dtype == torch.bfloat16 and state["exp_avg_sq"].dtype == torch.float32
        mu_want = np.asarray(adam.mu.astype(jnp.float32))
        mu_got = state["exp_avg"].float().numpy()
        if i == 0:
            ulp = BF16_ULP * 2.0 ** np.floor(np.log2(np.maximum(np.abs(mu_want), 1e-30)))
            assert np.all(np.abs(mu_got - mu_want) <= ulp)
            nu = np.asarray(adam.nu)  # adam's g + wd·p cancels: f32 rounding against the largest element
            np.testing.assert_allclose(state["exp_avg_sq"].numpy(), nu, rtol=1e-6, atol=1e-6 * np.abs(nu).max())
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-5, atol=1e-6)


def test_bf16_moment_state_dict_round_trip_keeps_bf16():
    p = torch.nn.Parameter(torch.randn(5, 3))
    opt = make_optimizer("adamw", [p], 1e-2, 0.1, moment_dtype="bfloat16")
    p.grad = torch.randn(5, 3)
    opt.step()
    saved = {k: v.clone() for k, v in opt.state[p].items()}
    again = make_optimizer("adamw", [p], 1e-2, 0.1, moment_dtype="bfloat16")
    again.load_state_dict(opt.state_dict())
    for k, v in saved.items():
        assert again.state[p][k].dtype == v.dtype and torch.equal(again.state[p][k], v), k
    with pytest.raises(ValueError, match="moment_dtype"):
        make_optimizer("adamw", [p], 1e-2, 0.1, moment_dtype="float16")


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory) -> str:
    data = tmp_path_factory.mktemp("optim")
    write_synthetic_dataset(str(data), n_users=300, n_items=80, n_reviews=6000, seed=11)
    return str(data)


@pytest.mark.parametrize("optimizer,lr", [("adamw", 0.01), ("adamw", 3e-3), ("adam", 3e-3)])
def test_bf16_moment_trajectory_tracks_the_jax_trainer(synthetic, optimizer, lr):
    """The port's and JAX's trainers at moment_dtype=bfloat16 from the same
    weights, at the trainer's bars (VAL_TOL after epoch 0, LATER_EPOCH_TOL
    after the later ones). A stored moment one bf16 ulp apart moves the
    run more than an f32 ulp does: with Adam at lr 0.01, whose val loss
    jumps up in epoch 1, that difference grows past the later-epoch bar
    there (as a JAX run from weights one f32 ulp away moves too, less), so
    Adam is held at lr 3e-3."""
    splits, art = jax_splits(f"{synthetic}/{REVIEWS}")
    jdims = JaxModelDims.from_artifacts(art)
    small = dict(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=1, dropout=0.0)
    tkw = dict(optimizer=optimizer, lr=lr, batch_size=256, n_epochs=3, seed=3, eval_batch_size=1024,
               early_stop_patience=10, moment_dtype="bfloat16")
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(5), jdims, JaxModelConfig(**small)))
    want = jax_train_dcn(splits, jdims, JaxModelConfig(**small), JaxTrainConfig(**tkw),
                         init_state=(params, bn_state))
    got = train_dcn(splits, port_dims(jdims), ModelConfig(**small), TrainConfig(**tkw),
                    init_state=(params, bn_state), device="cpu")
    assert len(got.history) == len(want.history) == 3
    for g, w, bar in zip(got.history, want.history, [VAL_TOL, LATER_EPOCH_TOL, LATER_EPOCH_TOL]):
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=bar["rtol"], abs=bar["atol"]), g["epoch"]
    assert got.final_metrics["val_auc"] == pytest.approx(want.final_metrics["val_auc"], abs=2e-3)
    fused = train_dcn(splits, port_dims(jdims), ModelConfig(**small), TrainConfig(**tkw, fused_epoch=True),
                      init_state=(params, bn_state), device="cpu")
    assert fused.history == got.history  # the fused epoch runs the same steps


def test_unique_segments_is_a_static_unique():
    rng = np.random.default_rng(1)
    for n, B in ((10, 24), (3, 5), (50, 8), (1, 4)):
        ids = rng.integers(0, n, B)
        uids, order, seg = unique_segments(torch.as_tensor(ids), n)
        want = np.unique(ids)
        np.testing.assert_array_equal(uids.numpy()[:len(want)], want)
        assert (uids.numpy()[len(want):] == n).all()
        np.testing.assert_array_equal(uids.numpy()[seg.numpy()], ids[order.numpy()])


def _lazy_and_dense(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0):
    dense = DCNR(DIMS, cfg, generator=torch.Generator().manual_seed(seed)).train()
    lazy = DCNR(DIMS, cfg, generator=torch.Generator().manual_seed(seed)).train()
    return (dense, make_train_optimizer(dense, tcfg)), (lazy, make_train_optimizer(lazy, dataclasses.replace(
        tcfg, lazy_table_updates=True)))


@pytest.mark.parametrize("arch", ["dcnr", "cross_only"])
@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_lazy_equals_dense_bitwise_under_full_coverage(optimizer, arch):
    """Every row touched every step: the lazy row update is the dense
    torch.optim step bit for bit, for the tables and the tower."""
    cfg = ModelConfig(**dict(SMALL, arch=arch))
    tcfg = TrainConfig(optimizer=optimizer, lr=1e-2, weight_decay=1e-2)
    (dense, dopt), (lazy, lopt) = _lazy_and_dense(cfg, tcfg)
    assert isinstance(lopt, LazyTableOptimizer)
    assert {id(p) for p in lopt.dense.param_groups[0]["params"]} == {id(p) for p in dense_parameters(lazy)}
    for step in range(4):
        batch = _torch_batch(_batch(True, seed=step))
        ld = train_step(dense, dopt, batch, None)
        ll = train_step(lazy, lopt, batch, None)
        assert torch.equal(ld, ll), step
    a, b = _state(dense), _state(lazy)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for name in lopt.names:
        p = dict(dense.named_parameters())[name]
        assert torch.equal(dopt.state[p]["exp_avg"], lopt.m[name]), name
        assert torch.equal(dopt.state[p]["exp_avg_sq"], lopt.v[name]), name


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_lazy_step_matches_jax_lazy(optimizer):
    """One lazy step from the same weights, JAX's make_lazy_update against
    the port's, on a batch with duplicates and untouched rows."""
    jcfg = JaxModelConfig(**SMALL)
    tcfg = JaxTrainConfig(optimizer=optimizer, lr=1e-2, weight_decay=1e-2)
    tx = jax_make_optimizer(optimizer, tcfg.lr, tcfg.weight_decay)
    params, bn = init_dcn(jax.random.PRNGKey(0), JDIMS, jcfg)
    batch = _batch(False, seed=3)
    batch["user"][:5] = [3, 3, 7, 1, 3]  # duplicates, and rows outside {0, 1}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    update = make_lazy_update(jcfg, tcfg)
    jp, jbn, jopt, jloss = update(params, bn, init_lazy_opt(tx, params), tx.update, jb, jax.random.PRNGKey(1))

    model = dcnr_from_jax(np_tree(params), np_tree(bn), DIMS, ModelConfig(**SMALL), train=True)
    opt = make_train_optimizer(model, TrainConfig(optimizer=optimizer, lr=1e-2, weight_decay=1e-2,
                                                  lazy_table_updates=True))
    loss = train_step(model, opt, _torch_batch(batch), None)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    got_p, got_bn = jax_from_dcnr(model)
    got, want = flatten_tree({"params": got_p, "s": got_bn}), flatten_tree({"params": np_tree(jp), "s": np_tree(jbn)})
    assert got.keys() == want.keys()
    for k in want:
        if PRE_BN_BIAS.fullmatch(k):  # zero exact gradient: Adam turns its rounding noise into ±lr steps (C1)
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for name, key in (("user_embedding", "user_embedding"), ("item_embedding", "item_embedding")):
        np.testing.assert_allclose(opt.m[name].numpy(), np.asarray(jopt.m[key]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(opt.v[name].numpy(), np.asarray(jopt.v[key]), rtol=1e-5, atol=1e-9)
    assert float(opt.count) == float(jopt.count) == 1.0


def test_lazy_untouched_rows_stay_frozen():
    """Rows no batch references keep their parameters and moments exactly;
    the dense AdamW decays them."""
    cfg = ModelConfig(**SMALL)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-2, weight_decay=1e-1)
    (dense, dopt), (lazy, lopt) = _lazy_and_dense(cfg, tcfg)
    u0 = lazy.user_embedding.detach().clone()
    for step in range(3):
        batch = _torch_batch(_batch(False, seed=step))
        train_step(lazy, lopt, batch, None)
        train_step(dense, dopt, batch, None)
    u1 = lazy.user_embedding.detach()
    assert not torch.allclose(u0[:2], u1[:2])
    assert torch.equal(u0[2:], u1[2:])
    assert (lopt.m["user_embedding"][2:] == 0).all() and (lopt.v["user_embedding"][2:] == 0).all()
    assert not torch.allclose(dense.user_embedding.detach()[2:], u0[2:])


def test_lazy_trainer_resumes_bit_for_bit_and_tracks_dense(synthetic, tmp_path):
    splits, art = port_splits(f"{synthetic}/{REVIEWS}")
    dims = ModelDims.from_artifacts(art)
    mcfg = ModelConfig(emb_dim=8, hidden_dim=32, n_cross_layers=1, n_res_blocks=1, dropout=0.2)
    tcfg = TrainConfig(lr=3e-3, batch_size=256, n_epochs=4, lazy_table_updates=True, early_stop_patience=10)
    full = train_dcn(splits, dims, mcfg, tcfg, device="cpu")
    train_dcn(splits, dims, mcfg, dataclasses.replace(tcfg, n_epochs=2), checkpoint_dir=str(tmp_path), device="cpu")
    resumed = train_dcn(splits, dims, mcfg, tcfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert resumed.history == full.history and resumed.final_metrics == full.final_metrics
    fa, fb = flatten_tree(full.params), flatten_tree(resumed.params)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    dense = train_dcn(splits, dims, mcfg, dataclasses.replace(tcfg, lazy_table_updates=False), device="cpu")
    assert full.history[-1]["val_loss"] < full.history[0]["val_loss"]
    assert full.final_metrics["val_logloss"] == pytest.approx(dense.final_metrics["val_logloss"], abs=5e-3)
