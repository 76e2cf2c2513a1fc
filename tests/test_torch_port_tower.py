"""Fused-tower parity: the port's fold_eval_params, build_x0 and plain tower
against the JAX package's fold_eval_params, build_x0, the Pallas kernel in
interpret mode, and apply_dcn(train=False). The CUDA kernel itself is
held to the plain version in tests/test_torch_port_cuda.py and chip_smoke.py."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import apply_dcn, init_dcn
from hhrs_tpu.ops.pallas.tower_kernel import build_x0 as jax_build_x0
from hhrs_tpu.ops.pallas.tower_kernel import dcnr_tower_eval_pallas
from hhrs_tpu.ops.pallas.tower_kernel import fold_eval_params as jax_fold
from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.models.convert import dcnr_from_jax
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.ops import tower
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

CAT_DIMS = (("city", 6), ("hotel_type", 5))
DIMS = ModelDims(n_users=50, n_items=40, cat_dims=CAT_DIMS, n_num_features=11)
JAX_DIMS = JaxModelDims(n_users=50, n_items=40, cat_dims=CAT_DIMS, n_num_features=11)
TOL = dict(rtol=2e-5, atol=2e-5)  # the JAX kernel's own parity bar


def _setup(n_res: int, n_cross: int, hidden: int, variant: str, B: int = 200):
    kw = dict(emb_dim=8, hidden_dim=hidden, n_cross_layers=n_cross, n_res_blocks=n_res,
              dropout=0.3, cross_variant=variant)
    jcfg = JaxModelConfig(**kw)
    params, state = init_dcn(jax.random.PRNGKey(2), JAX_DIMS, jcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * np.arange(x.size, dtype=np.float32).reshape(x.shape) / x.size,
        state,
    )
    rng = np.random.default_rng(3)
    inputs = (
        rng.integers(0, DIMS.n_users, B),
        rng.integers(0, DIMS.n_items, B),
        np.stack([rng.integers(0, 6, B), rng.integers(0, 5, B)], axis=1),
        rng.standard_normal((B, 11)).astype(np.float32),
    )
    model = dcnr_from_jax(params, state, DIMS, ModelConfig(**kw))
    return params, state, jcfg, model, inputs


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("n_res,n_cross,hidden", [(1, 2, 64), (2, 3, 96), (0, 1, 32)])
def test_tower_matches_jax(n_res, n_cross, hidden, variant):
    params, state, jcfg, model, inputs = _setup(n_res, n_cross, hidden, variant)
    jf = jax_fold(params, state, eps=jcfg.bn_eps)
    f = tower.fold_eval_params(model)
    np.testing.assert_allclose(f["w0"].numpy(), np.asarray(jf["w0"]), rtol=0, atol=0)
    for key in ("w1", "b1", "w2", "b2"):
        want = np.stack([np.asarray(b[key]) for b in jf["blocks"]]) if n_res else np.zeros(
            f[key].shape, np.float32)
        np.testing.assert_allclose(f[key].numpy(), want, rtol=1e-6, atol=1e-7, err_msg=key)
    for key in ("cross_w", "cross_b", "final_w", "final_b"):
        np.testing.assert_array_equal(f[key].numpy(), np.asarray(jf[key]), err_msg=key)

    jx0 = np.asarray(jax_build_x0(params, *inputs))
    with torch.no_grad():
        x0 = tower.build_x0(model, *(torch.from_numpy(a) for a in inputs))
    np.testing.assert_array_equal(x0.numpy(), jx0)

    ref, _ = apply_dcn(params, state, *inputs, cfg=jcfg, train=False)
    pallas = dcnr_tower_eval_pallas(jf, jx0, variant, interpret=True)
    before = tower.tower_eval.launches
    with torch.no_grad():
        plain = tower.tower_eval_ref(f, x0, variant)
        wrapped = tower.tower_eval(f, x0, variant)
    assert tower.tower_eval.launches == before  # a CPU tensor never launches
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)


def test_fold_rejects_other_archs():
    _, _, _, model, _ = _setup(1, 2, 32, "code")
    model.cfg = ModelConfig(arch="deep_only")
    with pytest.raises(ValueError, match="dcnr"):
        tower.fold_eval_params(model)


def test_tower_eval_rejects_other_devices():
    _, _, _, model, inputs = _setup(1, 2, 32, "code", B=4)
    f = tower.fold_eval_params(model)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tower.tower_eval(f, torch.zeros(4, 27, device="meta"))
