"""Fused-tower parity: the port's fold_eval_params, build_x0 and plain tower
against the JAX package's fold_eval_params, build_x0, the Pallas kernel in
interpret mode, and apply_dcn(train=False). The CUDA kernel itself is
held to the plain version in tests/test_torch_port_cuda.py and chip_smoke.py;
its launch plan, a pure function of the shapes, is checked here."""

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


SMEM_OPTIN = 232_448  # an H100's opt-in shared memory per block
# Clusters of blocks that each take an SM, resident at once on an H100 SXM
# (cudaOccupancyMaxActiveClusters, as chip_smoke.py prints it).
RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15}
# Device ms of one wave of each plan at the hpo_r5 widths on an H100
# (kernel_ab.py's sweep, PERF.md §6).
HPO_R5_WAVE_MS = {
    (16, 1): 0.1745, (16, 2): 0.1055, (16, 4): 0.0866, (16, 8): 0.0702,
    (32, 1): 0.2335, (32, 2): 0.1488, (32, 4): 0.1140, (32, 8): 0.0983,
    (64, 1): 0.4165, (64, 2): 0.2550, (64, 4): 0.1843, (64, 8): 0.1536,
}
# The HPO space's widths (hhrs_tpu/hpo/space.py): emb_dim in {16, 24, 32,
# 48, 64} gives d = 2 emb_dim + 17 on the repo's data; hidden 32 to 512.
HPO_D = (49, 65, 81, 113, 145)
HPO_H = tuple(range(32, 513, 32))


def work_ms(d: int, H: int) -> dict:
    """A wave's time as a block's work: the FMAs a thread does per k-row
    (rows / 4 x lane columns) and a fixed part worth 12 of them."""
    return {(rows, c): 12 + rows // 4 * tower._lane_cols(H, c)
            for rows, c in tower.tower_plans(d, H, 3, SMEM_OPTIN)}


@pytest.mark.parametrize("d,H", [(113, 320), (113, 96), (113, 100), (43, 32), (43, 64), (43, 96)])
@pytest.mark.parametrize("B", [1, 31, 128, 1024, 8192, 8193])
def test_tower_plan_covers_every_row_and_column_once(B, d, H):
    rows, cluster = tower.tower_plan(B, RESIDENT, work_ms(d, H))
    assert (rows, cluster) in tower.tower_plans(d, H, 3, SMEM_OPTIN)
    assert tower._lane_cols(H, cluster) <= tower._MAX_LANE_COLS[rows]
    tiles = -(-B // rows)
    covered = np.zeros(tiles * rows, int)
    for t in range(tiles):
        covered[t * rows:(t + 1) * rows] += 1
    assert (covered[:B] == 1).all()  # the zero rows past B are never written out
    cols = np.zeros(H, int)
    for c0, width in tower.tower_column_slices(H, cluster):
        assert c0 % 4 == 0 and width >= 0
        cols[c0:c0 + width] += 1
    assert (cols == 1).all()
    panel_k, stages, smem = tower.tower_layout(d, H, rows, cluster, SMEM_OPTIN)
    assert smem <= SMEM_OPTIN and panel_k % 16 == 0 and 2 <= stages <= 8


def test_tower_plan_at_hpo_r5_widths():
    # one request: 8 tiles x 8 = 64 blocks; recommend_many(K=8): 64 tiles x 2;
    # K = 16: 64 tiles x 2 again; 32 and 64 requests: 128 tiles, no cluster
    assert set(HPO_R5_WAVE_MS) == set(tower.tower_plans(113, 320, 3, SMEM_OPTIN))
    assert [tower.tower_plan(B, RESIDENT, HPO_R5_WAVE_MS) for B in (128, 1024, 2048, 4096, 8192)] == [
        (16, 8), (16, 2), (32, 2), (32, 1), (64, 1)]


def test_tower_plan_counts_waves_of_resident_clusters():
    # 16 tiles of 16 rows: clusters of 8 take two waves where 15 fit at
    # once, and the plan takes clusters of 4; one wave where 16 fit
    assert tower.tower_plan(256, RESIDENT, HPO_R5_WAVE_MS) == (16, 4)
    assert tower.tower_plan(256, {**RESIDENT, 8: 16}, HPO_R5_WAVE_MS) == (16, 8)
    # a cluster size the device cannot run is never chosen
    assert tower.tower_plan(128, {**RESIDENT, 8: 0}, HPO_R5_WAVE_MS)[1] != 8


def test_every_kernel_instance_is_some_plan():
    # csrc/tower_eval.cu builds one instance per (rows, lane columns) that
    # _MAX_LANE_COLS allows; with a wave's time as a block's work, each is
    # the plan of some batch at some width of the HPO space
    built = {(rows, cn) for rows in tower.TILE_ROWS for cn in range(1, tower._MAX_LANE_COLS[rows] + 1)}
    used = set()
    for d in HPO_D:
        for H in HPO_H:
            for B in [1, 256, 512, 640] + [1024 * k for k in range(1, 9)]:
                rows, cluster = tower.tower_plan(B, RESIDENT, work_ms(d, H))
                used.add((rows, tower._lane_cols(H, cluster)))
    assert used == built


def test_tower_plans_and_plan_raise_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        tower.tower_plans(4000, 320, 3, SMEM_OPTIN)
    with pytest.raises(ValueError, match="columns per block"):
        tower.tower_plans(113, 5000, 3, SMEM_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        tower.tower_plans(113, 320, 3, 20 * 1024)
    with pytest.raises(ValueError, match="plan the device runs"):
        tower.tower_plan(128, {1: 132}, {(16, 8): 0.07})
