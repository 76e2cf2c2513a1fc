"""Model parity: the port's DCNR module (weights moved in by the weight
carrier) against hhrs_tpu's apply_dcn, plus the msgpack decoder and the
artifact loader against flax."""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import apply_dcn, init_dcn
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle
from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree
from hhrs_tpu_torch.models.dcn import ARCHS, DCNR, ModelDims
from hhrs_tpu_torch.ops.nn import BatchNorm
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
from hhrs_tpu_torch.train.serialization import msgpack_restore

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
CAT_DIMS = (("city", 6), ("hotel_type", 5))
DIMS = ModelDims(n_users=50, n_items=40, cat_dims=CAT_DIMS, n_num_features=11)
JAX_DIMS = JaxModelDims(n_users=50, n_items=40, cat_dims=CAT_DIMS, n_num_features=11)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch CPU work on one intra-op thread. The suite runs
    several pytest workers on the same cores, and torch's OpenMP pool
    spin-waits when the cores are oversubscribed, which slows every
    worker. The other port test modules import this fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed: int, B: int):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, DIMS.n_users, B),
        rng.integers(0, DIMS.n_items, B),
        np.stack([rng.integers(0, 6, B), rng.integers(0, 5, B)], axis=1),
        rng.standard_normal((B, 11)).astype(np.float32),
    )


def _jax_model(arch: str, variant: str, seed: int = 0):
    kw = dict(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=2, dropout=0.0,
              arch=arch, cross_variant=variant)
    params, state = init_dcn(jax.random.PRNGKey(seed), JAX_DIMS, JaxModelConfig(**kw))
    # non-trivial running statistics so eval BN is not the identity
    rng = np.random.default_rng(seed + 1)
    state = jax.tree.map(
        lambda x: np.asarray(x) + 0.2 * np.abs(rng.standard_normal(x.shape)).astype(np.float32),
        state,
    )
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(state), JaxModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dcnr_eval_and_train_match_apply_dcn(arch, variant):
    params, state, jcfg, cfg = _jax_model(arch, variant)
    model = dcnr_from_jax(params, state, DIMS, cfg)
    u, i, c, n = _inputs(3, 96)
    tu, ti, tc, tn = (torch.from_numpy(a) for a in (u, i, c, n))

    ref, _ = apply_dcn(params, state, u, i, c, n, cfg=jcfg, train=False)
    with torch.no_grad():
        out = model(tu, ti, tc, tn)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)

    ref_t, new_state = apply_dcn(params, state, u, i, c, n, cfg=jcfg, train=True)
    model.train()
    with torch.no_grad():
        out_t = model(tu, ti, tc, tn)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), rtol=1e-5, atol=1e-6)
    want = flatten_tree(jax.tree.map(np.asarray, new_state))
    got = dict(model.named_buffers())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_batchnorm_batch_of_one_raises_in_train_mode():
    bn = BatchNorm(4).train()
    with pytest.raises(ValueError, match=">1 example"):
        bn(torch.ones(1, 4))
    bn.eval()
    assert bn(torch.ones(1, 4)).shape == (1, 4)


def test_train_mode_dropout_needs_generator():
    cfg = ModelConfig(emb_dim=8, hidden_dim=32, dropout=0.5)
    model = DCNR(DIMS, cfg, generator=torch.Generator().manual_seed(0)).train()
    u, i, c, n = (torch.from_numpy(a) for a in _inputs(0, 8))
    with pytest.raises(ValueError, match="generator"):
        model(u, i, c, n)
    out = model(u, i, c, n, generator=torch.Generator().manual_seed(1))
    assert out.shape == (8,) and torch.isfinite(out).all()


def test_bf16_config_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DCNR(DIMS, ModelConfig(compute_dtype="bfloat16"))


def test_weight_carrier_rejects_a_mismatched_tree():
    params, state, _, cfg = _jax_model("dcnr", "code")
    params = dict(params, final={"kernel": np.zeros((5, 1), np.float32),
                                 "bias": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="size mismatch"):
        dcnr_from_jax(params, state, DIMS, cfg)
    params.pop("final")
    with pytest.raises(RuntimeError, match="Missing key"):
        dcnr_from_jax(params, state, DIMS, cfg)


def _assert_same_tree(got, want, path="") -> None:
    assert type(got) is type(want) or isinstance(want, np.ndarray), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_msgpack_decoder_matches_flax_on_hpo_r5():
    data = (ARTIFACT / "params.msgpack").read_bytes()
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_msgpack_decoder_matches_flax_on_scalars_and_lists():
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, -1, 127, 128, -33, 70000, -70000, 2**40, -(2**40)],
        "floats": [0.5, -1e300],
        "text": ["a", "é" * 40, "x" * 70000],
        "flag": [True, False, None],
        "blob": b"\x00\x01" * 200,
        "arrays": [rng.standard_normal((3, 4)).astype(np.float32),
                   np.arange(5, dtype=np.int32), np.zeros((0, 7), np.float32)],
        "empty": {},
    }
    data = serialization.msgpack_serialize(tree)
    got, want = msgpack_restore(data), serialization.msgpack_restore(data)
    assert got.keys() == want.keys()
    for k in ("ints", "floats", "text", "flag", "blob", "empty"):
        assert got[k] == want[k], k
    for a, b in zip(got["arrays"], want["arrays"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_msgpack_decoder_refuses_chunked_leaves():
    data = serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 1}, "chunks": {}}}
    )
    with pytest.raises(ValueError, match="chunked"):
        msgpack_restore(data)


def test_artifact_bundle_matches_jax_loader():
    ours, theirs = load_artifact_bundle(str(ARTIFACT)), jax_load_bundle(str(ARTIFACT))
    want = flatten_tree(jax.tree.map(np.asarray, {"params": theirs.params, "bn_state": theirs.bn_state}))
    got = flatten_tree({"params": ours.params, "bn_state": ours.bn_state})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert vars(ours.model_cfg) == vars(theirs.model_cfg)
    assert ours.dims.cat_dims == theirs.dims.cat_dims
    assert (ours.dims.n_users, ours.dims.n_items) == (theirs.dims.n_users, theirs.dims.n_items)
    np.testing.assert_array_equal(ours.item_embeddings, theirs.item_embeddings)
    assert ours.preproc.user_id_mapping == theirs.preproc.user_id_mapping
    assert ours.preproc.cat_encoders == theirs.preproc.cat_encoders
