"""Model parity: the port's DCNR module (weights moved in by the weight
carrier) against hhrs_tpu's apply_dcn, in f32 and at bf16 compute and
storage, plus the msgpack decoder and the artifact loader against flax.

The bf16 bar is relative to bf16 itself: ``max |port − JAX bf16|`` against
``dev = max |JAX bf16 − JAX f32|`` on the same inputs, both measured in the
test (``BF16_BAR``). Both sides round to bf16 at the same operations; they
differ where an f32 value that both round lies within f32 summation noise
of a bf16 rounding boundary (XLA and torch sum in different orders), and
one such flip moves a logit by one bf16 rounding of one activation."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import apply_dcn, apply_dcn_from_x0, init_dcn
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle
from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree
from hhrs_tpu_torch.models import dcn
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


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


@pytest.mark.parametrize("compute,storage,message", [
    ("float16", "float32", "unknown model.compute_dtype 'float16'"),
    ("float32", "int8", "unknown model.storage_dtype 'int8'"),
    ("float32", "bfloat16", "requires model.compute_dtype='bfloat16'"),
])
def test_dtype_validation_errors_are_jaxs(compute, storage, message):
    """The dtype rules of apply_dcn_from_x0, raised with its wording."""
    params, state, jcfg, _ = _jax_model("dcnr", "code")
    bad = dict(compute_dtype=compute, storage_dtype=storage)
    with pytest.raises(ValueError, match=re.escape(message)) as jax_err:
        apply_dcn(params, state, *_inputs(0, 4), cfg=dataclasses.replace(jcfg, **bad))
    with pytest.raises(ValueError, match=re.escape(message)) as port_err:
        DCNR(DIMS, ModelConfig(**bad))
    assert str(port_err.value) == str(jax_err.value)


BF16_BAR = 0.05  # max |port − JAX bf16| <= BF16_BAR · max |JAX bf16 − JAX f32|
# Train mode on the small random model: XLA and torch sum the BatchNorm
# statistics in different orders, so a few bf16 roundings of the normalized
# activations flip; one flip moved a logit by up to 0.104 · dev (deep_only,
# f32 storage). The 99th percentile is held to BF16_BAR, the largest to
# BF16_FLIP_BAR.
BF16_FLIP_BAR = 0.25
STORAGE = [("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def _bf16_bar(got, want, want_f32, what: str, flips: bool = False) -> float:
    """Hold ``got`` to ``want`` (JAX bf16) at the bar against ``dev``;
    returns the ratio of the largest |Δ| to ``dev``."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    dev = float(np.abs(np.asarray(want, np.float64) - np.asarray(want_f32, np.float64)).max())
    assert dev > 0, f"{what}: JAX bf16 equals JAX f32"
    if flips:
        assert np.quantile(err, 0.99) <= BF16_BAR * dev, (what, np.quantile(err, 0.99), dev)
        assert err.max() <= BF16_FLIP_BAR * dev, (what, err.max(), dev)
    else:
        assert err.max() <= BF16_BAR * dev, (what, err.max(), dev)
    return float(err.max() / dev)


@pytest.mark.parametrize("compute,storage", STORAGE)
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_dcnr_matches_apply_dcn(arch, variant, compute, storage, record_property):
    """Eval and train logits, the new BN state (f32) and x0 → logits
    (apply_dcn_from_x0) at bf16 compute and at bf16 compute + storage,
    against apply_dcn at the same dtypes."""
    params, state, jcfg, cfg = _jax_model(arch, variant)
    jcfg16 = dataclasses.replace(jcfg, compute_dtype=compute, storage_dtype=storage)
    model = dcnr_from_jax(params, state, DIMS, dataclasses.replace(cfg, compute_dtype=compute,
                                                                   storage_dtype=storage))
    u, i, c, n = _inputs(3, 96)
    tin = [torch.from_numpy(a) for a in (u, i, c, n)]
    ratios = {}
    for train in (False, True):
        want, new_state = apply_dcn(params, state, u, i, c, n, cfg=jcfg16, train=train)
        want32, state32 = apply_dcn(params, state, u, i, c, n, cfg=jcfg, train=train)
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in flatten_tree(state).items()},
                              strict=False)  # the running statistics as they were before the pass
        model.train(train)
        with torch.no_grad():
            got = model(*tin)
        assert got.dtype == torch.float32
        ratios[f"{'train' if train else 'eval'}_logits"] = _bf16_bar(got.numpy(), want, want32, "logits", train)
        if train:
            want_s, want_s32 = flatten_tree(np_tree(new_state)), flatten_tree(np_tree(state32))
            for k, v in want_s.items():
                buf = dict(model.named_buffers())[k]
                assert buf.dtype == torch.float32
                ratios[k] = _bf16_bar(buf.numpy(), v, want_s32[k], k, flips=True)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in flatten_tree(state).items()},
                          strict=False)  # undo the train pass's update of the running statistics
    with torch.no_grad():
        x0 = model.eval().embed(*tin)
    want, _ = apply_dcn_from_x0(params, state, x0.numpy(), cfg=jcfg16)
    want32, _ = apply_dcn_from_x0(params, state, x0.numpy(), cfg=jcfg)
    with torch.no_grad():
        ratios["x0_logits"] = _bf16_bar(dcn.apply_dcn_from_x0(model, x0).numpy(), want, want32, "x0 → logits")
    record_property("max_ratio_to_dev", max(ratios.values()))


@pytest.fixture(scope="module")
def hpo_r5_rows():
    """4,096 rows of data/'s train split (the port's Preprocessor) and the
    hpo_r5 artifact: the configuration and inputs the engine and trainer run."""
    from hhrs_tpu_torch.config import Config
    from hhrs_tpu_torch.train.cli import build_dataset

    splits, _ = build_dataset(str(REPO / "data"), Config())
    rows = np.random.default_rng(0).permutation(splits.n_train)[:4096]
    feats = [getattr(splits, f"train_{k}")[rows] for k in ("user", "item", "cat", "num")]
    return jax_load_bundle(str(ARTIFACT)), load_artifact_bundle(str(ARTIFACT)), feats


@pytest.mark.parametrize("compute,storage", STORAGE)
def test_bf16_hpo_r5_matches_apply_dcn(hpo_r5_rows, compute, storage, record_property):
    """The hpo_r5 model on real rows, eval and train, at BF16_BAR on the
    largest |Δ| (no flip allowance)."""
    jb, bundle, feats = hpo_r5_rows
    jcfg32 = dataclasses.replace(jb.model_cfg, dropout=0.0)
    jcfg = dataclasses.replace(jcfg32, compute_dtype=compute, storage_dtype=storage)
    cfg = dataclasses.replace(bundle.model_cfg, dropout=0.0, compute_dtype=compute, storage_dtype=storage)
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, cfg)
    tin = [torch.from_numpy(a) for a in feats]
    for train in (False, True):
        want, _ = apply_dcn(jb.params, jb.bn_state, *feats, cfg=jcfg, train=train)
        want32, _ = apply_dcn(jb.params, jb.bn_state, *feats, cfg=jcfg32, train=train)
        with torch.no_grad():
            got = model.train(train)(*tin)
        record_property(f"{'train' if train else 'eval'}_ratio", _bf16_bar(got.numpy(), want, want32, "logits"))


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
