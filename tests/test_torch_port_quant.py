"""int8 embedding tables: the port's ``ops/quant.py`` against
``hhrs_tpu/ops/quant.py``, and a quantized params tree through the weight
carrier into ``DCNR``.

Bars: the int8 values and scales are bitwise JAX's (the same f32
operations, round half to even); a lookup equals the dequantized table's
rows exactly; the logits of a model with quantized tables meet JAX's at the
tower kernel's bar, rtol = atol = 2e-5."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhrs_tpu.models.dcn import apply_dcn
from hhrs_tpu.ops import quant as jquant
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle
from hhrs_tpu_torch.models.convert import dcnr_from_jax
from hhrs_tpu_torch.ops import quant
from hhrs_tpu_torch.ops.tower import build_x0
from tests.test_torch_port_model import DIMS, _inputs, _jax_model, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
TOL = dict(rtol=2e-5, atol=2e-5)


def _random_table(seed: int, n: int, d: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((n, d)) * rng.uniform(0.01, 10, (n, 1))).astype(np.float32)
    table[::7] = 0.0  # zero rows take scale 1
    return table


def _assert_bitwise(got: quant.QuantizedTable, want) -> None:
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy().view(np.int32), np.asarray(want.scales).view(np.int32))


@pytest.mark.parametrize("seed,n,d", [(0, 50, 8), (1, 300, 48), (2, 7, 1), (3, 1000, 5)])
def test_quantize_table_is_bitwise_jaxs_on_random_tables(seed, n, d):
    table = _random_table(seed, n, d)
    _assert_bitwise(quant.quantize_table(table), jquant.quantize_table(jnp.asarray(table)))
    _assert_bitwise(quant.quantize_table(torch.from_numpy(table)), jquant.quantize_table(jnp.asarray(table)))


def test_zero_rows_get_scale_one():
    qt = quant.quantize_table(np.zeros((4, 6), np.float32))
    assert (qt.scales == 1).all() and (qt.values == 0).all()
    assert qt.shape == (4, 6) and qt.nbytes() == 4 * 6 + 4 * 4


@pytest.mark.parametrize("name", ["user_embedding", "item_embedding", "cat_embeddings"])
def test_quantize_table_is_bitwise_jaxs_on_hpo_r5(name):
    tables = jax_load_bundle(str(ARTIFACT)).params[name]
    for table in (tables if isinstance(tables, list) else [tables]):
        table = np.asarray(table)
        _assert_bitwise(quant.quantize_table(table), jquant.quantize_table(jnp.asarray(table)))
        assert quant.quantization_error(table) == pytest.approx(jquant.quantization_error(jnp.asarray(table)),
                                                                rel=1e-6)


def test_lookup_equals_dequantized_gather():
    qt = quant.quantize_table(_random_table(4, 40, 9))
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 40, (6, 5)))
    got = quant.quantized_lookup(qt, ids)
    assert got.shape == (6, 5, 9) and got.dtype == torch.float32
    assert torch.equal(got, quant.dequantize(qt)[ids])
    want = jquant.quantized_lookup(jquant.quantize_table(jnp.asarray(_random_table(4, 40, 9))), ids.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_table_lookup_dispatches_on_the_table_type():
    table = torch.from_numpy(_random_table(6, 20, 4))
    ids = torch.tensor([0, 3, 3, 19])
    assert torch.equal(quant.table_lookup(table, ids), table[ids])
    qt = quant.quantize_table(table)
    assert torch.equal(quant.table_lookup(qt, ids), quant.quantized_lookup(qt, ids))


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("arch", ["dcnr", "dcn_mlp", "cross_only", "deep_only"])
def test_quantized_model_logits_match_jax(arch, variant):
    """The port's quantize_embedding_params, then the carrier, against
    JAX's quantize_embedding_params and apply_dcn: the same int8 tables,
    x0 exactly (build_x0 through table_lookup), logits at 2e-5."""
    params, state, jcfg, cfg = _jax_model(arch, variant)
    jparams = jquant.quantize_embedding_params(jax.tree.map(jnp.asarray, params))
    model = dcnr_from_jax(quant.quantize_embedding_params(params), state, DIMS, cfg)
    u, i, c, n = _inputs(7, 64)
    tin = [torch.from_numpy(a) for a in (u, i, c, n)]
    want, _ = apply_dcn(jparams, state, u, i, c, n, cfg=jcfg, train=False)
    with torch.no_grad():
        got = model(*tin)
        x0 = build_x0(model, *tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_x0 = np.concatenate([np.asarray(jquant.quantized_lookup(jparams["user_embedding"], u)),
                              np.asarray(jquant.quantized_lookup(jparams["item_embedding"], i)),
                              *[np.asarray(jquant.quantized_lookup(t, c[:, k]))
                                for k, t in enumerate(jparams["cat_embeddings"])], n], axis=1)
    np.testing.assert_array_equal(x0.numpy(), want_x0)


def test_carrier_takes_jax_quantized_trees():
    """A JAX params tree whose tables are JAX QuantizedTables (and its
    msgpack form, categorical tables keyed "0", "1") loads into the same
    int8 buffers as the port's own quantized tree."""
    params, state, _, cfg = _jax_model("dcnr", "code")
    jtree = jax.tree.map(np.asarray, jquant.quantize_embedding_params(jax.tree.map(jnp.asarray, params)))
    msgpack_form = dict(jtree, cat_embeddings={str(k): t for k, t in enumerate(jtree["cat_embeddings"])})
    ours = dcnr_from_jax(quant.quantize_embedding_params(params), state, DIMS, cfg)
    for tree in (jtree, msgpack_form):
        theirs = dcnr_from_jax(tree, state, DIMS, cfg)
        a, b = ours.state_dict(), theirs.state_dict()
        assert a.keys() == b.keys() and "user_embedding.values" in a and "cat_embeddings.1.scales" in a
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert isinstance(ours.item_embedding, quant.QuantizedTable)


def test_carrier_refuses_mixed_or_misplaced_quantized_leaves():
    params, state, _, cfg = _jax_model("dcnr", "code")
    mixed = dict(params, cat_embeddings=[quant.quantize_table(params["cat_embeddings"][0]),
                                         params["cat_embeddings"][1]])
    with pytest.raises(ValueError, match="every categorical table"):
        dcnr_from_jax(mixed, state, DIMS, cfg)
    misplaced = dict(params, final=dict(params["final"], kernel=quant.quantize_table(params["final"]["kernel"])))
    with pytest.raises(ValueError, match="only embedding tables"):
        dcnr_from_jax(misplaced, state, DIMS, cfg)
