"""The trainer's data and checking options against hhrs_tpu's (on the
CPU): out-of-core slab streaming (``train.stream_slab_steps``), the NaN
checks (``train.debug_nans``) and the catalog-ranking recall
(``train/eval_retrieval.py``, ``train.eval_catalog_recall``).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.config import TrainConfig as JaxTrainConfig
from hhrs_tpu.data.preprocess import DatasetSplits
from hhrs_tpu.data.synthetic import write_synthetic_dataset
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import init_dcn
from hhrs_tpu.train.eval_retrieval import _item_feature_table as jax_item_table
from hhrs_tpu.train.eval_retrieval import catalog_recall_at_k as jax_catalog_recall
from hhrs_tpu.train.eval_retrieval import catalog_recall_from_scores as jax_recall_from_scores
from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn
from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.train.eval_retrieval import _item_feature_table, catalog_recall_at_k, catalog_recall_from_scores
from hhrs_tpu_torch.train.trainer import train_dcn
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_port_train import jax_splits, np_tree, port_dims, port_splits

REVIEWS = "hackathon_augmented_data.csv"
# tests/test_stream_slabs.py's run: dropout on, a ragged last batch wrapped
MCFG = dict(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=1, dropout=0.3)
TCFG = dict(batch_size=256, n_epochs=3, seed=7, drop_remainder=False, eval_batch_size=512, early_stop_patience=10)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("slabs")
    write_synthetic_dataset(str(d), n_users=250, n_items=70, n_reviews=5000, seed=21)
    splits, art = port_splits(str(d / REVIEWS))
    return splits, ModelDims.from_artifacts(art)


@pytest.fixture(scope="module")
def resident_run(data):
    splits, dims = data
    return train_dcn(splits, dims, ModelConfig(**MCFG), TrainConfig(**TCFG), device="cpu")


def assert_bitwise(got, want) -> None:
    assert got.history == want.history and got.final_metrics == want.final_metrics
    fa, fb = flatten_tree({"p": got.params, "s": got.bn_state}), flatten_tree({"p": want.params, "s": want.bn_state})
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("K", [1, 4, 100])
def test_slab_streaming_is_the_resident_run_bitwise(data, resident_run, K):
    """K = 4 leaves a ragged last slab; K = 100 is one slab an epoch."""
    splits, dims = data
    steps = -(-splits.n_train // TCFG["batch_size"])
    assert steps % 4 != 0
    got = train_dcn(splits, dims, ModelConfig(**MCFG), TrainConfig(**TCFG, stream_slab_steps=K), device="cpu")
    assert_bitwise(got, resident_run)


def test_slab_streaming_from_memmap(data, resident_run, tmp_path):
    """The train split may be np.memmap: only the gathered slab rows load."""
    splits, dims = data
    mm = {}
    for f in ("train_user", "train_item", "train_cat", "train_num", "train_y"):
        np.save(tmp_path / f"{f}.npy", getattr(splits, f))
        mm[f] = np.load(tmp_path / f"{f}.npy", mmap_mode="r")
    got = train_dcn(dataclasses.replace(splits, **mm), dims, ModelConfig(**MCFG),
                    TrainConfig(**TCFG, stream_slab_steps=3), device="cpu")
    assert_bitwise(got, resident_run)


def test_slab_streaming_rejects_fused_epoch_as_jax_does(data):
    splits, dims = data
    for run, m, t, kw in ((train_dcn, ModelConfig, TrainConfig, {"device": "cpu"}),
                          (jax_train_dcn, JaxModelConfig, JaxTrainConfig, {})):
        with pytest.raises(ValueError, match="mutually exclusive"):
            run(splits, dims, m(**MCFG), t(**TCFG, stream_slab_steps=2, fused_epoch=True), **kw)


def test_slab_streaming_with_lazy_tables_is_the_resident_lazy_run(data):
    splits, dims = data
    tcfg = TrainConfig(**dict(TCFG, n_epochs=2), lazy_table_updates=True)
    resident = train_dcn(splits, dims, ModelConfig(**MCFG), tcfg, device="cpu")
    slabbed = train_dcn(splits, dims, ModelConfig(**MCFG), dataclasses.replace(tcfg, stream_slab_steps=4),
                        device="cpu")
    assert_bitwise(slabbed, resident)


def _poisoned(splits, split: str = "train"):
    num = getattr(splits, f"{split}_num").copy()
    num[3, 2] = np.nan
    return dataclasses.replace(splits, **{f"{split}_num": num})


@pytest.mark.parametrize("option", [{}, {"fused_epoch": True}, {"stream_slab_steps": 4},
                                    {"lazy_table_updates": True}])
def test_debug_nans_raises_on_a_poisoned_batch(data, option):
    splits, dims = data
    tcfg = TrainConfig(**dict(TCFG, n_epochs=1), debug_nans=True, **option)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        train_dcn(_poisoned(splits), dims, ModelConfig(**MCFG), tcfg, device="cpu")
    with pytest.raises(FloatingPointError, match="val logits"):
        train_dcn(_poisoned(splits, "val"), dims, ModelConfig(**MCFG), tcfg, device="cpu")
    clean = train_dcn(splits, dims, ModelConfig(**MCFG), tcfg, device="cpu")  # no NaN: no raise
    plain = train_dcn(splits, dims, ModelConfig(**MCFG), dataclasses.replace(tcfg, debug_nans=False), device="cpu")
    assert clean.history == plain.history


def test_debug_nans_raises_where_jax_raises(data):
    """A NaN feature in one train row: JAX's jax_debug_nans raises
    FloatingPointError in that step; the port raises after it. Without
    debug_nans neither raises and both end with NaN losses."""
    splits, dims = data
    jdims = JaxModelDims(dims.n_users, dims.n_items, dims.cat_dims, dims.n_num_features)
    poisoned = _poisoned(splits)
    tkw = dict(TCFG, n_epochs=1)
    try:
        with pytest.raises(FloatingPointError):
            jax_train_dcn(poisoned, jdims, JaxModelConfig(**MCFG), JaxTrainConfig(**tkw, debug_nans=True))
    finally:
        jax.config.update("jax_debug_nans", False)  # the JAX trainer sets it for the process
    with pytest.raises(FloatingPointError):
        train_dcn(poisoned, dims, ModelConfig(**MCFG), TrainConfig(**tkw, debug_nans=True), device="cpu")
    jres = jax_train_dcn(poisoned, jdims, JaxModelConfig(**MCFG), JaxTrainConfig(**tkw))
    res = train_dcn(poisoned, dims, ModelConfig(**MCFG), TrainConfig(**tkw), device="cpu")
    assert np.isnan(jres.history[0]["train_loss"]) and np.isnan(res.history[0]["train_loss"])


def _catalog_splits(seed: int = 3) -> DatasetSplits:
    """tests/test_eval_retrieval.py's random splits: 150 items (> k)."""
    rng = np.random.default_rng(seed)

    def part(n):
        return (rng.integers(0, 20, n).astype(np.int32), rng.integers(0, 150, n).astype(np.int32),
                rng.integers(0, 3, (n, 2)).astype(np.int32), rng.normal(size=(n, 11)).astype(np.float32),
                (rng.uniform(size=n) < 0.5).astype(np.float32))

    return DatasetSplits(*part(800), *part(266))


def test_item_feature_table_equals_jax():
    splits = _catalog_splits()
    for got, want in zip(_item_feature_table(splits), jax_item_table(splits)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exclude_train", [True, False])
def test_catalog_recall_from_scores_equals_jax(exclude_train):
    splits = _catalog_splits()
    items = _item_feature_table(splits)[0]
    scores = np.random.default_rng(0).standard_normal((20, len(items)))

    def score_fn(chunk):
        return scores[chunk]

    kw = dict(k=10, exclude_train=exclude_train, user_chunk=7, max_users=15)
    assert catalog_recall_from_scores(score_fn, items, splits, **kw) == \
        jax_recall_from_scores(score_fn, items, splits, **kw)


@pytest.mark.parametrize("arch", ["dcnr", "cross_only"])
def test_catalog_recall_at_k_equals_jax_on_the_same_weights(arch):
    splits = _catalog_splits()
    jdims = JaxModelDims(20, 150, (("a", 3), ("b", 3)), 11)
    cfg = dict(emb_dim=4, hidden_dim=8, n_cross_layers=1, n_res_blocks=1, dropout=0.0, arch=arch)
    params, bn = np_tree(init_dcn(jax.random.PRNGKey(0), jdims, JaxModelConfig(**cfg)))
    want = jax_catalog_recall(params, bn, JaxModelConfig(**cfg), splits, k=10)
    model = dcnr_from_jax(params, bn, port_dims(jdims), ModelConfig(**cfg))
    got = catalog_recall_at_k(model, splits, k=10, user_chunk=7)
    assert 0.0 < got < 1.0 and got == want


def test_trainer_reports_catalog_recall(tmp_path):
    write_synthetic_dataset(str(tmp_path), n_users=200, n_items=300, n_reviews=6000, seed=5)
    splits, art = jax_splits(str(tmp_path / REVIEWS))
    jdims = JaxModelDims.from_artifacts(art)
    mcfg = dict(emb_dim=8, hidden_dim=32, n_cross_layers=1, n_res_blocks=1, dropout=0.0)
    tkw = dict(batch_size=1024, n_epochs=2, eval_catalog_recall=True)
    params, bn = np_tree(init_dcn(jax.random.PRNGKey(1), jdims, JaxModelConfig(**mcfg)))
    want = jax_train_dcn(splits, jdims, JaxModelConfig(**mcfg), JaxTrainConfig(**tkw), init_state=(params, bn))
    got = train_dcn(splits, port_dims(jdims), ModelConfig(**mcfg), TrainConfig(**tkw), init_state=(params, bn),
                    device="cpu")
    r_got, r_want = got.final_metrics["catalog_recall_at_100"], want.final_metrics["catalog_recall_at_100"]
    assert 0.0 < r_got < 1.0
    assert r_got == pytest.approx(r_want, abs=0.02)  # two trained models, not the same weights
