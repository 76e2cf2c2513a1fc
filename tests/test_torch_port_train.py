"""Training-slice parity: the port's Preprocessor, trainer, weight carrier,
artifact export and trainer CLI (on the CPU) against hhrs_tpu's.

The golden file ``hhrs_tpu_torch/testdata/train_golden_hpo_r5.json`` holds
the JAX trainer's trajectory (per-epoch val loss, LR, final metrics) from
the hpo_r5 artifact's weights with the hpo_r5 trial-139 hyperparameters and
dropout 0; ``chip_smoke.py`` holds a training run on the card against it.
Regenerate it with ``python tests/test_torch_port_train.py --write``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # for the --write entry point
    sys.path.insert(0, str(REPO))

from hhrs_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from hhrs_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from hhrs_tpu.data.features import add_engineered_features as jax_features  # noqa: E402
from hhrs_tpu.data.ingest import load_reviews_csv as jax_load_reviews  # noqa: E402
from hhrs_tpu.data.ingest import noise_filter as jax_noise_filter  # noqa: E402
from hhrs_tpu.data.preprocess import Preprocessor as JaxPreprocessor  # noqa: E402
from hhrs_tpu.data.synthetic import write_synthetic_dataset  # noqa: E402
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims  # noqa: E402
from hhrs_tpu.models.dcn import init_dcn  # noqa: E402
from hhrs_tpu.train.artifacts import export_artifacts as jax_export  # noqa: E402
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle  # noqa: E402
from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn  # noqa: E402
from hhrs_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from hhrs_tpu_torch.data.features import add_engineered_features  # noqa: E402
from hhrs_tpu_torch.data.ingest import load_reviews_csv, noise_filter  # noqa: E402
from hhrs_tpu_torch.data.preprocess import Preprocessor  # noqa: E402
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree, jax_from_dcnr  # noqa: E402
from hhrs_tpu_torch.models.dcn import ARCHS, ModelDims  # noqa: E402
from hhrs_tpu_torch.train import cli  # noqa: E402
from hhrs_tpu_torch.train.artifacts import export_artifacts, load_artifact_bundle  # noqa: E402
from hhrs_tpu_torch.train.serialization import msgpack_serialize  # noqa: E402
from hhrs_tpu_torch.train.trainer import train_dcn  # noqa: E402
from tests.test_torch_port_model import one_torch_thread  # noqa: E402,F401 — module fixture

ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
DATA = REPO / "data"
GOLDEN = REPO / "hhrs_tpu_torch/testdata/train_golden_hpo_r5.json"
REVIEWS = "hackathon_augmented_data.csv"
VAL_TOL = dict(rtol=2e-3, atol=2e-4)  # the bar of tests/test_parity_train.py
# The golden run's epochs after the first carry ~1e-3 of rounding noise
# (chip_smoke.py LATER_EPOCH_TOL; PERF.md §6).
LATER_EPOCH_TOL = dict(rtol=5e-3, atol=2e-4)
SMALL_MODEL = dict(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=1, dropout=0.0)


def jax_splits(csv: str, **kw):
    return JaxPreprocessor(**kw).fit_transform(jax_features(jax_noise_filter(jax_load_reviews(csv))))


def port_splits(csv: str, **kw):
    return Preprocessor(**kw).fit_transform(add_engineered_features(noise_filter(load_reviews_csv(csv))))


def assert_same_splits(got, want) -> None:
    for name, ref in vars(want).items():
        arr = getattr(got, name)
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)


def port_dims(jdims: JaxModelDims) -> ModelDims:
    return ModelDims(jdims.n_users, jdims.n_items, jdims.cat_dims, jdims.n_num_features)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory) -> str:
    """~6k synthetic reviews (the size of tests/test_parity_train.py)."""
    data = tmp_path_factory.mktemp("synthetic")
    write_synthetic_dataset(str(data), n_users=300, n_items=80, n_reviews=6000, seed=11)
    return str(data)


def test_preprocessor_matches_jax_on_data_and_hpo_r5():
    csv = str(DATA / REVIEWS)
    want_splits, want_art = jax_splits(csv)
    splits, art = port_splits(csv)
    assert (splits.n_train, splits.n_val) == (want_splits.n_train, want_splits.n_val) == (17945, 4487)
    assert_same_splits(splits, want_splits)
    shipped = json.loads((ARTIFACT / "preproc.json").read_text())
    assert json.loads(json.dumps(art.to_json_dict())) == shipped
    assert json.loads(json.dumps(want_art.to_json_dict())) == shipped


def test_preprocessor_without_leakage_compat(synthetic):
    csv = os.path.join(synthetic, REVIEWS)
    want_splits, want_art = jax_splits(csv, leakage_compat=False)
    splits, art = port_splits(csv, leakage_compat=False)
    assert_same_splits(splits, want_splits)
    assert json.loads(json.dumps(art.to_json_dict())) == json.loads(json.dumps(want_art.to_json_dict()))


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_trainer_matches_jax_trainer(synthetic, optimizer):
    splits, art = jax_splits(os.path.join(synthetic, REVIEWS))
    jdims = JaxModelDims.from_artifacts(art)
    # lr high enough, and patience 0, that the plateau scheduler decays once
    tkw = dict(optimizer=optimizer, lr=0.01, batch_size=256, n_epochs=3, seed=3,
               eval_batch_size=1024, lr_plateau_patience=0, lr_plateau_factor=0.5,
               early_stop_patience=10)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(5), jdims, JaxModelConfig(**SMALL_MODEL)))

    want = jax_train_dcn(splits, jdims, JaxModelConfig(**SMALL_MODEL), JaxTrainConfig(**tkw),
                         init_state=(params, bn_state))
    got = train_dcn(splits, port_dims(jdims), ModelConfig(**SMALL_MODEL), TrainConfig(**tkw),
                    init_state=(params, bn_state), device="cpu")

    np.testing.assert_allclose([h["val_loss"] for h in got.history],
                               [h["val_loss"] for h in want.history], **VAL_TOL)
    lrs = [h["lr"] for h in want.history]
    assert [h["lr"] for h in got.history] == lrs and len(set(lrs)) > 1
    assert got.final_metrics["val_logloss"] == pytest.approx(want.final_metrics["val_logloss"], **{
        "rel": VAL_TOL["rtol"], "abs": VAL_TOL["atol"]})
    assert got.final_metrics["val_auc"] == pytest.approx(want.final_metrics["val_auc"], abs=2e-3)
    assert got.best_epoch == want.best_epoch
    assert len(got.step_ms) == 2 * (splits.n_train // 256) and got.examples_per_s > 0


def test_golden_file_matches_its_recorded_config():
    golden = json.loads(GOLDEN.read_text())
    want = golden_configs()
    assert golden["model_config"] == dataclasses.asdict(want[0])
    assert golden["train_config"] == dataclasses.asdict(want[1])
    assert [h["lr"] for h in golden["history"]] == [want[1].lr] * want[1].n_epochs
    assert golden["n_train"] == 17945 and golden["n_val"] == 4487


def test_port_reproduces_the_golden_trajectory_on_the_cpu():
    golden = json.loads(GOLDEN.read_text())
    model_cfg, train_cfg = golden_configs()
    bundle = load_artifact_bundle(str(ARTIFACT))
    splits, _ = port_splits(str(DATA / REVIEWS))
    got = train_dcn(splits, bundle.dims, model_cfg, train_cfg,
                    init_state=(bundle.params, bundle.bn_state), device="cpu")
    want = golden["history"]
    assert len(got.history) == len(want)
    for h, w, bar in zip(got.history, want, [VAL_TOL] + [LATER_EPOCH_TOL] * (len(want) - 1)):
        assert h["val_loss"] == pytest.approx(w["val_loss"], rel=bar["rtol"], abs=bar["atol"])
        assert h["lr"] == w["lr"]
    fm, gm = got.final_metrics, golden["final_metrics"]
    assert fm["val_logloss"] == pytest.approx(gm["val_logloss"], rel=VAL_TOL["rtol"], abs=VAL_TOL["atol"])
    assert fm["val_auc"] == pytest.approx(gm["val_auc"], abs=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_reverse_carrier_inverts_dcnr_from_jax(arch):
    jdims = JaxModelDims(n_users=30, n_items=20, cat_dims=(("city", 6), ("hotel_type", 5)),
                         n_num_features=11)
    kw = dict(SMALL_MODEL, arch=arch)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(1), jdims, JaxModelConfig(**kw)))
    got_params, got_bn = jax_from_dcnr(dcnr_from_jax(params, bn_state, port_dims(jdims), ModelConfig(**kw)))
    assert jax.tree.structure(got_params) == jax.tree.structure(params)
    assert jax.tree.structure(got_bn) == jax.tree.structure(bn_state)
    for a, b in zip(jax.tree.leaves((got_params, got_bn)), jax.tree.leaves((params, bn_state))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and into a module left in train mode
    model = dcnr_from_jax(params, bn_state, port_dims(jdims), ModelConfig(**kw), train=True)
    assert model.training and all(m.training for m in model.modules())
    for a, b in zip(jax.tree.leaves(jax_from_dcnr(model)), jax.tree.leaves((params, bn_state))):
        np.testing.assert_array_equal(a, b)


def test_port_export_loads_in_jax_bit_identically(tmp_path):
    bundle = load_artifact_bundle(str(ARTIFACT))
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg)
    params, bn_state = jax_from_dcnr(model)
    export_artifacts(str(tmp_path), params, bn_state, bundle.model_cfg, bundle.dims, bundle.preproc,
                     bundle.metrics, train_cfg=TrainConfig())
    theirs = jax_load_bundle(str(tmp_path))
    want = flatten_tree({"params": bundle.params, "bn_state": bundle.bn_state})
    got = flatten_tree(np_tree({"params": theirs.params, "bn_state": theirs.bn_state}))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert vars(theirs.model_cfg) == vars(bundle.model_cfg)
    assert theirs.dims.to_dict() == bundle.dims.to_dict()
    assert theirs.preproc.to_json_dict() == bundle.preproc.to_json_dict()
    np.testing.assert_array_equal(theirs.item_embeddings, bundle.item_embeddings)
    assert (tmp_path / "params.msgpack").read_bytes() == (ARTIFACT / "params.msgpack").read_bytes()


def test_msgpack_encoder_writes_the_bytes_of_the_jax_export():
    from flax import serialization

    rng = np.random.default_rng(0)
    tree = {"z": [rng.standard_normal((3, 4)).astype(np.float32), np.zeros((0, 7), np.float32)],
            "a": {f"k{i}": np.ones(i, np.uint8) for i in range(20)},
            "m": {"big": np.ones(70000, np.float32), "x" * 40: np.arange(5, dtype=np.int32)},
            "e": {}, "l": []}
    assert msgpack_serialize(tree) == serialization.to_bytes(jax.device_get(tree))


def test_jax_export_loads_in_the_port(tmp_path):
    jdims = JaxModelDims(n_users=30, n_items=20, cat_dims=(("city", 6),), n_num_features=11)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(2), jdims, JaxModelConfig(**SMALL_MODEL)))
    preproc = jax_load_bundle(str(ARTIFACT)).preproc
    jax_export(str(tmp_path), params, bn_state, JaxModelConfig(**SMALL_MODEL), jdims, preproc, {"x": 1.0})
    ours = load_artifact_bundle(str(tmp_path))
    got = flatten_tree({"params": ours.params, "bn_state": ours.bn_state})
    want = flatten_tree({"params": params, "bn_state": bn_state})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ours.metrics == {"x": 1.0} and ours.dims == port_dims(jdims)
    np.testing.assert_array_equal(ours.item_embeddings, params["item_embedding"])


def test_cli_trains_and_exports_on_the_cpu(synthetic, tmp_path):
    out = tmp_path / "artifact"
    assert cli.main(["--data", synthetic, "--out", str(out), "--epochs", "1", "--device", "cpu",
                     "model.hidden_dim=32", "train.batch_size=256"]) == 0
    theirs = jax_load_bundle(str(out))
    assert theirs.model_cfg.hidden_dim == 32
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["train_config"]["batch_size"] == 256 and manifest["train_config"]["n_epochs"] == 1
    assert np.isfinite(manifest["metrics"]["val_logloss"])
    assert load_artifact_bundle(str(out)).item_embeddings.shape == (theirs.dims.n_items, 16)


def test_cli_rejects_an_unknown_section(synthetic, tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--data", synthetic, "--out", str(tmp_path), "mesh.data_axis=2"])


@pytest.mark.parametrize("option,value,item", [
    ("lazy_table_updates", True, "ROADMAP A7"),
    ("stream_slab_steps", 4, "ROADMAP A6c"),
    ("fused_epoch", True, "ROADMAP A6c"),
    ("mesh_resident_data", True, "ROADMAP A11"),
    ("moment_dtype", "bfloat16", "ROADMAP A6c"),
    ("rng_impl", "rbg", "ROADMAP A6c"),
    ("debug_nans", True, "ROADMAP A6c"),
    ("eval_catalog_recall", True, "ROADMAP A7"),
    ("mesh", object(), "ROADMAP A11"),
    ("explicit_exchange", "all_to_all", "ROADMAP A11"),
    ("checkpoint_dir", "ckpt", "ROADMAP A6b"),
])
def test_unported_options_name_their_roadmap_item(option, value, item):
    dims = ModelDims(n_users=4, n_items=4, cat_dims=(), n_num_features=1)
    kwargs, tcfg = {}, TrainConfig()
    if hasattr(tcfg, option):
        setattr(tcfg, option, value)
    else:
        kwargs[option] = value
    with pytest.raises(NotImplementedError, match=item):
        train_dcn(None, dims, ModelConfig(), tcfg, device="cpu", **kwargs)


def test_trainer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dcn(None, ModelDims(4, 4, (), 1), ModelConfig(), TrainConfig())


def golden_configs() -> tuple:
    """hpo_r5's winner (trial 139 of benchmarks/results/hpo_r5/journal.jsonl)
    with dropout 0 and 2 epochs: the parity run of chip_smoke.py."""
    manifest = json.loads((ARTIFACT / "manifest.json").read_text())
    model_cfg = ModelConfig(**dict(manifest["model_config"], dropout=0.0))
    train_cfg = TrainConfig(lr=0.006412302371102712, batch_size=512, weight_decay=0.10000000000000006,
                            optimizer="adamw", lr_plateau_patience=3, lr_plateau_factor=0.1,
                            n_epochs=2)
    return model_cfg, train_cfg


def make_golden() -> dict:
    model_cfg, train_cfg = golden_configs()
    bundle = jax_load_bundle(str(ARTIFACT))
    splits, _ = jax_splits(str(DATA / REVIEWS))
    result = jax_train_dcn(splits, bundle.dims, JaxModelConfig(**dataclasses.asdict(model_cfg)),
                           JaxTrainConfig(**dataclasses.asdict(train_cfg)),
                           init_state=(bundle.params, bundle.bn_state))
    return {
        "artifact": "benchmarks/results/hpo_r5/best",
        "data": "data",
        "model_config": dataclasses.asdict(model_cfg),
        "train_config": dataclasses.asdict(train_cfg),
        "n_train": splits.n_train,
        "n_val": splits.n_val,
        "history": result.history,
        "final_metrics": result.final_metrics,
    }


if __name__ == "__main__":
    if "--write" not in sys.argv:
        raise SystemExit("usage: python tests/test_torch_port_train.py --write")
    jax.config.update("jax_platforms", "cpu")
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
