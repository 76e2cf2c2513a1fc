"""The retraining operator's modules against hhrs_tpu's (on the CPU): warm
start (``train/warmstart.py``), artifact evaluation (``train/evaluate.py``,
``train/eval_cli.py``), the database seed and the registry CLI
(``db/registry.py::seed_database``, ``db/cli.py``), and the trainer CLI's
``--init-from`` and ``--register-db --promote``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sqlite3

import numpy as np
import pytest

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.config import TrainConfig as JaxTrainConfig
from hhrs_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from hhrs_tpu.db.registry import seed_database as jax_seed_database
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.train import eval_cli as jax_eval_cli
from hhrs_tpu.train.artifacts import export_artifacts as jax_export
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle
from hhrs_tpu.train.evaluate import evaluate_artifacts as jax_evaluate
from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn
from hhrs_tpu.train.warmstart import extend_mapping as jax_extend_mapping
from hhrs_tpu.train.warmstart import prepare_warm_start as jax_prepare_warm_start
from hhrs_tpu_torch.config import Config, ModelConfig, TrainConfig
from hhrs_tpu_torch.data.synthetic import generate_synthetic_dataset, write_table_csv
from hhrs_tpu_torch.data.table import take
from hhrs_tpu_torch.db import cli as db_cli
from hhrs_tpu_torch.db.registry import ModelRegistry, seed_database
from hhrs_tpu_torch.models.convert import flatten_tree
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.train import cli, eval_cli
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
from hhrs_tpu_torch.train.evaluate import evaluate_artifacts
from hhrs_tpu_torch.train.trainer import train_dcn
from hhrs_tpu_torch.train.warmstart import extend_mapping, prepare_warm_start
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_port_train import VAL_TOL, jax_splits, np_tree, port_dims, port_splits

REVIEWS = "hackathon_augmented_data.csv"
# tests/test_warmstart.py's model, at dropout 0 so that both trainers' runs compare
MCFG = dict(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=1, dropout=0.0)
SMALL = ["model.emb_dim=8", "model.hidden_dim=32", "model.n_cross_layers=1", "train.batch_size=256"]


def _jax_frame(csv: str):
    from hhrs_tpu.data.features import add_engineered_features
    from hhrs_tpu.data.ingest import load_reviews_csv, noise_filter

    return add_engineered_features(noise_filter(load_reviews_csv(csv)))


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    """tests/test_warmstart.py's shape: one generation; data A holds users
    1..150 and hotels up to 160, data B every row (new users, new hotels,
    new reviews). A JAX model trained on A and exported."""
    root = tmp_path_factory.mktemp("warm")
    ds = generate_synthetic_dataset(n_users=250, n_items=90, n_reviews=8000, seed=7)
    for name, rows in (("a", (ds.reviews["guest_id"] <= 150) & (ds.reviews["hotel_id"] <= 160)),
                       ("b", np.ones(len(ds.reviews["guest_id"]), bool))):
        os.makedirs(root / name)
        write_table_csv(str(root / name / REVIEWS), take(ds.reviews, rows))
        write_table_csv(str(root / name / "friendships.csv"), ds.friendships)
    splits, art = jax_splits(str(root / "a" / REVIEWS))
    dims = JaxModelDims.from_artifacts(art)
    res = jax_train_dcn(splits, dims, JaxModelConfig(**MCFG), JaxTrainConfig(batch_size=256, n_epochs=2))
    jax_export(str(root / "artifact"), res.params, res.bn_state, JaxModelConfig(**MCFG), dims, art,
               res.final_metrics)
    return root


def test_extend_mapping_equals_jax():
    for mapping, ids in (({10: 0, 20: 1}, [20, 30, 10, 30, 40]),
                         ({}, np.array([5, 3, 5, 9, 3], np.int64)),
                         ({"x": 0}, np.array(["y", "x", "z", "y"], dtype=object))):
        assert extend_mapping(mapping, ids) == jax_extend_mapping(mapping, ids)


def _warm_starts(root):
    jws = jax_prepare_warm_start(jax_load_bundle(str(root / "artifact")), _jax_frame(str(root / "b" / REVIEWS)))
    ws = prepare_warm_start(load_artifact_bundle(str(root / "artifact")),
                            cli.load_frame(str(root / "b" / REVIEWS), Config()))
    return ws, jws


def test_warm_start_grows_the_vocabularies_as_jax_does(shipped):
    ws, jws = _warm_starts(shipped)
    assert ws.n_new_users == jws.n_new_users > 0 and ws.n_new_items == jws.n_new_items > 0
    assert ws.preproc.user_id_mapping == jws.preproc.user_id_mapping
    assert list(ws.preproc.user_id_mapping) == list(jws.preproc.user_id_mapping)
    assert ws.preproc.item_id_mapping == jws.preproc.item_id_mapping
    assert ws.dims == port_dims(jws.dims)
    for name, want in vars(jws.splits).items():
        got = getattr(ws.splits, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # frozen preprocessing, old rows and the tower copied from the artifact
    bundle = load_artifact_bundle(str(shipped / "artifact"))
    np.testing.assert_array_equal(ws.preproc.scaler.data_min, bundle.preproc.scaler.data_min)
    assert ws.preproc.cat_encoders == bundle.preproc.cat_encoders and ws.preproc.medians == bundle.preproc.medians
    for key, n_old in (("user_embedding", bundle.dims.n_users), ("item_embedding", bundle.dims.n_items)):
        np.testing.assert_array_equal(ws.params[key][:n_old], bundle.params[key])
        np.testing.assert_array_equal(ws.params[key][:n_old], np.asarray(jws.params[key])[:n_old])
        assert ws.params[key].shape == np.asarray(jws.params[key]).shape
    got, want = flatten_tree(ws.params), flatten_tree(np_tree(jws.params))
    assert got.keys() == want.keys()
    for k in want:
        if not k.startswith(("user_embedding", "item_embedding")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_warm_start_of_jax_weights_trains_as_jax_does(shipped):
    """The JAX warm start's weights, carried into the port by
    models/convert.py, fine-tuned on the port's warm-start splits: the
    trajectory of the JAX fine-tune at the trainer's bars."""
    ws, jws = _warm_starts(shipped)
    tkw = dict(batch_size=256, n_epochs=2, lr=3e-3, early_stop_patience=5)
    want = jax_train_dcn(jws.splits, jws.dims, JaxModelConfig(**MCFG), JaxTrainConfig(**tkw),
                         init_state=(jws.params, jws.bn_state))
    got = train_dcn(ws.splits, ws.dims, ModelConfig(**MCFG), TrainConfig(**tkw),
                    init_state=(np_tree(jws.params), np_tree(jws.bn_state)), device="cpu")
    np.testing.assert_allclose([h["val_loss"] for h in got.history], [h["val_loss"] for h in want.history],
                               **VAL_TOL)
    own = train_dcn(ws.splits, ws.dims, ModelConfig(**MCFG), TrainConfig(**tkw),
                    init_state=(ws.params, ws.bn_state), device="cpu")
    assert own.best_val_loss <= own.history[0]["val_loss"] and np.isfinite(own.best_val_loss)


def test_warm_start_refuses_a_feature_layout_change(shipped):
    bundle = load_artifact_bundle(str(shipped / "artifact"))
    tampered = dataclasses.replace(bundle, dims=ModelDims(bundle.dims.n_users, bundle.dims.n_items,
                                                          (("city", 3),), bundle.dims.n_num_features))
    with pytest.raises(ValueError, match="feature layout"):
        prepare_warm_start(tampered, cli.load_frame(str(shipped / "a" / REVIEWS), Config()))


@pytest.mark.parametrize("split", ["all", "val", "train"])
def test_evaluate_artifacts_matches_jax(shipped, split):
    """The JAX artifact on data B (unseen users and hotels take the serving
    fallbacks), and under a data.* override, at rtol 1e-5."""
    for overrides in ([], ["data.positive_rating=7"]):
        from hhrs_tpu.config import build_config as jax_build_config
        from hhrs_tpu_torch.config import build_config

        args = (str(shipped / "artifact"), str(shipped / "b"))
        want = jax_evaluate(*args, cfg=jax_build_config(overrides, environ={}), split=split, eval_batch=512)
        got = evaluate_artifacts(*args, cfg=build_config(overrides, environ={}), split=split, eval_batch=512,
                                 device="cpu")
        assert got.keys() == want.keys() and got["rows"] == want["rows"] > 0
        for k in ("logloss", "auc", "rmse", "recall_at_100"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_evaluate_refuses_unlabelled_data_and_unknown_splits(shipped, tmp_path):
    os.makedirs(tmp_path / "nolabel")
    with open(shipped / "b" / REVIEWS) as f:
        lines = [",".join(line.rstrip("\n").split(",")[:-1]) for line in f]
    (tmp_path / "nolabel" / REVIEWS).write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError):
        evaluate_artifacts(str(shipped / "artifact"), str(tmp_path / "nolabel"), device="cpu")
    with pytest.raises(ValueError, match="split"):
        evaluate_artifacts(str(shipped / "artifact"), str(shipped / "b"), split="test", device="cpu")


def test_eval_cli_val_split_reproduces_the_manifest(tmp_path, capsys):
    data, art = str(tmp_path / "data"), str(tmp_path / "art")
    assert cli.main(["--synthetic", "--data", data, "--out", art, "--epochs", "1", "--device", "cpu",
                     "--synth-users", "150", "--synth-items", "60", "--synth-reviews", "3000",
                     "train.eval_batch_size=512", *SMALL]) == 0
    capsys.readouterr()
    assert eval_cli.main(["--artifacts", art, "--data", data, "--split", "val", "--eval-batch", "512",
                          "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    manifest = json.loads(open(os.path.join(art, "manifest.json")).read())["metrics"]
    for k in ("logloss", "auc", "rmse"):
        assert out[k] == pytest.approx(manifest[f"val_{k}"], rel=1e-6), k
    assert jax_eval_cli.main(["--artifacts", art, "--data", data, "--split", "val", "--eval-batch", "512"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out.keys() == theirs.keys() and out["rows"] == theirs["rows"]
    assert out["logloss"] == pytest.approx(theirs["logloss"], rel=1e-5)


def _rows(db: str) -> dict:
    conn = sqlite3.connect(db)
    try:
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in ("users", "hotels", "reviews", "friendships")}
    finally:
        conn.close()


def test_seed_database_writes_the_jax_rows(shipped, tmp_path):
    for data in ("a", "b"):
        ours, theirs = str(tmp_path / f"ours_{data}.sqlite"), str(tmp_path / f"theirs_{data}.sqlite")
        counts = seed_database(ours, str(shipped / data))
        assert counts == jax_seed_database(theirs, str(shipped / data))
        assert _rows(ours) == _rows(theirs)
        assert seed_database(ours, str(shipped / data)) == counts  # idempotent
    with pytest.raises(FileNotFoundError):
        seed_database(str(tmp_path / "x.sqlite"), str(tmp_path / "nope"))


def test_db_cli_seed_register_list_active_path(shipped, tmp_path, capsys):
    db = str(tmp_path / "r.sqlite")
    assert db_cli.main(["seed", "--db", db, "--data", str(shipped / "a")]) == 0
    assert db_cli.main(["register", "--db", db, "--artifacts", str(shipped / "artifact"), "--version", "v1"]) == 0
    capsys.readouterr()
    assert db_cli.main(["list", "--db", db]) == 0
    listed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [(m["version"], m["is_active"]) for m in listed] == [("v1", True)]
    assert db_cli.main(["active-path", "--db", db]) == 0
    assert capsys.readouterr().out.strip() == os.path.abspath(shipped / "artifact")
    assert db_cli.main(["activate", "--db", db, "--model-id", "7"]) == 1  # no such model


def test_db_cli_promote_eval_data_gate(shipped, tmp_path):
    """promote --eval-data scores candidate and incumbent on one dataset: a
    copy of the active artifact ties, and a tie keeps the incumbent."""
    twin = tmp_path / "twin"
    shutil.copytree(shipped / "artifact", twin)
    db = str(tmp_path / "reg.sqlite")
    base = ["--db", db, "--eval-data", str(shipped / "b"), "--device", "cpu"]
    assert db_cli.main(["promote", "--artifacts", str(shipped / "artifact"), *base]) == 0
    assert db_cli.main(["promote", "--artifacts", str(twin), *base]) == 0
    reg = ModelRegistry(db)
    assert reg.active()["artifact_path"] == os.path.abspath(shipped / "artifact")
    models = reg.list()
    assert len(models) == 2
    for m in models:
        assert "gate_logloss" in m["metrics"] and m["metrics"]["gate_eval_data"] == os.path.abspath(shipped / "b")


def test_cli_init_from_and_promote_gate(tmp_path):
    """--init-from a port-trained artifact on a larger refreshed dataset, with
    --register-db --promote: model.* overrides give way to the artifact's
    manifest, old ids keep their rows, and the gate registers both."""
    db = str(tmp_path / "reg.sqlite")
    base = ["--synthetic", "--epochs", "2", "--device", "cpu", "--register-db", db, "--promote"]
    overrides = ["train.batch_size=256", "model.emb_dim=8", "model.hidden_dim=32"]
    assert cli.main(["--data", str(tmp_path / "da"), "--out", str(tmp_path / "a"), "--synth-users", "120",
                     "--synth-items", "50", "--synth-reviews", "2000", *base, *overrides]) == 0
    assert ModelRegistry(db).active()["artifact_path"] == os.path.abspath(tmp_path / "a")
    assert cli.main(["--data", str(tmp_path / "db"), "--out", str(tmp_path / "b"), "--init-from",
                     str(tmp_path / "a"), "--synth-users", "200", "--synth-items", "80", "--synth-reviews", "3500",
                     *base, *overrides, "model.emb_dim=4"]) == 0
    a, b = load_artifact_bundle(str(tmp_path / "a")), load_artifact_bundle(str(tmp_path / "b"))
    assert b.dims.n_users > a.dims.n_users and b.model_cfg == a.model_cfg
    for ext_id, row in a.preproc.user_id_mapping.items():
        assert b.preproc.user_id_mapping[ext_id] == row
    models = ModelRegistry(db).list()
    assert len(models) == 2 and sum(m["is_active"] for m in models) == 1
    assert jax_load_bundle(str(tmp_path / "b")).dims.n_users == b.dims.n_users  # JAX loads it
    with pytest.raises(SystemExit):
        cli.main(["--data", str(tmp_path / "da"), "--promote", "--device", "cpu"])  # --promote needs a registry


def test_port_splits_agree_with_the_jax_preprocessor_on_data_a(shipped):
    splits, _ = port_splits(str(shipped / "a" / REVIEWS))
    want, _ = JaxPreprocessor().fit_transform(_jax_frame(str(shipped / "a" / REVIEWS)))
    np.testing.assert_array_equal(splits.val_user, want.val_user)
