"""The retraining path's host side against hhrs_tpu's: the layered config
(presets, ``HHRS_*`` environment, tokens), the CLIs' flag sets, the
synthetic generator, ``transform_with_artifacts``, the dataset cache and
the profiling hooks (on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

from hhrs_tpu import config as jax_config
from hhrs_tpu import pipeline as jax_pipeline
from hhrs_tpu.data.features import add_engineered_features as jax_features
from hhrs_tpu.data.ingest import load_reviews_csv as jax_load_reviews
from hhrs_tpu.data.ingest import noise_filter as jax_noise_filter
from hhrs_tpu.data.preprocess import PreprocessArtifacts as JaxArtifacts
from hhrs_tpu.data.preprocess import transform_with_artifacts as jax_transform
from hhrs_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from hhrs_tpu.data.synthetic import write_synthetic_dataset as jax_write
from hhrs_tpu.db import cli as jax_db_cli
from hhrs_tpu.train import cli as jax_train_cli
from hhrs_tpu.train import eval_cli as jax_eval_cli
from hhrs_tpu_torch import config, pipeline
from hhrs_tpu_torch.data import cache
from hhrs_tpu_torch.data.features import add_engineered_features
from hhrs_tpu_torch.data.ingest import load_reviews_csv, noise_filter
from hhrs_tpu_torch.data.preprocess import PreprocessArtifacts, transform_with_artifacts
from hhrs_tpu_torch.data.synthetic import append_reviews, generate_synthetic_dataset, write_synthetic_dataset
from hhrs_tpu_torch.db import cli as db_cli
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.train import cli, eval_cli
from hhrs_tpu_torch.train.trainer import train_dcn
from tests.torch_port_mesh_train_world import one_rank_world
from hhrs_tpu_torch.utils.profiling import StepTimer, trace
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

REVIEWS = "hackathon_augmented_data.csv"
SMALL = ["model.emb_dim=8", "model.hidden_dim=32", "model.n_cross_layers=1", "model.n_res_blocks=1",
         "train.batch_size=256"]
ENVS = [
    {},
    {"HHRS_SERVE_PORT": "8765", "HHRS_TRAIN_BATCH_SIZE": "1024", "HHRS_DATA_LEAKAGE_COMPAT": "false",
     "HHRS_MODEL_STORAGE_DTYPE": "bfloat16", "UNRELATED": "x", "HHRS_BENCH_BUDGET_S": "600"},
    {"HHRS_PRESET": "tuned", "HHRS_TRAIN_RNG_IMPL": "threefry2x32", "HHRS_MESH_EXPLICIT_EXCHANGE": "psum"},
]
TOKENS = [[], ["train.batch_size=64", "model.emb_dim=8", "data.categorical_cols=city,hotel_type",
               "serve.city_bounded=false", "retrieval.mmr_top_k=5"]]


@pytest.mark.parametrize("preset", [None, "tuned", "reference"])
@pytest.mark.parametrize("env", range(len(ENVS)))
@pytest.mark.parametrize("tokens", range(len(TOKENS)))
def test_build_config_matches_jax(preset, env, tokens):
    got = config.build_config(TOKENS[tokens], preset=preset, environ=ENVS[env])
    want = jax_config.build_config(TOKENS[tokens], preset=preset, environ=ENVS[env])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]


@pytest.mark.parametrize("env,match", [
    ({"HHRS_SRVE_PORT": "8000"}, "unknown config environment"),
    ({"HHRS_SERVE_PORTT": "8000"}, "no field"),
])
def test_env_mistakes_fail_as_jax_does(env, match):
    for build in (config.build_config, jax_config.build_config):
        with pytest.raises(ValueError, match=match):
            build([], environ=env)


def test_unknown_preset_and_bad_token_fail_as_jax_does():
    for mod in (config, jax_config):
        with pytest.raises(ValueError, match="unknown preset"):
            mod.build_config([], preset="turbo", environ={})
        with pytest.raises(SystemExit):
            mod.build_config(["train.batch_size", "1024"], environ={})


def test_mesh_fields_are_refused_naming_a11(tmp_path, monkeypatch):
    """The ``mesh.*`` fields and ``--mesh`` / ``--distributed`` are accepted
    and reach ``train_dcn``, the trainer options with them: the config
    refuses none of them on a mesh (lazy table updates and slab streaming
    run there) and names no ROADMAP item."""
    cfg = config.build_config(["mesh.data_axis=2", "mesh.explicit_exchange=capped",
                               "mesh.exchange_capacity_factor=1.5", "train.lazy_table_updates=true",
                               "train.stream_slab_steps=4"], environ={})
    assert (cfg.mesh.data_axis, cfg.mesh.explicit_exchange, cfg.mesh.exchange_capacity_factor) == (2, "capped", 1.5)
    assert cfg.train.lazy_table_updates and cfg.train.stream_slab_steps == 4
    assert not hasattr(config, "unported_mesh_train_options")
    assert "A11" not in Path(config.__file__).read_text()
    seen = []

    class Reached(Exception):
        pass

    seen_args = []

    def fake_train_dcn(*args, **kwargs):
        seen.append(kwargs)
        seen_args.append(args)
        raise Reached

    monkeypatch.setattr(cli, "train_dcn", fake_train_dcn)
    data = str(tmp_path / "data")
    base = ["--data", data, "--synthetic", "--synth-users", "40", "--synth-items", "12", "--synth-reviews", "600",
            "--device", "cpu", "--out", str(tmp_path / "out"), "mesh.explicit_exchange=all_to_all",
            "train.stream_slab_steps=4"]
    with one_rank_world(str(tmp_path)):
        for flags in (["--mesh", "1x1"], ["--distributed"]):
            with pytest.raises(Reached):
                cli.main([*base, *flags])
    assert [tuple(k["mesh"].shape) for k in seen] == [(1, 1), (1, 1)]
    assert all(k["explicit_exchange"] == "all_to_all" and k["exchange_capacity_factor"] == 1.25 for k in seen)
    assert [a[3].stream_slab_steps for a in seen_args] == [4, 4]


def _flags(main, argv_prefix=()) -> set:
    """The options a CLI's --help lists."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main([*argv_prefix, "--help"])
    return set(re.findall(r"(?m)^\s+(--[a-z][\w-]*)", out.getvalue()))


@pytest.mark.parametrize("name,ours,theirs,prefix", [
    ("train", cli.main, jax_train_cli.main, ()),
    ("eval", eval_cli.main, jax_eval_cli.main, ()),
    ("pipeline", pipeline.main, jax_pipeline.main, ()),
    ("db promote", db_cli.main, jax_db_cli.main, ("promote",)),
    ("db seed", db_cli.main, jax_db_cli.main, ("seed",)),
])
def test_cli_flags_are_jax_flags_plus_device(name, ours, theirs, prefix):
    got, want = _flags(ours, prefix), _flags(theirs, prefix)
    assert "--data" in want or "--db" in want
    extra = set() if name == "db seed" else {"--device"}
    assert got == want | extra, name


@pytest.mark.parametrize("kw", [
    dict(n_users=300, n_items=80, n_reviews=6000, seed=11),
    dict(n_users=50, n_items=120, n_reviews=900, n_friendships=400, n_cities=3, latent_dim=4, seed=3),
])
def test_synthetic_tables_equal_jax_columns(kw):
    ours, theirs = generate_synthetic_dataset(**kw), jax_generate(**kw)
    assert list(ours.reviews) == list(theirs.reviews.columns)
    for col in theirs.reviews.columns:
        want = theirs.reviews[col].to_numpy()
        np.testing.assert_array_equal(ours.reviews[col], want, err_msg=col)
        assert ours.reviews[col].dtype == want.dtype, col
    for col in ("user_id_1", "user_id_2"):
        np.testing.assert_array_equal(ours.friendships[col], theirs.friendships[col].to_numpy())


def test_synthetic_csvs_are_the_jax_bytes(tmp_path):
    kw = dict(n_users=120, n_items=50, n_reviews=2500, seed=5)
    write_synthetic_dataset(str(tmp_path / "ours"), **kw)
    jax_write(str(tmp_path / "theirs"), **kw)
    for name in (REVIEWS, "friendships.csv"):
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes(), name
    append_reviews(str(tmp_path / "ours"), 77_000_001, n=3, rating=9)
    rows = (tmp_path / "ours" / REVIEWS).read_text().splitlines()
    assert len(rows) == 2500 + 1 + 3 and rows[-1].startswith("77000001,")


def test_transform_with_artifacts_equals_jax(tmp_path):
    """Saved preprocessing on fresher data: unseen users, items and a
    category fall back as the JAX function falls back."""
    jax_write(str(tmp_path / "fit"), n_users=100, n_items=40, n_reviews=1500, seed=3)
    jax_write(str(tmp_path / "fresh"), n_users=160, n_items=70, n_reviews=1500, n_cities=8, seed=4)
    from hhrs_tpu.data.preprocess import Preprocessor as JaxPreprocessor

    frame = jax_features(jax_noise_filter(jax_load_reviews(str(tmp_path / "fit" / REVIEWS))))
    _, jart = JaxPreprocessor().fit_transform(frame)
    jart.save(str(tmp_path / "preproc.json"))
    ours_art = PreprocessArtifacts.load(str(tmp_path / "preproc.json"))
    theirs_art = JaxArtifacts.load(str(tmp_path / "preproc.json"))
    csv = str(tmp_path / "fresh" / REVIEWS)
    want = jax_transform(theirs_art, jax_features(jax_noise_filter(jax_load_reviews(csv))))
    got = transform_with_artifacts(ours_art, add_engineered_features(noise_filter(load_reviews_csv(csv))))
    assert got.keys() == want.keys() == {"user", "item", "cat", "num", "y"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["user"] == theirs_art.unknown_user_id).any() and (want["cat"] == 0).any()


@pytest.fixture(scope="module")
def small_data(tmp_path_factory) -> str:
    d = str(tmp_path_factory.mktemp("cfgdata"))
    write_synthetic_dataset(d, n_users=150, n_items=60, n_reviews=3000, seed=9)
    return d


def test_dataset_cache_round_trip_is_bitwise(small_data, tmp_path):
    cfg = config.Config()
    fresh = cli.build_dataset(small_data, cfg)
    first = cli.build_dataset(small_data, cfg, cache_dir=str(tmp_path))
    key = cache.cache_key(os.path.join(small_data, REVIEWS), cli.cache_knobs(cfg))
    assert sorted(os.listdir(tmp_path)) == [f"{key}.npz", f"{key}.preproc.json"]
    hit = cache.load(str(tmp_path), key)
    for got in (first, hit):
        for name, want in vars(fresh[0]).items():
            arr = getattr(got[0], name)
            assert arr.dtype == want.dtype
            np.testing.assert_array_equal(arr, want, err_msg=name)
        assert got[1].to_json_dict() == fresh[1].to_json_dict()
    (tmp_path / f"{key}.npz").write_bytes(b"torn")
    assert cache.load(str(tmp_path), key) is None  # a torn entry is a miss


def test_dataset_cache_key_follows_the_knobs_and_the_file(small_data, tmp_path):
    csv = os.path.join(small_data, REVIEWS)
    base = cli.cache_knobs(config.Config())
    key = cache.cache_key(csv, base)
    assert cache.cache_key(csv, dict(base)) == key
    for change in ({"pos": 7.0}, {"seed": 1}, {"leakage": False}, {"num": ["stars"]}):
        assert cache.cache_key(csv, {**base, **change}) != key, change
    copy = tmp_path / REVIEWS
    copy.write_bytes(open(csv, "rb").read())
    assert cache.cache_key(str(copy), base) != key  # another path
    os.utime(csv, ns=(1, 1))
    assert cache.cache_key(csv, base) != key  # another mtime


def test_cli_metrics_log_cache_and_profile(small_data, tmp_path):
    args = ["--data", small_data, "--device", "cpu", "--epochs", "2", *SMALL]
    log_path, prof = tmp_path / "m.jsonl", tmp_path / "prof"
    assert cli.main([*args, "--out", str(tmp_path / "a"), "--cache-dir", str(tmp_path / "c"),
                     "--metrics-log", str(log_path), "--profile-dir", str(prof)]) == 0
    records = [json.loads(line) for line in log_path.read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1] and all("val_loss" in r and "ts" in r for r in records)
    trace_json = json.loads((prof / "trace.json").read_text())
    assert trace_json["traceEvents"]
    assert len(os.listdir(tmp_path / "c")) == 2
    # a second run hits the cache and trains the same model
    assert cli.main([*args, "--out", str(tmp_path / "b"), "--cache-dir", str(tmp_path / "c")]) == 0
    ma = json.loads((tmp_path / "a" / "manifest.json").read_text())["metrics"]
    mb = json.loads((tmp_path / "b" / "manifest.json").read_text())["metrics"]
    assert ma == mb


def test_trace_and_step_timer(tmp_path):
    import torch

    with trace(str(tmp_path)):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    t = StepTimer()
    with pytest.raises(RuntimeError):
        t.stop()
    assert t.summary() == {"steps": 0}
    for _ in range(3):
        t.start()
        t.stop()
    s = t.summary(examples_per_step=10)
    assert s["steps"] == 3 and s["examples_per_s"] > 0 and s["min_ms"] <= s["mean_ms"]


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_rng_impls_draw_the_same_stream(small_data, impl):
    splits, art = cli.build_dataset(small_data, config.Config())
    dims = ModelDims.from_artifacts(art)
    mcfg = config.ModelConfig(emb_dim=8, hidden_dim=32, n_cross_layers=1, dropout=0.3)
    tcfg = config.TrainConfig(batch_size=256, n_epochs=1, eval_batch_size=512)
    base = train_dcn(splits, dims, mcfg, tcfg, device="cpu")
    got = train_dcn(splits, dims, mcfg, dataclasses.replace(tcfg, rng_impl=impl), device="cpu")
    assert got.history == base.history


def test_unknown_rng_impl_is_refused_with_the_jax_message():
    from hhrs_tpu.config import ModelConfig as JaxModelConfig
    from hhrs_tpu.config import TrainConfig as JaxTrainConfig
    from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
    from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn

    messages = []
    for run, mcfg, tcfg, dims in (
            (train_dcn, config.ModelConfig(), config.TrainConfig(rng_impl="philox"), ModelDims(4, 4, (), 1)),
            (jax_train_dcn, JaxModelConfig(), JaxTrainConfig(rng_impl="philox"), JaxModelDims(4, 4, (), 1))):
        with pytest.raises(ValueError) as err:
            run(None, dims, mcfg, tcfg, **({"device": "cpu"} if run is train_dcn else {}))
        messages.append(str(err.value))
    assert messages[0] == messages[1] == ("unknown train.rng_impl 'philox'; expected 'threefry2x32' or 'rbg'")


def test_tuned_preset_trains_one_step_of_32768_on_the_cpu(tmp_path):
    """The acceptance command: --synthetic --preset tuned at 80,000 reviews,
    one epoch of one 32,768-row step at bf16 compute and storage."""
    data, out = tmp_path / "d", tmp_path / "a"
    assert cli.main(["--synthetic", "--data", str(data), "--out", str(out), "--preset", "tuned", "--device", "cpu",
                     "--epochs", "1", "--synth-reviews", "80000"]) == 0
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["train_config"]["batch_size"] == 32768 and manifest["train_config"]["rng_impl"] == "rbg"
    assert manifest["model_config"]["storage_dtype"] == "bfloat16"
    assert np.isfinite(manifest["metrics"]["val_logloss"])
    splits, _ = cli.build_dataset(str(data), config.Config())
    assert 32768 <= splits.n_train < 2 * 32768
