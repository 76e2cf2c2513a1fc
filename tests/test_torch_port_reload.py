"""Hot reload and the model registry on the port's stack: the registry and
data reload cases of ``tests/test_serve_reload.py``, run on
``hhrs_tpu_torch/serve/reload.py`` with the port's engines (on the CPU)
serving artifacts the JAX trainer wrote; and the port's
``db/registry.py`` and ``data_fingerprint`` against the JAX package's.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request

import pytest

from hhrs_tpu.config import ModelConfig, TrainConfig
from hhrs_tpu.data import Preprocessor, add_engineered_features
from hhrs_tpu.data.ingest import noise_filter
from hhrs_tpu.data.synthetic import append_reviews, write_synthetic_dataset
from hhrs_tpu.db import registry as jax_registry
from hhrs_tpu.models.dcn import ModelDims
from hhrs_tpu.serve import reload as jax_reload
from hhrs_tpu.train.artifacts import export_artifacts
from hhrs_tpu.train.trainer import train_dcn
from hhrs_tpu_torch.db import registry as port_registry
from hhrs_tpu_torch.db.registry import ModelRegistry, connect, create_schema, resolve_artifacts_dir
from hhrs_tpu_torch.serve import reload
from hhrs_tpu_torch.serve.engine import RecommendationEngine, load_frames
from hhrs_tpu_torch.serve.http import make_server
from hhrs_tpu_torch.serve.reload import (
    DataReloader, FramesCache, RegistryReloader, SwappableEngine, data_fingerprint)
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture


@pytest.fixture(scope="module")
def setup(tmp_path_factory, one_torch_thread):  # noqa: F811
    """A synthetic data dir and two models the JAX trainer fitted on it
    (the fixture of tests/test_serve_reload.py)."""
    tmp = tmp_path_factory.mktemp("port_reload")
    data_dir = str(tmp / "data")
    ds = write_synthetic_dataset(data_dir, n_users=120, n_items=60, n_reviews=2500, seed=45)
    main_df = add_engineered_features(ds.reviews.rename(columns={"guest_id": "user_id", "hotel_id": "item_id"}))
    splits, art = Preprocessor().fit_transform(noise_filter(main_df.copy()))
    dims = ModelDims.from_artifacts(art)
    mcfg = ModelConfig(emb_dim=8, hidden_dim=32, n_cross_layers=1, n_res_blocks=1)
    dirs = []
    for seed in (0, 1):
        r = train_dcn(splits, dims, mcfg, TrainConfig(lr=3e-3, batch_size=256, n_epochs=1, seed=seed))
        out = str(tmp / f"artifacts_{seed}")
        export_artifacts(out, r.params, r.bn_state, mcfg, dims, art, r.final_metrics)
        dirs.append(out)
    return {"tmp": tmp, "data": data_dir, "dirs": dirs}


def _db(setup, name: str) -> str:
    path = str(setup["tmp"] / name)
    conn = connect(path)
    create_schema(conn)
    conn.close()
    return path


def build_for(data_dir):
    """The production build_stack shape: re-reads the data dir's CSVs."""
    def build(adir, frames=None):
        return RecommendationEngine.from_dirs(adir, data_dir, device="cpu", frames=frames)
    return build


def users_of(holder) -> set:
    return {int(u) for u in holder.gen.universe.user_ids}


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read().decode())


# ---------------------------------------------------------------- registry reload

def test_hot_reload_swaps_active_model(setup):
    dir_a, dir_b = (os.path.abspath(d) for d in setup["dirs"])
    db = _db(setup, "reg_swap.sqlite")
    reg = ModelRegistry(db)
    reg.register("v_a", dir_a, activate=True)
    build = build_for(setup["data"])
    holder = SwappableEngine(build(dir_a))
    reloader = RegistryReloader(holder, f"registry:{db}", build, poll_s=3600, current_dir=dir_a)
    server = make_server(holder, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert _get(base + "/healthz")["model"] == dir_a
        assert reloader.check_once() is False
        reg.register("v_b", dir_b, activate=True)
        assert reloader.check_once() is True
        h = _get(base + "/healthz")
        assert h["model"] == dir_b and h["status"] == "ok" and h["hot_swaps"] == 1
        uni = holder.gen.universe
        req = urllib.request.Request(base + "/recommendations", data=json.dumps(
            {"user_id": int(uni.user_ids[0]), "city": uni.cities[0], "type": "friends", "lambda_param": 1.0}).encode())
        with urllib.request.urlopen(req) as r:
            assert r.status == 200 and "ranked_hotels" in json.loads(r.read().decode())
    finally:
        server.shutdown()
        server.server_close()


def test_failed_reload_keeps_serving(setup):
    dir_a = os.path.abspath(setup["dirs"][0])
    db = _db(setup, "reg_fail.sqlite")
    reg = ModelRegistry(db)
    reg.register("v_good", dir_a, activate=True)
    build = build_for(setup["data"])
    holder = SwappableEngine(build(dir_a))
    reloader = RegistryReloader(holder, f"registry:{db}", build, poll_s=3600, current_dir=dir_a)
    reg.register("v_broken", dir_a + "_nonexistent", activate=True)
    assert reloader.check_once() is False
    assert holder.artifacts_dir == dir_a
    uni = holder.gen.universe
    assert "ranked_hotels" in holder.recommend(int(uni.user_ids[0]), uni.cities[0], "friends", 1.0)
    reg.register("v_good_2", dir_a, activate=True)  # same dir, new registration: swaps
    assert reloader.check_once() is True
    assert holder.artifacts_dir == dir_a


def test_post_boot_reregister_over_same_dir_swaps(setup):
    dir_a = setup["dirs"][0]
    db = _db(setup, "reg_adopt.sqlite")
    reg = ModelRegistry(db)
    reg.register("adopt-v1", dir_a)
    built = []
    build = build_for(setup["data"])

    def counting_build(adir, frames=None):
        built.append(adir)
        return build(adir, frames)

    holder = SwappableEngine(build(dir_a))
    reloader = RegistryReloader(holder, f"registry:{db}", counting_build, poll_s=3600, current_dir=dir_a)
    reloader.current_key = (None, dir_a)  # the init read failed
    assert reloader.check_once() is False and built == []
    assert reloader.current_key[0] is not None
    reloader.current_key = (None, dir_a)
    reloader._boot_at = 0.0
    reg.register("adopt-v2", dir_a)
    assert reloader.check_once() is True and built == [dir_a]
    assert reloader.check_once() is False and built == [dir_a]


def test_registry_reload_parses_snapshot_despite_racing_writer(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    seen = []

    def frames_loader(d):
        seen.append(d)
        return load_frames(d)

    def build2(adir, frames=None):
        assert frames is not None
        append_reviews(data_dir, 60_000_001)  # a writer races the rebuild
        return RecommendationEngine.from_dirs(adir, data_dir, device="cpu", frames=frames)

    db = _db(setup, "reg_snap.sqlite")
    reg = ModelRegistry(db)
    reg.register("v1", art_dir, activate=True)
    holder = SwappableEngine(build_for(data_dir)(art_dir))
    reloader = RegistryReloader(holder, f"registry:{db}", build2, poll_s=3600, current_dir=art_dir,
                                data_dir=data_dir, frames_loader=frames_loader)
    reg.register("v2", art_dir, activate=True)
    assert reloader.check_once() is True
    assert seen and seen[0] != data_dir  # a temp snapshot, not the live dir


def test_registry_reload_reuses_cached_frames_when_data_unchanged(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    parses = []

    def frames_loader(d):
        parses.append(d)
        return load_frames(d)

    cache = FramesCache(data_fingerprint(data_dir), frames_loader(data_dir))
    db = _db(setup, "reg_cache.sqlite")
    reg = ModelRegistry(db)
    reg.register("v1", art_dir, activate=True)
    build = build_for(data_dir)
    holder = SwappableEngine(build(art_dir))
    reloader = RegistryReloader(holder, f"registry:{db}", build, poll_s=3600, current_dir=art_dir,
                                data_dir=data_dir, frames_loader=frames_loader, frames_cache=cache)
    reg.register("v2", art_dir, activate=True)
    assert reloader.check_once() is True and parses == [data_dir]
    append_reviews(data_dir, 70_000_001)
    reg.register("v3", art_dir, activate=True)
    assert reloader.check_once() is True
    assert len(parses) == 2 and parses[1] != data_dir


def test_registry_swap_advances_data_reloader_baseline(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    builds = []
    build = build_for(data_dir)

    def build2(adir, frames=None):
        builds.append(adir)
        assert frames is not None
        return build(adir, frames)

    db = _db(setup, "reg_advance.sqlite")
    reg = ModelRegistry(db)
    reg.register("v1", art_dir, activate=True)
    fp0 = data_fingerprint(data_dir)
    cache = FramesCache(fp0, load_frames(data_dir))
    holder = SwappableEngine(build(art_dir))
    lock = threading.Lock()
    reloader = RegistryReloader(holder, f"registry:{db}", build2, poll_s=3600, current_dir=art_dir,
                                swap_lock=lock, data_dir=data_dir, frames_loader=load_frames,
                                frames_cache=cache)
    dr = DataReloader(holder, data_dir, build2, poll_s=3600, current_dir_fn=lambda: reloader.current_dir,
                      swap_lock=lock, frames_loader=load_frames, baseline_fp=fp0, frames_cache=cache)
    reloader.data_reloader = dr
    append_reviews(data_dir, 72_000_001)
    reg.register("v2", art_dir, activate=True)
    assert reloader.check_once() is True and len(builds) == 1
    served = holder.current
    for _ in range(3):
        assert dr.check_once() is False
    assert holder.current is served and len(builds) == 1
    assert 72_000_001 in users_of(holder)


# ---------------------------------------------------------------- data reload

def test_data_reload_swaps_on_stable_change(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    build = build_for(data_dir)
    holder = SwappableEngine(build(art_dir))
    dr = DataReloader(holder, data_dir, build, poll_s=3600, current_dir_fn=lambda: art_dir)
    first = holder.current
    assert dr.check_once() is False and holder.current is first
    new_user = 10_987_654
    assert new_user not in users_of(holder)
    append_reviews(data_dir, new_user)
    assert dr.check_once() is False and holder.current is first  # debounce
    assert dr.check_once() is True and holder.current is not first
    assert new_user in users_of(holder)
    assert "ranked_hotels" in holder.recommend(new_user, holder.gen.universe.cities[0], "personal", 1.0)
    assert dr.check_once() is False


def test_data_reload_debounces_mid_write_churn(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    builds = []
    build = build_for(data_dir)

    def counting_build(adir, frames=None):
        builds.append(adir)
        return build(adir, frames)

    holder = SwappableEngine(build(art_dir))
    dr = DataReloader(holder, data_dir, counting_build, poll_s=3600, current_dir_fn=lambda: art_dir)
    for uid in (20_000_001, 20_000_002, 20_000_003):
        append_reviews(data_dir, uid)
        assert dr.check_once() is False
    assert builds == []
    assert dr.check_once() is True and builds == [art_dir]


def test_data_reload_failed_parse_keeps_serving(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    build = build_for(data_dir)
    holder = SwappableEngine(build(art_dir))
    dr = DataReloader(holder, data_dir, build, poll_s=3600, current_dir_fn=lambda: art_dir)
    first = holder.current
    p = os.path.join(data_dir, "hackathon_augmented_data.csv")
    good = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(b"guest_id,hotel_id\n1,2\n")  # missing required columns
    assert dr.check_once() is False  # debounce
    assert dr.check_once() is False  # the parse failed
    assert holder.current is first and dr._failed_fp is not None
    uni = holder.gen.universe
    assert "ranked_hotels" in holder.recommend(int(uni.user_ids[0]), uni.cities[0], "friends", 1.0)
    with open(p, "wb") as f:
        f.write(good)
    append_reviews(data_dir, 30_000_001)
    assert dr.check_once() is False
    assert dr.check_once() is True and holder.current is not first


def test_data_reload_discards_engine_on_mid_build_change(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    uid = iter(range(40_000_001, 40_000_010))
    build = build_for(data_dir)

    def racing_build(adir, frames=None):
        eng = build(adir, frames)
        append_reviews(data_dir, next(uid))
        return eng

    holder = SwappableEngine(build(art_dir))
    dr = DataReloader(holder, data_dir, racing_build, poll_s=3600, current_dir_fn=lambda: art_dir)
    first = holder.current
    append_reviews(data_dir, next(uid))
    assert dr.check_once() is False
    assert dr.check_once() is False  # built, then saw the race: discarded
    assert holder.current is first
    assert dr._pending == data_fingerprint(data_dir)


def test_data_reload_snapshot_survives_concurrent_writes(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    calls = []

    def build2(adir, frames):
        calls.append(adir)
        append_reviews(data_dir, 50_000_000 + len(calls))  # a writer races every rebuild
        return RecommendationEngine.from_dirs(adir, data_dir, device="cpu", frames=frames)

    holder = SwappableEngine(build_for(data_dir)(art_dir))
    dr = DataReloader(holder, data_dir, build2, poll_s=3600, current_dir_fn=lambda: art_dir,
                      frames_loader=load_frames)
    first = holder.current
    append_reviews(data_dir, 50_999_999)
    assert dr.check_once() is False
    assert dr.check_once() is True and holder.current is not first
    assert 50_999_999 in users_of(holder) and 50_000_001 not in users_of(holder)
    assert dr.check_once() is False
    assert dr.check_once() is True and 50_000_001 in users_of(holder)
    assert calls == [art_dir, art_dir]


def test_data_reloader_honors_pre_parse_baseline_fingerprint(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    build = build_for(data_dir)
    fp_before_parse = data_fingerprint(data_dir)
    append_reviews(data_dir, 61_000_001)
    holder = SwappableEngine(build(art_dir))
    dr = DataReloader(holder, data_dir, build, poll_s=3600, current_dir_fn=lambda: art_dir,
                      baseline_fp=fp_before_parse)
    assert dr.check_once() is False
    assert dr.check_once() is True and 61_000_001 in users_of(holder)


def test_data_reloader_reuses_cached_frames(setup):
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    parses = []

    def frames_loader(d):
        parses.append(d)
        return load_frames(d)

    build = build_for(data_dir)
    cache = FramesCache()
    holder = SwappableEngine(build(art_dir))
    dr = DataReloader(holder, data_dir, build, poll_s=3600, current_dir_fn=lambda: art_dir,
                      frames_loader=frames_loader, baseline_fp=data_fingerprint(data_dir), frames_cache=cache)
    first = holder.current
    append_reviews(data_dir, 71_000_001)
    cache.put(data_fingerprint(data_dir), frames_loader(data_dir))
    assert dr.check_once() is False
    assert dr.check_once() is True and holder.current is not first
    assert len(parses) == 1 and 71_000_001 in users_of(holder)


def test_swapped_out_stack_is_closed_after_the_grace(setup, monkeypatch):
    """_defer_close closes the old stack once its grace period is over (on
    a card that frees its CUDA graphs)."""
    monkeypatch.setattr(reload, "OLD_STACK_CLOSE_GRACE_S", 0.05)
    data_dir, art_dir = setup["data"], setup["dirs"][0]
    closed = threading.Event()

    class Old:
        def close(self):
            closed.set()

    holder = SwappableEngine(Old())
    dr = DataReloader(holder, data_dir, build_for(data_dir), poll_s=3600, current_dir_fn=lambda: art_dir)
    append_reviews(data_dir, 74_000_001)
    assert dr.check_once() is False and not closed.is_set()
    assert dr.check_once() is True
    assert closed.wait(5) and holder.swap_count == 1


# ---------------------------------------------------------------- against the JAX package

def test_data_fingerprint_and_snapshot_equal_jax(setup, tmp_path):
    data_dir = setup["data"]
    assert data_fingerprint(data_dir) == jax_reload.data_fingerprint(data_dir)
    missing = str(tmp_path / "nope")
    assert data_fingerprint(missing) == jax_reload.data_fingerprint(missing)
    snap = reload.snapshot_data_dir(data_dir)
    try:
        assert data_fingerprint(snap) == jax_reload.data_fingerprint(data_dir)
    finally:
        import shutil

        shutil.rmtree(snap)
    assert reload.DATA_FILES == jax_reload.DATA_FILES


def _rows(reg) -> list:
    return [{k: v for k, v in r.items() if k != "created_at"} for r in reg.list()]


def test_registry_written_by_jax_is_read_by_the_port(setup):
    db = str(setup["tmp"] / "jax_written.sqlite")
    jreg = jax_registry.ModelRegistry(db, create=True)
    jreg.register("v1", setup["dirs"][0], metrics={"val_logloss": 0.5})
    jreg.promote_if_better(None, setup["dirs"][1], {"val_logloss": 0.4})
    preg = ModelRegistry(db)
    assert _rows(preg) == _rows(jreg) and preg.active() == jreg.active()
    assert resolve_artifacts_dir(f"registry:{db}") == jax_registry.resolve_artifacts_dir(f"registry:{db}") \
        == os.path.abspath(setup["dirs"][1])


def test_registry_written_by_the_port_is_read_by_jax(setup):
    db = str(setup["tmp"] / "port_written.sqlite")
    preg = ModelRegistry(db, create=True)
    preg.register(None, setup["dirs"][0], metrics={"val_auc": 0.7}, hyperparams={"lr": 1e-3})
    _, promoted, _ = preg.promote_if_better(None, setup["dirs"][1], {"val_auc": 0.6}, metric="val_auc")
    assert not promoted
    preg.activate(2)
    jreg = jax_registry.ModelRegistry(db)
    assert _rows(jreg) == _rows(preg) and jreg.active() == preg.active()
    assert [r["version"] for r in jreg.list()] == ["v1", "v2"]
    with pytest.raises(FileNotFoundError):
        ModelRegistry(str(setup["tmp"] / "absent.sqlite"))


def test_schema_equals_jax(setup):
    sql = {}
    for name, mod in (("jax", jax_registry), ("port", port_registry)):
        path = str(setup["tmp"] / f"schema_{name}.sqlite")
        conn = mod.connect(path)
        mod.create_schema(conn)
        sql[name] = conn.execute("SELECT name, sql FROM sqlite_master ORDER BY name").fetchall()
        conn.close()
    assert sql["port"] == sql["jax"]

