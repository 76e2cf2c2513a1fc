"""The serving stacks over a mesh: the port's canary, shadow, registry reload
and data reload on a gloo world of 2 CPU processes, against the JAX
package's mesh engines and arms on ``tests/conftest.py``'s 8 virtual
devices.

The fixture is ``tests/test_serve_mesh.py``'s (220 users, 121 items, 6,000
reviews, seed 33; a small DCN-R trained by the JAX trainer), with seeded
noise on every weight for the canary, the shadow and the registry's second
model (``tests/test_torch_port_serve_stack.py::perturbed_artifact``). The
world is spawned once for the module (``torch_port_mesh_reload_world.py``
drives the CLI's stack on it) and joins under a time limit of its own, so a
hang fails its tests instead of the suite. Every response must be the JSON
of the JAX mesh engine of its arm, the arms' stats JAX's on the same
requests, and every engine the world closed or discarded must be gone from
both ranks while the world serves on.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
import types
import urllib.request

import jax
import numpy as np
import pytest

from hhrs_tpu.config import ModelConfig, TrainConfig
from hhrs_tpu.data import Preprocessor, add_engineered_features
from hhrs_tpu.data.ingest import load_reviews_csv, noise_filter
from hhrs_tpu.data.synthetic import write_synthetic_dataset
from hhrs_tpu.models.dcn import ModelDims
from hhrs_tpu.parallel import mesh as jax_mesh
from hhrs_tpu.serve.canary import CanaryEngine as JaxCanary
from hhrs_tpu.serve.canary import routes_to_canary
from hhrs_tpu.serve.engine import RecommendationEngine as JaxEngine
from hhrs_tpu.serve.shadow import ShadowEngine as JaxShadow
from hhrs_tpu.train.artifacts import export_artifacts
from hhrs_tpu.train.trainer import train_dcn
from hhrs_tpu_torch.db.registry import ModelRegistry
from hhrs_tpu_torch.parallel import distributed
from tests.test_torch_port_mesh import REPO, _alive, _free_port, _ranks_of
from tests.test_torch_port_serve_stack import perturbed_artifact
from tests.torch_port_mesh_reload_world import stack_checks

WORLD_TIMEOUT_S = 240  # the world's join: every check of the module on it
FRACTION = 0.5
NEW_USER = 31_000_001


def _json(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("torch_port_mesh_reload")
    data, artifacts = str(tmp / "data"), str(tmp / "artifacts")
    write_synthetic_dataset(data, n_users=220, n_items=121, n_reviews=6000, seed=33)
    main_df = add_engineered_features(load_reviews_csv(os.path.join(data, "hackathon_augmented_data.csv")))
    splits, art = Preprocessor().fit_transform(noise_filter(main_df.copy()))
    dims = ModelDims.from_artifacts(art)
    mcfg = ModelConfig(emb_dim=8, hidden_dim=32, n_cross_layers=1, n_res_blocks=1, dropout=0.2)
    result = train_dcn(splits, dims, mcfg, TrainConfig(lr=3e-3, batch_size=512, n_epochs=2))
    export_artifacts(artifacts, result.params, result.bn_state, mcfg, dims, art, result.final_metrics)
    dirs = {name: perturbed_artifact(str(tmp / name), seed=seed, source=artifacts)
            for name, seed in (("canary", 1), ("second", 2), ("shadow", 3))}
    poison = str(tmp / "poison")
    shutil.copytree(artifacts, poison)
    world_data = str(tmp / "world_data")
    shutil.copytree(data, world_data)
    registry = str(tmp / "registry.sqlite")
    ModelRegistry(registry, create=True).register("v1", artifacts)

    jm = jax_mesh.make_mesh(4, 2)
    primary = JaxEngine.from_dirs(artifacts, data, mesh=jm)
    uni = primary.gen.universe
    users = [int(u) for u in uni.user_ids[:10]]
    assert {routes_to_canary(u, FRACTION) for u in users} == {False, True}  # both arms see traffic
    assert not routes_to_canary(NEW_USER, FRACTION)  # the new user's answers come from the primary
    requests = [[u, c, m, lam] for u in users for c in uni.cities[:2]
                for m, lam in (("friends", 0.6), ("personal", 1.0))]
    spec = {
        "registry": registry, "data": world_data, "served_data": str(tmp / "served_data"), "poison": poison,
        **dirs, "requests": requests,
        "many": [[users[i], uni.cities[i % len(uni.cities)], ("friends", "personal")[i % 2], (0.6, 1.0)[i % 2]]
                 for i in range(6)],
        "new_user": NEW_USER,
        "after_data": [[NEW_USER, c, m, 1.0] for c in uni.cities[:3] for m in ("friends", "personal")]
        + requests[::5],
    }
    return types.SimpleNamespace(tmp=tmp, spec=spec, data=data, artifacts=artifacts, jax_mesh=jm,
                                 primary=primary, **{k: v for k, v in dirs.items()})


@pytest.fixture(scope="module")
def world(fixture):
    out = distributed.launch(stack_checks, 2, (fixture.spec,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                             store_dir=str(fixture.tmp))
    assert len(out["ranks"]) == 2
    return out


@pytest.fixture(scope="module")
def jax_arms(fixture):
    """JAX's mesh engines of each arm, and its canary and shadow arms driven
    with the world's requests in the world's order."""
    jm, data = fixture.jax_mesh, fixture.data
    canary = JaxEngine.from_dirs(fixture.canary, data, mesh=jm)
    shadow_eng = JaxEngine.from_dirs(fixture.shadow, data, mesh=jm)
    arm = JaxCanary(fixture.primary, canary, FRACTION, canary_dir=fixture.canary)
    shadow = JaxShadow(arm, shadow_eng, shadow_dir=fixture.shadow)
    answers = []
    for req in fixture.spec["requests"]:
        answers.append(shadow.recommend(*req))
        shadow.drain()
    many = shadow.recommend_many([tuple(r) for r in fixture.spec["many"]])
    shadow.drain()
    return types.SimpleNamespace(canary=canary, answers=answers, many=many, canary_stats=shadow.canary_stats(),
                                 shadow_stats=shadow.shadow_stats())


def _want(fixture, jax_arms, reqs: list, primary) -> list:
    """Each request answered by the JAX mesh engine of its arm."""
    return [_json((jax_arms.canary if routes_to_canary(r[0], FRACTION) else primary).recommend(*r)) for r in reqs]


def _counts_without_latency(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "canary_latency"}


# ---- the arms ------------------------------------------------------------------ #


def test_mesh_canary_answers_each_request_from_its_arm(world, fixture, jax_arms):
    spec = fixture.spec
    assert [_json(x) for x in world["canary"]] == [_json(x) for x in jax_arms.answers]
    assert world["canary"] == _want(fixture, jax_arms, spec["requests"], fixture.primary)
    assert [_json(x) for x in world["many"]] == [_json(x) for x in jax_arms.many]


def test_mesh_canary_stats_equal_jax(world, jax_arms):
    got, want = world["canary_stats"], jax_arms.canary_stats
    assert _counts_without_latency(got) == _counts_without_latency(want)
    assert got["canary_served"] > 0 and got["primary_served"] > 0
    assert got["canary_latency"]["count"] == want["canary_latency"]["count"]


def test_mesh_shadow_stats_equal_jax_after_a_drain(world, jax_arms):
    got, want = world["shadow_stats"], jax_arms.shadow_stats
    assert got == want
    assert got["compared"] == len(world["canary"]) + len(world["many"]) and got["pending"] == 0


# ---- the swaps ------------------------------------------------------------------- #


def test_mesh_registry_swap_serves_the_new_model(world, fixture, jax_arms):
    assert world["registry_swapped"] is True
    second = JaxEngine.from_dirs(fixture.second, fixture.data, mesh=fixture.jax_mesh)
    assert world["after_registry"] == _want(fixture, jax_arms, fixture.spec["requests"], second)
    assert world["after_registry"] != world["canary"]  # the primary arm's model did change


def test_mesh_data_swap_serves_the_refreshed_universe(world, fixture, jax_arms):
    assert world["data_swapped"] == (False, True)  # debounced once, then swapped
    assert world["new_user_known"]
    refreshed = JaxEngine.from_dirs(fixture.second, fixture.spec["served_data"], mesh=fixture.jax_mesh)
    want = _want(fixture, jax_arms, fixture.spec["after_data"], refreshed)
    assert world["after_data"] == want
    assert any(r.get("ranked_hotels") for r in world["after_data"][:6])  # the new user is served


# ---- the engines' lives across the world ---------------------------------------- #


def _drops_before_stop(world, rank: int) -> list:
    return [eid for eid, stopped in world["ranks"][rank]["drops"] if not stopped]


def test_swapped_out_engines_close_on_every_rank(world):
    ids = world["engine_ids"]
    assert world["startup_ids"] == sorted(ids.values())  # primary, canary, shadow: one id each, on both ranks
    for rank in (0, 1):
        drops = _drops_before_stop(world, rank)
        assert world["closed_after_registry"] in drops and world["closed_after_data"] in drops
    assert world["closed_after_registry"] not in world["ids_after_registry"]
    assert world["after_poison"] == world["after_data"]  # the world served on


def test_a_build_that_fails_on_one_rank_is_discarded_on_all(world):
    assert world["poison_swapped"] is False and world["poison_kept"]
    assert world["after_poison"] == world["after_data"]
    poisoned = world["poison_id"]
    assert poisoned not in world["ids_after_poison"]
    leader, follower = world["ranks"]
    assert follower["faults"] == [poisoned] and not leader["faults"]  # rank 1 failed its build
    assert poisoned in _drops_before_stop(world, 0)  # rank 0 built it, and discarded it at COMMIT
    assert poisoned not in _drops_before_stop(world, 1)  # rank 1 never held it


def test_torn_read_discard_closes_on_every_rank(world):
    assert world["torn"] == (False, False) and world["torn_kept"]
    assert len(world["torn_built"]) == 1
    torn = world["torn_built"][0]
    assert torn not in world["ids_after_torn"]
    for rank in (0, 1):
        assert torn in _drops_before_stop(world, rank)
    assert world["after_torn"] == world["after_data"]


def test_closing_an_arm_frees_it_on_every_rank_and_the_world_serves_on(world, fixture):
    closed = world["closed_canary"]
    assert closed not in world["ids_after_canary_close"]
    for rank in (0, 1):
        assert closed in _drops_before_stop(world, rank)
    # the canary's slice falls back to the primary, counted as errors, as in JAX
    reqs = fixture.spec["after_data"]
    in_slice = [routes_to_canary(r[0], FRACTION) for r in reqs]
    refreshed = world["after_data"]
    for got, was, canary in zip(world["after_canary_close"], refreshed, in_slice):
        if not canary:
            assert got == was
    assert world["stats_end"]["canary"]["errors"] == sum(in_slice) > 0


def test_world_shutdown_ends_every_follower(world):
    assert world["ids_after_stack_close"] == []  # the stack's close freed every engine through CLOSE
    assert world["counts_before_stop"]["STOP"] == 0
    for r in world["ranks"]:
        assert r["counts"]["STOP"] == 1 and r["ids_after_stop"] == []
        assert not [eid for eid, stopped in r["drops"] if stopped]  # nothing was left to free at the STOP
    leader, follower = world["ranks"]
    assert {k: v for k, v in leader["counts"].items() if k != "NOOP"} == \
        {k: v for k, v in follower["counts"].items() if k != "NOOP"}  # every header reached the follower


# ---- the CLI ------------------------------------------------------------------------- #


def test_cli_mesh_serves_every_stack_and_stops_every_rank(fixture, tmp_path):
    """``serve.cli --mesh 2 --device cpu`` with the canary, the shadow and
    both pollers: /healthz reports both arms, one request of each arm is
    its arm's answer, a registry activation is hot-swapped (``hot_swaps``),
    and SIGTERM ends every rank."""
    registry = str(tmp_path / "registry.sqlite")
    ModelRegistry(registry, create=True).register("v1", fixture.artifacts)
    port = _free_port()
    log_path = tmp_path / "cli.log"
    users = [r[0] for r in fixture.spec["requests"]]
    by_arm = {arm: next(u for u in users if routes_to_canary(u, FRACTION) == arm) for arm in (False, True)}
    city = fixture.primary.gen.universe.cities[0]
    canary_single = JaxEngine.from_dirs(fixture.canary, fixture.data)
    primary_single = JaxEngine.from_dirs(fixture.artifacts, fixture.data)
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hhrs_tpu_torch.serve.cli", "--artifacts", f"registry:{registry}", "--data",
             fixture.data, "--device", "cpu", "--mesh", "2", "--host", "127.0.0.1", "--port", str(port),
             "--batch-window-ms", "2", "--canary", fixture.canary, "--canary-fraction", str(FRACTION),
             "--shadow", fixture.shadow, "--reload-poll-s", "0.5", "--data-poll-s", "30"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=log_file, stderr=subprocess.STDOUT)
        ranks = []
        try:
            health = _wait_health(port, proc, lambda h: True)
            assert health is not None and health["status"] == "ok", log_path.read_text()[-3000:]
            assert health["shadow"]["shadow_model"] == fixture.shadow
            assert health["canary"]["canary_model"] == fixture.canary and health["hot_swaps"] == 0
            ranks = _ranks_of(proc.pid)
            assert len(ranks) == 2
            for arm, single in ((False, primary_single), (True, canary_single)):
                req = [by_arm[arm], city, "friends", 0.6]
                assert _post(port, req) == _json(single.recommend(*req)), arm
            ModelRegistry(registry).register("v2", fixture.second)
            health = _wait_health(port, proc, lambda h: h.get("hot_swaps") == 1)
            assert health is not None and health["model"] == fixture.second, log_path.read_text()[-3000:]
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=20)
    deadline = time.monotonic() + 20
    while any(map(_alive, ranks)) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not any(map(_alive, ranks))


def _wait_health(port: int, proc, done, timeout_s: float = 120.0) -> dict | None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                health = json.loads(r.read())
            if done(health):
                return health
        except OSError:
            pass
        time.sleep(0.3)
    return None


def _post(port: int, req: list) -> dict:
    body = json.dumps({"user_id": req[0], "city": req[1], "type": req[2], "lambda_param": req[3]}).encode()
    post = urllib.request.Request(f"http://127.0.0.1:{port}/recommendations", data=body,
                                  headers={"content-type": "application/json"})
    with urllib.request.urlopen(post, timeout=60) as r:
        return json.loads(r.read())


def test_world_frames_digest_is_content_only():
    """The fingerprint every rank votes at COMMIT: equal for equal tables
    built apart, different for one changed cell."""
    from hhrs_tpu_torch.serve.lockstep import frames_digest

    a = ({"x": np.arange(5), "s": np.array(["a", np.nan, "c"], dtype=object)}, {"f": np.zeros(2)})
    b = ({"s": np.array(["a", np.nan, "c"], dtype=object), "x": np.arange(5)}, {"f": np.zeros(2)})
    c = ({"x": np.arange(5), "s": np.array(["a", np.nan, "d"], dtype=object)}, {"f": np.zeros(2)})
    assert frames_digest(a) == frames_digest(b) != frames_digest(c)
    assert 0 <= frames_digest(a) < 2**63
