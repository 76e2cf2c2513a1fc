"""Mesh serving: the PyTorch port's gloo worlds of CPU processes against the
JAX package on ``tests/conftest.py``'s 8 virtual devices.

The fixture is ``tests/test_serve_mesh.py``'s (220 users, 121 items, 6,000
reviews, seed 33; a small DCN-R trained by the JAX trainer), written as
CSVs that both packages read. 121 items pad on both worlds the port spawns
(W = 2 → 122 rows, W = 3 → 123) and on JAX's 4×2 mesh (128).

Each world is spawned once for the module (``torch_port_mesh_world.py``
runs every check on it) and joins under a time limit of its own, so a
hang fails its tests instead of the suite. The port's mesh engine must give
the JAX mesh engine's JSON for every request, ``similar_items`` its
answers, ``sharded_cosine_topk`` and ``ShardedItemScorer.top_k`` its
indices, and ``score_all`` its logits at rtol 1e-5 / atol 1e-6.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hhrs_tpu.config import ModelConfig, TrainConfig
from hhrs_tpu.data import Preprocessor, add_engineered_features
from hhrs_tpu.data.ingest import load_reviews_csv, noise_filter
from hhrs_tpu.data.synthetic import write_synthetic_dataset
from hhrs_tpu.models.dcn import ModelDims
from hhrs_tpu.parallel import distributed as jax_distributed
from hhrs_tpu.parallel import mesh as jax_mesh
from hhrs_tpu.retrieval.sharded import sharded_cosine_topk as jax_sharded_cosine_topk
from hhrs_tpu.serve.engine import RecommendationEngine as JaxEngine
from hhrs_tpu.serve.sharded_scoring import ShardedItemScorer as JaxScorer
from hhrs_tpu.train.artifacts import export_artifacts
from hhrs_tpu.train.trainer import train_dcn
from hhrs_tpu_torch.parallel import distributed, mesh
from hhrs_tpu_torch.retrieval.sharded import shard_k
from hhrs_tpu_torch.retrieval.similarity import cosine_topk, normalize_rows
from hhrs_tpu_torch.serve import cli
from tests.torch_port_mesh_world import faulty_batch, mesh_checks

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 3)
WORLD_TIMEOUT_S = 300  # one world's join: every check of the module on it
KS = (1, 5, 12)
UNKNOWN_ITEM = 999_999_999
UNKNOWN_USER = 999_999_998


# ---- the mesh's arithmetic against JAX's ----------------------------------- #


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("model_axis", [None, 1, 2, 3, 4, 8])
def test_mesh_shape_for_matches_jax(n, model_axis):
    assert mesh.mesh_shape_for(n, model_axis) == jax_mesh.mesh_shape_for(n, model_axis)


@pytest.mark.parametrize("spec", ["1", "2", "8", "4x2", "2X4", " 2x2 ", "1x8", "3"])
def test_mesh_spec_matches_jax(spec, eight_devices):
    jm = jax_mesh.mesh_from_spec(spec)
    assert mesh.parse_mesh_spec(spec) == (jm.shape["data"], jm.shape["model"])


@pytest.mark.parametrize("spec", ["", "x", "0", "2x0", "0x2", "4y2", "-2", "2x", "a", "2x2x2"])
def test_bad_mesh_specs_raise_as_in_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_mesh.mesh_from_spec(spec)
    with pytest.raises(ValueError) as got:
        mesh.mesh_from_spec(spec)
    assert str(got.value) == str(want.value)


def _stub_mesh(shards: int):
    return types.SimpleNamespace(size=lambda: shards)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 121, 600, 4000])
@pytest.mark.parametrize("shards", [None, 1, 2, 3, 4, 8])
def test_pad_to_shards_matches_jax(n, shards, eight_devices):
    jm = None if shards is None else jax_mesh.make_mesh(shards, 1, devices=eight_devices[:shards])
    pm = None if shards is None else _stub_mesh(shards)
    assert mesh.pad_to_shards(n, pm) == jax_mesh.pad_to_shards(n, jm)


@pytest.mark.parametrize("n", [121, 600, 4000])
@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (8, 1), (3, 1), (1, 2)])
def test_row_layout_matches_jax_row_shardings(n, data, model, eight_devices):
    jm = jax_mesh.make_mesh(data, model, devices=eight_devices[: data * model])
    padded = jax_mesh.pad_to_shards(n, jm)
    index = jax_mesh.row_shardings(jm)[0].devices_indices_map((padded,))
    for r, device in enumerate(jm.devices.flat):  # row-major over (data, model)
        rows = mesh.row_layout(n, data * model, r)
        assert (rows.start, rows.stop, rows.padded) == (index[device][0].start, index[device][0].stop, padded)


def test_sharded_topk_refusal_matches_jax(eight_devices):
    jm = jax_mesh.make_mesh(3, 1, devices=eight_devices[:3])
    table = np.eye(6, 4, dtype=np.float32)
    with pytest.raises(ValueError) as want:
        jax_sharded_cosine_topk(jm, table, table[:1], 7, model_axis=("data", "model"))
    with pytest.raises(ValueError) as got:
        shard_k(7, 6, 3)
    assert str(got.value) == str(want.value)


# ---- the world: configuration, the backend rule, the launcher -------------- #

_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
        "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("env,jax_too", [
    ({}, True),
    ({"NUM_PROCESSES": "2"}, True),
    ({"PROCESS_ID": "1"}, True),
    ({"NUM_PROCESSES": "2", "PROCESS_ID": "1"}, True),
    ({"WORLD_SIZE": "2", "RANK": "1"}, False),
    ({"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "2", "RANK": "1"}, False),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1", "NUM_PROCESSES": "2"}, False),
])
def test_initialize_distributed_refuses_partial_configs(monkeypatch, env, jax_too):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if not env:
        assert distributed.initialize_distributed() is False
        assert jax_distributed.initialize_distributed() is False
        return
    with pytest.raises(RuntimeError, match="refusing|without both"):
        distributed.initialize_distributed()
    if jax_too:
        with pytest.raises(RuntimeError, match="refusing"):
            jax_distributed.initialize_distributed()


@pytest.mark.parametrize("contract", ["jax", "torchrun"])
def test_initialize_distributed_times_out_with_a_clear_error(monkeypatch, contract):
    """Rank 1 of 2 whose coordinator never comes up: RuntimeError after the
    timeout, not a hang."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    port = _free_port()
    env = ({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "2", "PROCESS_ID": "1"}
           if contract == "jax" else
           {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": "1"})
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not form within 2s"):
        distributed.initialize_distributed(timeout_s=2, device="cpu")
    assert time.monotonic() - t0 < 60
    assert not torch.distributed.is_initialized()


def test_backend_rule(monkeypatch):
    assert distributed.choose_backend(torch.device("cpu"), 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend(torch.device("cuda", 0), 1) == "nccl"  # a card each
    assert distributed.choose_backend(torch.device("cuda", 0), 2) == "gloo"  # ranks share the card
    assert [distributed.rank_device("cuda", r) for r in range(2)] == [torch.device("cuda", 0)] * 2
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")


def _rank_and_size(offset: int) -> tuple:
    return torch.distributed.get_rank() + offset, torch.distributed.get_world_size()


def _rank_one_fails() -> None:
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank one cannot go on")
    torch.distributed.barrier()  # rank 0 waits here for a rank that is gone


def test_launcher_returns_rank_zero_and_raises_a_failing_rank(tmp_path):
    assert distributed.launch(_rank_and_size, 3, (10,), device="cpu", timeout_s=120,
                              store_dir=str(tmp_path)) == (10, 3)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of the world failed.*rank one cannot go on"):
        distributed.launch(_rank_one_fails, 2, device="cpu", timeout_s=120, store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60  # rank 0 is stopped, not waited for


def test_world_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """No device given: cuda, which raises without a card (the CPU only
    when asked), before any rank starts or any world forms."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.launch(_rank_and_size, 2, (0,), timeout_s=60, store_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_world(0, 1, f"file://{tmp_path / 'store'}")
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
                        "RANK": "1"}.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_distributed(timeout_s=2)
    assert not torch.distributed.is_initialized()


# ---- the fixture and the worlds --------------------------------------------- #


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("torch_port_mesh")
    data, artifacts = str(tmp / "data"), str(tmp / "artifacts")
    write_synthetic_dataset(data, n_users=220, n_items=121, n_reviews=6000, seed=33)
    main_df = add_engineered_features(load_reviews_csv(os.path.join(data, "hackathon_augmented_data.csv")))
    splits, art = Preprocessor().fit_transform(noise_filter(main_df.copy()))
    dims = ModelDims.from_artifacts(art)
    mcfg = ModelConfig(emb_dim=8, hidden_dim=32, n_cross_layers=1, n_res_blocks=1, dropout=0.2)
    result = train_dcn(splits, dims, mcfg, TrainConfig(lr=3e-3, batch_size=512, n_epochs=2))
    export_artifacts(artifacts, result.params, result.bn_state, mcfg, dims, art, result.final_metrics)
    single = JaxEngine.from_dirs(artifacts, data)
    jm = jax_mesh.make_mesh(4, 2)
    uni = single.gen.universe
    users = [int(u) for u in uni.user_ids[:8]]
    friendless = [int(u) for u in uni.user_ids if len(single.graph.friends_of(int(u))) == 0][:1]
    items = list(single.bundle.preproc.item_id_mapping)[:10]
    rng = np.random.default_rng(5)
    retrieval = str(tmp / "retrieval_embeddings.npy")  # learned-retriever vectors: any [n_items, D] rows
    np.save(retrieval, rng.normal(size=(single.bundle.item_embeddings.shape[0], 6)).astype(np.float32))
    spec = {
        "artifacts": artifacts, "data": data, "retrieval": retrieval,
        "requests": [[u, c, m, lam] for m, lam in (("friends", 1.0), ("friends", 0.6), ("personal", 1.0),
                                                   ("personal", 0.6)) for u in users for c in uni.cities[:2]],
        "many": [[users[i], uni.cities[i % len(uni.cities)], "friends" if i % 2 else "personal",
                  0.6 if i % 3 else 1.0] for i in range(5)],
        "edge": [[users[0], "Nowhere-City", "friends", 0.7], [UNKNOWN_USER, uni.cities[0], "friends", 0.6]]
        + [[u, uni.cities[0], "friends", 1.0] for u in friendless],  # the fallback path, where one exists
        "similar": [[int(i), n] for i in items for n in (1, 5, 16)] + [[UNKNOWN_ITEM, 10]],
        "quantized": [[u, c, "friends", lam] for u in users[:6] for c in uni.cities[:2] for lam in (1.0, 0.6)],
        "candidates": [[u, uni.cities[0], m] for u in users[:5] for m in ("friends", "personal")],
        "table": rng.normal(size=(53, 6)).astype(np.float32),
        "queries": rng.normal(size=(7, 6)).astype(np.float32),
        "ks": KS,
        "scorer_items": tuple(np.asarray(single._dev[k]) for k in ("item_internal", "X_cat", "X_num")),
        "scorer_users": [0, 17, 101],
    }
    return types.SimpleNamespace(tmp=tmp, spec=spec, single=single, jax_mesh=jm,
                                 meshed=JaxEngine.from_dirs(artifacts, data, mesh=jm))


@pytest.fixture(scope="module")
def jax_answers(fixture):
    spec, je = fixture.spec, fixture.meshed
    q = JaxEngine.from_dirs(spec["artifacts"], spec["data"], mesh=fixture.jax_mesh, quantize_tables=True)
    r = JaxEngine.from_dirs(spec["artifacts"], spec["data"], mesh=fixture.jax_mesh,
                            retrieval_embeddings_path=spec["retrieval"])
    return {
        "sweep": [je.recommend(*r) for r in spec["requests"]],
        "many": je.recommend_many([tuple(r) for r in spec["many"]]),
        "edge": [je.recommend(*r) for r in spec["edge"]],
        "similar": [je.similar_items(i, n) for i, n in spec["similar"]],
        "quantized": [q.recommend(*r) for r in spec["quantized"]],
        "retrieval": ([r.recommend(*x) for x in spec["quantized"]], [r.similar_items(i, n) for i, n in spec["similar"]]),
        "candidates": [je.gen.generate(u, c, m, je.graph) for u, c, m in spec["candidates"]],
    }


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def world(request, fixture):
    W = request.param
    out = distributed.launch(mesh_checks, W, (fixture.spec,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                             store_dir=str(fixture.tmp))
    assert out["shape"] == (W, 1)
    return W, out


def test_mesh_engine_identical_responses(world, jax_answers):
    W, out = world
    got, want = out["plain"]["sweep"], jax_answers["sweep"]
    assert len(got) == len(want) == 64
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (W, i)
    assert out["plain"]["order_width"] == mesh.pad_to_shards(121, _stub_mesh(W))  # the padded item axis


def test_mesh_engine_batched_and_edge_requests(world, jax_answers):
    _, out = world
    assert out["plain"]["many"] == jax_answers["many"]
    assert out["plain"]["edge"] == jax_answers["edge"]
    assert out["plain"]["edge"][0]["ranked_hotels"] == [] and "message" in out["plain"]["edge"][0]


def test_mesh_similar_items_identical(world, jax_answers):
    _, out = world
    assert out["plain"]["similar"] == jax_answers["similar"]
    assert out["plain"]["similar"][-1] is None


def test_mesh_quantized_tables_identical(world, jax_answers):
    _, out = world
    assert out["quantized"] == jax_answers["quantized"]
    assert sum(len(r.get("ranked_hotels", [])) for r in out["quantized"]) > 0


def test_mesh_retrieval_embeddings_identical(world, jax_answers):
    _, out = world
    assert out["retrieval"][0] == jax_answers["retrieval"][0]
    assert out["retrieval"][1] == jax_answers["retrieval"][1]


def test_mesh_candidate_mask_matches(world, jax_answers):
    _, out = world
    for (cb, nb), (ca, na) in zip(out["candidates"], jax_answers["candidates"]):
        np.testing.assert_array_equal(cb, ca)
        assert nb == na


def test_mesh_disables_cap_and_city_bounding(world, fixture):
    _, out = world
    assert out["switched_off"] == (0, False)
    assert out["capped"] == fixture.single.recommend(*fixture.spec["requests"][0])


@pytest.mark.parametrize("k", KS)
def test_sharded_cosine_topk_matches_jax(world, fixture, k):
    W, out = world
    spec = fixture.spec
    table, queries = spec["table"], spec["queries"]
    n = table.shape[0]
    jm = fixture.jax_mesh
    padded = np.pad(table, ((0, jax_mesh.pad_to_shards(n, jm) - n), (0, 0)))
    tab = np.asarray(normalize_rows(torch.as_tensor(padded)))
    _, want = jax_sharded_cosine_topk(jm, tab, queries, k, model_axis=("data", "model"), n_valid=n)
    got_vals, got = out["topk"][k]
    np.testing.assert_array_equal(got, np.asarray(want))
    single_vals, single = cosine_topk(normalize_rows(torch.as_tensor(table)), torch.as_tensor(queries), k)
    np.testing.assert_array_equal(got, single.numpy())
    np.testing.assert_allclose(got_vals, single_vals.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_scorer_matches_jax(world, fixture):
    _, out = world
    spec, single = fixture.spec, fixture.single
    scorer = JaxScorer(fixture.jax_mesh, single.bundle.params, single.bundle.bn_state, single.bundle.model_cfg,
                       *spec["scorer_items"])
    for u in spec["scorer_users"]:
        np.testing.assert_allclose(out["score_all"][u], np.asarray(scorer.score_all(u)), rtol=1e-5, atol=1e-6)
        for k in KS:
            _, want = scorer.top_k(u, k)
            np.testing.assert_array_equal(out["score_top_k"][(u, k)][1], np.asarray(want))


def test_mesh_engine_fault_ends_the_world(fixture):
    """A batch that fails part way on rank 0 ends rank 0's process, and the
    launcher then stops the world, far inside the world's 600 s collective
    timeout (the followers were waiting in the failed batch's collectives)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank \d of the world (failed|exited with code)"):
        distributed.launch(faulty_batch, 2, (fixture.spec,), device="cpu", timeout_s=WORLD_TIMEOUT_S,
                           store_dir=str(fixture.tmp))
    assert time.monotonic() - t0 < 120


# ---- the CLI ------------------------------------------------------------------ #


def test_cli_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mesh", "2"])


def _ranks_of(pid: int) -> list:
    """The spawned ranks of process ``pid``: its children whose command
    line is multiprocessing's spawn entry."""
    out = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline") as f:
                cmdline = f.read()
        except (OSError, ValueError):
            continue
        if ppid == pid and "spawn_main" in cmdline:
            out.append(int(entry))
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_cli_mesh_serves_and_stops_every_rank(fixture):
    spec = fixture.spec
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "hhrs_tpu_torch.serve.cli", "--artifacts", spec["artifacts"], "--data",
         spec["data"], "--device", "cpu", "--mesh", "2", "--host", "127.0.0.1", "--port", str(port),
         "--batch-window-ms", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ranks = []
    try:
        deadline, health = time.monotonic() + 120, None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.3)
        assert health is not None and health["status"] == "ok", proc.stdout.read().decode()[-3000:]
        ranks = _ranks_of(proc.pid)
        assert len(ranks) == 2
        req = spec["requests"][1]
        body = json.dumps({"user_id": req[0], "city": req[1], "type": req[2], "lambda_param": req[3]}).encode()
        post = urllib.request.Request(f"http://127.0.0.1:{port}/recommendations", data=body,
                                      headers={"content-type": "application/json"})
        with urllib.request.urlopen(post, timeout=60) as r:
            assert json.loads(r.read()) == json.loads(json.dumps(fixture.single.recommend(*req)))
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
