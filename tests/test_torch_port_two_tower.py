"""The two-tower retriever (ROADMAP A10) of the port against
``hhrs_tpu/retrieval/two_tower.py``, on the CPU, and the engine's
``retrieval_embeddings`` option against the JAX engine's.

Every comparison starts from the JAX init (``init_two_tower`` at seed 42,
carried across by ``models/convert.py::two_tower_from_jax``) and the same
batches (the JAX trainer's ``np.random.default_rng(seed)`` permutations).

Testdata (JAX on the CPU, ``python tests/test_torch_port_two_tower.py
--write``): ``two_tower_init_data.npz``, the JAX init for ``data/``;
``two_tower_golden_data.json``, the JAX run's per-epoch losses and final
recall@100 from it (50 epochs, B = 1024); ``retrieval_embeddings_hpo_r5.npy``,
the JAX CLI's export from ``data/`` (its item rows are hpo_r5's); and
``serve_golden_hpo_r5_two_tower.json``, the JAX engine's golden sweep with
those embeddings. ``chip_smoke.py`` phase 12 holds the card to them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # for the --write entry point
    sys.path.insert(0, str(REPO))

import optax  # noqa: E402

from hhrs_tpu.models.dcn import ModelDims as JaxDims  # noqa: E402
from hhrs_tpu.retrieval import two_tower as J  # noqa: E402
from hhrs_tpu.serve.engine import RecommendationEngine as JaxEngine  # noqa: E402
from hhrs_tpu_torch.config import Config  # noqa: E402
from hhrs_tpu_torch.models.convert import flatten_tree, two_tower_from_jax  # noqa: E402
from hhrs_tpu_torch.models.dcn import ModelDims  # noqa: E402
from hhrs_tpu_torch.retrieval import two_tower as T  # noqa: E402
from hhrs_tpu_torch.serve.engine import RecommendationEngine, load_frames  # noqa: E402
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle  # noqa: E402
from hhrs_tpu_torch.train.cli import build_dataset  # noqa: E402
from hhrs_tpu_torch.train.optimizers import make_optimizer  # noqa: E402
from tests.test_torch_port_engine import make_golden, tie_swaps  # noqa: E402
from tests.test_torch_port_model import one_torch_thread  # noqa: F401,E402 — module fixture

ARTIFACT = str(REPO / "benchmarks/results/hpo_r5/best")
DATA = str(REPO / "data")
TESTDATA = REPO / "hhrs_tpu_torch/testdata"
INIT = TESTDATA / "two_tower_init_data.npz"
TRAIN_GOLDEN = TESTDATA / "two_tower_golden_data.json"
EMBEDDINGS = TESTDATA / "retrieval_embeddings_hpo_r5.npy"
SERVE_GOLDEN = TESTDATA / "serve_golden_hpo_r5_two_tower.json"
TOL = dict(rtol=1e-5, atol=1e-6)  # the model's parity bar: loss, gradients, one step, vectors
# Adam's first step is lr·g/(|g| + 1e-8): where |g| is near 1e-8 a gradient
# difference of summation order (up to 6.5e-10 measured) moves the step by
# up to lr·δ/(4·1e-8); such elements (|g| < 1e-6) moved up to 9.1e-6.
SUB_NOISE_GRAD, SUB_NOISE_ATOL = 1e-6, 2e-5
# C1's bars (chip_smoke.py VAL_TOL, LATER_EPOCH_TOL): epoch 0, later epochs.
EPOCH0_TOL, LATER_TOL = dict(rtol=2e-3, atol=2e-4), dict(rtol=5e-3, atol=2e-4)
SWAP_TOL = 1e-4  # the golden tie rule


def jax_dims(dims: ModelDims) -> JaxDims:
    return JaxDims(dims.n_users, dims.n_items, dims.cat_dims, dims.n_num_features)


@pytest.fixture(scope="module")
def dataset():
    splits, art = build_dataset(DATA, Config())
    return splits, art, ModelDims.from_artifacts(art)


@pytest.fixture(scope="module")
def jax_init(dataset):
    """The JAX init at seed 42 for data/ (numpy leaves), equal to the
    testdata file."""
    _, _, dims = dataset
    params = jax.tree.map(np.asarray, J.init_two_tower(jax.random.PRNGKey(42), jax_dims(dims), J.TwoTowerConfig()))
    return params


def first_batch(splits, n: int = 1024) -> dict:
    pos = np.asarray(splits.train_y) == 1.0
    return {"user": splits.train_user[pos][:n], "item": splits.train_item[pos][:n],
            "cat": splits.train_cat[pos][:n], "num": splits.train_num[pos][:n]}


def torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32 if k == "num" else torch.int64) for k, v in batch.items()}


def test_testdata_init_is_the_jax_init(jax_init):
    saved = np.load(INIT)
    flat = flatten_tree(jax_init)
    assert sorted(saved.files) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)


def test_init_shapes_are_jaxs(dataset):
    """A port init has the JAX tree's leaves and shapes (tables floor(sqrt(n)) + 1 wide)."""
    _, _, dims = dataset
    cfg = T.TwoTowerConfig()
    ours = T.init_two_tower(torch.Generator().manual_seed(0), dims, cfg)
    theirs = flatten_tree(J.init_two_tower(jax.random.PRNGKey(0), jax_dims(dims), J.TwoTowerConfig()))
    assert {k: tuple(v.shape) for k, v in ours.state_dict().items()} == {k: tuple(v.shape) for k, v in theirs.items()}
    assert [t.shape[1] for t in ours.cat_embeddings] == [int(np.floor(np.sqrt(n))) + 1 for _, n in dims.cat_dims]


def test_carrier_rejects_a_mismatched_tree(dataset, jax_init):
    _, _, dims = dataset
    bad = dict(jax_init, user_l2={"kernel": np.zeros((64, 31), np.float32), "bias": np.zeros(31, np.float32)})
    with pytest.raises(RuntimeError):
        two_tower_from_jax(bad, dims, T.TwoTowerConfig())


def test_towers_and_loss_match_jax(dataset, jax_init):
    """The two towers' vectors and the in-batch loss with logQ, on the first
    1,024 positives, at the model bar."""
    splits, _, dims = dataset
    model = two_tower_from_jax(jax_init, dims, T.TwoTowerConfig())
    batch = first_batch(splits)
    log_q = T.log_q_table(splits, dims.n_items)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = torch_batch(batch)
    with torch.no_grad():
        np.testing.assert_allclose(T.user_tower(model, tb["user"]).numpy(),
                                   np.asarray(J.user_tower(jax_init, jb["user"])), **TOL)
        np.testing.assert_allclose(T.item_tower(model, tb["item"], tb["cat"], tb["num"]).numpy(),
                                   np.asarray(J.item_tower(jax_init, jb["item"], jb["cat"], jb["num"])), **TOL)
        for q in (None, log_q):
            want = float(J.in_batch_softmax_loss(jax_init, jb, 0.2, None if q is None else jnp.asarray(q)))
            got = float(T.in_batch_softmax_loss(model, tb, 0.2, None if q is None else torch.as_tensor(q)))
            np.testing.assert_allclose(got, want, **TOL)


def test_one_adamw_step_matches_optax(dataset, jax_init):
    """Gradients and one AdamW step (optax's ``adamw``: decay on every leaf,
    eps 1e-8) from the JAX init on the same batch: gradients and parameters
    at the model bar, parameters whose gradient is below SUB_NOISE_GRAD at
    SUB_NOISE_ATOL."""
    splits, _, dims = dataset
    cfg = T.TwoTowerConfig()
    log_q = T.log_q_table(splits, dims.n_items)
    batch = first_batch(splits)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, jax_init)
    tx = optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    _, grads = jax.value_and_grad(J.in_batch_softmax_loss)(params, jb, cfg.temperature, jnp.asarray(log_q))
    updates, _ = tx.update(grads, tx.init(params), params)
    want = flatten_tree(jax.tree.map(lambda p, u: np.asarray(p + u), params, updates))
    want_g = flatten_tree(jax.tree.map(np.asarray, grads))

    model = two_tower_from_jax(jax_init, dims, cfg)
    opt = make_optimizer("adamw", model.parameters(), cfg.lr, cfg.weight_decay)
    T.in_batch_softmax_loss(model, torch_batch(batch), cfg.temperature, torch.as_tensor(log_q)).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], err_msg=name, **TOL)
    opt.step()
    for name, p in model.named_parameters():
        got, w, g = p.detach().numpy(), want[name], np.abs(want_g[name])
        above = g >= SUB_NOISE_GRAD
        np.testing.assert_allclose(got[above], w[above], err_msg=name, **TOL)
        np.testing.assert_allclose(got[~above], w[~above], rtol=0, atol=SUB_NOISE_ATOL, err_msg=name)


def test_duplicate_items_in_batch_are_masked(dataset, jax_init):
    """A batch of one item 64 times: every negative is a false negative and
    masked, so the loss is exactly the positive's softmax alone (0), finite,
    as JAX's."""
    splits, _, dims = dataset
    batch = dict(first_batch(splits, 64), item=np.zeros(64, np.int32))
    model = two_tower_from_jax(jax_init, dims, T.TwoTowerConfig())
    with torch.no_grad():
        got = float(T.in_batch_softmax_loss(model, torch_batch(batch), 0.2))
    want = float(J.in_batch_softmax_loss(jax_init, {k: jnp.asarray(v) for k, v in batch.items()}, 0.2))
    assert np.isfinite(got) and got == pytest.approx(0.0, abs=1e-5)
    assert got == pytest.approx(want, abs=1e-6)


@pytest.fixture(scope="module")
def three_epochs(dataset, jax_init):
    splits, _, dims = dataset
    cfg = T.TwoTowerConfig(n_epochs=3)
    ours = T.train_two_tower(splits, dims, cfg, device="cpu", init=two_tower_from_jax(jax_init, dims, cfg))
    theirs = J.train_two_tower(splits, jax_dims(dims), J.TwoTowerConfig(n_epochs=3))
    return ours, theirs


def test_three_epochs_track_the_jax_run(three_epochs):
    """Per-epoch mean loss at C1's bars (rtol 2e-3 at epoch 0, 5e-3 after),
    and recall@100 within CATALOG_RECALL_TOL (0.01) of JAX's."""
    ours, theirs = three_epochs
    got = [h["train_loss"] for h in ours.history]
    want = [h["train_loss"] for h in theirs.history]
    assert len(got) == 3
    np.testing.assert_allclose(got[0], want[0], **EPOCH0_TOL)
    np.testing.assert_allclose(got[1:], want[1:], **LATER_TOL)
    assert got[-1] < got[0]
    assert abs(ours.final_recall_at_100 - theirs.final_recall_at_100) <= 0.01
    assert ours.examples_per_s > 0


def test_exported_rows_cover_every_item_normalized(dataset, three_epochs, tmp_path):
    """``retrieval_embeddings.npy``: one L2-normalized row per internal item
    (unseen items from their id alone), the JAX export of the same weights
    at the model bar."""
    splits, _, dims = dataset
    ours, theirs = three_epochs
    path = T.export_retrieval_embeddings(str(tmp_path / "port"), ours.model, splits, dims)
    V = np.load(path)
    assert V.shape == (dims.n_items, T.TwoTowerConfig().out_dim) and V.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(V, axis=1), 1.0, atol=1e-4)
    same = two_tower_from_jax(jax.tree.map(np.asarray, theirs.params), dims, T.TwoTowerConfig())
    mine = np.load(T.export_retrieval_embeddings(str(tmp_path / "same"), same, splits, dims))
    want = np.load(J.export_retrieval_embeddings(str(tmp_path / "jax"), theirs.params, splits, jax_dims(dims)))
    np.testing.assert_allclose(mine, want, **TOL)


def test_testdata_golden_run_is_reproduced_by_jax(dataset):
    """The JAX run recorded in the testdata repeats its first 3 epochs."""
    splits, _, dims = dataset
    golden = json.loads(TRAIN_GOLDEN.read_text())
    r = J.train_two_tower(splits, jax_dims(dims), J.TwoTowerConfig(n_epochs=3), eval_recall=False)
    assert [h["train_loss"] for h in r.history] == golden["train_loss"][:3]
    assert golden["config"] == dataclasses.asdict(T.TwoTowerConfig())


def test_training_without_a_card_raises(dataset, monkeypatch):
    splits, _, dims = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_two_tower(splits, dims, T.TwoTowerConfig(n_epochs=1))


# ---- the engine's option ------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_golden():
    return json.loads(SERVE_GOLDEN.read_text())


@pytest.fixture(scope="module")
def engines():
    table = np.load(EMBEDDINGS)
    frames = load_frames(DATA)
    port = {cb: RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", city_bounded=cb, frames=frames,
                                               retrieval_embeddings_path=str(EMBEDDINGS)) for cb in (True, False)}
    jax_engines = {cb: JaxEngine.from_dirs(ARTIFACT, DATA, city_bounded=cb, retrieval_embeddings_path=str(EMBEDDINGS))
                   for cb in (True, False)}
    return port, jax_engines, table


def test_testdata_embeddings_use_hpo_r5s_item_rows(dataset):
    """The retriever was trained on data/, whose fitted item mapping is the
    hpo_r5 artifact's: the exported rows are its 600 internal items."""
    _, art, _ = dataset
    assert art.item_id_mapping == load_artifact_bundle(ARTIFACT).preproc.item_id_mapping
    V = np.load(EMBEDDINGS)
    assert V.shape == (600, 32)
    np.testing.assert_allclose(np.linalg.norm(V, axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("city_bounded", [True, False])
def test_engine_json_with_embeddings_equals_jaxs(engines, serve_golden, city_bounded):
    """The golden sweep, the padded batches and similar_items through both
    engines with the embeddings: equal JSON."""
    port, jax_engines, _ = engines
    te, je = port[city_bounded], jax_engines[city_bounded]
    for req in serve_golden["requests"]:
        assert te.recommend(*req) == je.recommend(*req), req
    many = [serve_golden["requests"][i] for i in serve_golden["many"]]
    assert te.recommend_many(many, pad_to=8) == je.recommend_many(many, pad_to=8)
    for item, n, _ in serve_golden["similar"]:
        assert te.similar_items(item, n) == je.similar_items(item, n)


def test_engine_with_embeddings_matches_its_golden(engines, serve_golden):
    """The port on the CPU against the JAX golden file under the tie rule
    (0 swaps expected on the CPU), and the embeddings change the answers."""
    port, _, _ = engines
    te = port[True]
    swaps = sum(tie_swaps(te.recommend(*req), want, logits, SWAP_TOL)
                for req, want, logits in zip(serve_golden["requests"], serve_golden["responses"],
                                             serve_golden["logits"]))
    assert swaps == 0
    for item, n, want in serve_golden["similar"]:
        assert te.similar_items(item, n) == want
    plain = json.loads((TESTDATA / "serve_golden_hpo_r5.json").read_text())
    assert plain["requests"] == serve_golden["requests"]
    assert plain["responses"] != serve_golden["responses"] or plain["similar"] != serve_golden["similar"]


def test_engine_swaps_every_similarity_table_and_keeps_the_ranker(engines):
    """The item table of kNN expansion, MMR and similar_items is the
    retrieval table at its own width; the ranker still scores through the
    tower (on the CPU its plain version)."""
    port, _, table = engines
    te = port[True]
    assert te.bundle.item_embeddings.shape == table.shape
    np.testing.assert_array_equal(te._emb_train.numpy(), table)
    assert te._dev["emb_norm"].shape[1] == table.shape[1] == te._table_norm_train.shape[1]
    assert te._folded is not None and "tower" in te.scoring


def test_crafted_orthogonal_groups_drive_similar_items():
    """Groups of 4 internal ids share one vector, orthogonal-ish to the other
    groups: similar_items returns exactly the group mates, so the
    substituted vectors (not the ranker's) drive the index; requests still
    serve."""
    bundle = load_artifact_bundle(ARTIFACT)
    n = bundle.item_embeddings.shape[0]
    rng = np.random.default_rng(0)
    groups = rng.normal(size=(n // 4 + 1, 64)).astype(np.float32)
    V = groups[np.arange(n) // 4]
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    main, friendships = load_frames(DATA)
    eng = RecommendationEngine(bundle, main, friendships, device="cpu", retrieval_embeddings=V)
    inv = {v: k for k, v in bundle.preproc.item_id_mapping.items()}
    assert set(eng.similar_items(inv[8], 3)) == {inv[9], inv[10], inv[11]}
    uni = eng.gen.universe
    assert "ranked_hotels" in eng.recommend(int(uni.user_ids[0]), uni.cities[0], "friends", 0.7)
    with pytest.raises(ValueError, match=r"retrieval_embeddings rows \(599\) != the artifact's internal item count \(600\)"):
        RecommendationEngine(bundle, main, friendships, device="cpu", retrieval_embeddings=V[:-1])


# ---- the CLIs -------------------------------------------------------------------------


def test_cli_export_then_serve_the_flag(tmp_path):
    """The documented workflow: the retriever's CLI trains and exports on
    synthetic data, a ranker trains on the same data, and ``serve.cli``'s
    stack serves with ``--retrieval-embeddings``."""
    from hhrs_tpu_torch.serve import cli as serve_cli
    from hhrs_tpu_torch.train import cli as train_cli

    data, out, art = str(tmp_path / "d"), str(tmp_path / "o"), str(tmp_path / "a")
    synth = ["--synth-users", "200", "--synth-items", "80", "--synth-reviews", "4000"]
    assert T.main(["--synthetic", "--data", data, "--out", out, "--epochs", "2", "--batch-size", "256",
                   "--device", "cpu", *synth]) == 0
    V = np.load(os.path.join(out, T.RETRIEVAL_EMB))
    assert 0 < V.shape[0] <= 80
    np.testing.assert_allclose(np.linalg.norm(V, axis=1), 1.0, atol=1e-4)
    assert train_cli.main(["--data", data, "--out", art, "--epochs", "1", "--device", "cpu",
                           "model.emb_dim=8", "model.hidden_dim=16"]) == 0
    args = serve_cli.build_parser().parse_args(
        ["--artifacts", art, "--data", data, "--device", "cpu", "--no-warmup",
         "--retrieval-embeddings", os.path.join(out, T.RETRIEVAL_EMB)])
    stack = serve_cli.build_stack(args)
    np.testing.assert_array_equal(stack.engine.bundle.item_embeddings, V)
    uni = stack.engine.gen.universe
    assert "ranked_hotels" in stack.engine.recommend(int(uni.user_ids[0]), uni.cities[0], "friends", 0.7)


def test_cli_flags_are_jaxs_plus_device():
    got = {a.dest: (tuple(a.option_strings), a.type, a.default) for a in T.build_parser()._actions}
    assert got.pop("device") == (("--device",), None, None)
    import argparse

    grabbed = {}
    original = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        grabbed["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            J.main([])
    finally:
        argparse.ArgumentParser.parse_args = original
    want = {a.dest: (tuple(a.option_strings), a.type, a.default) for a in grabbed["p"]._actions}
    assert got == want


def write_testdata() -> None:
    """The four testdata files, from the JAX package on the CPU."""
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    splits, art = build_dataset(DATA, Config())
    dims = jax_dims(ModelDims.from_artifacts(art))
    if art.item_id_mapping != load_artifact_bundle(ARTIFACT).preproc.item_id_mapping:
        raise SystemExit("data/'s item mapping is not hpo_r5's: the embeddings would not fit the artifact")
    cfg = J.TwoTowerConfig()
    init = flatten_tree(jax.tree.map(np.asarray, J.init_two_tower(jax.random.PRNGKey(cfg.seed), dims, cfg)))
    np.savez_compressed(INIT, **init)
    r = J.train_two_tower(splits, dims, cfg)
    TRAIN_GOLDEN.write_text(json.dumps({
        "data": "data", "config": dataclasses.asdict(cfg),
        "train_loss": [h["train_loss"] for h in r.history],
        "final_recall_at_100": r.final_recall_at_100}, indent=1) + "\n")
    with tempfile.TemporaryDirectory() as tmp:
        assert J.main(["--data", DATA, "--out", tmp]) == 0
        V = np.load(os.path.join(tmp, J.RETRIEVAL_EMB))
    np.save(EMBEDDINGS, V)
    engine = JaxEngine.from_dirs(ARTIFACT, DATA, retrieval_embeddings_path=str(EMBEDDINGS))
    golden = dict(make_golden(engine), options={"retrieval_embeddings_path": str(EMBEDDINGS.relative_to(REPO))})
    SERVE_GOLDEN.write_text(json.dumps(golden, separators=(",", ":")) + "\n")
    for p in (INIT, TRAIN_GOLDEN, EMBEDDINGS, SERVE_GOLDEN):
        print(f"wrote {p} ({os.path.getsize(p)} bytes)")


if __name__ == "__main__":
    if "--write" not in sys.argv:
        raise SystemExit("usage: python tests/test_torch_port_two_tower.py --write")
    write_testdata()
