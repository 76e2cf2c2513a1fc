"""Retrieval, MMR and host-data parity between the PyTorch port and the
JAX package: similarity/top-k, the candidate generator on data/ (every
city, both modes, the ghost-neighbour case), MMR picks, the CSV table and
item featurization."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from hhrs_tpu.config import RetrievalConfig as JaxRetrievalConfig
from hhrs_tpu.data.features import add_engineered_features as jax_features
from hhrs_tpu.data.ingest import load_friendships_csv as jax_load_friends
from hhrs_tpu.data.ingest import load_reviews_csv as jax_load_reviews
from hhrs_tpu.data.ingest import noise_filter as jax_noise_filter
from hhrs_tpu.data.preprocess import PreprocessArtifacts as JaxPreproc
from hhrs_tpu.data.preprocess import encode_item_features as jax_encode
from hhrs_tpu.ops.mmr import mmr_rerank as jax_mmr
from hhrs_tpu.retrieval.candidates import CandidateGenerator as JaxGenerator
from hhrs_tpu.retrieval.graph import FriendGraph as JaxGraph
from hhrs_tpu.retrieval.similarity import build_neighbor_table as jax_neighbors
from hhrs_tpu.retrieval.similarity import cosine_topk as jax_topk
from hhrs_tpu.retrieval.similarity import normalize_rows as jax_normalize
from hhrs_tpu_torch.config import RetrievalConfig
from hhrs_tpu_torch.data.features import add_engineered_features
from hhrs_tpu_torch.data.ingest import load_friendships_csv, load_reviews_csv, noise_filter
from hhrs_tpu_torch.data.preprocess import PreprocessArtifacts, encode_item_features
from hhrs_tpu_torch.data.table import first_occurrence, read_csv, take, unique_first
from hhrs_tpu_torch.ops.mmr import mmr_rerank
from hhrs_tpu_torch.retrieval.candidates import CandidateGenerator
from hhrs_tpu_torch.retrieval.graph import FriendGraph
from hhrs_tpu_torch.retrieval.similarity import build_neighbor_table, cosine_topk, normalize_rows
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
REVIEWS = str(REPO / "data/hackathon_augmented_data.csv")
FRIENDS = str(REPO / "data/friendships.csv")


# --------------------------------------------------------------- similarity


def test_normalize_rows_matches():
    x = np.random.default_rng(0).standard_normal((50, 7)).astype(np.float32)
    x[3] = 0.0  # the eps floor
    np.testing.assert_allclose(
        normalize_rows(torch.from_numpy(x)).numpy(), np.asarray(jax_normalize(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("k", [1, 5, 40])
def test_cosine_topk_matches_with_ties(k):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    table[10:20] = table[0]  # exact ties: lower index first, like lax.top_k
    tn = np.asarray(jax_normalize(jnp.asarray(table)))
    q = table[[0, 5, 33]]
    s_ref, i_ref = jax_topk(jnp.asarray(tn), jnp.asarray(q), k)
    s, i = cosine_topk(torch.from_numpy(tn.copy()), torch.from_numpy(q), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,k", [(0, 10), (1, 10), (7, 10), (11, 10), (600, 10)])
def test_build_neighbor_table_matches(n, k):
    emb = np.load(ARTIFACT / "item_embeddings.npy")[:n]
    got = build_neighbor_table(torch.from_numpy(emb), k)
    want = jax_neighbors(emb, k)
    assert got.dtype == np.int32 and got.shape == (n, k)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- candidates


@pytest.fixture(scope="module")
def frames():
    jdf = jax_features(jax_load_reviews(REVIEWS))
    jfr = jax_load_friends(FRIENDS)
    tab = add_engineered_features(load_reviews_csv(REVIEWS))
    tfr = load_friendships_csv(FRIENDS)
    return jdf, jfr, tab, tfr


@pytest.fixture(scope="module")
def generators(frames):
    jdf, jfr, tab, tfr = frames
    art = JaxPreproc.load(str(ARTIFACT / "preproc.json"))
    emb = np.load(ARTIFACT / "item_embeddings.npy")
    jg = JaxGenerator(jdf, art.item_id_mapping, emb, JaxRetrievalConfig())
    tg = CandidateGenerator(tab, art.item_id_mapping, emb, RetrievalConfig(), device="cpu")
    return jg, tg, JaxGraph.from_pairs(jfr, jg.universe.user_index), FriendGraph.from_pairs(
        tfr, tg.universe.user_index)


def test_universe_and_tables_match(generators):
    jg, tg, jgraph, tgraph = generators
    ju, tu = jg.universe, tg.universe
    np.testing.assert_array_equal(tu.item_ids, ju.item_ids)
    np.testing.assert_array_equal(tu.user_ids, ju.user_ids)
    assert tu.cities == ju.cities and tu.city_index == ju.city_index
    np.testing.assert_array_equal(tg.city_rows_np, jg.city_rows_np)
    np.testing.assert_array_equal(tg.nbr_by_serve_np, jg.nbr_by_serve_np)
    assert tg.n_ghosts == jg.n_ghosts
    assert tgraph.max_degree == jgraph.max_degree
    for u in list(jgraph.adjacency_ext)[:50]:
        np.testing.assert_array_equal(tgraph.friends_of(u), jgraph.friends_of(u))
        np.testing.assert_array_equal(tgraph.friend_indices(u), jgraph.friend_indices(u))


@pytest.mark.parametrize("mode", ["friends", "personal"])
def test_candidate_masks_match_every_city(generators, mode):
    jg, tg, jgraph, tgraph = generators
    users = [int(u) for u in jg.universe.user_ids[::97]] + [424242]
    cities = list(jg.universe.cities) + ["Atlantis"]
    reqs = [(u, c) for u in users for c in cities]
    for u, c in reqs:
        jc, jn = jg.generate(u, c, mode, jgraph)
        tc, tn = tg.generate(u, c, mode, tgraph)
        assert tn == jn, (u, c)
        np.testing.assert_array_equal(tc, jc, err_msg=f"{u} {c}")
    # the batched form gives the same masks as one request at a time
    src = torch.as_tensor(np.stack([tg.sources_for(u, mode, tgraph) for u, _ in reqs]))
    cidx = torch.as_tensor([tg.city_index(c) for _, c in reqs])
    cand, _neg, count = tg.generate_batch(src, cidx)
    for k, (u, c) in enumerate(reqs[:20]):
        jc, jn = jg.generate(u, c, mode, jgraph)
        assert int(count[k]) == jn
        np.testing.assert_array_equal(cand[k].numpy(), jc)


def test_ghost_neighbours_count_toward_fallback():
    """The case of tests/test_retrieval.py: train items absent from the
    serve table suppress the popularity fallback though never candidates."""
    rows = [(10, 1, "X", 9.0, 50)] + [(90 + it, it, "X", 6.0, 100 + it) for it in range(2, 7)]
    cols = ["user_id", "item_id", "city", "rating_overall", "user_reviews_count"]
    jdf = pd.DataFrame(rows, columns=cols)
    tab = {c: np.array([r[i] for r in rows], dtype=object if c == "city" else None)
           for i, c in enumerate(cols)}
    rng = np.random.default_rng(0)

    def build(mapping, n_train):
        emb = rng.standard_normal((n_train, 4)).astype(np.float32)
        emb[0] = 1.0
        for j in range(n_train - 10, n_train):
            emb[j] = 1.0 + 1e-3 * rng.standard_normal(4)
        kw = dict(expand_neighbors=10, min_candidates=5, popular_pool=100)
        jg = JaxGenerator(jdf, mapping, emb, JaxRetrievalConfig(**kw))
        tg = CandidateGenerator(tab, mapping, emb, RetrievalConfig(**kw), device="cpu")
        return jg, tg

    phantom = {it: i for i, it in enumerate(range(1, 7))}
    phantom.update({ext: 6 + g for g, ext in enumerate(range(100, 115))})
    plain = {it: i for i, it in enumerate(range(1, 7))}
    counts = []
    for mapping, n_train, ghosts in ((phantom, 21, 15), (plain, 6, 0)):
        jg, tg = build(mapping, n_train)
        assert tg.n_ghosts == jg.n_ghosts == ghosts
        jc, jn = jg.generate(10, "X", "personal", None)
        tc, tn = tg.generate(10, "X", "personal", None)
        assert tn == jn
        np.testing.assert_array_equal(tc, jc)
        counts.append(tn)
    assert counts[0] == 1 and counts[1] > counts[0]


# -------------------------------------------------------------------- MMR


def _mmr_case(seed: int, M: int, ties: bool):
    rng = np.random.default_rng(seed)
    d = 6
    emb = rng.standard_normal((M, d)).astype(np.float32)
    scores = rng.standard_normal(M).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    if ties:
        # many equal relevances, and one-hot embeddings whose cosines (0 or 1)
        # are exact in any summation order, so MMR values tie exactly
        scores = np.round(scores, 0)
        emb = np.eye(d, dtype=np.float32)[rng.integers(0, d, M)]
    cand = rng.random(M) < 0.6
    embedded = rng.random(M) < 0.85
    scores = np.where(cand, scores, -1e30).astype(np.float32)
    return scores, emb, cand, embedded


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.3, 0.7, 1.0])
def test_mmr_picks_match(ties, lam):
    cases = [_mmr_case(s, 64, ties) for s in range(4)] + [_mmr_case(9, 64, ties)]
    cases[-1][2][:] = False  # no candidates at all
    want = [np.asarray(jax_mmr(jnp.asarray(s), jnp.asarray(e), jnp.asarray(c), jnp.asarray(b),
                               jnp.float32(lam), top_k=20)) for s, e, c, b in cases]
    stack = lambda i: torch.from_numpy(np.stack([c[i] for c in cases]))  # noqa: E731
    got = mmr_rerank(stack(0), stack(1), stack(2), stack(3),
                     torch.full((len(cases),), lam, dtype=torch.float32), top_k=20)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


# ------------------------------------------------------------------ data


def test_csv_table_matches_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b,c,d,e\n1,x,1.5,,7\n2,,NA,y,8\n1,x,3,y,\n3,z,4,nan,9\n")
    tab, df = read_csv(str(path)), pd.read_csv(path)
    for col in df.columns:
        want = df[col].to_numpy()
        if want.dtype.kind in "if":
            assert tab[col].dtype == want.dtype, col
            np.testing.assert_array_equal(tab[col], want)
        else:
            got = [None if isinstance(v, float) else v for v in tab[col].tolist()]
            assert got == [None if isinstance(v, float) else v for v in want.tolist()], col
    np.testing.assert_array_equal(first_occurrence(tab["a"]), [0, 1, 3])
    assert unique_first(tab["b"], dropna=True).tolist() == list(pd.unique(df["b"].dropna()))
    assert unique_first(tab["d"]).tolist()[1:] == ["y"]


def test_reviews_features_and_item_encoding_match(frames):
    jdf, _, tab, _ = frames
    for col in jdf.columns:
        want = jdf[col].to_numpy()
        if want.dtype.kind in "if":
            np.testing.assert_array_equal(tab[col], want, err_msg=col)
        else:
            assert tab[col].tolist() == want.tolist(), col
    art_j = JaxPreproc.load(str(ARTIFACT / "preproc.json"))
    art_t = PreprocessArtifacts.load(str(ARTIFACT / "preproc.json"))
    assert art_t.item_id_mapping == art_j.item_id_mapping
    assert art_t.medians == art_j.medians and art_t.unknown_user_id == art_j.unknown_user_id
    jitems = jdf.drop_duplicates(subset=["item_id"])
    titems = take(tab, first_occurrence(tab["item_id"]))
    # unknown items and categories fall back to 0
    jitems = jitems.assign(city=jitems["city"].where(np.arange(len(jitems)) % 7 != 0, "Nowhere"))
    titems["city"] = np.where(np.arange(len(titems["city"])) % 7 != 0, titems["city"], "Nowhere")
    for got, want in zip(encode_item_features(art_t, titems), jax_encode(art_j, jitems)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(noise_filter(tab)["rating_overall"]) == len(jax_noise_filter(jdf))
