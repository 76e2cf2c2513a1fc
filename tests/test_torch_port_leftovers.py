"""ROADMAP A12's last two functions against hhrs_tpu's: ``config.from_cli``
(the defaults with ``section.field=value`` tokens) and
``data/preprocess.py::encode_items_for_ranking`` (serve-time featurization
with the reference's fallbacks: unknown user → ``unknown_user_id``,
unknown item → 0, unknown category → 0), on the CPU.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from hhrs_tpu import config as jax_config
from hhrs_tpu.data.preprocess import MinMaxStats as JaxMinMax
from hhrs_tpu.data.preprocess import PreprocessArtifacts as JaxArtifacts
from hhrs_tpu.data.preprocess import encode_items_for_ranking as jax_encode
from hhrs_tpu_torch import config
from hhrs_tpu_torch.data.preprocess import PreprocessArtifacts, encode_items_for_ranking
from hhrs_tpu_torch.data.table import first_occurrence, take
from hhrs_tpu_torch.serve.engine import load_frames
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
from tests.test_torch_port_engine import ARTIFACT, DATA

TOKENS = [
    [],
    ["model.emb_dim=48", "train.lr=0.003"],
    ["model.arch=cross_only", "model.cross_variant=canonical", "train.fused_epoch=true"],
    ["data.categorical_cols=city, hotel_type", "serve.port=8123", "serve.city_bounded=no"],
    ["retrieval.mmr_top_k=10", "model.dropout=0", "train.batch_size=32768", "model.emb_dim=8"],
]


@pytest.mark.parametrize("tokens", TOKENS)
def test_from_cli_equals_jaxs(tokens):
    assert dataclasses.asdict(config.from_cli(tokens)) == dataclasses.asdict(jax_config.from_cli(tokens))


def test_from_cli_ignores_the_environment_and_refuses_a_bad_token(monkeypatch):
    """Only the defaults and the tokens: no preset, no ``HHRS_*``; a token
    without ``=`` exits as in JAX."""
    monkeypatch.setenv("HHRS_PRESET", "tuned")
    monkeypatch.setenv("HHRS_TRAIN_LR", "0.5")
    assert dataclasses.asdict(config.from_cli([])) == dataclasses.asdict(config.Config())
    for fn in (config.from_cli, jax_config.from_cli):
        with pytest.raises(SystemExit, match="section.field=value"):
            fn(["model.emb_dim", "8"])


NUM_COLS = ["price_rub", "stars"]


def jax_artifacts() -> JaxArtifacts:
    """The JAX property test's artifacts (``tests/test_fallback_properties.py``)."""
    return JaxArtifacts(
        user_id_mapping={100 + i: i for i in range(10)},
        item_id_mapping={200 + i: i for i in range(7)},
        cat_encoders={"city": {"A": 0, "B": 1, "C": 2}, "hotel_type": {"h": 0, "r": 1}},
        scaler=JaxMinMax(data_min=np.array([100.0, 1.0]), data_max=np.array([900.0, 1.0])),
        numerical_cols=NUM_COLS, categorical_cols=["city", "hotel_type"],
        medians={"price_rub": 500.0, "stars": 3.0})


def port_artifacts(art: JaxArtifacts) -> PreprocessArtifacts:
    return PreprocessArtifacts.from_json_dict(json.loads(json.dumps(art.to_json_dict())))


def assert_same_encoding(got: tuple, want: tuple) -> None:
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@settings(max_examples=60, deadline=None)
@given(user_id=st.integers(min_value=-10_000, max_value=10_000),
       item_ids=st.lists(st.integers(min_value=-500, max_value=500), min_size=1, max_size=12), data=st.data())
def test_encode_items_for_ranking_equals_jaxs_with_every_fallback(user_id, item_ids, data):
    """Generated users, items, categories and numericals (NaN included): the
    four arrays equal JAX's, dtypes included."""
    n = len(item_ids)
    cols = {
        "item_id": item_ids,
        "city": data.draw(st.lists(st.sampled_from(["A", "B", "C", "Zzz", "???"]), min_size=n, max_size=n)),
        "hotel_type": data.draw(st.lists(st.sampled_from(["h", "r", "unknown"]), min_size=n, max_size=n)),
        "price_rub": data.draw(st.lists(st.one_of(st.floats(0, 5000, allow_nan=False), st.just(np.nan)),
                                        min_size=n, max_size=n)),
        "stars": data.draw(st.lists(st.floats(1, 5, allow_nan=False), min_size=n, max_size=n)),
    }
    art = jax_artifacts()
    table = {"item_id": np.asarray(item_ids, np.int64), "city": np.asarray(cols["city"], dtype=object),
             "hotel_type": np.asarray(cols["hotel_type"], dtype=object),
             "price_rub": np.asarray(cols["price_rub"], np.float64), "stars": np.asarray(cols["stars"], np.float64)}
    got = encode_items_for_ranking(port_artifacts(art), table, user_id)
    assert_same_encoding(got, jax_encode(art, pd.DataFrame(cols), user_id))
    assert (got[0] == art.user_id_mapping.get(user_id, art.n_users // 2)).all()


@pytest.mark.parametrize("user_id", ["known", "unknown"])
def test_encode_items_for_ranking_on_hpo_r5_and_data(user_id):
    """The serve items of data/ (one row per item, an unknown item and an
    unknown city poisoned in) for a known and an unknown user, against JAX
    on the same rows."""
    from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle

    art = load_artifact_bundle(ARTIFACT).preproc
    main = load_frames(DATA)[0]
    items = take(main, first_occurrence(main["item_id"])[:40])
    items["item_id"] = items["item_id"].copy()
    items["item_id"][0] = 10**9
    items["city"] = items["city"].copy()
    items["city"][1] = "Nowhere"
    uid = next(iter(art.user_id_mapping)) if user_id == "known" else 10**9
    got = encode_items_for_ranking(art, items, uid)
    want = jax_encode(jax_load_bundle(ARTIFACT).preproc, pd.DataFrame(items), uid)
    assert_same_encoding(got, want)
    assert got[1][0] == 0 and got[2][1, 0] == 0
    assert (got[0] == (art.user_id_mapping[uid] if user_id == "known" else art.unknown_user_id)).all()
