"""Plain preprocessing: what the program derives from a world, worked out
again in numpy for the references (no code of the program).

The rules are the recommender's documented ones: engineered ratios (a
division by zero gives 0), the noise filter (rating_overall >= 8 or <= 4)
for training, vocabularies of users and items in order of first appearance,
category codes in sorted order, numericals min-max scaled over the whole
filtered table, and an 80/20 split by ``RandomState(42).permutation`` with
the validation rows first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

NUMERICAL = ("price_rub", "stars", "user_reviews_count", "rating_overall", "rating_location",
             "rating_cleanliness", "rating_food", "rating_service",
             "price_per_star", "cleanliness_vs_service", "location_premium")
CATEGORICAL = ("city", "hotel_type")
SPLIT_SEED = 42
TEST_SIZE = 0.2


def _ratio(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        out = a / b
    return np.where(np.isfinite(out), out, 0.0)


def numericals(t: dict) -> np.ndarray:
    """The 11 numerical columns, engineered ones included → ``[n, 11]`` f64."""
    f = lambda c: np.asarray(t[c], np.float64)  # noqa: E731
    eng = {
        "price_per_star": _ratio(f("price_rub"), f("stars")),
        "cleanliness_vs_service": _ratio(f("rating_cleanliness"), f("rating_service")),
        "location_premium": f("rating_overall") - f("rating_location"),
    }
    return np.stack([eng[c] if c in eng else f(c) for c in NUMERICAL], axis=1)


def first_order(values: np.ndarray) -> np.ndarray:
    """Distinct values in order of first appearance."""
    uniq, first = np.unique(values, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


@dataclass
class Fit:
    users: np.ndarray  # external user ids in vocabulary order
    items: np.ndarray  # external item ids in vocabulary order
    cats: dict  # column -> sorted category names
    lo: np.ndarray  # [11] scaler minimum
    scale: np.ndarray  # [11] scaler range (1 where it is 0)

    def user_code(self, ext: np.ndarray) -> np.ndarray:
        """Vocabulary codes; an unknown user gets ``n_users // 2``."""
        return _lookup(self.users, ext, len(self.users) // 2)

    def item_code(self, ext: np.ndarray) -> np.ndarray:
        return _lookup(self.items, ext, 0)

    def cat_codes(self, t: dict) -> np.ndarray:
        return np.stack([_lookup(self.cats[c], np.asarray(t[c]).astype(str), 0) for c in CATEGORICAL], axis=1)

    def scaled(self, t: dict) -> np.ndarray:
        return ((numericals(t) - self.lo) / self.scale).astype(np.float32)


def _lookup(vocab: np.ndarray, values: np.ndarray, fill: int) -> np.ndarray:
    order = np.argsort(vocab, kind="stable")
    pos = np.searchsorted(vocab[order], values)
    pos = np.clip(pos, 0, len(vocab) - 1)
    hit = vocab[order][pos] == values
    return np.where(hit, order[pos], fill).astype(np.int64)


def noise_filtered(reviews: dict) -> dict:
    r = np.asarray(reviews["rating_overall"], np.float64)
    keep = (r >= 8.0) | (r <= 4.0)
    return {k: v[keep] for k, v in reviews.items()}


def fit(table: dict) -> Fit:
    """The vocabularies and scaler of a (filtered) table."""
    users = first_order(np.asarray(table["user_id"]))
    items = first_order(np.asarray(table["item_id"]))
    cats = {c: np.array(sorted(set(np.asarray(table[c]).astype(str).tolist()))) for c in CATEGORICAL}
    x = numericals(table)
    lo, hi = x.min(axis=0), x.max(axis=0)
    return Fit(users, items, cats, lo, np.where(hi - lo == 0.0, 1.0, hi - lo))


def splits(table: dict, f: Fit) -> dict:
    """→ {"train": rows, "val": rows}, each {"user", "item", "cat", "num", "y"}."""
    n = len(table["user_id"])
    enc = {"user": f.user_code(np.asarray(table["user_id"])), "item": f.item_code(np.asarray(table["item_id"])),
           "cat": f.cat_codes(table), "num": f.scaled(table),
           "y": np.asarray(table["was_booked"], np.float32)}
    n_test = math.ceil(TEST_SIZE * n)
    perm = np.random.RandomState(SPLIT_SEED).permutation(n)
    return {"train": {k: v[perm[n_test:]] for k, v in enc.items()},
            "val": {k: v[perm[:n_test]] for k, v in enc.items()}}


def serve_items(reviews: dict, f: Fit) -> dict:
    """Every hotel of the serve table (the unfiltered reviews) in order of
    first appearance, with its first row's features → {"ext", "row",
    "item", "cat", "num", "city", "price", "stars"}."""
    ext = first_order(np.asarray(reviews["item_id"]))
    uniq, first = np.unique(np.asarray(reviews["item_id"]), return_index=True)
    row = first[np.searchsorted(uniq, ext)]
    t = {k: v[row] for k, v in reviews.items()}
    return {"ext": ext, "row": row, "item": f.item_code(ext), "known": _lookup(f.items, ext, -1) >= 0,
            "cat": f.cat_codes(t), "num": f.scaled(t), "city": t["city"].astype(str),
            "price": np.asarray(t["price_rub"], np.float64), "stars": np.asarray(t["stars"], np.float64)}
