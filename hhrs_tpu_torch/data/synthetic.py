"""Synthetic dataset generator with the hackathon CSV schema (counterpart
of ``hhrs_tpu/data/synthetic.py``).

The same numpy draws in the same order as the JAX module, so a seed gives
the same reviews and friendships there and here; the tables are the port's
column dicts (:mod:`hhrs_tpu_torch.data.table`) in place of DataFrames, and
the CSVs are written as ``DataFrame.to_csv(index=False)`` writes them. The
data has a learnable booking signal: a low-rank user × item affinity plus
price and quality effects, and a friendship graph clustered by the users'
latent taste clusters.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from hhrs_tpu_torch.data import schema

CITIES = [
    "Sochi", "Moscow", "Kazan", "SPB", "Kaliningrad",
    "Ekaterinburg", "Novosibirsk", "Vladivostok",
]
HOTEL_TYPES = ["hotel", "hostel", "apartment", "resort", "guesthouse"]
REVIEWS_CSV = "hackathon_augmented_data.csv"
FRIENDS_CSV = "friendships.csv"


@dataclass
class SyntheticDataset:
    reviews: dict  # column name -> [n_reviews] array, in the CSV's column order
    friendships: dict  # "user_id_1", "user_id_2" -> [n] int64


def generate_synthetic_dataset(
    n_users: int = 2000,
    n_items: int = 600,
    n_reviews: int = 40000,
    n_friendships: int = 6000,
    n_cities: int = 6,
    latent_dim: int = 8,
    seed: int = 0,
) -> SyntheticDataset:
    rng = np.random.default_rng(seed)
    n_cities = min(n_cities, len(CITIES))

    # users belong to taste clusters; items have latent vectors
    n_clusters = 8
    user_cluster = rng.integers(0, n_clusters, size=n_users)
    cluster_centers = rng.normal(0, 1.0, size=(n_clusters, latent_dim))
    user_vecs = cluster_centers[user_cluster] + 0.4 * rng.normal(size=(n_users, latent_dim))

    item_city = rng.integers(0, n_cities, size=n_items)
    item_type = rng.integers(0, len(HOTEL_TYPES), size=n_items)
    item_vecs = rng.normal(0, 1.0, size=(n_items, latent_dim))
    item_stars = rng.integers(1, 6, size=n_items).astype(np.float64)
    item_price = np.round(np.exp(rng.normal(7.5 + 0.35 * item_stars, 0.4)), 0)  # price follows stars
    item_quality = 0.5 * (item_stars - 3) + rng.normal(0, 0.7, size=n_items)
    item_reviews_count = rng.integers(1, 2000, size=n_items).astype(np.float64)

    # each review is one user × item interaction in the item's city
    u = rng.integers(0, n_users, size=n_reviews)
    it = rng.integers(0, n_items, size=n_reviews)
    affinity = np.einsum("ij,ij->i", user_vecs[u], item_vecs[it]) / np.sqrt(latent_dim)
    base = affinity + item_quality[it]

    # rating_overall on 1..10, bimodal so that the noise filter keeps most rows
    rating_overall = np.clip(np.round(5.5 + 2.5 * np.tanh(base) + rng.normal(0, 1.2, n_reviews)), 1, 10)
    sub = lambda: np.clip(np.round(rating_overall + rng.normal(0, 1.0, n_reviews)), 1, 10)  # noqa: E731
    rating_location = sub()
    rating_cleanliness = sub()
    rating_food = sub()
    rating_service = sub()

    # booking probability: affinity + quality − price sensitivity
    logit = 1.4 * base - 0.3 * (np.log(item_price[it]) - 8.0) + rng.normal(0, 0.5, n_reviews)
    was_booked = (rng.uniform(size=n_reviews) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int64)

    reviews = {
        schema.RAW_USER_COL: u + 1,  # external ids are 1-based
        schema.RAW_ITEM_COL: it + 101,
        "city": np.array(CITIES, dtype=object)[item_city[it]],
        "hotel_type": np.array(HOTEL_TYPES, dtype=object)[item_type[it]],
        "price_rub": item_price[it],
        "stars": item_stars[it],
        "user_reviews_count": item_reviews_count[it],
        "rating_overall": rating_overall,
        "rating_location": rating_location,
        "rating_cleanliness": rating_cleanliness,
        "rating_food": rating_food,
        "rating_service": rating_service,
        schema.TARGET_COL: was_booked,
    }

    # friendships: same-cluster pairs preferred, undirected, first of each pair kept
    f1 = rng.integers(0, n_users, size=n_friendships * 2)
    same = rng.uniform(size=n_friendships * 2) < 0.7
    order = np.argsort(user_cluster, kind="stable")
    cluster_sorted = user_cluster[order]
    starts = np.searchsorted(cluster_sorted, user_cluster[f1], side="left")
    ends = np.searchsorted(cluster_sorted, user_cluster[f1], side="right")
    within = starts + rng.integers(0, np.maximum(ends - starts, 1))
    f2 = np.where(same, order[np.clip(within, 0, n_users - 1)], rng.integers(0, n_users, size=n_friendships * 2))
    mask = f1 != f2
    a = np.minimum(f1[mask], f2[mask]) + 1
    b = np.maximum(f1[mask], f2[mask]) + 1
    pairs = list(dict.fromkeys(zip(a.tolist(), b.tolist())))[:n_friendships]  # drop_duplicates().head(n)
    pair_arr = np.array(pairs, dtype=np.int64).reshape(len(pairs), 2)
    friendships = {"user_id_1": pair_arr[:, 0], "user_id_2": pair_arr[:, 1]}
    return SyntheticDataset(reviews=reviews, friendships=friendships)


def write_table_csv(path: str, table: dict) -> None:
    """A table as ``DataFrame.to_csv(index=False)`` writes it: a header row,
    floats in their shortest round-trip form, ``\\n`` line ends."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(table))
        writer.writerows(zip(*(col.tolist() for col in table.values())))


def write_synthetic_dataset(data_dir: str, **kwargs) -> SyntheticDataset:
    os.makedirs(data_dir, exist_ok=True)
    ds = generate_synthetic_dataset(**kwargs)
    write_table_csv(os.path.join(data_dir, REVIEWS_CSV), ds.reviews)
    write_table_csv(os.path.join(data_dir, FRIENDS_CSV), ds.friendships)
    return ds


def append_reviews(data_dir: str, user_id: int, n: int = 1, rating: int | None = None) -> None:
    """Append ``n`` copies of the reviews CSV's last row under a new
    external ``user_id`` (``rating`` overrides ``rating_overall``), so that
    the file changes and the data fingerprint registers a fresh drop. For
    the synthetic CSVs: the row is split on commas, so a quoted last row or
    a header-only file raises ``ValueError``."""
    path = os.path.join(data_dir, REVIEWS_CSV)
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = f.readlines()
    if not rows:
        raise ValueError(f"{path} has no data rows to clone")
    last = rows[-1].strip().split(",")
    if len(last) != len(header) or any('"' in cell for cell in last):
        raise ValueError(
            f"{path}'s last row is not naive-splittable (quoted/misaligned "
            "fields) — append_reviews only supports the synthetic CSV shape")
    last[header.index(schema.RAW_USER_COL)] = str(user_id)
    if rating is not None:
        last[header.index("rating_overall")] = str(rating)
    needs_nl = not rows[-1].endswith("\n")  # a last line without its newline
    with open(path, "a") as f:
        if needs_nl:
            f.write("\n")
        f.write("\n".join(",".join(last) for _ in range(n)) + "\n")
