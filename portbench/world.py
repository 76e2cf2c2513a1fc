"""The benchmark's worlds: reviews and friendships drawn from a seed.

``generate`` is a copy of ``hhrs_tpu_torch/data/synthetic.py``'s
``generate_synthetic_dataset`` (the same numpy draws in the same order), kept
here so that a change to the program cannot change the benchmark's data.

The tables are column dicts of numpy arrays, as the program's CSV reader
gives them after its rename: ``user_id``, ``item_id``, the CSV's other
columns, and ``friendships`` with ``user_id_1``, ``user_id_2``.
"""

from __future__ import annotations

import numpy as np

CITIES = [
    "Sochi", "Moscow", "Kazan", "SPB", "Kaliningrad",
    "Ekaterinburg", "Novosibirsk", "Vladivostok",
]
HOTEL_TYPES = ["hotel", "hostel", "apartment", "resort", "guesthouse"]
WORLD_KEYS = ("n_users", "n_items", "n_reviews", "n_friendships", "n_cities")


def generate(n_users: int, n_items: int, n_reviews: int, n_friendships: int, n_cities: int,
             seed: int, latent_dim: int = 8) -> tuple[dict, dict]:
    """→ (reviews, friendships). Reviews hold ``user_id`` (1-based) and
    ``item_id`` (from 101) in place of the CSV's ``guest_id`` and
    ``hotel_id``."""
    rng = np.random.default_rng(seed)
    n_cities = min(n_cities, len(CITIES))

    n_clusters = 8
    user_cluster = rng.integers(0, n_clusters, size=n_users)
    cluster_centers = rng.normal(0, 1.0, size=(n_clusters, latent_dim))
    user_vecs = cluster_centers[user_cluster] + 0.4 * rng.normal(size=(n_users, latent_dim))

    item_city = rng.integers(0, n_cities, size=n_items)
    item_type = rng.integers(0, len(HOTEL_TYPES), size=n_items)
    item_vecs = rng.normal(0, 1.0, size=(n_items, latent_dim))
    item_stars = rng.integers(1, 6, size=n_items).astype(np.float64)
    item_price = np.round(np.exp(rng.normal(7.5 + 0.35 * item_stars, 0.4)), 0)
    item_quality = 0.5 * (item_stars - 3) + rng.normal(0, 0.7, size=n_items)
    item_reviews_count = rng.integers(1, 2000, size=n_items).astype(np.float64)

    u = rng.integers(0, n_users, size=n_reviews)
    it = rng.integers(0, n_items, size=n_reviews)
    affinity = np.einsum("ij,ij->i", user_vecs[u], item_vecs[it]) / np.sqrt(latent_dim)
    base = affinity + item_quality[it]

    rating_overall = np.clip(np.round(5.5 + 2.5 * np.tanh(base) + rng.normal(0, 1.2, n_reviews)), 1, 10)
    sub = lambda: np.clip(np.round(rating_overall + rng.normal(0, 1.0, n_reviews)), 1, 10)  # noqa: E731
    rating_location = sub()
    rating_cleanliness = sub()
    rating_food = sub()
    rating_service = sub()

    logit = 1.4 * base - 0.3 * (np.log(item_price[it]) - 8.0) + rng.normal(0, 0.5, n_reviews)
    was_booked = (rng.uniform(size=n_reviews) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int64)

    reviews = {
        "user_id": u + 1,
        "item_id": it + 101,
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
        "was_booked": was_booked,
    }

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
    pairs = list(dict.fromkeys(zip(a.tolist(), b.tolist())))[:n_friendships]
    pair_arr = np.array(pairs, dtype=np.int64).reshape(len(pairs), 2)
    friendships = {"user_id_1": pair_arr[:, 0], "user_id_2": pair_arr[:, 1]}
    return reviews, friendships


def build(world: dict, seed: int) -> tuple[dict, dict]:
    """A traffic file's ``world`` entry (the keys of :data:`WORLD_KEYS`) and
    a seed → (reviews, friendships)."""
    unknown = set(world) - set(WORLD_KEYS)
    if unknown:
        raise ValueError(f"unknown world keys {sorted(unknown)}")
    return generate(seed=seed, **world)


def home_cities(reviews: dict) -> dict:
    """user → the city of most of their reviews; a tie goes to the city they
    reviewed first (the batch export's rule)."""
    users, cities = reviews["user_id"], reviews["city"]
    names, codes = np.unique(cities.astype(str), return_inverse=True)
    first = {}
    counts = {}
    for i, (u, c) in enumerate(zip(users.tolist(), codes.tolist())):
        key = (u, c)
        if key not in counts:
            counts[key] = 0
            first[key] = i
        counts[key] += 1
    best: dict = {}
    for (u, c), n in counts.items():
        cur = best.get(u)
        if cur is None or n > cur[1] or (n == cur[1] and first[(u, c)] < cur[2]):
            best[u] = (c, n, first[(u, c)])
    return {u: str(names[c]) for u, (c, _n, _f) in best.items()}


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 32-bit seeds derived from one seed of any size."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint32)]
