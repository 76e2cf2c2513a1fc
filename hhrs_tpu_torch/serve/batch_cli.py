"""Offline batch inference: ``python -m hhrs_tpu_torch.serve.batch_cli``.

Counterpart of ``hhrs_tpu/serve/batch_cli.py``, with its flags plus
``--device``: precompute recommendations for many users into JSONL (nightly
top-k exports, cache warming, offline evaluation of the two-stage
pipeline). It drives the engine through ``recommend_many(chunk,
pad_to=--chunk)``: on a card one CUDA-graph replay of the chunk's bucket
and one device→host copy per chunk of users. Each line equals the online
``engine.recommend`` of the same request.

Each user is recommended in a city: ``--city X`` fixes one for everyone;
the default infers each user's home city (their most-reviewed city).

Output: one JSON line per user::

  {"user_id": 7, "city": "Sochi", "hotels": [<ranked payloads>]}

and a final summary line on stderr with users/s throughput. The device
defaults to ``cuda`` and the run fails without a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.table import isna

log = logging.getLogger("hhrs_tpu_torch.serve.batch")


def home_cities(main: dict) -> dict:
    """user_id → most-reviewed city (ties: the city whose first review comes
    first in table order, as the JAX package's stable sort over pandas'
    first-appearance groups gives). Reviews without a city do not count."""
    counts: dict = {}  # (user, city) -> reviews, in order of first appearance
    for user, city in zip(main[schema.USER_COL].tolist(), main["city"].tolist()):
        if not isna(city):
            counts[(user, city)] = counts.get((user, city), 0) + 1
    best: dict = {}
    for (user, city), n in counts.items():
        if user not in best or n > best[user][1]:
            best[user] = (city, n)
    return {user: city for user, (city, _n) in best.items()}


def main(argv=None) -> int:
    from hhrs_tpu_torch.utils.logging import setup_logging

    setup_logging()
    p = argparse.ArgumentParser(description="Offline batch recommendations → JSONL")
    p.add_argument("--artifacts", default="artifacts",
                   help="artifact dir, or 'registry:<db>' for the active model")
    p.add_argument("--data", default="data")
    p.add_argument("--out", default="recommendations.jsonl")
    p.add_argument("--users", default=None,
                   help="file with one user id per line (default: every user in the reviews table)")
    p.add_argument("--city", default=None,
                   help="recommend everyone in this city (default: each user's most-reviewed city)")
    p.add_argument("--mode", choices=["friends", "personal"], default="friends")
    p.add_argument("--lambda-param", type=float, default=0.7)
    p.add_argument("--chunk", type=int, default=64,
                   help="users per device dispatch (one batch bucket, one CUDA graph on a card)")
    p.add_argument("--limit", type=int, default=None, help="cap user count")
    p.add_argument("--quantize-tables", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from hhrs_tpu_torch.config import build_config
    from hhrs_tpu_torch.db.registry import resolve_artifacts_dir
    from hhrs_tpu_torch.serve.engine import RecommendationEngine, load_frames

    cfg = build_config(args.overrides, log=log)
    frames = load_frames(args.data)
    engine = RecommendationEngine.from_dirs(
        resolve_artifacts_dir(args.artifacts), args.data,
        retrieval_cfg=cfg.retrieval, device=args.device,
        quantize_tables=args.quantize_tables or cfg.serve.quantize_tables,
        candidate_cap=cfg.serve.candidate_cap,
        city_bounded=cfg.serve.city_bounded,
        bf16=args.bf16, frames=frames)

    if args.users:
        with open(args.users) as f:
            users = [int(line) for line in f if line.strip()]
    else:
        users = [int(u) for u in engine.gen.universe.user_ids]
    if args.limit:
        users = users[: args.limit]

    homes = None if args.city else home_cities(frames[0])
    requests = []
    for u in users:
        city = args.city or homes.get(u)
        if city is None:
            continue  # user with no reviews and no --city: nothing to infer
        requests.append((u, city, args.mode, args.lambda_param))

    n = len(requests)
    log.info("batch inference: %d users, chunk %d", n, args.chunk)
    t0 = time.perf_counter()
    written = 0
    with open(args.out, "w") as f:
        for i in range(0, n, args.chunk):
            chunk = requests[i : i + args.chunk]
            results = engine.recommend_many(chunk, pad_to=args.chunk)
            for (u, city, _m, _l), res in zip(chunk, results):
                f.write(json.dumps({"user_id": u, "city": city,
                                    "hotels": res.get("ranked_hotels", [])}) + "\n")
                written += 1
    dt = time.perf_counter() - t0
    print(json.dumps({"metric": "batch_inference", "users": written,
                      "seconds": round(dt, 2),
                      "users_per_s": round(written / dt, 1) if dt > 0 else None,
                      "out": args.out}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
