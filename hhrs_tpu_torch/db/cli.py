"""DB ops entry point: ``python -m hhrs_tpu_torch.db.cli`` (counterpart of
``hhrs_tpu/db/cli.py``, with the same subcommands)::

    seed         --db hhrs.sqlite --data data/
    register     --db hhrs.sqlite --artifacts artifacts/ [--version v1] [--no-activate]
    activate     --db hhrs.sqlite --model-id N
    promote      --db hhrs.sqlite --artifacts artifacts/ [--metric val_logloss]
                 [--eval-data DIR [--eval-split all|val|train] [--device cuda|cpu]] [section.field=value ...]
    list         --db hhrs.sqlite
    active-path  --db hhrs.sqlite

``promote`` activates the candidate only if it beats the active model (the
retraining gate); with ``--eval-data`` both models are scored again on that
data by the port (``train/evaluate.py``, on the card unless ``--device
cpu``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from hhrs_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("hhrs_tpu_torch.db")


def run_promote(db: str, artifacts: str, *, version: str | None = None, metric: str = "val_logloss",
                direction: str = "auto", eval_data: str | None = None, eval_split: str = "all", cfg=None,
                record_eval_data: str | None = None, device=None):
    """Register ``artifacts`` in ``db`` and activate it only if it beats the
    incumbent on ``metric`` → ``(model_id, promoted, reason)``.

    With ``eval_data`` the candidate and the incumbent are both scored on
    that dataset (``evaluate_artifacts`` on ``device``) and the gate compares
    those numbers, ``gate_<metric without val_>``. ``cfg`` must be the
    layered config the candidate trained under: the evaluation filters and
    splits with ``cfg.data``, and a gate under other settings would carve
    another val split, with rows the candidate trained on.
    ``record_eval_data`` is the data path written to the registry in place
    of ``eval_data`` (the pipeline scores a snapshot and records the data
    dir it copied)."""
    from hhrs_tpu_torch.db.registry import ModelRegistry

    with open(os.path.join(artifacts, "manifest.json")) as f:
        manifest = json.load(f)
    reg = ModelRegistry(db, create=True)
    metrics = dict(manifest.get("metrics", {}))
    incumbent_value = None
    if eval_data:
        from hhrs_tpu_torch.train.evaluate import evaluate_artifacts

        key = metric.removeprefix("val_")  # the evaluation's keys have no val_ prefix
        cand_eval = evaluate_artifacts(artifacts, eval_data, cfg=cfg, split=eval_split, device=device)
        if key not in cand_eval:
            raise KeyError(f"--metric {metric!r} → no {key!r} in eval results {sorted(cand_eval)}")
        metric = f"gate_{key}"
        metrics[metric] = cand_eval[key]
        metrics["gate_eval_data"] = os.path.abspath(record_eval_data if record_eval_data is not None else eval_data)
        active = reg.active()
        if active is not None:
            inc_eval = evaluate_artifacts(active["artifact_path"], eval_data, cfg=cfg, split=eval_split,
                                          device=device)
            incumbent_value = inc_eval[key]
            log.info("re-scored on %s (%d rows): candidate %s=%.6g, incumbent %s=%.6g", eval_data,
                     cand_eval["rows"], key, cand_eval[key], key, inc_eval[key])
    return reg.promote_if_better(version, artifacts, metrics=metrics, hyperparams=manifest.get("model_config", {}),
                                 metric=metric, direction=direction, incumbent_value=incumbent_value)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DB seeding and model registry ops (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("seed")
    ps.add_argument("--db", default="hhrs.sqlite")
    ps.add_argument("--data", default="data")

    pr = sub.add_parser("register")
    pr.add_argument("--db", default="hhrs.sqlite")
    pr.add_argument("--artifacts", default="artifacts")
    pr.add_argument("--version", default=None)
    pr.add_argument("--no-activate", action="store_true")

    pa = sub.add_parser("activate")
    pa.add_argument("--db", default="hhrs.sqlite")
    pa.add_argument("--model-id", type=int, required=True)

    pp = sub.add_parser("promote", help="register an artifact and activate it only if it beats the active "
                                        "model on --metric (losers are registered inactive)")
    pp.add_argument("--db", default="hhrs.sqlite")
    pp.add_argument("--artifacts", default="artifacts")
    pp.add_argument("--version", default=None)
    pp.add_argument("--metric", default="val_logloss")
    pp.add_argument("--direction", choices=("min", "max", "auto"), default="auto")
    pp.add_argument("--eval-data", default=None, metavar="DIR",
                    help="score both the candidate and the incumbent on this dataset and compare those "
                         "numbers instead of each model's own-split manifest metrics")
    pp.add_argument("--eval-split", choices=("all", "val", "train"), default="all",
                    help="'all' suits a held-out eval dir; if --eval-data is the candidate's own "
                         "training data, use 'val' (scoring all rows rewards memorization)")
    pp.add_argument("--device", default=None, help="where --eval-data is scored: cuda (default) or cpu")
    pp.add_argument("overrides", nargs="*",
                    help="section.field=value config overrides: pass the data.* overrides the "
                         "candidate trained under, or the gate's filter and split differ from its")

    pl = sub.add_parser("list")
    pl.add_argument("--db", default="hhrs.sqlite")

    pap = sub.add_parser("active-path", help="print the active model's artifact dir")
    pap.add_argument("--db", default="hhrs.sqlite")
    return p


def main(argv=None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    from hhrs_tpu_torch.db.registry import ModelRegistry, seed_database

    try:
        if args.cmd == "seed":
            counts = seed_database(args.db, args.data)
            log.info("Database seeded successfully: %s", counts)
        elif args.cmd == "register":
            with open(os.path.join(args.artifacts, "manifest.json")) as f:
                manifest = json.load(f)
            reg = ModelRegistry(args.db, create=True)
            mid = reg.register(args.version or None, args.artifacts, metrics=manifest.get("metrics", {}),
                               hyperparams=manifest.get("model_config", {}), activate=not args.no_activate)
            log.info("registered model_id=%d version=%s", mid,
                     next(m["version"] for m in reg.list() if m["model_id"] == mid))
        elif args.cmd == "activate":
            ModelRegistry(args.db).activate(args.model_id)
            log.info("model %d is now active", args.model_id)
        elif args.cmd == "promote":
            cfg = None
            if args.eval_data:
                # HHRS_* and HHRS_PRESET must reach the gate's filter and split too
                from hhrs_tpu_torch.config import build_config

                cfg = build_config(list(args.overrides or []), log=log)
            elif args.overrides:
                log.warning("config overrides given but no --eval-data: the gate compares manifest metrics "
                            "and the overrides have no effect")
            mid, promoted, reason = run_promote(
                args.db, args.artifacts, version=args.version or None, metric=args.metric,
                direction=args.direction, eval_data=args.eval_data, eval_split=args.eval_split, cfg=cfg,
                device=args.device)
            log.info("model_id=%d %s — %s", mid, "PROMOTED" if promoted else "registered inactive", reason)
        elif args.cmd == "list":
            for m in ModelRegistry(args.db).list():
                print(json.dumps(m))
        elif args.cmd == "active-path":
            active = ModelRegistry(args.db).active()
            if active is None:
                log.error("no active model in %s", args.db)
                return 1
            print(active["artifact_path"])
        return 0
    except Exception as e:  # noqa: BLE001 — the CLI's boundary: log it, exit 1
        log.error("An error occurred: %s", e, exc_info=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
