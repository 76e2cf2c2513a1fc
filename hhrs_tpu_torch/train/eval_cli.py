"""Standalone model evaluation: ``python -m hhrs_tpu_torch.train.eval_cli``.

Counterpart of ``hhrs_tpu/train/eval_cli.py``, with its flags plus
``--device``: score an existing artifact dir (or the registry's active
model) on a dataset with the artifact's saved preprocessing, no refit.
``--split val`` reproduces the training run's validation split, and so
the manifest's metrics on the training data; the default scores every
filtered row::

    python -m hhrs_tpu_torch.train.eval_cli --artifacts DIR --data DATA \\
        [--split all|val|train] [--eval-batch N] [--device cuda|cpu] [section.field=value ...]

Prints one JSON line: rows, logloss, AUC, RMSE and the row-level
recall@100. The device defaults to ``cuda`` and the run fails without a
card.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from hhrs_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("hhrs_tpu_torch.eval")


def main(argv=None) -> int:
    setup_logging()
    p = argparse.ArgumentParser(description="Evaluate a trained model on a dataset with the PyTorch port")
    p.add_argument("--artifacts", default="artifacts",
                   help="artifact dir, or 'registry:<db>' for the active model")
    p.add_argument("--data", default="data", help="data dir with the reviews CSV")
    p.add_argument("--split", choices=["all", "val", "train"], default="all",
                   help="'val'/'train' reproduce the training run's seed-42 split of this dataset; "
                        "'all' scores every filtered row")
    p.add_argument("--eval-batch", type=int, default=8192)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="section.field=value config overrides")
    args = p.parse_args(argv)

    from hhrs_tpu_torch.config import build_config
    from hhrs_tpu_torch.db.registry import resolve_artifacts_dir
    from hhrs_tpu_torch.train.evaluate import evaluate_artifacts

    cfg = build_config(args.overrides, log=log)
    artifacts_dir = resolve_artifacts_dir(args.artifacts)
    try:
        res = evaluate_artifacts(artifacts_dir, args.data, cfg=cfg, split=args.split,
                                 eval_batch=args.eval_batch, device=args.device)
    except ValueError as e:
        log.critical("%s", e)
        return 1
    print(json.dumps({"metric": "model_eval", "artifacts": artifacts_dir, "split": args.split, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
