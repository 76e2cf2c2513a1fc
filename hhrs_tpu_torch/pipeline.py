"""Continuous training: watch the data, fine-tune, gate, promote
(counterpart of ``hhrs_tpu/pipeline.py``)::

    python -m hhrs_tpu_torch.pipeline --data DIR --db REG.sqlite --runs-dir RUNS \\
        [--once] [--poll-s S] [--max-cycles N] [--cold] [--epochs N] [--preset P] \\
        [--promote-metric M] [--eval-split all|val|train] [--device cuda|cpu] [section.field=value ...]

A cycle (:func:`run_cycle`):

1. copies the data CSVs to a consistent temp snapshot
   (``serve/reload.py::snapshot_data_dir``), so a writer appending during
   the run cannot tear the read; train and gate read the snapshot;
2. trains through the port's ``train/cli.py`` in this process: warm-started
   from the registry's active model (frozen encoders and scaler, vocabularies
   that grow, ``train/warmstart.py``), or cold when the registry has none;
3. gates: both the candidate and the incumbent are scored on the
   snapshot's held-out split under the trainer's layered config
   (``db/cli.py::run_promote``);
4. promotes the candidate in the registry only if it is better; a loser
   stays registered inactive with its gate metrics.

Every cycle appends one JSON record to ``<runs-dir>/pipeline_history.jsonl``
(run dir, warm start, train rc, gate decision and reason, seconds). A
failed train or gate is recorded with ``"ok": false`` and the watch loop
goes on: one bad drop does not end it. ``--once`` runs one cycle and exits
0 or 1 by its outcome; otherwise the data's fingerprint is polled and a
change seen on two ticks in a row starts a cycle. Each cycle's trainer
takes its CUDA-graph capture stream from ``device.capture_stream``, so two
cycles of one process never capture on a stream a live owner holds.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sqlite3
import sys
import time

from hhrs_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("hhrs_tpu_torch.pipeline")


def _append_history(runs_dir: str, rec: dict) -> None:
    os.makedirs(runs_dir, exist_ok=True)
    with open(os.path.join(runs_dir, "pipeline_history.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def run_cycle(data_dir: str, db: str, runs_dir: str, *, epochs: int | None = None, preset: str | None = None,
              warm_start: bool = True, promote_metric: str = "val_logloss", eval_split: str = "val",
              overrides: list[str] | None = None, tag: str = "", device: str | None = None) -> dict:
    """One train → gate → promote cycle → its history record. Never raises:
    a failure is recorded with ``"ok": False``."""
    from hhrs_tpu_torch.db import cli as db_cli
    from hhrs_tpu_torch.db.registry import ModelRegistry
    from hhrs_tpu_torch.serve.reload import snapshot_data_dir
    from hhrs_tpu_torch.train import cli as train_cli

    t0 = time.time()
    base = os.path.join(runs_dir, time.strftime("model-%Y%m%d-%H%M%S") + (f"-{tag}" if tag else ""))
    out, n = base, 1
    while os.path.exists(out):  # two cycles within one second
        out, n = f"{base}-{n}", n + 1
    rec: dict = {"ts": t0, "run_dir": out, "data_dir": os.path.abspath(data_dir)}
    try:
        snap = snapshot_data_dir(data_dir)
    except OSError:
        snap = None  # the cause is logged (disk, permissions)
    if snap is None:
        log.warning("data snapshot unavailable (see log); training from the LIVE dir (a mid-train write may "
                    "tear the read)")
    cycle_data = snap if snap is not None else data_dir
    rec["snapshot"] = snap is not None

    try:
        init_from = None
        if warm_start:
            try:
                active = ModelRegistry(db).active()
            except (FileNotFoundError, sqlite3.Error):
                active = None  # no usable registry yet: a cold start
            if active is not None:
                init_from = active["artifact_path"]
        rec["warm_start_from"] = init_from

        train_args = ["--data", cycle_data, "--out", out]
        if init_from:
            train_args += ["--init-from", init_from]
        if epochs is not None:
            train_args += ["--epochs", str(epochs)]
        if preset:
            train_args += ["--preset", preset]
        if device:
            train_args += ["--device", device]
        train_args += list(overrides or [])
        log.info("cycle: training into %s (%s)", out, f"warm start from {init_from}" if init_from else "cold start")
        t_train = time.time()
        try:
            rc = train_cli.main(train_args)
        except Exception as e:  # noqa: BLE001 — the watch loop must survive a bad drop
            log.error("training raised: %s", e, exc_info=True)
            rec.update(ok=False, stage="train", error=repr(e))
            return rec
        rec["train_rc"] = rc
        if rc != 0:
            rec.update(ok=False, stage="train")
            return rec
        rec["train_s"] = round(time.time() - t_train, 3)

        t_gate = time.time()
        try:
            # the gate scores the snapshot the candidate trained on, under its layered config
            from hhrs_tpu_torch.config import build_config

            gate_cfg = build_config(list(overrides or []), preset=preset, log=log)
            mid, promoted, reason = db_cli.run_promote(db, out, metric=promote_metric, eval_data=cycle_data,
                                                       eval_split=eval_split, cfg=gate_cfg,
                                                       record_eval_data=data_dir, device=device)
        except Exception as e:  # noqa: BLE001
            log.error("promote gate raised: %s", e, exc_info=True)
            rec.update(ok=False, stage="promote", error=repr(e))
            return rec
        rec.update(ok=True, model_id=mid, promoted=promoted, reason=reason, gate_s=round(time.time() - t_gate, 3),
                   total_s=round(time.time() - t0, 3))
        log.info("cycle done in %.1fs: model_id=%d %s — %s", rec["total_s"], mid,
                 "PROMOTED" if promoted else "kept incumbent", reason)
        return rec
    finally:
        if snap is not None:
            shutil.rmtree(snap, ignore_errors=True)


def main(argv=None) -> int:
    setup_logging()
    p = argparse.ArgumentParser(description="Continuous training with the PyTorch port: watch data, fine-tune, "
                                            "gate, promote")
    p.add_argument("--data", default="data", help="data dir with the two CSVs (watched)")
    p.add_argument("--db", required=True, help="sqlite model registry (created if missing)")
    p.add_argument("--runs-dir", default="runs", help="each cycle trains into a fresh subdir here")
    p.add_argument("--once", action="store_true",
                   help="run one cycle now (no watching) and exit; the exit code is the cycle's outcome")
    p.add_argument("--poll-s", type=float, default=30.0, help="watch mode: data fingerprint poll interval")
    p.add_argument("--max-cycles", type=int, default=0,
                   help="watch mode: stop after N triggered cycles, failed ones counted (0 = forever)")
    p.add_argument("--cold", action="store_true",
                   help="train from scratch each cycle instead of warm-starting from the active model")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--preset", default=None, help="train preset (e.g. 'tuned'); forwarded to the trainer")
    p.add_argument("--promote-metric", default="val_logloss")
    p.add_argument("--eval-split", choices=("all", "val", "train"), default="val",
                   help="the split of the refreshed data the gate scores both models on (default: the "
                        "held-out 'val'; the candidate trained on 'train')")
    p.add_argument("--device", default=None, help="cuda (default) or cpu, for training and the gate")
    p.add_argument("overrides", nargs="*", help="section.field=value config overrides, forwarded to the trainer")
    args = p.parse_args(argv)

    kw = dict(epochs=args.epochs, preset=args.preset, warm_start=not args.cold, promote_metric=args.promote_metric,
              eval_split=args.eval_split, overrides=args.overrides, device=args.device)
    if args.once:
        rec = run_cycle(args.data, args.db, args.runs_dir, **kw)
        _append_history(args.runs_dir, rec)
        return 0 if rec.get("ok") else 1

    # Watch: a fingerprint change seen on two ticks in a row starts a cycle
    # (a file mid-write does not); the snapshot protects the cycle's read.
    from hhrs_tpu_torch.serve.reload import data_fingerprint

    current_fp = data_fingerprint(args.data)
    pending = None
    cycles = 0
    log.info("watching %s every %.0fs (registry %s, runs in %s)", args.data, args.poll_s, args.db, args.runs_dir)
    while True:
        time.sleep(args.poll_s)
        fp = data_fingerprint(args.data)
        if fp == current_fp:
            pending = None
            continue
        if fp != pending:
            pending = fp
            continue
        cycles += 1
        rec = run_cycle(args.data, args.db, args.runs_dir, tag=f"c{cycles}", **kw)
        rec["trigger_fingerprint"] = [list(t) for t in fp]
        _append_history(args.runs_dir, rec)
        # this drop is seen even when its cycle failed: retrying it every tick would train in a loop
        current_fp = fp
        pending = None
        if args.max_cycles and cycles >= args.max_cycles:
            log.info("max cycles (%d) reached; exiting", args.max_cycles)
            return 0


if __name__ == "__main__":
    sys.exit(main())
