#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: build, parity, serving, training.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. needs ``torch.cuda.is_available()``; prints the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. builds ``hhrs_tpu_torch/csrc/tower_eval.cu`` and ``cross_stack.cu`` with
   nvcc (sm_90a), one nvcc for each source, started together, and beside
   them the native CSV reader ``csv_reader.cpp`` with g++;
3. prints the clusters the card holds at once and each launch plan's
   wave time, which the tower kernel's wrapper measures at first use and
   picks its plan from; holds the fused tower kernel against its plain
   PyTorch version on the card with the hpo_r5 weights: B ∈ {1, 31, 33, 128, 200, 1000, 8·128,
   64·128} (prefixes of one batch, each with the launch plan
   ``tower_plan`` picks), both cross variants, and a tower without
   residual blocks, at rtol = atol = 2e-5. Every launch runs twice and
   must repeat bit for bit; a flipped batch must give the same logits; and
   each B's logits must equal those of the same rows inside the largest
   batch, bit for bit (plan invariance);
   then the cross-stack forward and backward kernels against
   ``cross_stack_apply`` and ``cross_stack_backward_ref``: B ∈ {1, 3, 5,
   512, 1000, 4487, 8192} (ragged last tiles of 1 to 3 rows that are not
   bulk-copied, the training batch, the eval chunk), d ∈ {113, 33}, L ∈
   {1, 3}, both variants, at rtol 1e-5 / atol 1e-6 against the scale of
   the terms (``cross_stack_term_scale``); a repeated backward must be
   bit-identical, a row's output must not depend on its position in the
   batch, the registered operator ``hhrs::cross_stack_fwd`` (what the
   model calls without a gradient, and what an exported program records)
   on x0 as given, misaligned and strided must give the wrapper's forward
   bit for bit, forward and backward captured in a CUDA graph (under a backward
   scratch of its own) and replayed twice must give the eager results bit
   for bit, two backward graphs captured on one stream and replayed at
   once on two streams must each give their eager dx0/dw/db bit for bit,
   and a Hessian-vector product through ``CrossStackFn`` must equal the
   float64 one;
3b. the bfloat16 instantiation of the cross kernels against the plain
   versions on bf16 tensors (the model at ``compute_dtype=bfloat16``):
   B ∈ {1, 5, 9, 15, 512, 1000, 4487, 8192} (ragged last tiles of 1 to 7
   rows), d ∈ {113, 33}, L ∈ {1, 3}, both variants, at the term-scale bar
   with bf16's unit roundoff (rtol 2⁻⁸); repeated backwards bit-identical,
   flip invariance, the operator bit for bit the wrapper, and forward and backward replayed from a CUDA graph
   bit for bit;
4. builds ``RecommendationEngine.from_dirs("benchmarks/results/hpo_r5/best",
   "data")`` on cuda and serves the golden sweep (known, unknown and
   friendless users; every city and an unknown one; both modes; λ ∈
   {0.7, 1.0}), ``recommend_many`` with K = 8 and with K = 5 padded to 8,
   and ``similar_items``; every response must equal
   ``hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json``, where two hotels
   may trade places only if their golden logits differ by less than
   ``SWAP_TOL``. Each batch bucket runs as a CUDA graph; the kernel's launch
   count (an eager run and a capture per bucket) is reset just before this
   phase and must be > 0 after it. Then every request must give the same
   JSON through the eager path (the same launches, no graph);
5. times the kernel, its plain version and the cuBLAS products of the same
   tower at B = 128, 8·128 and 64·128: CUDA-event means, and beside them
   the device time of one call from torch.profiler (the kernel's own, and
   the sum of the products' GEMM kernels), so one request compares card
   against card (a kernel the profiler does not show fails the phase);
   then the p50 of ``recommend`` and ``recommend_many`` (K = 8), eager and
   graphed in turns over 8 rounds (host clock, each ending in the
   device→host copy), and a profile of 20 requests of each;
5b. the engine's options: ``quantize_tables`` (int8 tables, scored by the
   tower kernel), ``bf16`` (``DCNR.forward`` at compute bf16, through the
   bf16 cross forward kernel) and ``candidate_cap=16`` city-bounded and
   not, each over the golden sweep, buckets 1 and 8, graphed and eager:
   int8 against ``serve_golden_hpo_r5_int8.json`` under ``SWAP_TOL``; bf16
   against ``serve_golden_hpo_r5_bf16.json``, where two hotels may trade
   places only if their JAX bf16 logits differ by less than
   ``BF16_BAR · max |JAX bf16 − JAX f32|`` over the file's hotels; the
   capped engine equal to the uncapped one, both branches taken. Each
   engine's tower and cross-forward launches are counted from 0 over its
   sweep; then graphed ``recommend`` p50 of the f32, int8, bf16 and capped
   engines in turns, and the bf16 deep products' route timed;
6. training, parity runs: the port's ``Preprocessor`` on ``data/``, then
   ``train_dcn`` on cuda from the hpo_r5 weights with the hpo_r5 trial-139
   hyperparameters and dropout 0 for 2 epochs, per step and with
   ``train.fused_epoch``; the val loss must match
   ``hhrs_tpu_torch/testdata/train_golden_hpo_r5.json`` (the JAX trainer)
   at rtol 2e-3 / atol 2e-4 after the first epoch and at rtol 5e-3 after
   the later ones (``LATER_EPOCH_TOL``), the LR trace must be equal and the
   final val logloss / AUC must match at 2e-3; a second identical run must
   repeat each bit for bit. The same run with the plain cross stack in
   place of the kernels (its training steps and its evaluations) is
   printed beside it, as the trajectory's rounding-noise floor;
7. training, timing runs: the hpo_r5 configuration as trained (dropout
   0.6) from seeded random weights, 3 epochs, per step and with
   ``train.fused_epoch``, each with the cross kernels' launch counts reset
   just before and required as expected (> 0) just after; prints
   ``examples_per_s``, the p50 step time and a full-val eval's time,
   profiles one epoch of each, checks a checkpoint-and-resume round trip
   against the uninterrupted runs, exports the artifact to ``OUT_DIR``,
   loads it back and answers 5 golden requests from it;
7b. the same hpo_r5 training run at compute + storage bf16, per step and
   fused, with the bf16 cross kernels' launch counts from 0 (one backward a
   step), finite losses and f32 exported params;
8. prints the blocks of each cross kernel that the card runs at once
   (asked of the card), then times the cross kernels and their plain
   versions at B = 512, 4487 and 8192 (d = 113, L = 3): CUDA-event means,
   and each kernel's device time per call from torch.profiler over 50
   calls, which must show one cross kernel a call: a missing device time,
   more than 50 cross-kernel launches, or fewer than the profiler's
   ``PROFILE_DROPS`` allow fails the phase; the same for the bf16
   instantiation, in the same run;
9. the HTTP server and its serving stack: builds the port's CLI stack
   (``serve/cli.py::build_stack``: the engine on cuda from a registry, the
   dynamic batcher at a 2 ms window and 8 requests, the registry and data
   pollers, buckets 1, 8 and 64 captured before traffic) and serves it on
   127.0.0.1 from a thread, beside a server of the bare engine. The golden
   sweep through ``POST /recommendations``, one keep-alive client, in turns
   through both: 0 tie swaps, every body equal. The sweep as
   ``/recommendations/batch`` chunks of 64, equal to the single bodies; 16
   concurrent clients through each server, all 200 and equal;
   ``/similar_items`` against the golden answers; ``/healthz`` and
   ``/metrics`` must count the requests sent. Then, under 8 clients, a
   registry hot swap to phase 7's artifact and three data swaps: every
   answer 200, after the registry swap every body equal to the new engine's
   direct answer, and the card's memory after the data swaps (old stacks
   closed) no more than 8 MiB above that after the registry swap. The tower
   kernel's launches are set to 0 just before the stack is built and must be
   > 0 after the phase. Prints the p50 and p99 at one client, requests/s at
   16 clients with and without the batcher (clients in this process, and
   again from a client process: ``chip_smoke.py --http-client``), the
   batch endpoint's p50 at 64 requests, the engine's own p50s on the same
   sweep, and (a diagnostic) the one-client p50 with Nagle's algorithm on;
10. the retraining operator's path, each run's cross launches counted from
   0 just before it and read just after: (a) the ``tuned`` preset (B =
   32768, rng_impl=rbg, bf16 compute and storage) on its published data
   scale (``benchmarks/trainer_tuned.py``: 20,000 users, 4,000 items,
   500,000 reviews, seed 11) generated by ``data/synthetic.py`` into
   ``build/``: ingest cold and from ``--cache-dir``, then ``train/cli.py
   --preset tuned`` for 3 epochs per step and fused (the fused run also
   scores the catalog recall, 64 users × 4,000 items a forward): bf16
   cross launches > 0 at B = 32768, finite val logloss, AUC > 0.5; (b) the
   trainer's options on the hpo_r5 configuration and ``data/``, 3 epochs
   each: ``stream_slab_steps=8`` bit for bit the resident run,
   ``lazy_table_updates`` through the cross kernels, twice bit for bit,
   with its final val logloss within ``LAZY_TOL`` of the dense run's,
   ``moment_dtype=bfloat16`` per step and fused (stored first moments
   bf16), ``debug_nans`` raising ``FloatingPointError`` on a batch with one
   NaN feature per step and fused and not on clean data,
   ``eval_catalog_recall`` within ``CATALOG_RECALL_TOL`` of the same
   weights' value on the CPU; (c) two ``pipeline.py --once`` cycles on a
   copy of ``data/`` with a fresh registry, cold then warm after a data
   drop, both recorded ``ok``, then an engine on the card from the
   registry's active artifact answers one request through the tower
   kernel. Prints each run's step p50 and ``examples_per_s``, each cycle's
   train and gate seconds, and the phase's time;
11. the tuning operator's path and the rest of serve: (a) the trial-axis
   cross kernels at K = 8 (the hpo_r5 shape, B = 512, d = 113, L = 3; the
   search space's widest, B = 4096, d = 145, L = 6): every lane's y and dx0
   bit for bit the single-trial kernels' on its inputs, its dw and db bit
   for bit the single-trial backward's under the trial plan
   (``cross.trial_plan_of``, printed with its waves) and within the
   term-scale bar of it under ``plan_of``, all within the term-scale bar of
   the plain versions; the trial launch, K single-trial launches and the
   plain version timed (CUDA-event means, torch.profiler device time, and
   device time inside a CUDA graph); C5: the widest shape at the JAX init's
   full weight bound, the kernels within twice ``C5_SPREAD`` of the plain
   f32 version; (b) ``run_group`` of 8 lanes at trial 139's architecture
   (lanes from ``Study.ask(fixed=…)``), 3 epochs on ``data/``, its
   trial-axis launches counted from 0 (one a step and an eval chunk, not K
   times that), lanes 0 and 7 against their sequential ``train_dcn`` (val
   loss within C1's bars or twice a one-ulp twin's gap, LR decisions and
   best epoch equal), ``group_examples_per_s`` beside the sequential
   ``examples_per_s``; then C4, the same group at bf16 compute and storage,
   bf16 trial-axis launches only, lanes 0 and 7 against their sequential
   bf16 runs (``BF16_VAL_RTOL`` or twice a bf16 one-ulp twin's gap); (c)
   the HPO CLI as subprocesses (16 trials at ``--vectorize 8``, with
   ``--reclaim-lanes``, 2 sequential): each journal holds its trials, each
   best artifact serves a request through the tower kernel, and the
   port's Study resumes ``hpo_r5/journal.jsonl`` and asks 8 more; (d) the
   hpo_r5 ranker exported and loaded in a fresh process (``--export-check``)
   that imports no model code: B = 1, 128, 8192 bit for bit ``tower_eval``,
   one tower launch a call, timed against ``build_x0`` + ``tower_eval``; (e)
   the batch CLI over every user of ``data/`` in chunks of 64, each line
   equal to ``engine.recommend``, users/s and tower launches;
12. the two-tower retriever, the exported ranker of every architecture and
   the native CSV reader: (a) ``retrieval/two_tower.py`` at its default
   width (50 epochs, B = 1,024) on ``data/`` from the JAX init
   (``testdata/two_tower_init_data.npz``): epochs 0-2 at C1's bars against
   the JAX run (``two_tower_golden_data.json``), final recall@100 within
   ``CATALOG_RECALL_TOL`` of the JAX run's, ``examples_per_s``; (b) the golden sweep with the
   JAX-exported retrieval embeddings (``serve_golden_hpo_r5_two_tower.json``),
   buckets 1 and 8, graphed equal to eager, tower launches counted from 0;
   (c) every arch × {f32, bf16} × both variants at hpo_r5's widths (seeded
   weights) exported on the card and loaded back, B = 1, 128, 8192 bit for
   bit the engine's route for that bundle, ``hhrs::cross_stack_fwd`` (f32
   and bf16) and ``hhrs::tower_eval`` launches counted from 0 over the
   exported calls, CUDA-event ms beside the direct route; (d) phase 10a's
   500,000 rows read with ``engine="native"`` and ``engine="python"``:
   equal tables and splits, both times;
13. serving over a device mesh (``serve/engine.py``'s ``mesh``;
   ``parallel/``): (a) a world of one rank on NCCL in this process: the
   golden sweep at buckets 1 and 8 through the mesh engine, graphed and
   eager, equal to phase 4's engine's JSON, one tower launch per eager
   batch, the collectives made inside the bucket captures counted, and
   ``recommend`` p50 beside phase 4's engine in turns;
   (b) a gloo world of 2 ranks sharing the card (hpo_r5, 300 items a
   rank): the sweep at buckets 1 and 8 under the serve-correct rule against
   phase 4's engine (equal JSON, or trades of places only between hotels
   whose logits differ by less than ``SWAP_TOL``), ``similar_items`` of
   every item equal, each rank's tower on its rows held to
   ``tower_eval_ref`` at ``TOL``, its launches, the largest |Δlogit| of a
   rank's rows against one single-device launch, and one bf16 batch that
   launches the bf16 cross forward on each rank and no tower and meets the
   bf16 golden file at phase 5b's bar; (c) the same
   on phase 10a's data (4,000 items, 500,000 reviews) with a seeded random
   model at hpo_r5's widths over 3 ranks (4,002 rows), 64 requests, the
   one-request batch p50 (ranks that share one card: not a multi-GPU
   speed); (d) ``python -m hhrs_tpu_torch.serve.cli --mesh 2`` boots,
   answers ``/healthz`` and one ``POST /recommendations`` equal to the
   single-device answer, and leaves no rank after SIGTERM. Each world's
   backend and whether it ran graphed are printed;
14. training over a device mesh (``train_dcn``'s ``mesh``; ``parallel/``):
   (a) a world of one rank on NCCL in this process: the golden parity run
   (phase 6's) through ``train_dcn(mesh=1x1)``, its val losses within
   rtol 1e-4 / atol 1e-6 of phase 6's single-device run and within C1's
   bars of the golden file, the LR trace equal, its cross launches counted
   from 0 (one forward and one backward a step, one forward an eval chunk);
   then the hpo_r5 run's step p50 and ``examples_per_s`` beside the
   single-device trainer's, in turns; (b) a gloo world of 2 ranks sharing
   the card: on each rank the cross kernels on its 256 rows of a training
   batch, f32 and bf16 (y and dx0 the whole-batch launch's rows bit for
   bit, dw and db summed over the ranks within the term-scale bar of the
   whole batch); then one step of the hpo_r5 configuration (dropout 0.6,
   seeded weights) at 2x1, within rtol 1e-4 / atol 1e-6 of one
   single-device step; 3 epochs of it at 2x1 (the default exchange) and at
   1x2 with ``all_to_all``, each within rtol 1e-4 / atol 1e-6 of phase 7's
   single-device run or within the trajectory's rounding noise where that
   is larger (twice the widest gap among that run and its one-ulp, order
   and scale twins), with the LR trace equal, every rank's history equal
   and its replicated weights bit-identical, each rank's cross launches
   counted; one bf16 epoch (bf16 cross launches on each rank) within
   ``BF16_VAL_RTOL`` (or its noise) of the single-device bf16 epoch; the capped exchange
   at factor 1.0, its drop rate on the card equal to the same world's CPU
   run; the 2x1 step p50 and rank 0's host time inside collectives (ranks
   that share one card: not a multi-GPU speed); (c) ``python -m
   hhrs_tpu_torch.train.cli --mesh 2`` trains one epoch and writes one
   artifact, the single-device engine answers a request from it, and no
   rank is left after the CLI exits.

The last lines are one JSON object of kernel measurements, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
ARTIFACT = "benchmarks/results/hpo_r5/best"
GOLDEN = "hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json"
TRAIN_GOLDEN = "hhrs_tpu_torch/testdata/train_golden_hpo_r5.json"
OUT_DIR = REPO / "chiprun_out"
SEED = 0
TOL = 2e-5  # kernel vs plain, rtol and atol: the JAX kernel's parity bar
CROSS_TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX cross kernel's bar, against the term scale
CROSS_BF16_TOL = dict(rtol=2.0 ** -8, atol=0.0)  # bf16's unit roundoff, against the term scale
VAL_TOL = dict(rtol=2e-3, atol=2e-4)  # training trajectory vs the JAX trainer
# Epochs after the first: the val loss of this configuration (lr 6.4e-3 AdamW
# from a trained state) carries rounding noise of ~1e-3 by epoch 1, more
# than VAL_TOL allows (PERF.md §6); the bar there is 2x the largest
# gap measured between valid float32 runs. tests/test_torch_port_train.py
# holds the CPU run to the same two bars.
LATER_EPOCH_TOL = dict(rtol=5e-3, atol=2e-4)
# bf16 training: the bf16 trainer's bar on the val loss (tests/
# test_torch_port_train.py BF16_VAL_RTOL; one bf16 ulp is 2^-7 relative)
BF16_VAL_RTOL = 1e-2
SWAP_TOL = 1e-4  # golden logits of two hotels allowed to trade places
# The bf16 engine: two hotels may trade places where their JAX bf16 logits
# differ by less than BF16_BAR times the largest |JAX bf16 − JAX f32| logit
# of the golden file (tests/test_torch_port_model.py's model bar).
BF16_BAR = 0.05
GOLDEN_INT8 = "hhrs_tpu_torch/testdata/serve_golden_hpo_r5_int8.json"
GOLDEN_BF16 = "hhrs_tpu_torch/testdata/serve_golden_hpo_r5_bf16.json"
CAP = 16
# Tower parity sizes: one request, ragged tiles, the golden sweep's 200,
# recommend_many (K = 8), 64 requests; each takes another launch plan.
TOWER_PARITY_B = (1, 31, 33, 128, 200, 1000, 1024, 64 * 128)
TOWER_TIMED_B = ((128, 500), (8 * 128, 200), (64 * 128, 50))  # (B, calls)
# Cross parity sizes: ragged last tiles of 1, 3 and 1 rows past a multiple
# of 4 (B = 1, 3, 5), the training batch, the eval chunk (4487), 8192, and
# the tuned preset's batch (32768).
CROSS_PARITY_B = (1, 3, 5, 512, 1000, 4487, 8192, 32768)
# bf16 rows are bulk-copied 8 at a time: last tiles of 1, 5, 1 and 7 rows.
CROSS_BF16_PARITY_B = (1, 5, 9, 15, 512, 1000, 4487, 8192, 32768)
CROSS_TIMED_B = ((512, 500), (4487, 300), (8192, 200), (32768, 100))  # (B, calls), d = 113, L = 3
# H100 SXM published peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "nvidia-smi unavailable"


def demangled(name: str) -> str:
    """A kernel's mangled name as ``kernel<type, ints...>`` (the name as it
    is where it is no kernel of this repo)."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:I(f|13__nv_bfloat16)?((?:Li\d+E)*))?", name)
    if not m:
        return name
    kernel, elem, ints = m.groups()
    args = [{"f": "float", "13__nv_bfloat16": "bf16"}[elem]] if elem else []
    args += re.findall(r"Li(\d+)E", ints or "")
    return kernel + (f"<{', '.join(args)}>" if args else "")


def ptxas_summary(log: str) -> list:
    """(kernel, registers, spill bytes) of each entry point in a ptxas -v log."""
    rows, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = demangled(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spills))
            name = None
    return rows


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


class SmokeFailure(Exception):
    """A phase failed: the script prints why and exits non-zero."""


def tower_work(folded: dict, B: int) -> tuple[float, float]:
    """(flops, bytes) one call must do: each input read once, output written once."""
    d, H = folded["w0"].shape
    R, L = folded["w1"].shape[0], folded["cross_w"].shape[0]
    flops = 2.0 * B * (d * H + 2 * R * H * H + 3 * L * d + H + d)
    weights = sum(t.numel() for t in folded.values())
    return flops, 4.0 * (weights + B * d + B)


def time_cuda(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after warm-up (CUDA events).
    Where the host's launch path is longer than the kernel, this times the
    host."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(avg) -> list:
    """The kernels and copies of a profile. Their own times add up to the
    device's busy time, as the profiler's table totals it; an op's or an
    annotation range's device time would count the same kernels again."""
    from torch.autograd import DeviceType

    return [e for e in avg if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


# torch.profiler on the card drops kernel events now and then: in some
# processes one or a few of 50 in every profile (up to 6 of 50 measured,
# PERF.md section 6). A profile short of its launches is taken again, up to
# PROFILE_ATTEMPTS times; the fullest may still miss PROFILE_DROPS of them,
# never show more.
PROFILE_ATTEMPTS = 3
PROFILE_DROPS = 0.2


def profile_kernels(fn, calls: int, name: str | None = None, launches: int = 1) -> list:
    """The device events (kernels and copies) of ``calls`` calls of ``fn``
    after a warm-up, from torch.profiler: each with its name (``key``),
    count and self device time. Where ``name`` is given and fewer than
    ``launches`` kernels of it a call show, the calls are profiled again, up
    to ``PROFILE_ATTEMPTS`` times in all, and the fullest profile is
    returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best, best_n = [], -1
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof.key_averages())
        n = sum(e.count for e in events if name is None or name in e.key)
        if n > best_n:
            best, best_n = events, n
        if name is None or n >= launches * calls:
            break
    if name is not None and best_n < launches * calls:
        print(f"[profile] {best_n} of {launches * calls} launches of {name} shown in the fullest of "
              f"{PROFILE_ATTEMPTS} profiles", flush=True)
    return best


def device_ms_per_call(fn, calls: int, name: str | None = None, launches: int = 1) -> float | None:
    """Device time of one call (torch.profiler) over ``calls`` calls after a
    warm-up. Without ``name``: every kernel's and copy's self time, divided
    by ``calls``. With it: the self time of the kernels whose name holds
    it, where each call launches ``launches`` of them, scaled to ``launches
    * calls``. Raises where the profile shows more of them than that. None
    (not measured) where the profiler shows no device time, or more than
    ``PROFILE_DROPS`` of the launches missing: its kernel events can all be
    lost in a process, and the launch counters, not the profiler, prove the
    launches."""
    want = launches * calls
    events = [e for e in profile_kernels(fn, calls, name, launches) if name is None or name in e.key]
    total, shown = sum(e.self_device_time_total for e in events), sum(e.count for e in events)
    if name is not None and shown > want:
        raise SmokeFailure(f"{calls} calls launched {[(e.key, e.count) for e in events]}, not {launches} "
                           f"{name} a call")
    if total <= 0 or (name is not None and shown < (1 - PROFILE_DROPS) * want):
        print(f"[profile] device time of {name or 'any kernel'} not measured: the profiler shows {shown} "
              f"events" + (f" of {want} launches" if name is not None else ""), flush=True)
        return None
    if name is None:
        return total / 1e3 / calls
    return total / shown * want / 1e3 / calls


def ms_text(ms: float | None, scale: float = 1.0, digits: int = 4) -> str:
    """A device time for a log line; None (not measured) says so."""
    return "not measured" if ms is None else f"{ms * scale:.{digits}f}"


def compare_response(got: dict, want: dict, logits: list, tol: float = SWAP_TOL) -> int | None:
    """Number of tie swaps, or None when ``got`` breaks the tie rule (two
    hotels trade places only where their logits differ by less than ``tol``)."""
    if set(got) != set(want) or got.get("message") != want.get("message"):
        return None
    g, w = got["ranked_hotels"], want["ranked_hotels"]
    if len(g) != len(w):
        return None
    logit = {h["hotel_id"]: x for h, x in zip(w, logits)}
    payload = {h["hotel_id"]: h for h in w}
    swaps = 0
    for gh, wh in zip(g, w):
        if gh.get("hotel_id") not in payload or gh != payload[gh["hotel_id"]]:
            return None
        if gh["hotel_id"] != wh["hotel_id"]:
            if abs(logit[gh["hotel_id"]] - logit[wh["hotel_id"]]) >= tol:
                return None
            swaps += 1
    return swaps


def cross_work(B: int, d: int, L: int, kind: str, variant: str = "code", elem: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one cross-stack call on elements of ``elem`` bytes:
    each input read once, each output written once. A forward layer is a
    d-term gate (2d) and a 3-op update (3d) per row; the backward recomputes
    the forward and then does 8d (code) or 9d (canonical) per layer and row.
    The bf16 instantiation does the same f32 operations (its roundings are
    conversions, not counted) on half the bytes."""
    if kind == "fwd":
        return 5.0 * B * L * d, elem * (2 * B * d + 2 * L * d)
    per_layer = 8 if variant == "code" else 9
    return (5.0 + per_layer) * B * L * d, elem * (3 * B * d + 4 * L * d)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def serve_timings(engine, reqs: list, card: str) -> None:
    """``recommend`` and ``recommend_many`` (K = 8) p50, eager against
    graphed, in turns (eager, graphed, graphed, eager, twice) so that both
    see the same host; each p50 per round, their median and spread. Then a
    profile of 20 requests of each (a diagnostic)."""
    import torch

    def p50_one(fn) -> float:
        lat = []
        for i in range(3 * len(reqs) // 2):
            t0 = time.perf_counter()
            fn([reqs[i % len(reqs)]])
            lat.append(time.perf_counter() - t0)
        return statistics.median(lat[10:]) * 1e3

    def p50_many(fn) -> float:
        lat = []
        for i in range(30):
            batch = [reqs[(8 * i + j) % len(reqs)] for j in range(8)]
            t0 = time.perf_counter()
            fn(batch)
            lat.append(time.perf_counter() - t0)
        return statistics.median(lat[3:]) * 1e3

    paths = {"eager": engine._recommend_eager, "graphed": engine.recommend_many}
    rounds = {k: {"one": [], "many": []} for k in paths}
    for label in ("eager", "graphed", "graphed", "eager") * 2:
        rounds[label]["one"].append(p50_one(paths[label]))
        rounds[label]["many"].append(p50_many(paths[label]))
    for label, r in rounds.items():
        for kind, name in (("one", "recommend p50 ms/request"), ("many", "recommend_many(K=8) p50 ms/batch")):
            xs = r[kind]
            print(f"[time] {label} {name}: rounds {', '.join(f'{x:.3f}' for x in xs)}; median "
                  f"{statistics.median(xs):.3f}, spread {min(xs):.3f}-{max(xs):.3f} (host clock, each ending in "
                  f"the device->host copy) on {card}")
    try:  # the profiler is a diagnostic, not a phase: its absence fails nothing
        from torch.profiler import ProfilerActivity, profile

        for label, fn in paths.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for req in reqs[:20]:
                    fn([req])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            avg = prof.key_averages()
            kernels_dev = device_events(avg)
            device_ms = sum(e.self_device_time_total for e in kernels_dev) / 1e3
            (OUT_DIR / f"chip_smoke_profile_{label}.txt").write_text(
                avg.table(sort_by="self_device_time_total", row_limit=40))
            if device_ms <= 0:
                print(f"[profile] 20 {label} recommend calls: device time not measured (the profiler shows no "
                      f"device events); wall {wall_ms:.2f} ms on {card}")
                continue
            print(f"[profile] 20 {label} recommend calls: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
                  f"(idle {100 * (1 - device_ms / wall_ms):.1f}% of wall, profiler on), "
                  f"{sum(e.count for e in kernels_dev) / 20:.0f} kernels and copies a request on {card}")
            for e in sorted(kernels_dev, key=lambda e: e.self_device_time_total, reverse=True)[:5]:
                print(f"[profile]   {label} {e.key[:64]:64s} self {e.self_device_time_total / 1e3:8.3f} ms "
                      f"calls {e.count}")
    except Exception as e:  # noqa: BLE001
        print(f"[profile] not measured: {type(e).__name__}: {e}")


def operator_outputs(w, b, x0, variant: str) -> list:
    """``hhrs::cross_stack_fwd`` (what CrossStack calls without a gradient,
    and what an exported program records) on x0 as given, on a copy of it
    off a 16-byte boundary and on a column-major copy: one counted forward
    launch each, after the operator's own copy of the last two."""
    import torch

    off = torch.empty(x0.numel() + 1, dtype=x0.dtype, device=x0.device)[1:].view(x0.shape).copy_(x0)
    strided = x0.t().contiguous().t()
    return [torch.ops.hhrs.cross_stack_fwd(x, w, b, variant) for x in (x0, off, strided)]


def held_operator(y_ops: list, y, where: str) -> None:
    """The operator's outputs must be the wrapper's ``y`` (itself held to
    the plain version) bit for bit, in its dtype."""
    import torch

    for name, got in zip(("as given", "misaligned", "strided"), y_ops):
        if got.dtype != y.dtype or not torch.equal(got, y):
            raise SmokeFailure(f"hhrs::cross_stack_fwd on an x0 {name} differs from cross_stack_forward at {where}")


def cross_parity(cross, model, features, dev) -> dict:
    """Forward and backward kernels against the plain versions; returns the
    largest |kernel − plain| of each."""
    import numpy as np
    import torch

    gen = np.random.default_rng(SEED + 1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    d_model = model.cross.w.shape[1]
    errs = {"fwd": 0.0, "bwd": 0.0}
    shares = {"fwd": 0.0, "bwd": 0.0}
    before = (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
    n_fwd = n_bwd = 0
    for B in CROSS_PARITY_B:
        for d in (d_model, 33):
            for L in (1, 3):
                for variant in ("code", "canonical"):
                    if d == d_model:  # hpo_r5's trained cross weights on real feature rows
                        x0 = features(B)
                        w, b = model.cross.w.detach()[:L].contiguous(), model.cross.b.detach()[:L].contiguous()
                    else:  # the JAX init's distributions, and a non-zero bias
                        x0 = f32(gen.standard_normal((B, d)))
                        w = f32(gen.uniform(-1, 1, (L, d)) / np.sqrt(d))
                        b = f32(0.1 * gen.standard_normal((L, d)))
                    dy = f32(gen.standard_normal((B, d)))
                    with torch.no_grad():
                        y = cross.cross_stack_forward(w, b, x0, variant)
                        grads = cross.cross_stack_backward(w, b, x0, dy, variant)
                        again = cross.cross_stack_backward(w, b, x0, dy, variant)
                        x0f, dyf = x0.flip(0).contiguous(), dy.flip(0).contiguous()
                        y_flip = cross.cross_stack_forward(w, b, x0f, variant).flip(0)
                        dx0_flip = cross.cross_stack_backward(w, b, x0f, dyf, variant)[0].flip(0)
                        y_ops = operator_outputs(w, b, x0, variant)
                        n_fwd, n_bwd = n_fwd + 2 + len(y_ops), n_bwd + 3
                        torch.cuda.synchronize()
                        ref = (cross.cross_stack_apply(w, b, x0, variant),
                               *cross.cross_stack_backward_ref(w, b, x0, dy, variant))
                        scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)
                    where = f"B={B} d={d} L={L} {variant}"
                    try:
                        e = [cross.assert_close_to_scale(g, r, sc, **CROSS_TOL, what=name)
                             for name, g, r, sc in zip(("y", "dx0", "dw", "db"), (y, *grads), ref, scale)]
                    except AssertionError as exc:
                        raise SmokeFailure(f"cross kernels disagree with their plain versions at {where}: {exc}")
                    if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                        raise SmokeFailure(f"a repeated cross backward is not bit-identical at {where}")
                    if not (torch.equal(y_flip, y) and torch.equal(dx0_flip, grads[0])):
                        raise SmokeFailure(f"a row's cross output depends on its position at {where}")
                    held_operator(y_ops, y, where)
                    errs["fwd"] = max(errs["fwd"], e[0][0])
                    errs["bwd"] = max(errs["bwd"], *(x[0] for x in e[1:]))
                    shares["fwd"] = max(shares["fwd"], e[0][1])
                    shares["bwd"] = max(shares["bwd"], *(x[1] for x in e[1:]))
                    print(f"[parity] cross {where}: max|kernel-plain| (share of the allowance) "
                          + " ".join(f"{n} {x[0]:.3e} ({x[1]:.2f})" for n, x in zip(("y", "dx0", "dw", "db"), e))
                          + "; repeat bit-identical; flip bit-identical; operator = wrapper bit for bit")
    # The training step's call, captured in a CUDA graph (the backward's
    # scratch allocated in the capture) and replayed: the tickets are back at
    # 0 after every launch.
    x0 = features(512)
    w, b = model.cross.w.detach().contiguous(), model.cross.b.detach().contiguous()
    dy = f32(gen.standard_normal(tuple(x0.shape)))
    with torch.no_grad():
        want = (cross.cross_stack_forward(w, b, x0, "code"), *cross.cross_stack_backward(w, b, x0, dy, "code"))
        side = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            outs = (cross.cross_stack_forward(w, b, x0, "code"), *cross.cross_stack_backward(w, b, x0, dy, "code"))
        n_fwd, n_bwd = n_fwd + 2, n_bwd + 2
        for _ in range(2):
            for t in outs:
                t.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(o, e) for o, e in zip(outs, want)):
                raise SmokeFailure("the cross kernels replayed from a CUDA graph differ from the eager calls")
    print("[parity] cross: forward + backward (B=512) captured in a CUDA graph and replayed twice: "
          "bit-identical to the eager calls")
    n_bwd += concurrent_graph_check(cross, features, f32, gen)
    fwd, bwd = double_backward_check(cross, features, f32, gen)
    n_fwd, n_bwd = n_fwd + fwd, n_bwd + bwd
    after = (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
    if (after[0] - before[0], after[1] - before[1]) != (n_fwd, n_bwd):
        raise SmokeFailure("the cross launch counters did not count every parity launch")
    print(f"[parity] cross: {n_fwd} forward + {n_bwd} backward launches held to rtol={CROSS_TOL['rtol']} "
          f"atol={CROSS_TOL['atol']} against the term scale; max abs err fwd {errs['fwd']:.3e} "
          f"bwd {errs['bwd']:.3e}; largest share of the allowance used fwd {shares['fwd']:.3f} "
          f"bwd {shares['bwd']:.3f}")
    return errs


def concurrent_graph_check(cross, features, f32, gen) -> int:
    """Fault C3: two backward graphs captured on one capture stream, each
    with the scratch it allocated in its capture, replayed at the same time
    on two streams (B = 8192, so the launches overlap) give their eager
    dx0/dw/db bit for bit, 20 times; and the library's owners of graphs
    (engines, fused epochs) never share a capture stream, whose cuBLAS
    workspace the graphs would share. Returns the backward launches made."""
    import torch

    from hhrs_tpu_torch.device import capture_stream

    cases = []
    for _ in range(2):
        x0 = features(8192)
        dy = f32(gen.standard_normal(tuple(x0.shape)))
        d = x0.shape[1]
        w, b = f32(gen.uniform(-1, 1, (3, d)) / d ** 0.5), f32(0.1 * gen.standard_normal((3, d)))
        cases.append((w, b, x0, dy, cross.cross_stack_backward(w, b, x0, dy, "code")))
    capture = torch.cuda.Stream()
    graphs = []
    for w, b, x0, dy, _ in cases:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            outs = cross.cross_stack_backward(w, b, x0, dy, "code")
        graphs.append((graph, outs))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(20):
        for (graph, outs), stream in zip(graphs, streams):
            for t in outs:
                t.fill_(float("nan"))
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        for stream in streams:
            torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        for (_, outs), case in zip(graphs, cases):
            if not all(torch.equal(o, e) for o, e in zip(outs, case[4])):
                raise SmokeFailure("two backward graphs of one capture stream replayed at once gave other "
                                   "dx0/dw/db than their eager calls")
    owners = [type("Owner", (), {})() for _ in range(40)]
    handles = {capture_stream(o, torch.device("cuda")).cuda_stream for o in owners}
    if len(handles) != len(owners):
        raise SmokeFailure("two live owners of CUDA graphs were given one capture stream")
    print("[parity] cross: two backward graphs (B=8192) captured on one stream, each with its own scratch, "
          "replayed at once on two streams 20 times: dx0/dw/db bit-identical to their eager calls; "
          f"{len(owners)} live owners of graphs hold {len(handles)} distinct capture streams")
    return 4


def double_backward_check(cross, features, f32, gen) -> tuple:
    """Fault C2: a Hessian-vector product through CrossStackFn on the card
    (the first-order values from one backward kernel launch, the second
    derivative from the closed form) against the float64 one, at the cross
    bar against each leaf's largest entry. Returns the forward and backward
    launches made."""
    import torch

    x0 = features(512)
    w = f32(gen.uniform(-1, 1, (3, x0.shape[1])) / x0.shape[1] ** 0.5)
    b = f32(0.1 * gen.standard_normal((3, x0.shape[1])))
    c = f32(gen.standard_normal(tuple(x0.shape)))
    v = [f32(gen.standard_normal(tuple(t.shape))) for t in (w, b, x0)]

    def hvp(fn, inputs, c, v):
        leaves = [t.clone().requires_grad_() for t in inputs]
        grads = torch.autograd.grad((fn(*leaves, "code") * c).sum(), leaves, create_graph=True)
        return torch.autograd.grad(sum((g * d).sum() for g, d in zip(grads, v)), leaves, materialize_grads=True)

    before = cross.cross_stack_backward.launches
    got = hvp(cross.CrossStackFn.apply, (w, b, x0), c, v)
    exact = hvp(cross.cross_stack_apply, [t.double() for t in (w, b, x0)], c.double(), [t.double() for t in v])
    if cross.cross_stack_backward.launches != before + 1:
        raise SmokeFailure("a double backward through CrossStackFn did not take its first-order values from "
                           "one backward kernel launch")
    shares = []
    for name, g, ex in zip(("w", "b", "x0"), got, exact):
        try:
            shares.append(cross.assert_close_to_scale(g, ex, ex.abs().max().expand_as(ex), **CROSS_TOL,
                                                      what=f"HVP {name}")[1])
        except AssertionError as exc:
            raise SmokeFailure(f"the double backward through CrossStackFn is not exact: {exc}")
    print(f"[parity] cross: Hessian-vector product through CrossStackFn (B=512; first-order values from the "
          f"backward kernel) equals the float64 one; largest share of the allowance {max(shares):.3f}")
    return 1, 1


def training_parity(splits, bundle, dev, card: str) -> list:
    """train_dcn on the card, per step and with train.fused_epoch, against
    the JAX trainer's golden trajectory; each run twice, bit for bit →
    the per-step run's history."""
    import numpy as np

    from hhrs_tpu_torch.config import ModelConfig, TrainConfig
    from hhrs_tpu_torch.models.convert import flatten_tree
    from hhrs_tpu_torch.ops import cross
    from hhrs_tpu_torch.train.trainer import train_dcn

    golden = json.loads((REPO / TRAIN_GOLDEN).read_text())
    if (splits.n_train, splits.n_val) != (golden["n_train"], golden["n_val"]):
        raise SmokeFailure(f"data/ gives {splits.n_train}/{splits.n_val} rows, the golden run "
                           f"{golden['n_train']}/{golden['n_val']}")
    model_cfg, train_cfg = ModelConfig(**golden["model_config"]), TrainConfig(**golden["train_config"])

    def run(params, fused=False):
        t0 = time.perf_counter()
        r = train_dcn(splits, bundle.dims, model_cfg, dataclasses.replace(train_cfg, fused_epoch=fused),
                      init_state=(params, bundle.bn_state), device=dev)
        return r, time.perf_counter() - t0

    def held(result, label):
        bars = [VAL_TOL] + [LATER_EPOCH_TOL] * (len(golden["history"]) - 1)
        for h, w, bar in zip(result.history, golden["history"], bars):
            allowed = bar["atol"] + bar["rtol"] * abs(w["val_loss"])
            print(f"[train]   {label} epoch {h['epoch']}: val_loss card {h['val_loss']:.7f} JAX {w['val_loss']:.7f} "
                  f"|Δ| {abs(h['val_loss'] - w['val_loss']):.3e} (allowed {allowed:.3e}); lr {h['lr']:.6g}")
        fm, gm = result.final_metrics, golden["final_metrics"]
        print(f"[train]   {label} final val_logloss {fm['val_logloss']:.7f} (JAX {gm['val_logloss']:.7f}), "
              f"val_auc {fm['val_auc']:.7f} (JAX {gm['val_auc']:.7f})")
        got = np.array([h["val_loss"] for h in result.history])
        want = np.array([h["val_loss"] for h in golden["history"]])
        if len(got) != len(want) or not all(np.isclose(g, w, **bar) for g, w, bar in zip(got, want, bars)):
            raise SmokeFailure(f"the card's {label} val-loss trajectory differs from the JAX trainer's golden one")
        if [h["lr"] for h in result.history] != [h["lr"] for h in golden["history"]]:
            raise SmokeFailure(f"the card's {label} LR trace differs from the JAX trainer's")
        if not (np.isclose(fm["val_logloss"], gm["val_logloss"], **VAL_TOL)
                and abs(fm["val_auc"] - gm["val_auc"]) <= 2e-3):
            raise SmokeFailure(f"the {label} final val logloss / AUC differ from the JAX trainer's")

    def same(a, b) -> bool:
        fa, fb = flatten_tree(a.params), flatten_tree(b.params)
        return a.history == b.history and all(np.array_equal(fa[k], fb[k]) for k in fa)

    for fused, label in ((False, "per-step"), (True, "fused-epoch")):
        result, secs = run(bundle.params, fused)
        again, _ = run(bundle.params, fused)  # deterministic kernels: the run repeats bit for bit
        if not same(result, again):
            raise SmokeFailure(f"two identical {label} training runs on the card differ")
        print(f"[train] {label} parity run (hpo_r5 weights, trial-139 hyperparameters, dropout 0, "
              f"{train_cfg.n_epochs} epochs) in {secs:.2f} s on {card}; a second identical run gives the same "
              "history and bit-identical weights")
        held(result, label)
        if not fused:
            per_step = result
    fused_lr_check(splits, bundle, model_cfg, train_cfg, dev)
    # The rounding-noise floor of this trajectory: the same run with the
    # plain cross stack (autograd through cross_stack_apply) in place of the
    # kernels, both valid float32 programs. CrossStack calls cross.cross_stack
    # with and without a gradient, so the evaluations are plain too.
    kernel_path = cross.cross_stack
    cross.cross_stack = cross.cross_stack_apply
    before = cross_counts(cross)
    try:
        plain, _ = run(bundle.params)
    finally:
        cross.cross_stack = kernel_path
    if cross_counts(cross) != before:
        raise SmokeFailure("the plain cross stack run launched a cross kernel (a training step or an evaluation "
                           "did not take the plain version)")
    for h, k, w in zip(plain.history, per_step.history, golden["history"]):
        print(f"[train]   epoch {h['epoch']}, plain cross stack on the card (0 cross launches, steps and "
              f"evaluations): val_loss {h['val_loss']:.7f}; "
              f"|kernels - plain| {abs(k['val_loss'] - h['val_loss']):.3e}, "
              f"|plain - JAX| {abs(h['val_loss'] - w['val_loss']):.3e}")
    return per_step.history


def fused_lr_check(splits, bundle, model_cfg, train_cfg, dev) -> None:
    """The fused epoch's graph reads the optimizer's LR tensor. From the
    hpo_r5 weights with lr_plateau_patience 0 the LR decays after epoch 1:
    the fused run (epochs 2 and 3 replayed at the decayed LR) keeps the
    per-step run's LR trace and stays at the golden bars of its val losses.
    And a replay after set_learning_rate(0) leaves every parameter as it
    was, bit for bit, while one at the LR moves them."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.train.optimizers import make_optimizer, set_learning_rate
    from hhrs_tpu_torch.train.trainer import FusedEpoch, split_tensors, train_dcn

    runs = [train_dcn(splits, bundle.dims, model_cfg,
                      dataclasses.replace(train_cfg, n_epochs=4, lr_plateau_patience=0, fused_epoch=fused),
                      init_state=(bundle.params, bundle.bn_state), device=dev) for fused in (False, True)]
    lrs = [[h["lr"] for h in r.history] for r in runs]
    bars = [VAL_TOL] + [LATER_EPOCH_TOL] * 3
    print(f"[train] plateau decay (patience 0, 4 epochs): LR trace per step {lrs[0]}, fused {lrs[1]}; "
          "val_loss per step / fused: " + ", ".join(f"{a['val_loss']:.7f} / {b['val_loss']:.7f}"
                                                   for a, b in zip(runs[0].history, runs[1].history)))
    if lrs[0] != lrs[1] or not min(lrs[1][:-1]) < lrs[1][0]:
        raise SmokeFailure("the plateau-decay runs' LR traces differ or never decay before the last epoch")
    if not all(np.isclose(f["val_loss"], p["val_loss"], **bar)
               for f, p, bar in zip(runs[1].history, runs[0].history, bars)):
        raise SmokeFailure("the fused run with a plateau decay left the per-step run's trajectory")

    model = runs[1].model.train()
    opt = make_optimizer(train_cfg.optimizer, model.parameters(), train_cfg.lr, train_cfg.weight_decay,
                         capturable_on=torch.device(dev))
    B = train_cfg.batch_size
    steps = splits.n_train // B
    fused = FusedEpoch(model, opt, split_tensors(splits, "train", dev), B, steps,
                       torch.Generator(device=dev).manual_seed(SEED))
    perm = np.random.default_rng(SEED).permutation(splits.n_train)[:steps * B]
    fused.run(perm)  # eager, then the capture

    def moved(rate: float) -> float:
        set_learning_rate(opt, rate)
        before = [t.detach().clone() for t in model.parameters()]
        fused.run(perm)
        torch.cuda.synchronize()
        return max(float((t.detach() - u).abs().max()) for t, u in zip(model.parameters(), before))

    at_lr, at_zero, at_tenth = moved(train_cfg.lr), moved(0.0), moved(train_cfg.lr / 10)
    print(f"[train] fused epoch replayed at LR {train_cfg.lr:.6g}, 0, {train_cfg.lr / 10:.6g}: largest parameter "
          f"move {at_lr:.3e}, {at_zero:.3e}, {at_tenth:.3e}")
    if not (at_zero == 0.0 and 0 < at_tenth < at_lr):
        raise SmokeFailure("the fused epoch's graph does not follow the optimizer's LR tensor")


def train_run(splits, dims, model_cfg, train_cfg, dev, card: str, label: str, extra_fwd: int = 0):
    """One timed train_dcn run, with the cross kernels' launch counts set to
    0 just before it and read just after → ``(result, launches)``: those of
    the instantiation of the model's compute dtype, the other's must stay 0.
    Per step, the wrappers launch one forward and one backward a step and
    one forward an eval chunk; under train.fused_epoch they launch in the
    first epoch, which runs eagerly, and in the capture after it, and every
    later epoch is one graph replay. ``extra_fwd``: forward launches beyond
    those (the catalog recall's chunks)."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.models.convert import flatten_tree
    from hhrs_tpu_torch.ops import cross
    from hhrs_tpu_torch.train.trainer import train_dcn

    torch.cuda.synchronize()
    reset_cross_counts(cross)
    t0 = time.perf_counter()
    result = train_dcn(splits, dims, model_cfg, train_cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cross_counts(cross)
    bf16 = model_cfg.compute_dtype == "bfloat16"
    launches = {k: counts[f"{k}_bf16" if bf16 else k] for k in ("fwd", "bwd")}
    other = {k: counts[k if bf16 else f"{k}_bf16"] for k in ("fwd", "bwd")}
    steps = splits.n_train // train_cfg.batch_size
    chunks = -(-splits.n_val // train_cfg.eval_batch_size)
    n_epochs = len(result.history)
    evals = n_epochs * chunks + chunks
    if train_cfg.fused_epoch and torch.device(dev).type == "cuda":  # the eager first epoch and the capture
        want = {"fwd": 2 * steps + evals + extra_fwd, "bwd": 2 * steps}
    else:
        want = {"fwd": n_epochs * steps + evals + extra_fwd, "bwd": n_epochs * steps}
    print(f"[train] {label} run (dropout {model_cfg.dropout}, seeded random weights, {n_epochs} epochs of "
          f"{steps} steps of {train_cfg.batch_size}) in {wall:.2f} s on {card}")
    for h in result.history:
        print(f"[train]   {label} epoch {h['epoch']}: train_loss {h['train_loss']:.5f} val_loss {h['val_loss']:.5f}")
    print(f"[train]   {label} final {json.dumps(result.final_metrics)}")
    print(f"[train] {label}: cross kernel launches by the wrappers: forward {launches['fwd']}, backward "
          f"{launches['bwd']} (expected {want['fwd']}, {want['bwd']}; "
          + ("the first epoch eager, then one capture, then one graph replay an epoch)" if train_cfg.fused_epoch
             else "one a step and an eval chunk)"))
    if min(launches.values()) <= 0 or launches != want or any(other.values()):
        raise SmokeFailure(f"the {label} training path did not launch the cross kernels as expected "
                           f"({launches}, and {other} of the other instantiation)")
    leaves = flatten_tree({"params": result.params, "bn_state": result.bn_state})
    if any(v.dtype != np.float32 for v in leaves.values()):
        raise SmokeFailure(f"the {label} run exported non-f32 params")
    if not all(np.isfinite(v) for v in result.final_metrics.values()):
        raise SmokeFailure(f"the {label} run's final metrics are not finite")
    p50 = statistics.median(result.step_ms)
    print(f"[time] {label} train step p50 {p50:.4f} ms ({len(result.step_ms)} "
          + ("epochs' CUDA-event time over their steps" if train_cfg.fused_epoch else "steps' CUDA events")
          + f", after the first epoch); examples_per_s {result.examples_per_s:.1f} (median epoch, eval "
          f"included) on {card}")
    return result, launches


def epoch_profiles(splits, dims, model_cfg, train_cfg, dev, card: str) -> None:
    """One epoch of the hpo_r5 configuration per step and one replayed from
    its graph, each under torch.profiler: wall, device busy, kernels, and
    the host's launch calls. A diagnostic: its absence fails nothing."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hhrs_tpu_torch.models.dcn import DCNR
    from hhrs_tpu_torch.train.optimizers import make_optimizer
    from hhrs_tpu_torch.train.trainer import FusedEpoch, split_tensors, train_step

    B = train_cfg.batch_size
    steps = splits.n_train // B
    model = DCNR(dims, model_cfg, generator=torch.Generator().manual_seed(SEED)).to(dev).train()
    data = split_tensors(splits, "train", dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    perm = np.random.default_rng(SEED).permutation(splits.n_train)[:steps * B]
    perm_dev = torch.as_tensor(perm, device=dev)
    opt = make_optimizer(train_cfg.optimizer, model.parameters(), train_cfg.lr, train_cfg.weight_decay)

    def per_step():
        for s in range(steps):
            idx = perm_dev[s * B:(s + 1) * B]
            train_step(model, opt, {k: v[idx] for k, v in data.items()}, gen)

    capturable = torch.device(dev) if torch.device(dev).type == "cuda" else None  # the CPU rehearses
    fused = FusedEpoch(model, make_optimizer(train_cfg.optimizer, model.parameters(), train_cfg.lr,
                                             train_cfg.weight_decay, capturable_on=capturable),
                       data, B, steps, gen)
    fused.run(perm)  # eager, then the capture
    for label, fn in (("per-step", per_step), ("fused-epoch", lambda: fused.run(perm))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avg = prof.key_averages()
        kernels_dev = device_events(avg)
        device_ms = sum(e.self_device_time_total for e in kernels_dev) / 1e3
        n_kernels = sum(e.count for e in kernels_dev)
        host_launches = {e.key: e.count for e in avg if re.fullmatch(r"cu(da)?(LaunchKernel\w*|GraphLaunch)", e.key)}
        (OUT_DIR / f"chip_smoke_train_profile_{label}.txt").write_text(
            avg.table(sort_by="self_device_time_total", row_limit=50) + "\n"
            + avg.table(sort_by="self_cpu_time_total", row_limit=30))
        if device_ms <= 0:
            print(f"[profile] one {label} epoch ({steps} steps): device time not measured (the profiler shows "
                  f"no device events); wall {wall_ms:.2f} ms on {card}")
            continue
        print(f"[profile] one {label} epoch ({steps} steps): wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
              f"(idle {100 * (1 - device_ms / wall_ms):.1f}% of wall, profiler on), {n_kernels} kernels and copies "
              f"({n_kernels / steps:.0f} a step), host launch calls {host_launches} on {card}")
        for e in sorted(kernels_dev, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
            print(f"[profile]   {label} device {e.key[:60]:60s} self {e.self_device_time_total / 1e3:8.3f} ms "
                  f"calls {e.count}")


def resume_round_trip(splits, dims, model_cfg, train_cfg, full, full_fused, dev) -> None:
    """Checkpoint and resume on the card: per step, 2 epochs then a rerun to
    3 equals the uninterrupted 3-epoch run bit for bit (dropout on: the
    dropout generator's state round-trips); fused, 1 epoch then a rerun to
    3 (which captures its graph anew) meets the uninterrupted fused run at
    the trajectory bar."""
    import shutil
    import tempfile

    import numpy as np

    from hhrs_tpu_torch.models.convert import flatten_tree
    from hhrs_tpu_torch.train.trainer import train_dcn

    root = REPO / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=root, prefix="chip_smoke_ckpt_"))
    try:
        for fused, first_epochs, ref in ((False, 2, full), (True, 1, full_fused)):
            cfg = dataclasses.replace(train_cfg, fused_epoch=fused)
            ckpt = str(tmp / ("fused" if fused else "per_step"))
            train_dcn(splits, dims, model_cfg, dataclasses.replace(cfg, n_epochs=first_epochs), checkpoint_dir=ckpt,
                      device=dev)
            resumed = train_dcn(splits, dims, model_cfg, cfg, checkpoint_dir=ckpt, device=dev)
            fa, fb = flatten_tree(resumed.params), flatten_tree(ref.params)
            bitwise = resumed.history == ref.history and all(np.array_equal(fa[k], fb[k]) for k in fa)
            gap = max(abs(a["val_loss"] - b["val_loss"]) for a, b in zip(resumed.history, ref.history))
            label = "fused-epoch" if fused else "per-step"
            print(f"[train] {label} resume: {first_epochs} epochs, then a rerun to {cfg.n_epochs} from the "
                  f"checkpoint: bit-identical to the uninterrupted run: {bitwise}; largest val-loss |Δ| {gap:.3e}")
            if [h["epoch"] for h in resumed.history] != [h["epoch"] for h in ref.history]:
                raise SmokeFailure(f"the {label} resumed run has other epochs than the uninterrupted one")
            if not fused and not bitwise:
                raise SmokeFailure("the resumed per-step run differs from the uninterrupted one")
            if fused and not all(np.isclose(a["val_loss"], b["val_loss"], **VAL_TOL)
                                 for a, b in zip(resumed.history, ref.history)):
                raise SmokeFailure("the resumed fused-epoch run left the uninterrupted run's trajectory")
    finally:
        shutil.rmtree(tmp)


def train_timing(splits, preproc, model_cfg, train_cfg, serve_golden, dev, card: str) -> dict:
    """The hpo_r5 configuration as trained, per step and with
    train.fused_epoch, timed; the epoch profiles; a resume round trip; then
    export, reload, serve. Returns the cross kernels' launches in each run
    and the first per-step run's history."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.models.convert import flatten_tree
    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.serve.engine import RecommendationEngine
    from hhrs_tpu_torch.train.artifacts import export_artifacts, load_artifact_bundle
    from hhrs_tpu_torch.train.trainer import eval_logits, split_tensors

    dims = ModelDims.from_artifacts(preproc)
    runs = {"per-step": [], "fused-epoch": []}
    for label in ("per-step", "fused-epoch", "fused-epoch", "per-step"):  # in turns, on one host
        cfg = dataclasses.replace(train_cfg, fused_epoch=label == "fused-epoch")
        runs[label].append(train_run(splits, dims, model_cfg, cfg, dev, card, label))
    for label, rs in runs.items():
        p50s = [statistics.median(r.step_ms) for r, _ in rs]
        rates = [r.examples_per_s for r, _ in rs]
        print(f"[time] {label} over {len(rs)} runs: step p50 {', '.join(f'{x:.4f}' for x in p50s)} ms; "
              f"examples_per_s {', '.join(f'{x:.1f}' for x in rates)} on {card}")
    (result, launches), (fused, fused_launches) = runs["per-step"][0], runs["fused-epoch"][0]

    val = split_tensors(splits, "val", dev)
    eval_s = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_logits(result.model, val, train_cfg.eval_batch_size)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    print(f"[time] full-val eval ({splits.n_val} rows): p50 {statistics.median(eval_s[1:]) * 1e3:.3f} ms "
          f"(host clock, ending in a synchronize) on {card}")

    try:  # the profiler is a diagnostic, not a phase: its absence fails nothing
        epoch_profiles(splits, dims, model_cfg, train_cfg, dev, card)
    except Exception as e:  # noqa: BLE001
        print(f"[profile] train epochs not measured: {type(e).__name__}: {e}")

    resume_round_trip(splits, dims, model_cfg, train_cfg, result, fused, dev)

    out = OUT_DIR / "train_smoke_artifact"
    export_artifacts(str(out), result.params, result.bn_state, model_cfg, dims, preproc,
                     result.final_metrics, train_cfg)
    back = load_artifact_bundle(str(out))
    a, b = flatten_tree(back.params), flatten_tree(result.params)
    if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k]) for k in a):
        raise SmokeFailure("the exported artifact does not load back to the trained weights")
    engine = RecommendationEngine.from_dirs(str(out), str(REPO / "data"), device=dev)
    for req in serve_golden["requests"][:5]:
        resp = engine.recommend(*req)
        hotels = resp.get("ranked_hotels")
        if not (isinstance(hotels, list) and all("hotel_id" in h for h in hotels) or "message" in resp):
            raise SmokeFailure(f"the trained artifact gave no answer to {req}")
        print(f"[train] served {req} from the trained artifact: "
              f"{len(hotels) if hotels is not None else resp['message']} hotels")
    return {"per_step": launches, "fused": fused_launches, "history": result.history}


def cross_timings(cross, dev, card: str, dtype=None) -> dict:
    """The cross kernels (the instantiation of ``dtype``, float32 by
    default) against their plain versions: CUDA-event means and device
    time per call."""
    import numpy as np
    import torch

    dtype = dtype or torch.float32
    tag = "" if dtype == torch.float32 else " bf16"
    gen = np.random.default_rng(SEED + 2)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).to(dtype).contiguous()  # noqa: E731
    d, L = 113, 3
    rows = {}
    probe = torch.empty((1, d), device=dev, dtype=dtype)
    print(f"[time] cross{tag}: the card runs {cross.capacity(probe, False)} forward blocks and "
          f"{cross.capacity(probe, True)} backward blocks (clusters of {cross.CLUSTER}) at once at d={d} "
          f"(occupancy asked of the card at the largest plan's shared memory; plans take at most "
          f"{cross.FWD_BLOCKS_PER_SM} and {cross.BWD_BLOCKS_PER_SM} an SM)")
    for B, iters in CROSS_TIMED_B:
        x0, dy = f32(gen.standard_normal((B, d))), f32(gen.standard_normal((B, d)))
        w, b = f32(gen.uniform(-1, 1, (L, d)) / np.sqrt(d)), f32(0.1 * gen.standard_normal((L, d)))
        with torch.no_grad():
            timed = {
                "fwd": (lambda: cross.cross_stack_forward(w, b, x0, "code"),
                        lambda: cross.cross_stack_apply(w, b, x0, "code")),
                "bwd": (lambda: cross.cross_stack_backward(w, b, x0, dy, "code"),
                        lambda: cross.cross_stack_backward_ref(w, b, x0, dy, "code")),
            }
            for kind, (kernel, plain) in timed.items():
                plan = cross.plan_of(x0, kind == "bwd")
                ms, plain_ms = time_cuda(kernel, iters), time_cuda(plain, iters)
                device_ms = device_ms_per_call(kernel, 50, "cross_")  # exactly one cross kernel a call
                flops, nbytes = cross_work(B, d, L, kind, elem=x0.element_size())
                bound_ms, bound_by = bound(flops, nbytes)
                rows[(kind, B)] = dict(B=B, plan=list(plan), ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
                print(f"[time] cross{tag} {kind} B={B} plan {tuple(plan)}: kernel {ms:.4f} ms (device "
                      f"{ms_text(device_ms, 1e3, 2)} us, one kernel a call), plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms * 1e3:.3f} us ({bound_by}; {flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.3f} MB); "
                      f"no single PyTorch call computes it (library_ms null) on {card}")
        leaves = [t.clone().requires_grad_() for t in (w, b, x0)]
        fns = {"kernels (CrossStackFn)": lambda: cross.CrossStackFn.apply(*leaves, "code").backward(dy),
               "plain (autograd)": lambda: cross.cross_stack_apply(*leaves, "code").backward(dy)}
        for name, fn in fns.items():
            print(f"[time] cross{tag} forward+backward B={B} through autograd, {name}: "
                  f"{time_cuda(fn, iters):.4f} ms on {card}")
    return rows


def reset_cross_counts(cross) -> None:
    """Every cross instantiation's launch count to 0."""
    for fn in (cross.cross_stack_forward, cross.cross_stack_backward):
        fn.launches = fn.launches_bf16 = 0


def cross_counts(cross) -> dict:
    f, b = cross.cross_stack_forward, cross.cross_stack_backward
    return {"fwd": f.launches, "bwd": b.launches, "fwd_bf16": f.launches_bf16, "bwd_bf16": b.launches_bf16}


def bf16_cross_parity(cross, model, features, dev) -> dict:
    """The bf16 instantiation of the cross kernels against the plain
    versions on the same bf16 tensors (phase 3b); returns the largest
    |kernel − plain| of the forward and the backward."""
    import numpy as np
    import torch

    gen = np.random.default_rng(SEED + 3)
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).to(torch.bfloat16).contiguous()  # noqa: E731
    d_model = model.cross.w.shape[1]
    errs, shares = {"fwd": 0.0, "bwd": 0.0}, {"fwd": 0.0, "bwd": 0.0}
    before = cross_counts(cross)
    n_fwd = n_bwd = 0
    for B in CROSS_BF16_PARITY_B:
        for d in (d_model, 33):
            for L in (1, 3):
                for variant in ("code", "canonical"):
                    if d == d_model:  # hpo_r5's trained cross weights on real feature rows, cast as the model casts
                        x0 = features(B).to(torch.bfloat16)
                        w = model.cross.w.detach()[:L].to(torch.bfloat16).contiguous()
                        b = model.cross.b.detach()[:L].to(torch.bfloat16).contiguous()
                    else:
                        x0 = bf(gen.standard_normal((B, d)))
                        w = bf(gen.uniform(-1, 1, (L, d)) / np.sqrt(d))
                        b = bf(0.1 * gen.standard_normal((L, d)))
                    dy = bf(gen.standard_normal((B, d)))
                    with torch.no_grad():
                        y = cross.cross_stack_forward(w, b, x0, variant)
                        grads = cross.cross_stack_backward(w, b, x0, dy, variant)
                        again = cross.cross_stack_backward(w, b, x0, dy, variant)
                        x0f, dyf = x0.flip(0).contiguous(), dy.flip(0).contiguous()
                        y_flip = cross.cross_stack_forward(w, b, x0f, variant).flip(0)
                        dx0_flip = cross.cross_stack_backward(w, b, x0f, dyf, variant)[0].flip(0)
                        y_ops = operator_outputs(w, b, x0, variant)
                        n_fwd, n_bwd = n_fwd + 2 + len(y_ops), n_bwd + 3
                        torch.cuda.synchronize()
                        ref = (cross.cross_stack_apply(w, b, x0, variant),
                               *cross.cross_stack_backward_ref(w, b, x0, dy, variant))
                        scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)
                    where = f"B={B} d={d} L={L} {variant} bf16"
                    if not all(t.dtype == torch.bfloat16 for t in (y, *grads)):
                        raise SmokeFailure(f"the bf16 cross kernels returned another dtype at {where}")
                    try:
                        e = [cross.assert_close_to_scale(g, r, sc, **CROSS_BF16_TOL, what=name)
                             for name, g, r, sc in zip(("y", "dx0", "dw", "db"), (y, *grads), ref, scale)]
                    except AssertionError as exc:
                        raise SmokeFailure(f"bf16 cross kernels disagree with their plain versions at {where}: {exc}")
                    if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                        raise SmokeFailure(f"a repeated bf16 cross backward is not bit-identical at {where}")
                    if not (torch.equal(y_flip, y) and torch.equal(dx0_flip, grads[0])):
                        raise SmokeFailure(f"a row's bf16 cross output depends on its position at {where}")
                    held_operator(y_ops, y, where)
                    bitwise = all(torch.equal(g, r) for g, r in zip((y, *grads), ref))
                    errs["fwd"] = max(errs["fwd"], e[0][0])
                    errs["bwd"] = max(errs["bwd"], *(x[0] for x in e[1:]))
                    shares["fwd"] = max(shares["fwd"], e[0][1])
                    shares["bwd"] = max(shares["bwd"], *(x[1] for x in e[1:]))
                    print(f"[parity] cross {where}: max|kernel-plain| (share of the allowance) "
                          + " ".join(f"{n} {x[0]:.3e} ({x[1]:.2f})" for n, x in zip(("y", "dx0", "dw", "db"), e))
                          + f"; equal to the plain version bit for bit: {bitwise}; repeat and flip bit-identical; "
                          "operator = wrapper bit for bit")
    for B in (512, 8192):  # the training batch and the largest, replayed from a graph
        x0 = features(B).to(torch.bfloat16)
        w, b = model.cross.w.detach().to(torch.bfloat16), model.cross.b.detach().to(torch.bfloat16)
        dy = bf(gen.standard_normal(tuple(x0.shape)))
        with torch.no_grad():
            want = (cross.cross_stack_forward(w, b, x0, "code"), *cross.cross_stack_backward(w, b, x0, dy, "code"))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
                outs = (cross.cross_stack_forward(w, b, x0, "code"),
                        *cross.cross_stack_backward(w, b, x0, dy, "code"))
            n_fwd, n_bwd = n_fwd + 2, n_bwd + 2
            for _ in range(2):
                for t in outs:
                    t.fill_(float("nan"))
                graph.replay()
                torch.cuda.synchronize()
                if not all(torch.equal(o, e) for o, e in zip(outs, want)):
                    raise SmokeFailure(f"the bf16 cross kernels replayed from a CUDA graph (B={B}) differ from the "
                                       "eager calls")
    after = cross_counts(cross)
    if (after["fwd_bf16"] - before["fwd_bf16"], after["bwd_bf16"] - before["bwd_bf16"]) != (n_fwd, n_bwd) or (
            after["fwd"], after["bwd"]) != (before["fwd"], before["bwd"]):
        raise SmokeFailure("the bf16 cross launches were not counted as bf16 launches, each once")
    print(f"[parity] cross bf16: {n_fwd} forward + {n_bwd} backward launches held to rtol={CROSS_BF16_TOL['rtol']} "
          f"(bf16's unit roundoff) atol={CROSS_BF16_TOL['atol']} against the term scale; max abs err fwd "
          f"{errs['fwd']:.3e} bwd {errs['bwd']:.3e}; largest share of the allowance fwd {shares['fwd']:.3f} bwd "
          f"{shares['bwd']:.3f}; forward + backward (B=512, 8192) replayed twice from a CUDA graph: bit-identical")
    return errs


def option_sweep(engine, golden: dict, tol: float, label: str, reference=None) -> dict:
    """The golden sweep through one option engine (phase 5b): every
    request by ``recommend`` (bucket 1; the capped program where the engine
    has a cap), ``recommend_many`` K = 8 and K = 5 padded to 8 (bucket 8),
    graphed, against the golden responses at ``tol``, and against
    ``reference`` (an engine whose JSON must be equal) where given. The
    tower and cross-forward launch counts are set to 0 just before and read
    just after. Then every request and batch must give the same JSON
    eagerly. Returns the counts, the tie swaps and the cap's branches."""
    import torch

    from hhrs_tpu_torch.ops import cross, tower

    torch.cuda.synchronize()
    tower.tower_eval.launches = 0
    reset_cross_counts(cross)
    branches = dict(engine.cap_branches)
    swaps, got_one = 0, []
    for req, want, logits in zip(golden["requests"], golden["responses"], golden["logits"]):
        got = json.loads(json.dumps(engine.recommend(*req)))
        got_one.append(got)
        n = compare_response(got, want, logits, tol)
        if n is None:
            raise SmokeFailure(f"the {label} engine's recommend{tuple(req)} differs from its golden response")
        swaps += n
    many = [golden["requests"][i] for i in golden["many"]]
    got_many = {}
    for batch, pad_to in ((many, None), (many[:5], 8)):
        got_many[pad_to] = engine.recommend_many(batch, pad_to=pad_to)
        for i, got in zip(golden["many"], got_many[pad_to]):
            n = compare_response(json.loads(json.dumps(got)), golden["responses"][i], golden["logits"][i], tol)
            if n is None:
                raise SmokeFailure(f"the {label} engine's recommend_many(K={len(batch)}) differs from golden {i}")
            swaps += n
    torch.cuda.synchronize()
    counts = {"tower": tower.tower_eval.launches, **{f"cross_{k}": v for k, v in cross_counts(cross).items()}}
    took = {k: engine.cap_branches[k] - branches[k] for k in branches}
    if reference is not None:
        differ = [r for r, g in zip(golden["requests"], got_one) if json.loads(json.dumps(reference.recommend(*r))) != g]
        if differ:
            raise SmokeFailure(f"the {label} engine differs from its reference engine for {differ[:3]}")
    capped = bool(engine._cap)
    differ = [r for r, g in zip(golden["requests"], got_one)
              if json.loads(json.dumps(engine._recommend_eager([r], capped=capped)[0])) != g]
    differ += [b for b in (many, many[:5]) if engine._recommend_eager(b, pad_to=8) != engine.recommend_many(b, pad_to=8)]
    if differ:
        raise SmokeFailure(f"the {label} engine's graphed path differs from its eager one for {differ[:3]}")
    print(f"[serve] {label}: {len(golden['requests'])} recommend + 2 batches match the golden file at tol {tol:.3e}"
          f" (tie swaps {swaps}); graphed equals eager; buckets {sorted(engine._buckets)}; scoring: {engine.scoring}")
    print(f"[serve] {label}: launches over the sweep: tower_eval {counts['tower']}, cross forward f32 "
          f"{counts['cross_fwd']}, cross forward bf16 {counts['cross_fwd_bf16']}"
          + (f"; cap {engine._cap}: {took['capped']} requests answered by the capped branch, {took['full']} by the "
             "full program" if capped else ""))
    return {"launches": counts, "swaps": swaps, "cap": took}


def serve_options(engine, golden: dict, dev, card: str) -> dict:
    """Phase 5b: the quantize_tables, bf16 and candidate_cap engines
    against their golden files, then graphed recommend p50 of the f32, int8,
    bf16 and capped engines in turns, and the bf16 deep products' route."""
    import torch

    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    data = str(REPO / "data")
    build = lambda **kw: RecommendationEngine.from_dirs(str(REPO / ARTIFACT), data, device=dev, **kw)  # noqa: E731
    golden_int8 = json.loads((REPO / GOLDEN_INT8).read_text())
    golden_bf16 = json.loads((REPO / GOLDEN_BF16).read_text())
    dev_bf16 = max(abs(a - b) for xs, ys in zip(golden_bf16["logits"], golden_bf16["logits_f32"])
                   for a, b in zip(xs, ys))
    bf16_tol = BF16_BAR * dev_bf16
    print(f"[serve] bf16 swap bar: {BF16_BAR} x max |JAX bf16 - JAX f32| logit over the golden hotels "
          f"({dev_bf16:.4e}) = {bf16_tol:.4e}")
    engines = {"int8": build(quantize_tables=True), "bf16": build(bf16=True),
               "cap16": build(candidate_cap=CAP), "cap16, city_bounded=False": build(candidate_cap=CAP, city_bounded=False)}
    uncapped_all_rows = build(city_bounded=False)
    out = {
        "int8": option_sweep(engines["int8"], golden_int8, SWAP_TOL, "quantize_tables"),
        "bf16": option_sweep(engines["bf16"], golden_bf16, bf16_tol, "bf16"),
        "cap16": option_sweep(engines["cap16"], golden, SWAP_TOL, f"candidate_cap={CAP}", reference=engine),
        "cap16_all_rows": option_sweep(engines["cap16, city_bounded=False"], golden, SWAP_TOL,
                                       f"candidate_cap={CAP}, city_bounded=False", reference=uncapped_all_rows),
    }
    if out["int8"]["swaps"] or out["int8"]["launches"]["tower"] <= 0:
        raise SmokeFailure("the int8 engine swapped hotels or did not score through the tower kernel")
    if out["bf16"]["launches"]["cross_fwd_bf16"] <= 0 or out["bf16"]["launches"]["tower"]:
        raise SmokeFailure("the bf16 engine did not score through the bf16 cross forward kernel alone")
    for key in ("cap16", "cap16_all_rows"):
        if min(out[key]["cap"].values()) <= 0 or out[key]["launches"]["tower"] <= 0:
            raise SmokeFailure(f"the {key} engine did not take both branches of the cap through the tower kernel")

    timed = {"f32": engine, "int8": engines["int8"], "bf16": engines["bf16"], "cap16": engines["cap16"]}
    reqs = golden["requests"]
    p50s = {k: [] for k in timed}
    for label in list(timed) + list(timed)[::-1]:  # in turns
        lat = []
        for i in range(len(reqs) + 10):
            t0 = time.perf_counter()
            timed[label].recommend(*reqs[i % len(reqs)])
            lat.append(time.perf_counter() - t0)
        p50s[label].append(statistics.median(lat[10:]) * 1e3)
    for label, xs in p50s.items():
        print(f"[time] graphed recommend p50, {label} engine: {', '.join(f'{x:.3f}' for x in xs)} ms (two rounds, "
              f"host clock, each ending in the device->host copy) on {card}")

    # The bf16 deep products' route on the card: an f32 GEMM of bf16-rounded operands.
    model = engines["bf16"].model
    lin = model.initial_deep
    with torch.no_grad():
        for B in (128, 8 * 128):
            x = torch.randn(B, lin.kernel.shape[0], device=dev)
            ms_bf16 = time_cuda(lambda: lin(x, torch.bfloat16), 300)
            ms_f32 = time_cuda(lambda: lin(x), 300)
            xb, kb = x.to(torch.bfloat16), lin.kernel.to(torch.bfloat16)
            try:
                lib = f"{time_cuda(lambda: torch.mm(xb, kb, out_dtype=torch.float32), 300):.4f} ms"
            except (RuntimeError, TypeError) as e:
                lib = f"not measured ({type(e).__name__})"
            print(f"[time] bf16 Linear route (initial_deep, B={B}): casts + f32 GEMM of bf16-rounded operands "
                  f"{ms_bf16:.4f} ms, the f32 Linear {ms_f32:.4f} ms, cuBLAS bf16 GEMM with f32 output (yardstick, "
                  f"unused) {lib} on {card}")
    return out


def bf16_training(splits, preproc, model_cfg, train_cfg, dev, card: str) -> dict:
    """Phase 7b: the hpo_r5 training run at compute + storage bf16, per step
    and fused; returns the bf16 cross kernels' launches of the per-step run."""
    from hhrs_tpu_torch.models.dcn import ModelDims

    dims = ModelDims.from_artifacts(preproc)
    cfg16 = dataclasses.replace(model_cfg, compute_dtype="bfloat16", storage_dtype="bfloat16")
    runs = {}
    for label in ("per-step", "fused-epoch"):
        cfg = dataclasses.replace(train_cfg, fused_epoch=label == "fused-epoch")
        runs[label] = train_run(splits, dims, cfg16, cfg, dev, card, f"bf16 {label}")
    for label, (r, launches) in runs.items():
        print(f"[time] bf16 {label}: step p50 {statistics.median(r.step_ms):.4f} ms, examples_per_s "
              f"{r.examples_per_s:.1f}; bf16 cross launches {launches} on {card}")
    return {"per_step": runs["per-step"][1], "fused": runs["fused-epoch"][1]}


class _Client:
    """One keep-alive HTTP/1.1 connection to a server on 127.0.0.1."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def call(self, method: str, path: str, payload=None) -> tuple[int, bytes]:
        body = None if payload is None else json.dumps(payload)
        self.conn.request(method, path, body=body,
                          headers={"Content-Type": "application/json"} if body is not None else {})
        r = self.conn.getresponse()
        return r.status, r.read()

    def close(self) -> None:
        self.conn.close()


def _payload(req: list) -> dict:
    u, c, m, lam = req
    return {"user_id": u, "city": c, "type": m, "lambda_param": lam}


def http_client_main(argv: list) -> int:
    """``chip_smoke.py --http-client PORT CLIENTS PER_CLIENT``: a client
    process for phase 9, so the server's host work is timed without its
    clients in the same interpreter. CLIENTS threads each send PER_CLIENT
    golden requests over one keep-alive connection; prints one JSON line
    of the latencies (s) and the wall time; exits 1 on any answer but 200."""
    port, clients, per_client = (int(x) for x in argv)
    reqs = json.loads((REPO / GOLDEN).read_text())["requests"]

    def run(c: int) -> list:
        cl, lat = _Client(port), []
        for k in range(per_client):
            t0 = time.perf_counter()
            status, _ = cl.call("POST", "/recommendations", _payload(reqs[(c * 7 + k) % len(reqs)]))
            lat.append(time.perf_counter() - t0)
            if status != 200:
                raise SmokeFailure(f"the client process got {status}")
        cl.close()
        return lat

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        lats = list(pool.map(run, range(clients)))
    print(json.dumps({"latencies": [x for lat in lats for x in lat], "wall": time.perf_counter() - t0}))
    return 0


def _append_review(path: Path, user_id: int) -> None:
    """Append a copy of the CSV's first review row under a new guest id."""
    lines = path.read_text().splitlines()
    header, first = lines[0].split(","), lines[1].split(",")
    first[header.index("guest_id")] = str(user_id)
    with open(path, "a") as f:
        f.write(",".join(first) + "\n")


def http_phase(golden: dict, trained_dir: str, dev, card: str) -> dict:
    """Phase 9: the port's CLI stack (``serve/cli.py::build_stack``: the
    engine on the card, the dynamic batcher, the hot-reload pollers, every
    bucket captured) served on 127.0.0.1 from a thread, with a second server
    of the bare engine beside it. The golden sweep through both; the sweep
    as /recommendations/batch chunks of 64; 16 concurrent clients; the read
    routes and the request count; a registry hot swap and three data swaps
    under traffic, then the card's memory. Returns the tower kernel's
    launches and the timings. Runs on the CPU too (no memory check there),
    to rehearse it."""
    import gc
    import shutil

    import torch

    from hhrs_tpu_torch.db.registry import ModelRegistry
    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.serve import cli, reload
    from hhrs_tpu_torch.serve.http import make_server
    from hhrs_tpu_torch.serve.schemas import HTTP_BATCH_PAD

    t_phase = time.perf_counter()
    work = REPO / "build" / "chip_smoke_http"
    shutil.rmtree(work, ignore_errors=True)
    (work / "data").mkdir(parents=True)
    for name in ("hackathon_augmented_data.csv", "friendships.csv"):
        shutil.copy2(REPO / "data" / name, work / "data" / name)
    db = str(work / "registry.sqlite")
    ModelRegistry(db, create=True).register("shipped", str(REPO / ARTIFACT))
    reload.OLD_STACK_CLOSE_GRACE_S = 0.5  # a swapped-out stack closes half a second after its swap
    reqs, n_req = golden["requests"], len(golden["requests"])
    servers, stack = [], None
    on_card = dev.type == "cuda"

    def memory() -> int:
        """Card memory allocated, after a collection and a synchronize."""
        gc.collect()
        if not on_card:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    try:
        mem0 = memory()
        tower.tower_eval.launches = 0
        t0 = time.perf_counter()
        args = cli.build_parser().parse_args(
            ["--artifacts", f"registry:{db}", "--data", str(work / "data"), "--device", str(dev),
             "--batch-window-ms", "2", "--max-batch", "8", "--warm-http-batch",
             "--reload-poll-s", "3600", "--data-poll-s", "3600"])
        stack = cli.build_stack(args)
        build_s = time.perf_counter() - t0
        engine = stack.engine.current._engine  # holder -> batcher -> engine
        buckets = sorted(engine._buckets)
        mem1 = memory()
        if on_card and buckets != [(1, False), (8, False), (HTTP_BATCH_PAD, False)]:
            raise SmokeFailure(f"the CLI stack captured buckets {buckets}, not 1, 8 and {HTTP_BATCH_PAD}")
        for target in (stack.engine, engine):  # the CLI stack (batcher on), the bare engine
            server = make_server(target, "127.0.0.1", 0)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            servers.append(server)
        port = {"batched": servers[0].server_address[1], "unbatched": servers[1].server_address[1]}
        print(f"[http] CLI stack built and warmed in {build_s:.2f} s: buckets {buckets}, "
              f"batcher window 2 ms / max 8, registry and data pollers on; card memory "
              f"{(mem1 - mem0) / 2**20:.1f} MiB")

        # The golden sweep through a socket, one client, in turns.
        sent = 0
        single, lat = {}, {"batched": [], "unbatched": []}
        for label in ("unbatched", "batched", "batched", "unbatched"):
            client, swaps = _Client(port[label]), 0
            for i, (req, want, logits) in enumerate(zip(reqs, golden["responses"], golden["logits"])):
                t0 = time.perf_counter()
                status, body = client.call("POST", "/recommendations", _payload(req))
                lat[label].append(time.perf_counter() - t0)
                got = json.loads(body)
                n = compare_response(got, want, logits) if status == 200 else None
                if n is None or n:
                    raise SmokeFailure(f"POST /recommendations {req} ({label}) gave {status} and not the golden "
                                       f"response with 0 tie swaps")
                if single.setdefault(i, got) != got:
                    raise SmokeFailure(f"POST /recommendations {req}: the {label} body differs from an earlier one")
            client.close()
            sent += n_req
        q = lambda xs, p: sorted(xs)[min(int(len(xs) * p), len(xs) - 1)] * 1e3  # noqa: E731
        timings = {f"{k}_1client_{name}": q(v, p) for k, v in lat.items()
                   for name, p in (("p50_ms", 0.5), ("p99_ms", 0.99))}
        for label in ("unbatched", "batched"):
            print(f"[time] http POST /recommendations, 1 client, {label}: p50 "
                  f"{timings[f'{label}_1client_p50_ms']:.3f} ms, p99 {timings[f'{label}_1client_p99_ms']:.3f} ms "
                  f"over {2 * n_req} requests (host clock, keep-alive socket) on {card}")
        print(f"[http] golden sweep: {4 * n_req} POST /recommendations match the golden file with 0 tie swaps")
        # The same server with Nagle's algorithm on, as the JAX package's handler has it: the body of each
        # response may wait for the client's delayed ACK of the headers.
        nagle = make_server(engine, "127.0.0.1", 0)
        nagle.RequestHandlerClass = type("NagleOn", (nagle.RequestHandlerClass,), {"disable_nagle_algorithm": False})
        threading.Thread(target=nagle.serve_forever, daemon=True).start()
        client, lat_nagle = _Client(nagle.server_address[1]), []
        for req in reqs[:40]:
            t0 = time.perf_counter()
            if client.call("POST", "/recommendations", _payload(req))[0] != 200:
                raise SmokeFailure("the server with Nagle's algorithm on did not answer 200")
            lat_nagle.append(time.perf_counter() - t0)
        client.close()
        nagle.shutdown()
        nagle.server_close()
        sent += 40
        timings["unbatched_1client_nagle_on_p50_ms"] = statistics.median(lat_nagle) * 1e3
        print(f"[time] http POST /recommendations, 1 client, unbatched, Nagle's algorithm on (a diagnostic): p50 "
              f"{timings['unbatched_1client_nagle_on_p50_ms']:.3f} ms over 40 requests on {card}")

        # The sweep as /recommendations/batch chunks of 64, equal to the single bodies.
        client = _Client(port["batched"])
        for start in range(0, n_req, HTTP_BATCH_PAD):
            chunk = list(range(start, min(start + HTTP_BATCH_PAD, n_req)))
            status, body = client.call("POST", "/recommendations/batch", {"requests": [_payload(reqs[i]) for i in chunk]})
            if status != 200 or json.loads(body)["responses"] != [single[i] for i in chunk]:
                raise SmokeFailure(f"POST /recommendations/batch of requests {chunk[0]}..{chunk[-1]} differs from "
                                   f"the single-request bodies")
            sent += len(chunk)
        batch64 = {"requests": [_payload(r) for r in reqs[:HTTP_BATCH_PAD]]}
        lat64 = []
        for _ in range(20):
            t0 = time.perf_counter()
            status, _ = client.call("POST", "/recommendations/batch", batch64)
            lat64.append(time.perf_counter() - t0)
            if status != 200:
                raise SmokeFailure(f"POST /recommendations/batch gave {status}")
            sent += HTTP_BATCH_PAD
        timings["batch64_p50_ms"] = statistics.median(lat64) * 1e3
        print(f"[time] http POST /recommendations/batch of 64 requests: p50 {timings['batch64_p50_ms']:.3f} ms "
              f"over 20 calls on {card}")

        # 16 concurrent clients, with the batcher and without, in turns.
        def hammer(label: str, per_client: int = 30) -> float:
            def client_run(c: int) -> list:
                cl, out = _Client(port[label]), []
                for k in range(per_client):
                    i = (c * 7 + k) % n_req
                    status, body = cl.call("POST", "/recommendations", _payload(reqs[i]))
                    out.append((i, status, body))
                cl.close()
                return out

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=16) as pool:
                results = [r for rs in pool.map(client_run, range(16)) for r in rs]
            wall = time.perf_counter() - t0
            bad = [(i, s) for i, s, b in results if s != 200 or json.loads(b) != single[i]]
            if bad:
                raise SmokeFailure(f"16 concurrent clients ({label}): {len(bad)} responses not 200 or not equal to "
                                   f"the unbatched bodies, first {bad[:3]}")
            return len(results) / wall

        rps = {"batched": [], "unbatched": []}
        for label in ("unbatched", "batched", "batched", "unbatched"):
            rps[label].append(hammer(label))
            sent += 16 * 30
        timings.update({f"{k}_16clients_rps": v for k, v in rps.items()})
        for label, xs in rps.items():
            print(f"[time] http 16 concurrent clients, {label}: {', '.join(f'{x:.1f}' for x in xs)} requests/s "
                  f"(2 rounds of 480 requests, keep-alive sockets; all 200 and equal to the unbatched bodies) "
                  f"on {card}")

        # The same traffic from a client process: the server's interpreter serves alone.
        def client_process(label: str, clients: int, per_client: int) -> dict:
            out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--http-client", str(port[label]),
                                  str(clients), str(per_client)], capture_output=True, text=True, timeout=300)
            if out.returncode:
                raise SmokeFailure(f"the client process failed: {out.stderr[-2000:]}")
            return json.loads(out.stdout.strip().splitlines()[-1])

        oop = {"batched": {"one": [], "rps": []}, "unbatched": {"one": [], "rps": []}}
        for label in ("unbatched", "batched", "batched", "unbatched"):
            oop[label]["one"] += client_process(label, 1, n_req)["latencies"]
            r = client_process(label, 16, 30)
            oop[label]["rps"].append(len(r["latencies"]) / r["wall"])
            sent += n_req + 16 * 30
        for label, r in oop.items():
            timings.update({f"{label}_1client_process_p50_ms": q(r["one"], 0.5),
                            f"{label}_1client_process_p99_ms": q(r["one"], 0.99),
                            f"{label}_16clients_process_rps": r["rps"]})
            print(f"[time] http from a client process, {label}: 1 client p50 {q(r['one'], 0.5):.3f} ms, p99 "
                  f"{q(r['one'], 0.99):.3f} ms over {len(r['one'])} requests; 16 clients "
                  f"{', '.join(f'{x:.1f}' for x in r['rps'])} requests/s (2 rounds of 480) on {card}")

        # The read routes, and the request count: the traffic sent.
        for item, n, want in golden["similar"]:
            status, body = client.call("GET", f"/similar_items?item_id={item}&n={n}")
            got = json.loads(body)
            if (want is None and status != 404) or (want is not None and (status, got) != (200, {"similar_item_ids": want})):
                raise SmokeFailure(f"GET /similar_items?item_id={item}&n={n} gave {status} {got}")
        status, body = client.call("GET", "/healthz")
        health = json.loads(body)
        status_m, metrics = client.call("GET", "/metrics")
        count_line = f"hhrs_recommend_requests_total {sent}"
        if (status, status_m) != (200, 200) or health["latency"]["count"] != sent or \
                count_line not in metrics.decode().splitlines() or health["model"] != str(REPO / ARTIFACT):
            raise SmokeFailure(f"/healthz or /metrics disagree with the {sent} requests sent: {health}, "
                               f"{metrics.decode()[:200]}")
        client.close()
        print(f"[http] /similar_items match the golden answers; /healthz and /metrics count the {sent} requests "
              f"sent; hot swaps so far {health['hot_swaps']}")

        # The engine alone on the same sweep: the HTTP layer's own cost is the difference.
        eng_one = []
        for req in reqs:
            t0 = time.perf_counter()
            engine.recommend(*req)
            eng_one.append(time.perf_counter() - t0)
        eng_8, eng_64 = [], []
        for k in range(20):
            t0 = time.perf_counter()
            engine.recommend_many(reqs[8 * k % n_req:][:8], pad_to=8)
            eng_8.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            engine.recommend_many(reqs[:HTTP_BATCH_PAD], pad_to=HTTP_BATCH_PAD)
            eng_64.append(time.perf_counter() - t0)
        timings.update(engine_recommend_p50_ms=statistics.median(eng_one) * 1e3,
                       engine_recommend_p99_ms=q(eng_one, 0.99),
                       engine_many8_p50_ms=statistics.median(eng_8) * 1e3,
                       engine_many64_p50_ms=statistics.median(eng_64) * 1e3)
        print(f"[time] engine alone on the same sweep: recommend p50 {timings['engine_recommend_p50_ms']:.3f} ms, "
              f"p99 {timings['engine_recommend_p99_ms']:.3f} ms; recommend_many(8, pad_to=8) p50 "
              f"{timings['engine_many8_p50_ms']:.3f} ms; recommend_many(64, pad_to=64) p50 "
              f"{timings['engine_many64_p50_ms']:.3f} ms (host clock) on {card}")
        bare = servers.pop()  # from here on only the CLI stack serves: the swaps may free the bare engine
        bare.shutdown()
        bare.server_close()
        del engine, bare

        # A registry hot swap and three data swaps under traffic.
        stop, statuses = threading.Event(), []

        def traffic(c: int) -> None:
            cl, k = _Client(port["batched"]), 0
            while not stop.is_set():
                if c == 7:
                    status, _ = cl.call("GET", f"/similar_items?item_id={golden['similar'][0][0]}&n=10")
                else:
                    status, _ = cl.call("POST", "/recommendations", _payload(reqs[(c * 17 + k) % n_req]))
                statuses.append(status)
                k += 1
            cl.close()

        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = [pool.submit(traffic, c) for c in range(8)]
            try:
                time.sleep(0.3)
                ModelRegistry(db).register("trained", trained_dir)
                t0 = time.perf_counter()
                if not stack.reloader.check_once():
                    raise SmokeFailure("the registry poller did not swap in the newly activated model")
                swap_s = [time.perf_counter() - t0]
                time.sleep(0.3)
                new_engine = stack.engine.current._engine
                streams = [new_engine._graph_stream.cuda_stream] if on_card else []
                client = _Client(port["batched"])
                for req in reqs[:24]:
                    status, body = client.call("POST", "/recommendations", _payload(req))
                    want = json.loads(json.dumps(new_engine.recommend_many([req], pad_to=8)[0]))
                    if (status, json.loads(body)) != (200, want):
                        raise SmokeFailure(f"after the swap, POST /recommendations {req} differs from the new "
                                           f"engine's direct answer")
                health = json.loads(client.call("GET", "/healthz")[1])
                client.close()
                del new_engine
                if health["model"] != trained_dir or health["hot_swaps"] != 1:
                    raise SmokeFailure(f"/healthz after the registry swap: {health}")
                time.sleep(reload.OLD_STACK_CLOSE_GRACE_S + 0.5)  # the old stack closes
                mem_swap1 = memory()
                data_csv = work / "data" / "hackathon_augmented_data.csv"
                for n in range(3):
                    _append_review(data_csv, 90_000_000 + n)
                    t0 = time.perf_counter()
                    if stack.data_reloader.check_once() or not stack.data_reloader.check_once():
                        raise SmokeFailure(f"data swap {n + 1} did not debounce once and then swap")
                    swap_s.append(time.perf_counter() - t0)
                    if on_card:
                        streams.append(stack.engine.current._engine._graph_stream.cuda_stream)
                    time.sleep(reload.OLD_STACK_CLOSE_GRACE_S + 0.2)  # the old stack closes, its stream is free
            finally:
                stop.set()
                for f in futures:
                    f.result()
        mem_swap4 = memory()
        live = stack.engine.current._engine
        bad = [s for s in statuses if s != 200]
        print(f"[http] hot swaps under 8 clients (7 POST /recommendations, 1 GET /similar_items): "
              f"{len(statuses)} requests, {len(bad)} not 200; the registry swap took {swap_s[0]:.2f} s and each "
              f"data swap {', '.join(f'{x:.2f}' for x in swap_s[1:])} s (build, capture, swap); after the registry "
              f"swap POST /recommendations equals the new engine's direct answers; live engine buckets "
              f"{sorted(live._buckets)}, serving {live.gen.universe.n_users} users")
        print(f"[http] card memory allocated: {mem0 / 2**20:.1f} MiB before the stack, {mem1 / 2**20:.1f} MiB with "
              f"it, {mem_swap1 / 2**20:.1f} MiB after the registry swap, {mem_swap4 / 2**20:.1f} MiB after 3 more "
              f"data swaps (old stacks closed); capture streams of the engines after each swap: {streams} "
              f"({len(set(streams))} distinct)")
        if bad or not statuses:
            raise SmokeFailure(f"{len(bad)} requests under the hot swaps were not answered 200: {bad[:5]}")
        if 90_000_002 not in {int(u) for u in live.gen.universe.user_ids}:
            raise SmokeFailure("the data swaps did not reach the live engine")
        if mem_swap4 > mem_swap1 + 8 * 2**20:
            raise SmokeFailure(f"card memory grew with the data swaps: {mem_swap1} -> {mem_swap4} bytes")
        memory()
        launches = tower.tower_eval.launches
        if on_card and launches <= 0:
            raise SmokeFailure("the HTTP phase never launched the tower kernel")
        print(f"[http] tower_eval launches over the phase: {launches} (the eager run and the capture of each "
              f"bucket of each stack built; requests replay the graphs); phase took "
              f"{time.perf_counter() - t_phase:.1f} s")
        return {"launches": launches, "timings": timings, "memory_mib": {
            "before": mem0 / 2**20, "stack": mem1 / 2**20, "after_registry_swap": mem_swap1 / 2**20,
            "after_3_data_swaps": mem_swap4 / 2**20}, "swaps_under_traffic": len(statuses)}
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        if stack is not None:
            for poller in (stack.reloader, stack.data_reloader):
                poller.stop()
            stack.engine.close()
        shutil.rmtree(work, ignore_errors=True)


# Phase 10: the retraining path.
TUNED_DATA = dict(n_users=20000, n_items=4000, n_reviews=500000, seed=11)  # benchmarks/trainer_tuned.py:38-39
TUNED_EPOCHS = 3
SLAB_STEPS = 8
# catalog recall@100, card against the CPU on the same weights: near-tied
# scores may trade places across the top-100 boundary between two float32
# programs (tests/test_torch_port_cuda.py holds the same bar)
CATALOG_RECALL_TOL = 0.01
# lazy against dense tables, final val logloss: the JAX package's own bar
# (tests/test_lazy.py, test_trainer_lazy_converges_with_dense). The runs
# are two optimizers: under AdamW (hpo_r5's weight decay 0.1) the dense one
# decays every table row each step and the lazy one only the batch's rows,
# so the trajectory bar of phase 7 (rounding noise) does not apply.
LAZY_TOL = 5e-3


def _launch_delta(cross, fn):
    """Run ``fn`` with every cross launch count set to 0 first → (its
    result, the counts after it)."""
    import torch

    torch.cuda.synchronize()
    reset_cross_counts(cross)
    out = fn()
    torch.cuda.synchronize()
    return out, cross_counts(cross)


def tuned_phase(cross, dev, card: str) -> dict:
    """Phase 10a: the ``tuned`` preset (B = 32768, rng_impl=rbg, bf16 compute
    and storage) through ``train/cli.py`` on its published data scale, per
    step and fused (the fused run also scores the catalog recall: 64 users
    × 4,000 items a forward). Returns the bf16 cross launches of each run."""
    import shutil

    import numpy as np

    from hhrs_tpu_torch.config import build_config
    from hhrs_tpu_torch.data.synthetic import write_synthetic_dataset
    from hhrs_tpu_torch.train import cli

    root = REPO / "build" / "tuned"
    shutil.rmtree(root, ignore_errors=True)
    data, cache_dir = root / "data", root / "cache"
    t0 = time.perf_counter()
    write_synthetic_dataset(str(data), **TUNED_DATA)
    gen_s = time.perf_counter() - t0
    cfg = build_config([], preset="tuned", environ={})
    t0 = time.perf_counter()
    splits, _ = cli.build_dataset(str(data), cfg, cache_dir=str(cache_dir))
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached, _ = cli.build_dataset(str(data), cfg, cache_dir=str(cache_dir))
    cached_s = time.perf_counter() - t0
    if not all(np.array_equal(getattr(cached, k), v) for k, v in vars(splits).items()):
        raise SmokeFailure("the dataset cache did not give back the ingested arrays")
    B = cfg.train.batch_size
    steps = splits.n_train // B
    print(f"[tuned] {TUNED_DATA['n_reviews']} reviews, {TUNED_DATA['n_users']} users, {TUNED_DATA['n_items']} items "
          f"(seed {TUNED_DATA['seed']}) generated in {gen_s:.2f} s; ingest {cold_s:.2f} s cold (the native reader, "
          f"preprocess, cache write), {cached_s:.3f} s from --cache-dir; {splits.n_train} train / {splits.n_val} "
          f"val rows: {steps} steps of {B} an epoch")
    out = {}
    for label, extra in (("per-step", []), ("fused-epoch", ["train.fused_epoch=true",
                                                            "train.eval_catalog_recall=true"])):
        argv = ["--data", str(data), "--out", str(root / label), "--preset", "tuned", "--cache-dir", str(cache_dir),
                "--epochs", str(TUNED_EPOCHS), *extra]
        t0 = time.perf_counter()
        (rc, result), counts = _launch_delta(cross, lambda: cli.run(argv))
        wall = time.perf_counter() - t0
        if rc != 0 or result is None:
            raise SmokeFailure(f"the tuned {label} run through train/cli.py exited {rc}")
        m = result.final_metrics
        p50 = statistics.median(result.step_ms)
        print(f"[tuned] {label}: {len(result.history)} epochs in {wall:.2f} s; examples_per_s "
              f"{result.examples_per_s:.1f}; step p50 {p50:.4f} ms ("
              + ("an epoch's CUDA-event time over its steps" if "fused" in label else "CUDA events")
              + f"); val logloss {m['val_logloss']:.5f} AUC {m['val_auc']:.5f}"
              + (f", catalog recall@100 {m['catalog_recall_at_100']:.5f}" if "catalog_recall_at_100" in m else "")
              + f"; bf16 cross launches at B={B}: forward {counts['fwd_bf16']}, backward {counts['bwd_bf16']} "
              f"(f32: {counts['fwd']}, {counts['bwd']}) on {card}")
        if min(counts["fwd_bf16"], counts["bwd_bf16"]) <= 0 or counts["fwd"] or counts["bwd"]:
            raise SmokeFailure(f"the tuned {label} run did not train through the bf16 cross kernels ({counts})")
        if not (np.isfinite(m["val_logloss"]) and m["val_auc"] > 0.5):
            raise SmokeFailure(f"the tuned {label} run's val logloss / AUC are not finite or not above 0.5: {m}")
        out[label] = {"fwd": counts["fwd_bf16"], "bwd": counts["bwd_bf16"], "step_p50_ms": p50,
                      "examples_per_s": result.examples_per_s, "ingest_s": {"cold": cold_s, "cached": cached_s}}
    return out


def _same_run(a, b) -> bool:
    import numpy as np

    from hhrs_tpu_torch.models.convert import flatten_tree

    fa = flatten_tree({"p": a.params, "s": a.bn_state})
    fb = flatten_tree({"p": b.params, "s": b.bn_state})
    return a.history == b.history and fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


def options_phase(cross, splits, preproc, model_cfg, train_cfg, dev, card: str) -> dict:
    """Phase 10b: the trainer's options on the hpo_r5 configuration and
    ``data/``, 3 epochs each → the cross launches of each run (f32)."""
    import shutil

    import numpy as np
    import torch

    from hhrs_tpu_torch.models.convert import dcnr_from_jax
    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.train.checkpoint import TrainCheckpointer
    from hhrs_tpu_torch.train.eval_retrieval import catalog_recall_at_k
    from hhrs_tpu_torch.train.trainer import train_dcn

    dims = ModelDims.from_artifacts(preproc)
    run = lambda label, extra_fwd=0, **kw: train_run(  # noqa: E731
        splits, dims, model_cfg, dataclasses.replace(train_cfg, **kw), dev, card, label, extra_fwd=extra_fwd)
    launches, p50 = {}, {}

    def note(label, result, counts):
        launches[label], p50[label] = counts, statistics.median(result.step_ms)

    # slabs: bitwise the resident run
    resident, counts = run("resident")
    note("resident", resident, counts)
    slab, counts = run(f"slabs K={SLAB_STEPS}", stream_slab_steps=SLAB_STEPS)
    note("slabs", slab, counts)
    if not _same_run(slab, resident):
        raise SmokeFailure("the slab-streamed run is not the resident run bit for bit")
    print(f"[options] stream_slab_steps={SLAB_STEPS}: per-epoch val losses and final parameters bit for bit the "
          f"resident run's")

    # lazy tables: through the cross kernels, beside the dense run
    lazy, counts = run("lazy tables", lazy_table_updates=True)
    note("lazy", lazy, counts)
    again, _ = run("lazy tables again", lazy_table_updates=True)
    if not _same_run(again, lazy):
        raise SmokeFailure("two lazy runs differ: the row step is not deterministic on the card")
    print("[options] lazy_table_updates: a second run gives the first's val losses and parameters bit for bit")
    gaps = [abs(a["val_loss"] - b["val_loss"]) for a, b in zip(lazy.history, resident.history)]
    fl, fd = lazy.final_metrics["val_logloss"], resident.final_metrics["val_logloss"]
    print(f"[options] lazy_table_updates: val loss gap to the dense run by epoch {', '.join(f'{g:.3e}' for g in gaps)} "
          f"(untouched rows are not decayed); final val logloss {fl:.5f} against {fd:.5f} (bar {LAZY_TOL}; "
          f"phase 7's trajectory bar there: {LATER_EPOCH_TOL['atol'] + LATER_EPOCH_TOL['rtol'] * fd:.3e})")
    if not (abs(fl - fd) <= LAZY_TOL and lazy.history[-1]["val_loss"] < lazy.history[0]["val_loss"]):
        raise SmokeFailure("the lazy run's final val logloss is not within LAZY_TOL of the dense run's, or it did "
                           "not learn")

    # bf16 first moments, per step and fused: stored bf16, finite
    ckpt_root = REPO / "build" / "chip_smoke_moments"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        for fused in (False, True):
            label = "bf16 moments" + (" fused" if fused else "")
            result, counts = run(label, moment_dtype="bfloat16", fused_epoch=fused)
            note(label, result, counts)
            ckpt = ckpt_root / label.replace(" ", "_")
            train_dcn(splits, dims, model_cfg, dataclasses.replace(train_cfg, n_epochs=1, moment_dtype="bfloat16",
                                                                   fused_epoch=fused),
                      checkpoint_dir=str(ckpt), device=dev)
            state, _ = TrainCheckpointer(str(ckpt)).restore(0, torch.device("cpu"))
            dtypes = {(k, str(v.dtype)) for st in state["optimizer"]["state"].values() for k, v in st.items()
                      if k != "step"}
            if dtypes != {("exp_avg", "torch.bfloat16"), ("exp_avg_sq", "torch.float32")}:
                raise SmokeFailure(f"the {label} run stored its moments as {sorted(dtypes)}")
            if not all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in result.history):
                raise SmokeFailure(f"the {label} run's losses are not finite")
            print(f"[options] moment_dtype=bfloat16{' fused' if fused else ''}: stored first moments bf16, second "
                  f"f32; losses finite")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)

    # NaN checks: a poisoned batch raises, per step and fused; clean data does not
    num = splits.train_num.copy()
    num[3, 2] = np.nan
    poisoned = dataclasses.replace(splits, train_num=num)
    for fused in (False, True):
        cfg = dataclasses.replace(train_cfg, debug_nans=True, fused_epoch=fused)
        try:
            train_dcn(poisoned, dims, model_cfg, cfg, device=dev)
        except FloatingPointError as e:
            print(f"[options] debug_nans{' fused' if fused else ''}: the poisoned batch raised FloatingPointError: {e}")
        else:
            raise SmokeFailure(f"debug_nans{' fused' if fused else ''} did not raise on a poisoned batch")
        label = "debug_nans" + (" fused" if fused else "")
        result, counts = run(label, debug_nans=True, fused_epoch=fused)  # clean data: no raise
        note(label, result, counts)

    # catalog recall: the card against the CPU on the same weights
    val_users = {u for u, y in zip(splits.val_user.tolist(), splits.val_y.tolist()) if y > 0.5}
    chunks = -(-min(len(val_users), 512) // 64)
    result, counts = run("catalog recall", extra_fwd=chunks, eval_catalog_recall=True)
    note("catalog recall", result, counts)
    card_recall = result.final_metrics["catalog_recall_at_100"]
    cpu_model = dcnr_from_jax(result.params, result.bn_state, dims, model_cfg, "cpu")
    cpu_recall = catalog_recall_at_k(cpu_model, splits, k=100)
    print(f"[options] catalog recall@100: card {card_recall:.6f}, the same weights on the CPU {cpu_recall:.6f} "
          f"(|Δ| {abs(card_recall - cpu_recall):.2e}, bar {CATALOG_RECALL_TOL}); {chunks} chunks of 64 users × "
          f"{len(set(splits.train_item.tolist()) | set(splits.val_item.tolist()))} items")
    if not abs(card_recall - cpu_recall) <= CATALOG_RECALL_TOL:
        raise SmokeFailure("the card's catalog recall differs from the CPU's on the same weights")

    print("[time] retraining options, train step p50 ms (hpo_r5 configuration, per step unless fused): "
          + ", ".join(f"{k} {v:.4f}" for k, v in p50.items()) + f" on {card}")
    return {"launches": launches, "step_p50_ms": p50}


def pipeline_phase(dev, card: str) -> dict:
    """Phase 10c: two ``pipeline.py --once`` cycles on a copy of ``data/``
    with a fresh registry (cold, then warm after a data drop), then an engine
    on the card from the registry's active artifact answers one request."""
    import shutil

    from hhrs_tpu_torch import pipeline
    from hhrs_tpu_torch.data.synthetic import append_reviews
    from hhrs_tpu_torch.db.registry import ModelRegistry
    from hhrs_tpu_torch.ops import cross, tower
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    work = REPO / "build" / "chip_smoke_retrain"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(REPO / "data", work / "data")
    data, db, runs = str(work / "data"), str(work / "registry.sqlite"), str(work / "runs")
    argv = ["--data", data, "--db", db, "--runs-dir", runs, "--once", "--epochs", "3"]
    try:
        (rc1, counts1) = _launch_delta(cross, lambda: pipeline.main(argv))
        append_reviews(data, 91_000_001, n=8, rating=9)
        (rc2, counts2) = _launch_delta(cross, lambda: pipeline.main(argv))
        with open(f"{runs}/pipeline_history.jsonl") as f:
            hist = [json.loads(line) for line in f]
        for i, h in enumerate(hist):
            print(f"[retrain] cycle {i + 1}: ok {h.get('ok')}, warm start from {h.get('warm_start_from')}, train "
                  f"{h.get('train_s')} s, gate {h.get('gate_s')} s, total {h.get('total_s')} s on {card}; "
                  f"{'PROMOTED' if h.get('promoted') else 'kept the incumbent'}: {h.get('reason')}")
        if (rc1, rc2) != (0, 0) or len(hist) != 2 or not all(h.get("ok") for h in hist):
            raise SmokeFailure(f"the retraining cycles failed: rc {rc1}, {rc2}; {hist}")
        first = ModelRegistry(db).list()[0]["artifact_path"]
        if hist[0]["warm_start_from"] is not None or hist[1]["warm_start_from"] != first:
            raise SmokeFailure("the second cycle did not warm-start from the first cycle's model")
        if min(counts1["fwd"], counts1["bwd"], counts2["fwd"], counts2["bwd"]) <= 0:
            raise SmokeFailure(f"a cycle did not train through the cross kernels ({counts1}, {counts2})")
        active = ModelRegistry(db).active()["artifact_path"]
        tower.tower_eval.launches = 0
        engine = RecommendationEngine.from_dirs(active, data, device=dev)
        uni = engine.gen.universe
        resp = engine.recommend(int(uni.user_ids[0]), uni.cities[0], "friends", 0.7)
        launches = tower.tower_eval.launches
        which = "the second" if hist[1]["promoted"] else "the first"
        print(f"[retrain] engine on the registry's active artifact ({which} cycle's): "
              f"{len(resp.get('ranked_hotels', []))} hotels for user {int(uni.user_ids[0])}; tower_eval launches "
              f"{launches} (the launch plans timed at first use at this model's widths, the eager run and the "
              f"capture of bucket 1; the request replays the graph)")
        if "ranked_hotels" not in resp or launches <= 0:
            raise SmokeFailure("the engine on the promoted model did not answer through the tower kernel")
        engine.close()
        return {"cycles": [{"fwd": c["fwd"], "bwd": c["bwd"]} for c in (counts1, counts2)],
                "tower_launches": launches, "history": hist}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def retrain_phase(cross, splits, preproc, model_cfg, train_cfg, dev, card: str) -> dict:
    """Phase 10: 10a, 10b, 10c; prints its time."""
    t0 = time.perf_counter()
    out = {"tuned": tuned_phase(cross, dev, card),
           "options": options_phase(cross, splits, preproc, model_cfg, train_cfg, dev, card),
           "pipeline": pipeline_phase(dev, card)}
    print(f"[retrain] phase 10 took {time.perf_counter() - t0:.1f} s")
    return out


# Phase 11: the tuning operator's path (vectorized HPO on the trial-axis cross
# kernels) and the rest of serve (the exported ranker, the batch CLI).
TRIALS_K = 8
# (B, d, L, calls, w bound): the hpo_r5 shape; the reference space's widest
# (emb 64: d = 2·64 + 6 + 11, 6 layers) at B = 4096. w is drawn as the JAX
# init draws it, U(±bound/sqrt(d)), at a quarter of its bound for 6 layers:
# there the init's gates make some rows grow doubly exponentially (|y| to
# 6e14 on these inputs), where no float32 program meets the term-scale bar
# (the plain version itself, against float64: y 14.5x outside it; at half the
# bound dx0 2.7x; at a quarter every output within 0.07 of the allowance).
TRIAL_SHAPES = ((512, 113, 3, 500, 1.0), (4096, 145, 6, 100, 0.25))
# C5: the widest shape at the JAX init's full bound, checked, not timed. There
# every float32 program is outside the term-scale bar against float64; the
# bar is stated from measured spreads (tests/test_torch_port_cross.py
# C5_SPREAD: about twice the largest |f32 − float64| / term scale of the
# plain version and of JAX's vmapped Pallas kernel, 48 lanes): the kernel and
# the plain f32 version, two f32 programs, are held to the sum of two such
# bars.
C5_SHAPE = (4096, 145, 6)
C5_SPREAD = {"y": 8e-4, "dx0": 1e-3, "dw": 1.2e-5, "db": 2.5e-4}
PHASE11_DIR = REPO / "build" / "phase11"
HPO_R5_JOURNAL = REPO / "benchmarks/results/hpo_r5/journal.jsonl"
EXPORT_B = (1, 128, 8192)


def _trial_counts(cross) -> dict:
    f, b = cross.cross_stack_forward_trials, cross.cross_stack_backward_trials
    return {"fwd": f.launches, "bwd": b.launches, "fwd_bf16": f.launches_bf16, "bwd_bf16": b.launches_bf16}


def bf16_flip_reach(cross, w, b, x0, dy) -> tuple:
    """How far one bf16 row scalar of the ``code`` stack, rounded to its
    other bf16 neighbour, moves a row of y and of dx0 (``[B, d]`` each, from
    the plain version in float64). Two bf16 programs that round at the same
    points but add a row's f32 sum in other orders round that sum to
    neighbouring bf16 values where it lies near a midpoint: one ulp, at most
    2⁻⁷ of the scalar. A gate g_l so moves x_{l+1} by 2⁻⁷·|g_l|·|x_l| and
    dx_l by 2⁻⁷·|g_l|·|dx_{l+1}|; a backward row sum s_l moves dx_l by
    2⁻⁷·|s_l|·|w_l|. Bounded here by the row's largest |g| and |s| over the
    layers times its term scale (the largest |x_l|, |dx_l|) and |w|. The
    moved value then rounds again: ``_trial_lanes_check`` adds one ulp of
    the entry, 2⁻⁷ of it."""
    w, b, x0, dy = (t.detach().double() for t in (w, b, x0, dy))
    terms, _, xs, _ = cross._walk_back(w, b, x0, dy, "code")
    g = torch_stack_max([(xs[l] * w[l]).sum(dim=1).abs() for l in range(w.shape[0])])
    s = torch_stack_max([t[2][:, 0].abs() for t in terms])
    sy, sdx = cross.cross_stack_term_scale(w, b, x0, dy, "code")[:2]
    return 2.0 ** -7 * g * sy, 2.0 ** -7 * (g * sdx + s * w.abs().amax(dim=0))


def torch_stack_max(rows: list):
    """The elementwise largest of equal-shaped ``[B]`` tensors, as ``[B, 1]``."""
    import torch

    return torch.stack(rows).amax(dim=0)[:, None]


def _trial_lanes_check(cross, w, b, x0, dy, tol: dict, where: str) -> tuple:
    """One trial-axis launch each way on ``x0 [K, B, d]`` (f32 or bf16), held
    lane by lane: y and dx0 bit for bit the single-trial kernels' under
    ``plan_of``; dw and db bit for bit the single-trial backward's under the
    trial plan, and within ``tol`` of it under ``plan_of`` (another plan adds
    the batch in another order); y, dx0, dw and db within ``tol`` of the plain
    versions, bf16 y and dx0 within ``tol`` plus one row scalar's flip
    (``bf16_flip_reach``) and one ulp of the entry (ROADMAP C8). Returns the largest dw / db gap to
    ``plan_of``'s, the largest errors against the plain versions and the
    count of bf16 row entries past ``tol`` alone."""
    import torch

    bf16 = x0.dtype == torch.bfloat16
    flipped = 0
    y = cross.cross_stack_forward_trials(w, b, x0, "code")
    grads = cross.cross_stack_backward_trials(w, b, x0, dy, "code")
    torch.cuda.synchronize()
    trial, sums_gap, errs = cross.trial_plan_of(x0), 0.0, {"fwd": 0.0, "bwd": 0.0}
    for k in range(x0.shape[0]):
        single = (cross.cross_stack_forward(w[k], b[k], x0[k], "code"),
                  *cross.cross_stack_backward(w[k], b[k], x0[k], dy[k], "code"))
        for name, got, want in zip(("y", "dx0"), (y[k], grads[0][k]), single[:2]):
            if not torch.equal(got, want):
                raise SmokeFailure(f"trial-axis {name} of lane {k} at {where} is not the single-trial kernel's "
                                   f"bit for bit")
        under = cross.cross_stack_backward(w[k], b[k], x0[k], dy[k], "code", plan=trial)
        for name, got, want in zip(("dw", "db"), (grads[1][k], grads[2][k]), under[1:]):
            if not torch.equal(got, want):
                raise SmokeFailure(f"trial-axis {name} of lane {k} at {where} is not the single-trial kernel's "
                                   f"under the trial plan {tuple(trial)} bit for bit")
        scale = cross.cross_stack_term_scale(w[k], b[k], x0[k], dy[k], "code")
        for i, name in ((2, "dw"), (3, "db")):
            gap, _ = cross.assert_close_to_scale(grads[i - 1][k], single[i], scale[i], **tol,
                                                 what=f"trial-axis {name} lane {k} {where} against plan_of's")
            sums_gap = max(sums_gap, gap)
        ref = (cross.cross_stack_apply(w[k], b[k], x0[k], "code"),
               *cross.cross_stack_backward_ref(w[k], b[k], x0[k], dy[k], "code"))
        reach = bf16_flip_reach(cross, w[k], b[k], x0[k], dy[k]) if bf16 else (0.0, 0.0)
        for i, (name, got) in enumerate(zip(("y", "dx0", "dw", "db"), (y[k], *(g[k] for g in grads)))):
            if bf16 and i < 2:
                bar_scale = scale[i] + (reach[i] + 2.0 ** -7 * ref[i].double().abs()) / tol["rtol"]
            else:
                bar_scale = scale[i]
            err, _ = cross.assert_close_to_scale(got, ref[i], bar_scale, **tol,
                                                 what=f"trial-axis {name} lane {k} {where}")
            if bf16 and i < 2:
                flipped += int(((got.double() - ref[i].double()).abs() > tol["rtol"] * scale[i]).sum())
            kind = "fwd" if name == "y" else "bwd"
            errs[kind] = max(errs[kind], err)
    return sums_gap, errs, flipped


def trial_axis_phase(cross, dev, card: str) -> dict:
    """Phase 11a: the trial-axis cross kernels at K = 8, f32 and bf16 (the
    f32 draws cast), against the single-trial kernels lane by lane and
    against their plain versions (``_trial_lanes_check``: f32 at the
    term-scale bar, bf16 at ``CROSS_BF16_TOL``); the forward's and the
    backward's trial plans and their waves printed; then each dtype's
    trial-axis launch, K single-trial launches and the plain version timed
    (CUDA-event means, device time from torch.profiler), with the bound of K
    stacks; then C5, the widest shape at the full init bound, held to the
    plain f32 version at its measured-spread bar."""
    import numpy as np
    import torch

    gen = np.random.default_rng(SEED + 11)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    K, rows, plans = TRIALS_K, {}, {}
    errs = {"fwd": 0.0, "bwd": 0.0, "fwd_bf16": 0.0, "bwd_bf16": 0.0}
    for B, d, L, calls, w_bound in TRIAL_SHAPES:
        x0, dy = f32(gen.standard_normal((K, B, d))), f32(gen.standard_normal((K, B, d)))
        w, b = f32(gen.uniform(-w_bound, w_bound, (K, L, d)) / np.sqrt(d)), f32(0.1 * gen.standard_normal((K, L, d)))
        for name, dtype, tol in (("f32", torch.float32, CROSS_TOL), ("bf16", torch.bfloat16, CROSS_BF16_TOL)):
            args = [t.to(dtype).contiguous() for t in (w, b, x0, dy)]
            sums_gap, lane_errs, flipped = _trial_lanes_check(cross, *args, tol, f"B={B} d={d} L={L} {name}")
            for kind, err in lane_errs.items():
                key = kind if name == "f32" else f"{kind}_bf16"
                errs[key] = max(errs[key], err)
            xk = args[2]
            trial, single_plan = cross.trial_plan_of(xk), cross.plan_of(xk[0], True)
            cap, trial_cap = cross.capacity(xk[0], True), cross.capacity(xk[0], True, trial.cluster)
            waves = {"trial": -(-K * trial.grid // trial_cap), "single": -(-K * single_plan.grid // cap)}
            fwd_trial, fwd_single = cross.fwd_trial_plan_of(xk), cross.plan_of(xk[0], False)
            fwd_cap = cross.capacity(xk[0], False)
            fwd_waves = {"trial": -(-K * fwd_trial.grid // fwd_cap), "single": -(-K * fwd_single.grid // fwd_cap)}
            plans[f"{B} {name}"] = {"trial_plan": list(trial), "single_plan": list(single_plan), "capacity": cap,
                                "trial_capacity": trial_cap, "waves": waves, "dw_db_gap_to_plan_of": sums_gap,
                                "row_entries_past_bf16_tol": flipped, "fwd_trial_plan": list(fwd_trial),
                                "fwd_single_plan": list(fwd_single), "fwd_capacity": fwd_cap,
                                "fwd_waves": fwd_waves}
            print(f"[trials] K={K} B={B} d={d} L={L} {name}: forward capacity {fwd_cap} blocks; forward trial plan "
                  f"{tuple(fwd_trial)} ({fwd_waves['trial']} wave(s) of K grids), single-trial plan "
                  f"{tuple(fwd_single)} ({fwd_waves['single']} waves); backward capacity {cap} blocks in clusters "
                  f"of 8, {trial_cap} in clusters of {trial.cluster}; trial plan {tuple(trial)} ({waves['trial']} "
                  f"wave(s) of K grids), single-trial plan {tuple(single_plan)} ({waves['single']} waves); every "
                  f"lane's y and dx0 bit for bit the single-trial kernels' (plan {tuple(fwd_single)} / "
                  f"{tuple(single_plan)}), dw and db bit for bit the single-trial kernel's under the trial plan and "
                  f"within rtol={tol['rtol']:.3g} atol={tol['atol']:.3g} of the term scale of it under plan_of (max "
                  f"|Δ| {sums_gap:.3e}); all within that bar of the plain versions (max |Δ| fwd "
                  f"{lane_errs['fwd']:.3e}, bwd {lane_errs['bwd']:.3e})"
                  + (f", y and dx0 with one row scalar's flip and one ulp of the entry beside it ({flipped} of "
                     f"{2 * xk.numel()} entries past the bar alone)" if name == "bf16" else ""))
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            wt, bt, xt, dyt = (t.to(dtype).contiguous() for t in (w, b, x0, dy))
            with torch.no_grad():
                timed = {
                    "fwd": (lambda: cross.cross_stack_forward_trials(wt, bt, xt, "code"),
                            lambda: [cross.cross_stack_forward(wt[k], bt[k], xt[k], "code") for k in range(K)],
                            lambda: cross.cross_stack_apply_trials(wt, bt, xt, "code")),
                    "bwd": (lambda: cross.cross_stack_backward_trials(wt, bt, xt, dyt, "code"),
                            lambda: [cross.cross_stack_backward(wt[k], bt[k], xt[k], dyt[k], "code") for k in range(K)],
                            lambda: cross.cross_stack_backward_ref_trials(wt, bt, xt, dyt, "code")),
                }
                for kind, (trial_fn, singles, plain) in timed.items():
                    ms, single_ms = time_cuda(trial_fn, calls), time_cuda(singles, calls)
                    plain_ms = time_cuda(plain, max(calls // 20, 5))
                    device_ms = device_ms_per_call(trial_fn, 50, "cross_")
                    single_device_ms = device_ms_per_call(singles, 20, "cross_", launches=K)
                    graph_ms, single_graph_ms = graph_ms_per_call(trial_fn, 20), graph_ms_per_call(singles, 20)
                    flops, nbytes = cross_work(B, d, L, kind, elem=xt.element_size())
                    bound_ms, bound_by = bound(K * flops, K * nbytes)
                    shown = plans[f"{B} {name}"]
                    timing = dict(K=K, B=B, d=d, L=L, ms=ms, device_ms=device_ms, graph_ms=graph_ms,
                                  k_single_launch_ms=single_ms, k_single_device_ms=single_device_ms,
                                  k_single_graph_ms=single_graph_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by,
                                  **(shown if kind == "bwd" else {"plan": shown["fwd_trial_plan"],
                                                                  "single_plan": shown["fwd_single_plan"],
                                                                  "capacity": shown["fwd_capacity"],
                                                                  "waves": shown["fwd_waves"]}))
                    if name == "f32":
                        rows[(kind, B)] = timing
                    else:
                        rows[(kind, B)]["bf16"] = timing
                    print(f"[time] trial-axis cross {kind} {name} K={K} B={B} d={d} L={L}: one launch {ms:.4f} ms "
                          f"(device {ms_text(device_ms, 1e3, 2)} us, in a graph {graph_ms * 1e3:.2f} us); {K} "
                          f"single-trial launches {single_ms:.4f} ms (device {ms_text(single_device_ms, 1e3, 2)} us, "
                          f"in a graph {single_graph_ms * 1e3:.2f} us); plain {plain_ms:.4f} ms; bound "
                          f"{bound_ms * 1e3:.3f} us ({bound_by}; {K * flops / 1e6:.3f} MFLOP, {K * nbytes / 1e6:.3f} "
                          f"MB) on {card}")
    return {"rows": rows, "errs": errs, "plans": plans, "c5": full_bound_check(cross, dev, gen)}


def full_bound_check(cross, dev, gen) -> dict:
    """C5: the trial-axis kernels at K = 8 on the widest shape with w at the
    JAX init's full bound, against the plain f32 version at twice
    ``C5_SPREAD`` (two f32 programs), against the term scale; each side's own
    largest spread from the plain version in float64 printed."""
    import numpy as np
    import torch

    (B, d, L), K = C5_SHAPE, TRIALS_K
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    x0, dy = f32(gen.standard_normal((K, B, d))), f32(gen.standard_normal((K, B, d)))
    w, b = f32(gen.uniform(-1, 1, (K, L, d)) / np.sqrt(d)), f32(0.1 * gen.standard_normal((K, L, d)))
    got = (cross.cross_stack_forward_trials(w, b, x0, "code"), *cross.cross_stack_backward_trials(w, b, x0, dy, "code"))
    plain = (cross.cross_stack_apply_trials(w, b, x0, "code"), *cross.cross_stack_backward_ref_trials(w, b, x0, dy, "code"))
    w64, b64, x64, dy64 = (t.double() for t in (w, b, x0, dy))
    exact = (cross.cross_stack_apply_trials(w64, b64, x64, "code"),
             *cross.cross_stack_backward_ref_trials(w64, b64, x64, dy64, "code"))
    torch.cuda.synchronize()
    out = {name: {"share_of_bar": 0.0, "kernel_spread": 0.0, "plain_spread": 0.0} for name in C5_SPREAD}
    for k in range(K):
        scales = cross.cross_stack_term_scale(w[k], b[k], x0[k], dy[k], "code")
        for i, name in enumerate(C5_SPREAD):
            _, share = cross.assert_close_to_scale(got[i][k], plain[i][k], scales[i], rtol=2 * C5_SPREAD[name],
                                                   atol=0.0, what=f"C5 {name} lane {k}")
            o = out[name]
            o["share_of_bar"] = max(o["share_of_bar"], share)
            for key, t in (("kernel_spread", got[i][k]), ("plain_spread", plain[i][k])):
                err = (t.double() - exact[i][k]).abs()
                o[key] = max(o[key], float(torch.where(err == 0, 0.0, err / scales[i]).max()))
    print(f"[trials] C5: K={K} B={B} d={d} L={L}, w at the full init bound (|y| to "
          f"{float(exact[0].abs().max()):.2e}): the trial-axis kernels within 2 x C5_SPREAD of the plain f32 "
          f"version; " + "; ".join(f"{n} {o['share_of_bar']:.2f} of the bar (spread from float64: kernel "
                                   f"{o['kernel_spread']:.2e}, plain {o['plain_spread']:.2e}; C5_SPREAD "
                                   f"{C5_SPREAD[n]:.1e})" for n, o in out.items()))
    return out


def graph_ms_per_call(fn, calls: int) -> float:
    """Device time of one call of ``fn`` without the host's launch path:
    ``calls`` calls captured in one CUDA graph (after a warm-up), the graph
    replayed 5 times between CUDA events, the mean per call. The profiler's
    counterpart where it loses kernel events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * calls)


def _journal_record(number: int) -> dict:
    for line in HPO_R5_JOURNAL.read_text().splitlines():
        rec = json.loads(line)
        if rec["number"] == number:
            return rec
    raise SmokeFailure(f"trial {number} is not in {HPO_R5_JOURNAL}")


def _one_ulp_init(dims, mcfg, seed: int, bf16: bool = False) -> tuple:
    """The initialization of ``seed`` as JAX-layout trees, with one ulp
    added to one weight of the final layer: a twin run's start. With
    ``bf16`` the ulp is bfloat16's (the weight rounded to bf16, then its next
    bf16 value), which a bf16 run computes with; a float32 ulp vanishes in
    its cast."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.models.convert import jax_from_dcnr
    from hhrs_tpu_torch.models.dcn import DCNR

    params, bn_state = jax_from_dcnr(DCNR(dims, mcfg, generator=torch.Generator().manual_seed(seed)))
    kernel = params["final"]["kernel"]
    if bf16:
        bits = torch.tensor([kernel.flat[0]]).to(torch.bfloat16).view(torch.int16) + 1
        kernel.flat[0] = np.float32(bits.view(torch.bfloat16).float().item())
    else:
        kernel.flat[0] = np.nextafter(kernel.flat[0], np.float32(np.inf))
    return params, bn_state


def _lane_backward_plan(cross, dims, mcfg, tcfg, dtype, dev):
    """The plan of the group's trial-axis backward: a lane's dw and db are
    the single-trial backward's under it, bit for bit (phase 11a)."""
    import torch

    from hhrs_tpu_torch.models.dcn import DCNR

    d = DCNR(dims, mcfg).cross.w.shape[1]
    return cross.trial_plan_of(torch.empty((TRIALS_K, tcfg.batch_size, d), dtype=dtype, device=dev))


def _default_run_bar(lane: float, seq: float, twin: float, default: float, floor: float) -> tuple:
    """A lane's val loss against the sequential run that users get (its
    cross backward under ``plan_of``): the gap and its bar, the larger of
    ``floor`` and twice the largest gap between the three sequential runs
    (under the lane's plan, its one-ulp twin, under ``plan_of``), which
    differ from each other by rounding alone: the trajectory's noise floor
    for a sum order or a one-ulp start."""
    refs = (seq, twin, default)
    spread = max(abs(p - q) for p in refs for q in refs)
    return abs(lane - default), max(floor, 2 * spread)


def _sequential_runs(cross, splits, dims, mk, tk, plan, dev, bf16: bool = False) -> tuple:
    """A lane's references: its sequential ``train_dcn`` and that run's
    one-ulp twin with every cross backward under ``plan`` (the lane's sum
    order of dw and db), and the sequential run under the default plan.
    The trial-axis backward sums a lane's dw and db in the trial plan's
    order, another order than ``plan_of``'s, and the trajectory amplifies
    that rounding (C1) past one-ulp noise (lane 7, epoch 0: 4.39e-3 from the
    run under ``plan_of``, its twin 1.66e-3); the held reference shares the
    lane's order, so it differs from the lane by the K-lane model's own
    operations alone (PERF.md §6); the run under ``plan_of`` holds the lane
    too, at ``_default_run_bar``."""
    from hhrs_tpu_torch.train.trainer import train_dcn

    real = cross._plan

    def lane_order(B, device_index, d, backward, dtype):
        return plan if backward else real(B, device_index, d, backward, dtype)

    cross._plan = lane_order
    try:
        seq = train_dcn(splits, dims, mk, tk, device=dev)
        twin = train_dcn(splits, dims, mk, tk, device=dev, init_state=_one_ulp_init(dims, mk, tk.seed, bf16=bf16))
    finally:
        cross._plan = real
    return seq, twin, train_dcn(splits, dims, mk, tk, device=dev)


def run_group_phase(cross, splits, preproc, dev, card: str) -> dict:
    """Phase 11b: ``run_group`` on the card at the hpo_r5 architecture, K = 8
    lanes asked of a Study with trial 139's architecture fixed, 3 epochs on
    ``data/``, the trial-axis launches counted from 0; lanes 0 and 7 held to
    the sequential ``train_dcn`` of their trials (its cross backward under
    the lane's plan, ``_sequential_runs``) at the C1 bars or twice the gap
    of its one-ulp twin, and to the sequential run under the default plan at
    ``_default_run_bar``."""
    from hhrs_tpu_torch.config import Config
    from hhrs_tpu_torch.hpo.cli import model_cfg_from_params, train_cfg_from_params
    from hhrs_tpu_torch.hpo.space import reference_search_space
    from hhrs_tpu_torch.hpo.study import Study
    import torch

    from hhrs_tpu_torch.hpo.vectorized import ARCH_KEYS, run_group
    from hhrs_tpu_torch.models.dcn import ModelDims

    dims = ModelDims.from_artifacts(preproc)
    fixed = {k: _journal_record(139)["params"][k] for k in ARCH_KEYS}
    trials = [t.params for t in Study(seed=0).ask(reference_search_space(), TRIALS_K, fixed=fixed)]
    cfg = Config()
    cfg.train.n_epochs = 3
    mcfg, tcfg = model_cfg_from_params(trials[0], cfg.model), train_cfg_from_params(trials[0], cfg.train)
    reset_cross_counts(cross)
    for fn in (cross.cross_stack_forward_trials, cross.cross_stack_backward_trials):
        fn.launches = fn.launches_bf16 = 0
    t0 = time.perf_counter()
    group = run_group(splits, dims, mcfg, tcfg, trials, device=dev)
    group_s = time.perf_counter() - t0
    counts, singles = _trial_counts(cross), cross_counts(cross)
    steps = splits.n_train // tcfg.batch_size
    chunks = -(-splits.n_val // tcfg.eval_batch_size)
    want = {"fwd": 3 * (steps + chunks) + chunks, "bwd": 3 * steps}
    lrs = ", ".join(f"{t['lr']:.3g}" for t in trials)
    drops = ", ".join(f"{t['dropout']:.2f}" for t in trials)
    print(f"[hpo] run_group K={TRIALS_K} (hpo_r5 architecture, trial 139's; lr {lrs}; dropout {drops}): "
          f"3 epochs in {group_s:.2f} s; trial-axis launches fwd "
          f"{counts['fwd']} bwd {counts['bwd']} (want {want['fwd']} / {want['bwd']}: one a step, one an eval chunk "
          f"of each epoch and of the final eval, not {TRIALS_K}x that); single-trial launches {singles}")
    if (counts["fwd"], counts["bwd"]) != (want["fwd"], want["bwd"]) or singles["fwd"] or singles["bwd"]:
        raise SmokeFailure(f"run_group launched {counts} trial-axis and {singles} single-trial cross kernels, "
                           f"not {want}")
    held, plan = {}, _lane_backward_plan(cross, dims, mcfg, tcfg, torch.float32, dev)
    for k in (0, TRIALS_K - 1):
        mk, tk = model_cfg_from_params(trials[k], cfg.model), train_cfg_from_params(trials[k], cfg.train)
        seq, twin, default = _sequential_runs(cross, splits, dims, mk, tk, plan, dev)
        lane, c1_held = group[k], True
        if len(lane.history) != len(seq.history):
            raise SmokeFailure(f"lane {k} ran {len(lane.history)} epochs, its sequential trial {len(seq.history)}")
        for e, (a, b, t, o) in enumerate(zip(lane.history, seq.history, twin.history, default.history)):
            c1 = VAL_TOL if e == 0 else LATER_EPOCH_TOL
            gap, twin_gap = abs(a["val_loss"] - b["val_loss"]), abs(t["val_loss"] - b["val_loss"])
            bar = max(c1["atol"] + c1["rtol"] * abs(b["val_loss"]), 2 * twin_gap)
            c1_held &= gap <= c1["atol"] + c1["rtol"] * abs(b["val_loss"])
            o_gap, o_bar = _default_run_bar(a["val_loss"], b["val_loss"], t["val_loss"], o["val_loss"],
                                            c1["atol"] + c1["rtol"] * abs(o["val_loss"]))
            print(f"[hpo] lane {k} epoch {e}: val {a['val_loss']:.6f}, sequential under the lane's plan "
                  f"{tuple(plan)} {b['val_loss']:.6f} (rel gap {gap / b['val_loss']:.2e}), its one-ulp twin "
                  f"{t['val_loss']:.6f} (rel gap {twin_gap / b['val_loss']:.2e}); bar {bar / b['val_loss']:.2e} "
                  f"rel; lr {a['lr']:.4g} / {b['lr']:.4g} / {o['lr']:.4g}; sequential under plan_of "
                  f"{o['val_loss']:.6f} (rel gap {o_gap / o['val_loss']:.2e}, bar {o_bar / o['val_loss']:.2e} rel)")
            if gap > bar or a["lr"] != b["lr"]:
                raise SmokeFailure(f"lane {k} epoch {e} is not its sequential trial's: {a} against {b}")
            if o_gap > o_bar or a["lr"] != o["lr"]:
                raise SmokeFailure(f"lane {k} epoch {e} is not its sequential trial's under plan_of: {a} against {o}")
        if lane.best_epoch != seq.best_epoch:
            raise SmokeFailure(f"lane {k} best epoch {lane.best_epoch}, sequential {seq.best_epoch}")
        held[k] = c1_held
        print(f"[hpo] lane {k}: best epoch {lane.best_epoch} both (under plan_of {default.best_epoch}); final val logloss {lane.final_metrics['val_logloss']:.6f} "
              f"/ {seq.final_metrics['val_logloss']:.6f}, AUC {lane.final_metrics['val_auc']:.5f} / "
              f"{seq.final_metrics['val_auc']:.5f}; the C1 bars alone {'held' if c1_held else 'did NOT hold'}; "
              f"sequential examples_per_s {default.examples_per_s:.1f} on {card}")
    print(f"[hpo] group_examples_per_s {group[0].group_examples_per_s:.1f} ({TRIALS_K} lanes, "
          f"{group[0].examples_per_s:.1f} each) against the sequential trainer's {default.examples_per_s:.1f} on the "
          f"same architecture on {card}")
    return {"launches": counts, "group_examples_per_s": group[0].group_examples_per_s,
            "examples_per_s": group[0].examples_per_s, "sequential_examples_per_s": default.examples_per_s,
            "group_s": group_s, "c1_bars_held": held,
            "bf16": bf16_group_check(cross, splits, dims, trials, cfg, want, dev, card)}


def bf16_group_check(cross, splits, dims, trials: list, cfg, want: dict, dev, card: str) -> dict:
    """C4 on the card: the same K = 8 group at compute and storage bf16, its
    trial-axis launches counted (bf16 only, want's counts), lanes 0 and 7
    held to their sequential bf16 ``train_dcn`` (under the lane's plan, as
    the f32 lanes are) at the bf16 trainer's bar (``BF16_VAL_RTOL`` on
    each epoch's val loss) or at twice the gap of the sequential run's bf16
    one-ulp twin where the trajectory's own noise is larger (as the f32
    lanes are held), the same LR decisions, and the best epoch of the
    sequential run or of its twin; and to the sequential bf16 run under
    ``plan_of`` at ``_default_run_bar`` (floor ``BF16_VAL_RTOL``)."""
    import torch

    from hhrs_tpu_torch.hpo.cli import model_cfg_from_params, train_cfg_from_params
    from hhrs_tpu_torch.hpo.vectorized import run_group

    def bf16_cfg(params):
        return dataclasses.replace(model_cfg_from_params(params, cfg.model), compute_dtype="bfloat16",
                                   storage_dtype="bfloat16")

    tcfg = train_cfg_from_params(trials[0], cfg.train)
    reset_cross_counts(cross)
    for fn in (cross.cross_stack_forward_trials, cross.cross_stack_backward_trials):
        fn.launches = fn.launches_bf16 = 0
    t0 = time.perf_counter()
    group = run_group(splits, dims, bf16_cfg(trials[0]), tcfg, trials, device=dev)
    group_s = time.perf_counter() - t0
    counts, singles = _trial_counts(cross), cross_counts(cross)
    print(f"[hpo] run_group K={TRIALS_K} at bf16 compute and storage: 3 epochs in {group_s:.2f} s; trial-axis "
          f"launches bf16 fwd {counts['fwd_bf16']} bwd {counts['bwd_bf16']}, f32 fwd {counts['fwd']} bwd "
          f"{counts['bwd']} (want {want['fwd']} / {want['bwd']} bf16, 0 f32); single-trial launches {singles}")
    if (counts["fwd_bf16"], counts["bwd_bf16"], counts["fwd"], counts["bwd"]) != (want["fwd"], want["bwd"], 0, 0) \
            or any(singles.values()):
        raise SmokeFailure(f"the bf16 run_group launched {counts} trial-axis and {singles} single-trial cross "
                           f"kernels, not {want} bf16")
    gaps, held = {}, {}
    plan = _lane_backward_plan(cross, dims, bf16_cfg(trials[0]), tcfg, torch.bfloat16, dev)
    for k in (0, TRIALS_K - 1):
        mk, tk = bf16_cfg(trials[k]), train_cfg_from_params(trials[k], cfg.train)
        seq, twin, default = _sequential_runs(cross, splits, dims, mk, tk, plan, dev, bf16=True)
        lane = group[k]
        if len(lane.history) != len(seq.history):
            raise SmokeFailure(f"bf16 lane {k} ran {len(lane.history)} epochs, its sequential trial "
                               f"{len(seq.history)}")
        held[k] = True
        for e, (a, b, t, o) in enumerate(zip(lane.history, seq.history, twin.history, default.history)):
            gap, twin_gap = abs(a["val_loss"] / b["val_loss"] - 1), abs(t["val_loss"] / b["val_loss"] - 1)
            bar = max(BF16_VAL_RTOL, 2 * twin_gap)
            gaps[(k, e)] = gap
            held[k] &= gap <= BF16_VAL_RTOL
            o_gap, o_bar = _default_run_bar(a["val_loss"], b["val_loss"], t["val_loss"], o["val_loss"],
                                            BF16_VAL_RTOL * abs(o["val_loss"]))
            print(f"[hpo] bf16 lane {k} epoch {e}: val {a['val_loss']:.6f}, sequential under the lane's plan "
                  f"{tuple(plan)} {b['val_loss']:.6f} (rel gap {gap:.2e}), its bf16 one-ulp twin {t['val_loss']:.6f} "
                  f"(rel gap {twin_gap:.2e}); bar {bar:.2e} rel; lr {a['lr']:.4g} / {b['lr']:.4g} / {o['lr']:.4g}; "
                  f"sequential under plan_of {o['val_loss']:.6f} (rel gap {o_gap / o['val_loss']:.2e}, bar "
                  f"{o_bar / o['val_loss']:.2e} rel)")
            if gap > bar or a["lr"] != b["lr"]:
                raise SmokeFailure(f"bf16 lane {k} epoch {e} is not its sequential trial's: {a} against {b}")
            if o_gap > o_bar or a["lr"] != o["lr"]:
                raise SmokeFailure(f"bf16 lane {k} epoch {e} is not its sequential trial's under plan_of: {a} "
                                   f"against {o}")
        # bf16 val losses of neighbouring epochs may lie within the trajectory's
        # noise of each other: the best epoch is held to the sequential run's,
        # or to its one-ulp twin's where the two pick differently
        if lane.best_epoch not in (seq.best_epoch, twin.best_epoch):
            raise SmokeFailure(f"bf16 lane {k} best epoch {lane.best_epoch}, sequential {seq.best_epoch}, its "
                               f"twin {twin.best_epoch}")
        print(f"[hpo] bf16 lane {k}: best epoch {lane.best_epoch}, sequential {seq.best_epoch}, its twin "
              f"{twin.best_epoch}, under plan_of {default.best_epoch}")
    print(f"[hpo] bf16 group_examples_per_s {group[0].group_examples_per_s:.1f} on {card}")
    return {"launches": counts, "group_examples_per_s": group[0].group_examples_per_s, "group_s": group_s,
            "max_rel_gap": max(gaps.values()), "bf16_bar_alone_held": held}


def hpo_cli_phase(dev, card: str) -> dict:
    """Phase 11c: the HPO CLI as subprocesses on the card (vectorized K = 8,
    with lane reclamation, sequential); each journal holds the asked trials,
    the best artifact serves a request through the tower kernel; the port's
    Study resumes JAX's hpo_r5 journal and asks its next 8 trials."""
    import shutil

    import torch

    from hhrs_tpu_torch.hpo.space import reference_search_space
    from hhrs_tpu_torch.hpo.study import Study
    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    root = PHASE11_DIR / "hpo"
    shutil.rmtree(root, ignore_errors=True)
    runs = {"vectorized": (["--trials", "16", "--vectorize", "8"], 16),
            "reclaim": (["--trials", "16", "--vectorize", "8", "--reclaim-lanes"], 16),
            "sequential": (["--trials", "2"], 2)}
    golden = json.loads((REPO / GOLDEN).read_text())
    out = {}
    for label, (extra, asked) in runs.items():
        d = root / label
        cmd = [sys.executable, "-m", "hhrs_tpu_torch.hpo.cli", "--data", str(REPO / "data"), "--epochs", "2",
               "--out", str(d), "--journal", str(d / "j.jsonl"), *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        (OUT_DIR / f"hpo_cli_{label}.log").write_text(proc.stdout[-20000:] + proc.stderr[-40000:])
        if proc.returncode != 0:
            raise SmokeFailure(f"the HPO CLI ({label}) exited {proc.returncode}: {proc.stderr[-2000:]}")
        records = [json.loads(line) for line in (d / "j.jsonl").read_text().splitlines()]
        states = {s: sum(r["state"] == s for r in records) for s in ("complete", "pruned", "failed")}
        if len(records) != asked or not states["complete"]:
            raise SmokeFailure(f"the HPO CLI ({label}) journaled {len(records)} trials ({states}), not {asked}")
        tower.tower_eval.launches = 0
        engine = RecommendationEngine.from_dirs(str(d), str(REPO / "data"), device=dev)
        resp = engine.recommend(*golden["requests"][0])
        torch.cuda.synchronize()
        launches = tower.tower_eval.launches
        engine.close()
        if "ranked_hotels" not in resp or launches <= 0:
            raise SmokeFailure(f"the HPO CLI's ({label}) best artifact did not serve through the tower kernel")
        best = min((r for r in records if r["state"] == "complete"), key=lambda r: r["value"])
        rates = [r["user_attrs"].get("group_examples_per_s", r["user_attrs"].get("examples_per_s"))
                 for r in records if r["state"] == "complete"]
        print(f"[hpo] cli {label}: {len(records)} trials journaled ({states}) in {seconds:.1f} s; best value "
              f"{best['value']:.5f} (trial {best['number']}, hidden {best['params']['hidden_dim']}, emb "
              f"{best['params']['emb_dim']}, batch {best['params']['batch_size']}); the best artifact answered "
              f"{len(resp['ranked_hotels'])} hotels, tower_eval launches {launches}; median rate "
              f"{statistics.median(rates):.1f} examples/s on {card}")
        out[label] = {"trials": len(records), "states": states, "seconds": seconds, "best": best["value"]}
    study = Study(journal_path=str(HPO_R5_JOURNAL), seed=0)
    asked = study.ask(reference_search_space(), 8)
    if len(study.trials) != 300 or [t.number for t in asked] != list(range(300, 308)):
        raise SmokeFailure("the port's Study did not resume the hpo_r5 journal's 300 trials")
    print(f"[hpo] the port's Study resumed {HPO_R5_JOURNAL.relative_to(REPO)} (300 trials, best "
          f"{study.best_value:.5f}) and asked trials 300-307: "
          + "; ".join(f"lr {t.params['lr']:.3g} hidden {t.params['hidden_dim']}" for t in asked))
    return out


def export_check_main(argv: list) -> int:
    """``chip_smoke.py --export-check RANKER CHECK``: phase 11d's fresh
    process. It imports the export module (and with it only
    ``hhrs_tpu_torch.ops.tower`` of the package's kernels), loads the
    program onto the card, scores CHECK's inputs and prints one JSON line:
    bitwise equality with CHECK's logits per batch size, and whether any
    ``hhrs_tpu_torch.models`` module was imported. Exits 1 unless all
    equal and none was."""
    import torch

    from hhrs_tpu_torch.serve.export import ExportedRanker

    ranker_path, check_path = argv
    ranker = ExportedRanker.load(ranker_path)
    check = torch.load(check_path)
    equal = {}
    for B, (inputs, want) in check.items():
        got = ranker(*(t.cuda() for t in inputs))
        equal[B] = bool(torch.equal(got.cpu(), want))
    models = sorted(m for m in sys.modules if m.startswith("hhrs_tpu_torch.models"))
    print(json.dumps({"equal": equal, "models_imported": models}))
    return 0 if all(equal.values()) and not models else 1


def export_phase(bundle, dev, card: str) -> dict:
    """Phase 11d: export hpo_r5 on the card, score B = 1, 128, 8192 in a
    fresh process (bitwise ``tower_eval``, no model code imported) and here
    (launches counted from 0), and time the loaded program against a direct
    ``build_x0`` + ``tower_eval``."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.models.convert import dcnr_from_jax
    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.serve.export import ExportedRanker, save_ranker

    PHASE11_DIR.mkdir(parents=True, exist_ok=True)
    path = str(PHASE11_DIR / "ranker.pt2")
    t0 = time.perf_counter()
    save_ranker(bundle, path)
    export_s = time.perf_counter() - t0
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg, dev)
    folded = tower.fold_eval_params(model)
    gen = np.random.default_rng(SEED + 12)
    inputs = {}
    for B in EXPORT_B:
        inputs[B] = (torch.as_tensor(gen.integers(0, bundle.dims.n_users, B), device=dev),
                     torch.as_tensor(gen.integers(0, bundle.dims.n_items, B), device=dev),
                     torch.as_tensor(np.stack([gen.integers(0, n, B) for _, n in bundle.dims.cat_dims], 1), device=dev),
                     torch.as_tensor(gen.random((B, bundle.dims.n_num_features), np.float32), device=dev))
    direct = lambda B: tower.tower_eval(folded, tower.build_x0(model, *inputs[B]))  # noqa: E731
    with torch.no_grad():
        want = {B: direct(B) for B in EXPORT_B}
    check = str(PHASE11_DIR / "export_check.pt")
    torch.save({B: (tuple(t.cpu() for t in inputs[B]), want[B].cpu()) for B in EXPORT_B}, check)
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--export-check", path, check], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    print(f"[export] recorded hpo_r5 in {export_s:.2f} s ({Path(path).stat().st_size / 1024:.1f} KB); a fresh "
          f"process loaded it on the card: {proc.stdout.strip()[-400:]}")
    if proc.returncode != 0:
        raise SmokeFailure(f"the exported ranker in a fresh process: rc {proc.returncode}, {proc.stderr[-2000:]}")
    ranker = ExportedRanker.load(path)
    with torch.no_grad():  # the plans of these widths were timed in phase 3: no launch here
        for B in EXPORT_B:
            tower.plan_of(folded, tower.build_x0(model, *inputs[B]))
    tower.tower_eval.launches = 0
    for B in EXPORT_B:
        if not torch.equal(ranker(*inputs[B]), want[B]):
            raise SmokeFailure(f"the exported ranker's logits at B={B} are not tower_eval's bit for bit")
    torch.cuda.synchronize()
    launches = tower.tower_eval.launches
    if launches != len(EXPORT_B):
        raise SmokeFailure(f"{len(EXPORT_B)} calls of the exported ranker launched the tower kernel {launches} times")
    timings = {}
    with torch.no_grad():
        for B, iters in ((128, 300), (8192, 100)):
            ms, direct_ms = time_cuda(lambda: ranker(*inputs[B]), iters), time_cuda(lambda: direct(B), iters)
            timings[B] = {"program_ms": ms, "direct_ms": direct_ms}
            print(f"[export] B={B}: the loaded program {ms:.4f} ms a call, build_x0 + tower_eval {direct_ms:.4f} ms "
                  f"(CUDA-event means) on {card}")
    print(f"[export] {len(EXPORT_B)} calls (B = {EXPORT_B}) of the loaded program: tower_eval launches {launches}, "
          f"logits bit for bit tower_eval's")
    return {"launches": launches, "timings": timings, "export_s": export_s}


def batch_cli_phase(engine, dev, card: str) -> dict:
    """Phase 11e: the batch CLI over every user of ``data/`` in chunks of 64
    on the card (tower launches counted from 0), each line equal to the
    engine's ``recommend`` of the same request; users/s."""
    import contextlib
    import io

    import torch

    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.serve import batch_cli

    PHASE11_DIR.mkdir(parents=True, exist_ok=True)
    out = PHASE11_DIR / "recs.jsonl"
    err = io.StringIO()
    tower.tower_eval.launches = 0
    with contextlib.redirect_stderr(err):
        rc = batch_cli.main(["--artifacts", str(REPO / ARTIFACT), "--data", str(REPO / "data"), "--out", str(out),
                             "--chunk", "64"])
    torch.cuda.synchronize()
    launches = tower.tower_eval.launches
    summary = [json.loads(line) for line in err.getvalue().splitlines() if line.startswith("{")]
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    if rc != 0 or not summary or len(lines) != summary[-1]["users"] or len(lines) < 2000:
        raise SmokeFailure(f"the batch CLI exited {rc} with {len(lines)} lines: {err.getvalue()[-1000:]}")
    differ = [rec["user_id"] for rec in lines
              if rec["hotels"] != engine.recommend(rec["user_id"], rec["city"], "friends", 0.7).get("ranked_hotels", [])]
    chunks = -(-len(lines) // 64)
    print(f"[batch] {len(lines)} users in chunks of 64: {summary[-1]['users_per_s']} users/s "
          f"({summary[-1]['seconds']} s, host clock) on {card}; tower_eval launches {launches} (the eager run and "
          f"the capture of the 64-request bucket; the {chunks} chunks replay its graph); lines unlike the "
          f"engine's recommend: {len(differ)}")
    if differ or launches <= 0:
        raise SmokeFailure(f"the batch CLI: {len(differ)} lines unlike engine.recommend (users {differ[:5]}), "
                           f"tower_eval launches {launches}")
    return {"launches": launches, "replays": chunks, "users_per_s": summary[-1]["users_per_s"],
            "users": len(lines)}


def tuning_phase(cross, splits, preproc, bundle, engine, dev, card: str) -> dict:
    """Phase 11: 11a–11e; prints its time."""
    t0 = time.perf_counter()
    out = {"trials": trial_axis_phase(cross, dev, card),
           "group": run_group_phase(cross, splits, preproc, dev, card),
           "cli": hpo_cli_phase(dev, card),
           "export": export_phase(bundle, dev, card),
           "batch": batch_cli_phase(engine, dev, card)}
    print(f"[hpo] phase 11 took {time.perf_counter() - t0:.1f} s")
    return out


# Phase 12: the two-tower retriever (A10), the exported ranker of every
# architecture and dtype on the registered cross operator (A8b), the native
# CSV reader (A13).
TWO_TOWER_INIT = "hhrs_tpu_torch/testdata/two_tower_init_data.npz"
TWO_TOWER_GOLDEN = "hhrs_tpu_torch/testdata/two_tower_golden_data.json"
RETRIEVAL_EMB = "hhrs_tpu_torch/testdata/retrieval_embeddings_hpo_r5.npy"
TWO_TOWER_SERVE_GOLDEN = "hhrs_tpu_torch/testdata/serve_golden_hpo_r5_two_tower.json"
PHASE12_DIR = REPO / "build" / "phase12"
EXPORT_ARCHS = ("dcnr", "cross_only", "deep_only", "dcn_mlp")
EXPORT_TIMED = ((128, 100), (8192, 30))  # (B, calls)


def two_tower_phase(splits, preproc, dev, card: str) -> dict:
    """Phase 12a: the retriever at its default width (50 epochs, B = 1024)
    on ``data/`` from the JAX init, against the JAX run: epochs 0-2 at C1's
    bars, final recall@100 within CATALOG_RECALL_TOL; its exported rows
    L2-normalized."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.models.convert import two_tower_from_jax
    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.retrieval import two_tower

    dims = ModelDims.from_artifacts(preproc)
    cfg = two_tower.TwoTowerConfig()
    jax_params = dict(np.load(REPO / TWO_TOWER_INIT))
    golden = json.loads((REPO / TWO_TOWER_GOLDEN).read_text())
    t0 = time.perf_counter()
    r = two_tower.train_two_tower(splits, dims, cfg, device=dev, init=two_tower_from_jax(jax_params, dims, cfg))
    wall = time.perf_counter() - t0
    got = [h["train_loss"] for h in r.history]
    want = golden["train_loss"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"[two-tower] {cfg.n_epochs} epochs of {len(splits.train_y[splits.train_y == 1]) // cfg.batch_size} steps "
          f"of B={cfg.batch_size} in {wall:.2f} s: examples_per_s {r.examples_per_s:.1f}, recall@100 "
          f"{r.final_recall_at_100:.5f} (JAX run {golden['final_recall_at_100']:.5f}); loss by epoch 0-2 "
          + ", ".join(f"{a:.6f} (JAX {b:.6f})" for a, b in zip(got[:3], want[:3]))
          + f"; last {got[-1]:.6f} (JAX {want[-1]:.6f}); largest relative gap over 50 epochs {max(gaps):.3e} "
          f"on {card}")
    for e, (a, b) in enumerate(zip(got[:3], want[:3])):
        tol = VAL_TOL if e == 0 else LATER_EPOCH_TOL
        if not abs(a - b) <= tol["atol"] + tol["rtol"] * abs(b):
            raise SmokeFailure(f"two-tower epoch {e} loss {a} against the JAX run's {b} (rtol {tol['rtol']})")
    gap = abs(r.final_recall_at_100 - golden["final_recall_at_100"])
    if not gap <= CATALOG_RECALL_TOL:
        raise SmokeFailure(f"two-tower recall@100 {r.final_recall_at_100} is {gap:.5f} from the JAX run's "
                           f"(bar {CATALOG_RECALL_TOL})")
    PHASE12_DIR.mkdir(parents=True, exist_ok=True)
    V = np.load(two_tower.export_retrieval_embeddings(str(PHASE12_DIR), r.model, splits, dims))
    if V.shape != (dims.n_items, cfg.out_dim) or not np.allclose(np.linalg.norm(V, axis=1), 1.0, atol=1e-4):
        raise SmokeFailure(f"the exported retrieval embeddings are not {dims.n_items} unit rows: {V.shape}")
    torch.cuda.synchronize()
    return {"examples_per_s": r.examples_per_s, "recall_at_100": r.final_recall_at_100,
            "jax_recall_at_100": golden["final_recall_at_100"], "recall_gap": gap,
            "loss_gap_epoch_0_2": gaps[:3], "wall_s": wall}


def two_tower_serve_phase(dev, card: str) -> dict:
    """Phase 12b: the golden sweep with the JAX-exported retrieval
    embeddings, buckets 1 and 8, graphed and eager, against the JAX engine's
    two-tower golden under SWAP_TOL; tower launches counted from 0."""
    import torch

    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    golden = json.loads((REPO / TWO_TOWER_SERVE_GOLDEN).read_text())
    torch.cuda.synchronize()
    tower.tower_eval.launches = 0
    engine = RecommendationEngine.from_dirs(str(REPO / ARTIFACT), str(REPO / "data"),
                                            retrieval_embeddings_path=str(REPO / RETRIEVAL_EMB))
    swaps = 0
    for req, want, logits in zip(golden["requests"], golden["responses"], golden["logits"]):
        s = compare_response(json.loads(json.dumps(engine.recommend(*req))), want, logits)
        if s is None:
            raise SmokeFailure(f"recommend{tuple(req)} with the retrieval embeddings differs from the golden response")
        swaps += s
    many = [golden["requests"][i] for i in golden["many"]]
    for batch, pad_to in ((many, None), (many[:5], 8)):
        for i, got in zip(golden["many"], engine.recommend_many(batch, pad_to=pad_to)):
            s = compare_response(json.loads(json.dumps(got)), golden["responses"][i], golden["logits"][i])
            if s is None:
                raise SmokeFailure(f"recommend_many(K={len(batch)}, pad_to={pad_to}) with the retrieval embeddings "
                                   f"differs from the golden response {i}")
            swaps += s
    for item, n, want in golden["similar"]:
        if engine.similar_items(item, n) != want:
            raise SmokeFailure(f"similar_items({item}, {n}) with the retrieval embeddings differs from the golden")
    torch.cuda.synchronize()
    launches = tower.tower_eval.launches
    buckets = sorted(engine._buckets)
    differ = [req for req in golden["requests"] if engine._recommend_eager([req]) != [engine.recommend(*req)]]
    differ += [b for b in (many, many[:5]) if engine._recommend_eager(b, pad_to=8) != engine.recommend_many(b, pad_to=8)]
    if differ:
        raise SmokeFailure(f"with the retrieval embeddings the graphed path differs from the eager one for {differ[:3]}")
    if launches <= 0 or buckets != [(1, False), (8, False)]:
        raise SmokeFailure(f"the two-tower sweep launched the tower kernel {launches} times, buckets {buckets}")
    print(f"[two-tower] the engine with retrieval_embeddings ({engine._emb_train.shape[1]}-wide) answered "
          f"{len(golden['requests'])} requests, 2 batches and {len(golden['similar'])} similar_items as the JAX "
          f"engine's golden file (tie swaps {swaps}); graphed JSON equals eager; tower_eval launches {launches} "
          f"(an eager run and a capture for buckets {buckets}) on {card}")
    engine.close()
    return {"launches": launches, "swaps": swaps}


def export_all_phase(bundle, dev, card: str) -> dict:
    """Phase 12c: every arch × {f32, bf16} × both variants at hpo_r5's widths
    (seeded random weights), exported on the card, loaded back and called at
    B = 1, 128, 8192: bit for bit the engine's route for that bundle, the
    registered operators' launches counted from 0 over the exported calls;
    CUDA-event ms a call beside the direct route."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.config import ModelConfig
    from hhrs_tpu_torch.models.convert import dcnr_from_jax, jax_from_dcnr
    from hhrs_tpu_torch.models.dcn import DCNR
    from hhrs_tpu_torch.ops import cross, tower
    from hhrs_tpu_torch.serve.export import ExportedRanker, save_ranker
    from hhrs_tpu_torch.train.artifacts import ArtifactBundle

    PHASE12_DIR.mkdir(parents=True, exist_ok=True)
    base = bundle.model_cfg
    gen = np.random.default_rng(SEED + 13)
    inputs = {B: (torch.as_tensor(gen.integers(0, bundle.dims.n_users, B), device=dev),
                  torch.as_tensor(gen.integers(0, bundle.dims.n_items, B), device=dev),
                  torch.as_tensor(np.stack([gen.integers(0, n, B) for _, n in bundle.dims.cat_dims], 1), device=dev),
                  torch.as_tensor(gen.random((B, bundle.dims.n_num_features), np.float32), device=dev))
              for B in EXPORT_B}
    totals = {"cross_fwd": 0, "cross_fwd_bf16": 0, "tower": 0}
    rows = []
    t_phase = time.perf_counter()
    for i, (arch, dtype, variant) in enumerate((a, d, v) for a in EXPORT_ARCHS for d in ("float32", "bfloat16")
                                               for v in ("code", "canonical")):
        cfg = ModelConfig(emb_dim=base.emb_dim, hidden_dim=base.hidden_dim, n_cross_layers=base.n_cross_layers,
                          n_res_blocks=base.n_res_blocks, arch=arch, cross_variant=variant, compute_dtype=dtype,
                          storage_dtype=dtype)
        params, bn_state = jax_from_dcnr(DCNR(bundle.dims, cfg, torch.Generator().manual_seed(100 + i)))
        b = ArtifactBundle(params, bn_state, cfg, bundle.dims, bundle.preproc, bundle.item_embeddings, {})
        t0 = time.perf_counter()
        path = save_ranker(b, str(PHASE12_DIR / f"{arch}_{dtype}_{variant}.pt2"))
        export_s = time.perf_counter() - t0
        ranker = ExportedRanker.load(path)
        model = dcnr_from_jax(params, bn_state, bundle.dims, cfg, dev)
        if tower.uses_tower(cfg):
            folded = tower.fold_eval_params(model)
            direct = lambda B: tower.tower_eval(folded, tower.build_x0(model, *inputs[B]), variant)  # noqa: E731
        else:
            direct = lambda B: model(*inputs[B])  # noqa: E731
        with torch.no_grad():
            want = {B: direct(B) for B in EXPORT_B}
        torch.cuda.synchronize()
        reset_cross_counts(cross)
        tower.tower_eval.launches = 0
        got = {B: ranker(*inputs[B]) for B in EXPORT_B}
        torch.cuda.synchronize()
        counts = {"cross_fwd": cross.cross_stack_forward.launches,
                  "cross_fwd_bf16": cross.cross_stack_forward.launches_bf16, "tower": tower.tower_eval.launches}
        for B in EXPORT_B:
            if not torch.equal(got[B], want[B]):
                raise SmokeFailure(f"the exported {arch} {dtype} {variant} ranker at B={B} is not its direct route "
                                   "bit for bit")
        expect = ({"cross_fwd": 0, "cross_fwd_bf16": 0, "tower": len(EXPORT_B)} if tower.uses_tower(cfg) else
                  {"cross_fwd": len(EXPORT_B) * (arch != "deep_only" and dtype == "float32"),
                   "cross_fwd_bf16": len(EXPORT_B) * (arch != "deep_only" and dtype == "bfloat16"), "tower": 0})
        if counts != expect:
            raise SmokeFailure(f"the exported {arch} {dtype} {variant} ranker launched {counts}, expected {expect}")
        for k in totals:
            totals[k] += counts[k]
        timings = {}
        with torch.no_grad():
            for B, iters in EXPORT_TIMED:
                timings[B] = {"program_ms": time_cuda(lambda: ranker(*inputs[B]), iters),
                              "direct_ms": time_cuda(lambda: direct(B), iters)}
        rows.append({"arch": arch, "dtype": dtype, "variant": variant, "export_s": export_s, "launches": counts,
                     "timings": timings})
        print(f"[export-all] {arch} {dtype} {variant}: recorded in {export_s:.2f} s, B = {EXPORT_B} bit for bit its "
              f"direct route, launches {counts}; "
              + "; ".join(f"B={B} program {t['program_ms']:.4f} ms, direct {t['direct_ms']:.4f} ms"
                          for B, t in timings.items()) + f" on {card}")
    if min(totals["cross_fwd"], totals["cross_fwd_bf16"], totals["tower"]) <= 0:
        raise SmokeFailure(f"the exported programs did not launch every operator's kernel: {totals}")
    print(f"[export-all] {len(rows)} programs in {time.perf_counter() - t_phase:.1f} s; launches over the exported "
          f"calls: hhrs::cross_stack_fwd f32 {totals['cross_fwd']}, bf16 {totals['cross_fwd_bf16']}, "
          f"hhrs::tower_eval {totals['tower']}")
    return {"launches": totals, "rows": rows}


def native_ingest_phase(card: str) -> dict:
    """Phase 12d: phase 10a's cold ingest of the tuned preset's 500,000 rows
    (``build/tuned/data``) read with ``engine="native"`` and with
    ``engine="python"``, each then through phase 10a's preprocessing: the
    tables equal column by column with the same dtypes, and the splits
    equal."""
    import numpy as np

    from hhrs_tpu_torch.config import build_config
    from hhrs_tpu_torch.data.features import add_engineered_features
    from hhrs_tpu_torch.data.ingest import load_reviews_csv, noise_filter
    from hhrs_tpu_torch.data.preprocess import Preprocessor
    from hhrs_tpu_torch.data.table import isna

    csv_path = str(REPO / "build" / "tuned" / "data" / "hackathon_augmented_data.csv")
    cfg = build_config([], preset="tuned", environ={})
    out, tables, splits = {}, {}, {}
    for engine in ("native", "python"):
        t0 = time.perf_counter()
        tables[engine] = load_reviews_csv(csv_path, engine=engine)
        read_s = time.perf_counter() - t0
        pre = Preprocessor(categorical_cols=cfg.data.categorical_cols, numerical_cols=cfg.data.numerical_cols,
                           test_size=cfg.data.test_size, split_seed=cfg.data.split_seed,
                           leakage_compat=cfg.data.leakage_compat)
        frame = add_engineered_features(noise_filter(tables[engine], cfg.data.positive_rating,
                                                     cfg.data.negative_rating))
        splits[engine], _ = pre.fit_transform(frame)
        out[engine] = {"read_s": read_s, "ingest_s": time.perf_counter() - t0}
    a, b = tables["native"], tables["python"]
    if list(a) != list(b):
        raise SmokeFailure(f"native and python tables have other columns: {list(a)} / {list(b)}")
    for name in a:
        x, y = a[name], b[name]
        same = x.dtype == y.dtype and x.shape == y.shape and (
            all((isna(p) and isna(q)) or (type(p) is type(q) and p == q) for p, q in zip(x.tolist(), y.tolist()))
            if x.dtype == object else np.array_equal(x, y, equal_nan=True))
        if not same:
            raise SmokeFailure(f"column {name!r}: the native table differs from the python table")
    if not all(np.array_equal(getattr(splits["native"], k), v) for k, v in vars(splits["python"]).items()):
        raise SmokeFailure("the splits of the native and the python tables differ")
    n = len(next(iter(a.values())))
    print(f"[ingest] {n} rows: engine=native read {out['native']['read_s']:.3f} s, cold ingest "
          f"{out['native']['ingest_s']:.2f} s; engine=python read {out['python']['read_s']:.3f} s, cold ingest "
          f"{out['python']['ingest_s']:.2f} s; tables equal column by column ({len(a)} columns, dtypes equal), "
          f"splits equal (host: {card})")
    return out


def retriever_export_ingest_phase(splits, preproc, bundle, dev, card: str) -> dict:
    """Phase 12 (a-d), timed as one."""
    t0 = time.perf_counter()
    out = {"two_tower": two_tower_phase(splits, preproc, dev, card),
           "serve": two_tower_serve_phase(dev, card),
           "export": export_all_phase(bundle, dev, card),
           "ingest": native_ingest_phase(card)}
    print(f"[phase12] phase 12 took {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 13: serving over a device mesh ------------------------------------ #

PHASE13_DIR = REPO / "build" / "phase13"
MESH_TUNED_REQUESTS = 64
MESH_SIMILAR_N = 10


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _engine_logits(engine, req: list, resp: dict) -> list:
    """A single-device engine's logits of the hotels ranked in ``resp``
    (the tie rule's inputs)."""
    import torch

    uni, d = engine.gen.universe, engine._dev
    rows = torch.as_tensor([uni.item_index[h["hotel_id"]] for h in resp.get("ranked_hotels", [])],
                           dtype=torch.int64, device=engine.device)
    users = torch.full_like(rows, engine._user_map.get(req[0], engine._unknown_user))
    with torch.no_grad():
        return engine._logits(users, d["item_internal"][rows], d["x_cat"][rows], d["x_num"][rows]).tolist()


def _held(got: list, want: list, logits: list, what: str) -> tuple:
    """(equal JSON count, tie swaps) of mesh responses against the
    single-device engine's under the serve-correct rule; fails otherwise."""
    equal = swaps = 0
    for i, (g, w, lg) in enumerate(zip(got, want, logits)):
        g = json.loads(json.dumps(g))
        s = compare_response(g, w, lg)
        if s is None:
            raise SmokeFailure(f"{what}: response {i} breaks the serve-correct rule against the single-device engine")
        equal += g == w
        swaps += s
    if len(got) != len(want):
        raise SmokeFailure(f"{what}: {len(got)} responses for {len(want)} requests")
    return equal, swaps


def mesh_rank_main(spec: dict) -> dict | None:
    """One rank of a phase-13 gloo world (13b, 13c): the mesh engine over
    ``spec``'s artifact and data. Every rank holds its tower logits to
    ``tower_eval_ref`` on the same rows; rank 0 serves ``spec``'s requests
    (and 13b's ``similar_items`` and bf16 batch) while the others follow;
    every rank's launches and checks come back to rank 0 → its answers."""
    import torch
    import torch.distributed as dist

    from hhrs_tpu_torch.ops import cross, tower
    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(spec["device"]) if spec["device"] == "cpu" else torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    mesh = make_mesh(-1, 1, dev)
    t0 = time.perf_counter()
    eng = RecommendationEngine.from_dirs(spec["artifacts"], spec["data"], device=dev, mesh=mesh)
    mine = {"rank": rank, "device": str(dev), "cuda_device": torch.cuda.current_device() if dev.type == "cuda" else None,
            "backend": dist.get_backend(), "graphs": eng.graphs, "rows": (eng.gen.items.start, eng.gen.items.stop),
            "build_s": time.perf_counter() - t0}

    # each rank's tower on its own rows, against the plain version on the same x0
    d, m = eng._dev, eng.gen.items.rows
    local_logits = {}
    err = bad = 0.0
    with torch.no_grad():
        for u in spec["logit_users"]:
            users = torch.full((m,), u, dtype=torch.int64, device=dev)
            x0 = tower.build_x0(eng.model, users, d["item_internal"], d["x_cat"], d["x_num"]).contiguous()
            out = tower.tower_eval(eng._folded, x0, eng.model.cfg.cross_variant)
            ref = tower.tower_eval_ref(eng._folded, x0, eng.model.cfg.cross_variant)
            e = (out - ref).abs()
            err = max(err, float(e.max()))
            bad += int((e > TOL + TOL * ref.abs()).sum())
            local_logits[u] = out.cpu().numpy()
    mine.update(tower_max_abs_err=err, tower_outside_tol=bad, logits=local_logits)

    _sync(dev)
    tower.tower_eval.launches = 0
    reset_cross_counts(cross)
    answers = None
    if rank == 0:
        try:
            times = []
            sweep = []
            for req in spec["requests"]:
                t = time.perf_counter()
                sweep.append(eng.recommend(*req))
                times.append(time.perf_counter() - t)
            batches = [eng.recommend_many(b, pad_to=8) for b in spec["batches"]]
            similar = [eng.similar_items(i, MESH_SIMILAR_N) for i in spec["similar"]]
            answers = {"sweep": sweep, "batches": batches, "similar": similar, "batch_s": times}
        finally:
            eng.shutdown()
    else:
        eng.follow()
    _sync(dev)
    mine["tower_launches"] = tower.tower_eval.launches
    mine["cross_launches"] = cross_counts(cross)
    mine["tower_route"] = eng._folded is not None  # f32 dcnr: the tower scores, no cross forward runs

    if spec["bf16_batch"]:  # one bf16 batch: cross-forward launches only, no tower launch
        e16 = RecommendationEngine.from_dirs(spec["artifacts"], spec["data"], device=dev, mesh=mesh, bf16=True)
        _sync(dev)
        tower.tower_eval.launches = 0
        reset_cross_counts(cross)
        if rank == 0:
            try:
                answers["bf16"] = e16.recommend_many(spec["bf16_batch"], pad_to=8)
            finally:
                e16.shutdown()
        else:
            e16.follow()
        _sync(dev)
        mine["bf16_launches"] = {"tower": tower.tower_eval.launches, **cross_counts(cross)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        answers["ranks"] = every
        return answers
    return None


def _mesh_report(label: str, out: dict, single, reqs: list, card: str) -> dict:
    """Hold a gloo world's answers (13b, 13c) to the single-device engine
    and print its ranks: backend, rows, tower parity and launches."""
    import numpy as np

    want = [single.recommend(*r) for r in reqs]
    want = [json.loads(json.dumps(w)) for w in want]
    logits = [_engine_logits(single, r, w) for r, w in zip(reqs, want)]
    equal, swaps = _held(out["sweep"], want, logits, f"{label} sweep")
    n_batch = 0
    for batch, got in zip(out["batches_req"], out["batches"]):
        w = [json.loads(json.dumps(x)) for x in single.recommend_many(batch, pad_to=8)]
        e, s = _held(got, w, [_engine_logits(single, r, x) for r, x in zip(batch, w)], f"{label} batch")
        equal, swaps, n_batch = equal + e, swaps + s, n_batch + len(batch)
    # the largest |Δlogit| of a rank's rows (B = its rows) against the same rows in one single-device launch
    import torch

    delta = 0.0
    M = single.gen.M
    with torch.no_grad():
        for u in out["logit_users"]:
            users = torch.full((M,), u, dtype=torch.int64, device=single.device)
            d = single._dev
            full = single._logits(users, d["item_internal"], d["x_cat"], d["x_num"]).cpu().numpy()
            for r in out["ranks"]:
                a, b = r["rows"]
                n = max(0, min(b, M) - a)
                delta = max(delta, float(np.abs(r["logits"][u][:n] - full[a:a + n]).max()) if n else 0.0)
    for r in out["ranks"]:
        print(f"[mesh] {label} rank {r['rank']}: {r['device']} (current cuda:{r['cuda_device']}), backend "
              f"{r['backend']}, {'graphed' if r['graphs'] else 'eager (no graphs)'}, item rows {r['rows']}, engine "
              f"built in {r['build_s']:.2f} s; tower_eval on its rows vs tower_eval_ref: max abs err "
              f"{r['tower_max_abs_err']:.3e}, outside rtol=atol={TOL}: {r['tower_outside_tol']}; launches over the "
              f"sweep: tower {r['tower_launches']}, cross {r['cross_launches']}")
        if r["tower_outside_tol"] or r["tower_launches"] <= 0:
            raise SmokeFailure(f"{label} rank {r['rank']}: tower parity or launches failed")
        if r["tower_route"] and (r["cross_launches"]["fwd"] or r["cross_launches"]["fwd_bf16"]):
            raise SmokeFailure(f"{label} rank {r['rank']}: the f32 dcnr sweep launched the cross forward "
                               f"{r['cross_launches']} beside the tower")
    print(f"[mesh] {label}: {len(reqs)} requests and {n_batch} batched held to the single-device engine: "
          f"{equal} equal JSON, {swaps} tie swaps (logits within {SWAP_TOL}); largest |Δlogit| of a rank's "
          f"rows against one single-device launch {delta:.3e} on {card}")
    return {"equal": equal, "swaps": swaps, "max_dlogit": delta,
            "launches": [r["tower_launches"] for r in out["ranks"]]}


def mesh_nccl_phase(golden: dict, single, dev, card: str) -> dict:
    """Phase 13a: a world of one rank on NCCL (the card's own; gloo on the
    CPU, to rehearse) in this process: the golden sweep at buckets 1 and 8
    through the mesh engine, graphed and eager, equal to the single-device
    engine's JSON; one tower launch per eager batch; the collectives made
    inside each bucket's capture counted; ``recommend`` p50 over the sweep
    beside the single-device engine's, in turns."""
    import torch
    import torch.distributed as dist

    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.parallel.distributed import init_world
    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    t0 = time.perf_counter()
    store = PHASE13_DIR / "nccl_store"
    store.unlink(missing_ok=True)
    init_world(0, 1, f"file://{store}", dev)
    captured = {"in_capture": 0, "outside": 0}
    originals = {n: getattr(dist, n) for n in ("all_gather_into_tensor", "all_reduce", "broadcast")}

    def counting(fn):
        def wrapped(*a, **k):
            capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
            captured["in_capture" if capturing else "outside"] += 1
            return fn(*a, **k)
        return wrapped

    try:
        for n, fn in originals.items():
            setattr(dist, n, counting(fn))
        backend = dist.get_backend()
        mesh = make_mesh(1, 1, dev)
        eng = RecommendationEngine.from_dirs(str(REPO / ARTIFACT), str(REPO / "data"), device=dev, mesh=mesh)
        reqs = golden["requests"]
        many = [reqs[i] for i in golden["many"]]
        want = [single.recommend(*r) for r in reqs]
        want_many = single.recommend_many(many, pad_to=8)
        tower.tower_eval.launches = 0
        got = [eng.recommend(*r) for r in reqs]
        got_many = eng.recommend_many(many, pad_to=8)
        _sync(dev)
        graphed_launches = tower.tower_eval.launches
        if got != want or got_many != want_many:
            raise SmokeFailure(f"13a: the NCCL mesh engine's graphed JSON differs from the single-device engine's "
                               f"({sum(a != b for a, b in zip(got, want))} of {len(reqs)} requests)")
        tower.tower_eval.launches = 0
        eager = [eng._recommend_eager([r])[0] for r in reqs]
        eager_many = eng._recommend_eager(many, pad_to=8)
        _sync(dev)
        eager_launches = tower.tower_eval.launches
        if eager != want or eager_many != want_many:
            raise SmokeFailure("13a: the NCCL mesh engine's eager JSON differs from the single-device engine's")
        p50 = {"single": [], "mesh": []}
        for label in ("single", "mesh", "mesh", "single"):  # in turns: graphed recommend over the sweep
            e = single if label == "single" else eng
            lat = []
            for r in reqs:
                t = time.perf_counter()
                e.recommend(*r)
                lat.append(time.perf_counter() - t)
            p50[label].append(statistics.median(lat) * 1e3)
        if eager_launches != len(reqs) + 1:
            raise SmokeFailure(f"13a: {eager_launches} tower launches for {len(reqs) + 1} eager batches, not one each")
        buckets = sorted(eng._buckets)
        if dev.type == "cuda" and (not eng.graphs or buckets != [(1, False), (8, False)]
                                   or captured["in_capture"] == 0):
            raise SmokeFailure(f"13a: the NCCL mesh engine did not run graphs with collectives inside "
                               f"(graphs {eng.graphs}, buckets {buckets}, {captured})")
        eng.close()
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[mesh] 13a: a world of 1 rank on {backend}, {'graphed' if eng.graphs else 'eager (no graphs)'}: "
          f"{len(reqs)} requests (bucket 1) and recommend_many(K={len(many)}, pad_to=8) equal the single-device "
          f"JSON {'graphed and eager' if eng.graphs else 'eagerly'}; tower launches: {graphed_launches} graphed (an eager run and a capture of "
          f"buckets {buckets}), {eager_launches} over {len(reqs) + 1} eager batches; collectives made inside "
          f"the captures {captured['in_capture']}, outside {captured['outside']}; recommend p50 over the sweep, in "
          f"turns: single-device {', '.join(f'{x:.3f}' for x in p50['single'])} ms, the 1-rank mesh "
          f"{', '.join(f'{x:.3f}' for x in p50['mesh'])} ms; {time.perf_counter() - t0:.1f} s on {card}")
    return {"backend": backend, "graphed": eng.graphs, "eager_launches": eager_launches,
            "graphed_launches": graphed_launches, "collectives_in_capture": captured["in_capture"],
            "recommend_p50_ms": p50}


def mesh_gloo_phase(golden: dict, single, dev, card: str) -> dict:
    """Phase 13b: a gloo world of 2 ranks sharing the card (hpo_r5, 600
    items, 300 a rank): the golden sweep at buckets 1 and 8 under the
    serve-correct rule, ``similar_items`` of every item equal, each rank's
    tower held to its plain version, its launches, and one bf16 batch with
    cross-forward launches only, held to the bf16 golden file at phase 5b's
    bar."""
    from hhrs_tpu_torch.parallel.distributed import launch

    t0 = time.perf_counter()
    reqs = golden["requests"]
    many = [reqs[i] for i in golden["many"]]
    items = [int(i) for i in single.bundle.preproc.item_id_mapping]
    golden_bf16 = json.loads((REPO / GOLDEN_BF16).read_text())
    bf16_tol = BF16_BAR * max(abs(a - b) for xs, ys in zip(golden_bf16["logits"], golden_bf16["logits_f32"])
                              for a, b in zip(xs, ys))
    spec = {"artifacts": str(REPO / ARTIFACT), "data": str(REPO / "data"), "device": dev.type,
            "requests": reqs, "batches": [many, many[:5]], "similar": items,
            "bf16_batch": [golden_bf16["requests"][i] for i in golden_bf16["many"]], "logit_users": [0, 7, 1234]}
    out = launch(mesh_rank_main, 2, (spec,), device=dev, timeout_s=600, store_dir=str(PHASE13_DIR))
    out.update(batches_req=spec["batches"], logit_users=spec["logit_users"])
    report = _mesh_report("13b", out, single, reqs, card)
    want_similar = [single.similar_items(i, MESH_SIMILAR_N) for i in items]
    if out["similar"] != want_similar:
        raise SmokeFailure(f"13b: similar_items differs for "
                           f"{sum(a != b for a, b in zip(out['similar'], want_similar))} of {len(items)} items")
    bf16 = [r["bf16_launches"] for r in out["ranks"]]
    if any(b["tower"] or b["fwd_bf16"] <= 0 or b["fwd"] for b in bf16):
        raise SmokeFailure(f"13b: the bf16 batch did not run on the bf16 cross forward alone: {bf16}")
    bf16_swaps = 0
    for i, got in zip(golden_bf16["many"], out["bf16"]):
        n = compare_response(json.loads(json.dumps(got)), golden_bf16["responses"][i], golden_bf16["logits"][i],
                             bf16_tol)
        if n is None:
            raise SmokeFailure(f"13b: the bf16 mesh batch differs from the bf16 golden response {i}")
        bf16_swaps += n
    print(f"[mesh] 13b: similar_items of all {len(items)} items equal the single-device engine's; one bf16 batch "
          f"(K={len(spec['bf16_batch'])}, pad_to=8) meets the bf16 golden file at tol {bf16_tol:.3e} (phase 5b's bar; "
          f"tie swaps {bf16_swaps}) and launched per rank: {bf16}; phase 13b took {time.perf_counter() - t0:.1f} s")
    report.update(similar_items=len(items), bf16_launches=bf16)
    return report


def _tuned_artifact(dev) -> tuple:
    """13c's artifact: phase 10a's tuned data with a seeded random model at
    hpo_r5's widths → (artifact dir, data dir)."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.config import Config
    from hhrs_tpu_torch.models.convert import jax_from_dcnr
    from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
    from hhrs_tpu_torch.train.artifacts import export_artifacts, load_artifact_bundle
    from hhrs_tpu_torch.train.cli import build_dataset

    data = REPO / "build" / "tuned" / "data"
    if not (data / "hackathon_augmented_data.csv").exists():  # phase 10a writes it; a rehearsal may not have run it
        from hhrs_tpu_torch.data.synthetic import write_synthetic_dataset

        write_synthetic_dataset(str(data), **TUNED_DATA)
    _, preproc = build_dataset(str(data), Config())
    cfg = load_artifact_bundle(str(REPO / ARTIFACT)).model_cfg
    dims = ModelDims.from_artifacts(preproc)
    params, bn_state = jax_from_dcnr(DCNR(dims, cfg, torch.Generator().manual_seed(SEED + 13)))
    rng = np.random.default_rng(SEED + 13)
    for block in bn_state["res_blocks"]:
        for bn in block.values():
            bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    out = PHASE13_DIR / "tuned_artifact"
    export_artifacts(str(out), params, bn_state, cfg, dims, preproc, {})
    return str(out), str(data)


def mesh_padded_phase(dev, card: str) -> dict:
    """Phase 13c: the tuned preset's data (4,000 items, 500,000 reviews)
    with a seeded random model at hpo_r5's widths, on a gloo world of 3
    ranks (4,000 → 4,002 rows): 64 requests and a batch under the
    serve-correct rule, tower parity and launches per rank, the batch p50."""
    import statistics as st

    import numpy as np

    from hhrs_tpu_torch.parallel.distributed import launch
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    t0 = time.perf_counter()
    artifacts, data = _tuned_artifact(dev)
    single = RecommendationEngine.from_dirs(artifacts, data, device=dev, city_bounded=False)
    uni = single.gen.universe
    rng = np.random.default_rng(SEED + 13)
    reqs = [[int(rng.choice(uni.user_ids)), uni.cities[int(rng.integers(len(uni.cities)))],
             ("friends", "personal")[i % 2], (0.7, 1.0)[(i // 2) % 2]] for i in range(MESH_TUNED_REQUESTS)]
    spec = {"artifacts": artifacts, "data": data, "device": dev.type, "requests": reqs, "batches": [reqs[:8]],
            "similar": [], "bf16_batch": None, "logit_users": [0, single.bundle.dims.n_users - 1]}
    out = launch(mesh_rank_main, 3, (spec,), device=dev, timeout_s=600, store_dir=str(PHASE13_DIR))
    out.update(batches_req=spec["batches"], logit_users=spec["logit_users"])
    report = _mesh_report("13c", out, single, reqs, card)
    p50 = st.median(out["batch_s"]) * 1e3
    rows = [r["rows"] for r in out["ranks"]]
    print(f"[mesh] 13c: {uni.n_items} items over 3 ranks as rows {rows}; one-request batch p50 {p50:.2f} ms "
          f"(host clock; three ranks share one card over gloo: a correctness and launch check, not a multi-GPU "
          f"speed); phase 13c took {time.perf_counter() - t0:.1f} s on {card}")
    report.update(batch_p50_ms=p50, rows=rows)
    return report


def _ranks_of(pid: int) -> list:
    """The spawned ranks of process ``pid``: its children whose command
    line is multiprocessing's spawn entry."""
    import os

    out = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline") as f:
                cmdline = f.read()
        except (OSError, ValueError):
            continue
        if ppid == pid and "spawn_main" in cmdline:
            out.append(int(entry))
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def mesh_cli_phase(golden: dict, single, dev, card: str) -> dict:
    """Phase 13d: ``python -m hhrs_tpu_torch.serve.cli --mesh 2`` boots,
    ``/healthz`` answers, one ``POST /recommendations`` equals the
    single-device answer, and no rank is left after SIGTERM."""
    import os
    import signal
    import socket
    import urllib.request

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_path = OUT_DIR / "phase13d_cli.log"
    cmd = [sys.executable, "-m", "hhrs_tpu_torch.serve.cli", "--artifacts", str(REPO / ARTIFACT), "--data",
           str(REPO / "data"), "--mesh", "2", "--host", "127.0.0.1", "--port", str(port), "--batch-window-ms", "2"]
    if dev.type == "cpu":
        cmd += ["--device", "cpu"]
    req = golden["requests"][1]
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT)
        ranks = []
        try:
            deadline, health = time.monotonic() + 180, None
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                        health = json.loads(r.read())
                    break
                except OSError:
                    time.sleep(0.3)
            if not health or health.get("status") != "ok":
                raise SmokeFailure(f"13d: the --mesh 2 CLI did not answer /healthz (see {log_path})")
            boot_s = time.perf_counter() - t0
            ranks = _ranks_of(proc.pid)
            body = json.dumps({"user_id": req[0], "city": req[1], "type": req[2], "lambda_param": req[3]}).encode()
            post = urllib.request.Request(f"http://127.0.0.1:{port}/recommendations", data=body,
                                          headers={"content-type": "application/json"})
            with urllib.request.urlopen(post, timeout=60) as r:
                got = json.loads(r.read())
            want = json.loads(json.dumps(single.recommend(*req)))
            if got != want:
                raise SmokeFailure("13d: the --mesh 2 CLI's answer differs from the single-device engine's")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=20)
    deadline = time.monotonic() + 20
    while any(map(_alive, ranks)) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = [p for p in ranks if _alive(p)]
    if rc != 0 or len(ranks) != 2 or left:
        raise SmokeFailure(f"13d: exit code {rc}, ranks {ranks}, left after SIGTERM {left} (see {log_path})")
    backend = re.findall(r"backend (\w+) \(([^)]*)\)", log_path.read_text())
    print(f"[mesh] 13d: serve.cli --mesh 2 answered /healthz {boot_s:.1f} s after the start (2 ranks {ranks}, "
          f"{sorted(set(backend))}); POST /recommendations equals the single-device answer; SIGTERM: exit {rc}, "
          f"no rank left; {time.perf_counter() - t0:.1f} s on {card}")
    return {"boot_s": boot_s, "ranks": len(ranks), "exit": rc}


def mesh_phase(golden: dict, single, dev, card: str) -> dict:
    """Phase 13: serving over a device mesh (13a–13d). ``single`` is phase
    4's single-device engine; it runs on the CPU too, to rehearse."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(PHASE13_DIR, ignore_errors=True)
    PHASE13_DIR.mkdir(parents=True)
    out = {"nccl": mesh_nccl_phase(golden, single, dev, card),
           "gloo": mesh_gloo_phase(golden, single, dev, card),
           "padded": mesh_padded_phase(dev, card),
           "cli": mesh_cli_phase(golden, single, dev, card)}
    print(f"[mesh] phase 13 took {time.perf_counter() - t0:.1f} s")
    return out


PHASE14_DIR = REPO / "build" / "phase14"
MESH_KERNEL_B = 512  # the hpo_r5 batch: 256 rows a rank on 2 ranks


def _digest(model) -> str:
    """A digest of every tensor a mesh rank holds whole (all but its table shards)."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        if k not in model.layout.sharded:
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_rows_kernel_check(cross, dev, rank: int, ranks: int, group=None) -> dict:
    """The cross kernels on this rank's rows of a training batch (hpo_r5's
    d = 113, L = 3; the same inputs on every rank, from ``SEED``), f32 and
    bf16: y and dx0 must be the whole-batch launch's rows bit for bit (the
    kernels are row-local), and dw, db summed over the ranks (one
    ``all_reduce``; the sum of the halves on one process when ``group`` is
    None and ``ranks`` halves run here) within the term-scale bar of the
    whole-batch backward. Returns the largest |Δ| of the sums. (On the CPU,
    to rehearse, the plain versions stand in for the kernels.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    fwd, bwd = cross.cross_stack_forward, cross.cross_stack_backward
    if dev.type == "cpu":
        fwd, bwd = cross.cross_stack_apply, cross.cross_stack_backward_ref
    gen = np.random.default_rng(SEED + 14)
    B, d, L = MESH_KERNEL_B, 113, 3
    out = {}
    for dtype, tol in ((torch.float32, CROSS_TOL), (torch.bfloat16, CROSS_BF16_TOL)):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).to(dtype).contiguous()  # noqa: E731
        x0, dy = t(gen.standard_normal((B, d))), t(gen.standard_normal((B, d)))
        w, b = t(gen.uniform(-1, 1, (L, d)) / np.sqrt(d)), t(0.1 * gen.standard_normal((L, d)))
        n = B // ranks
        with torch.no_grad():
            y_all = fwd(w, b, x0, "code")
            dx0_all, dw_all, db_all = bwd(w, b, x0, dy, "code")
            mine = range(ranks) if group is None else [rank]
            dw = torch.zeros(L, d, dtype=torch.float32, device=dev)
            db = torch.zeros(L, d, dtype=torch.float32, device=dev)
            for r in mine:
                rows = slice(r * n, (r + 1) * n)
                y = fwd(w, b, x0[rows].contiguous(), "code")
                dx0, dw_r, db_r = bwd(w, b, x0[rows].contiguous(), dy[rows].contiguous(), "code")
                if not (torch.equal(y, y_all[rows]) and torch.equal(dx0, dx0_all[rows])):
                    raise SmokeFailure(f"{dtype}: rank {r}'s cross y / dx0 on its rows differ from the whole-batch "
                                       "launch's rows")
                dw += dw_r.float()
                db += db_r.float()
            if group is not None:
                dist.all_reduce(dw, group=group)
                dist.all_reduce(db, group=group)
            scale = cross.cross_stack_term_scale(w, b, x0, dy, "code")
        errs = []
        for name, got, want, sc in (("dw", dw, dw_all, scale[2]), ("db", db, db_all, scale[3])):
            try:
                errs.append(cross.assert_close_to_scale(got, want.float(), sc, **tol, what=name)[0])
            except AssertionError as e:
                raise SmokeFailure(f"{dtype}: dw / db summed over {ranks} ranks' rows against the whole batch: {e}")
        out[str(dtype).split(".")[-1]] = max(errs)
    return out


# Phase 14b's runs in the world of 2 ranks: (label, mesh shape, exchange,
# capacity factor, model-config changes, epochs, device: None = the card,
# train rows: None = all of them). The one-step run trains on the first
# batch of rows alone, where rounding has had no steps to grow.
MESH_TRAIN_RUNS = (
    ("2x1 one step", (2, 1), None, 1.25, {}, 1, None, MESH_KERNEL_B),
    ("2x1", (2, 1), None, 1.25, {}, 3, None, None),
    ("1x2 all_to_all", (1, 2), "all_to_all", 1.25, {}, 3, None, None),
    ("2x1 bf16", (2, 1), None, 1.25, {"compute_dtype": "bfloat16"}, 1, None, None),
    ("1x2 capped", (1, 2), "capped", 1.0, {}, 1, None, None),
    ("1x2 capped cpu", (1, 2), "capped", 1.0, {}, 1, "cpu", None),
)
TIMED_MESH_RUN = "2x1"  # its step p50 and rank 0's time inside collectives are reported


def _first_rows(splits, n: int | None):
    """``splits`` with its first ``n`` train rows alone (all of them for None)."""
    if n is None:
        return splits
    return dataclasses.replace(splits, **{f"train_{k}": getattr(splits, f"train_{k}")[:n]
                                          for k in ("user", "item", "cat", "num", "y")})


def mesh_train_rank_main(spec: dict) -> list | None:
    """One rank of phase 14b's gloo world (2 ranks sharing the card): the
    cross kernels on its rows, then each run of ``MESH_TRAIN_RUNS``, its
    cross launches counted from 0 just before and read just after; on the
    first run rank 0's host time inside collectives. → every rank's
    reports on rank 0."""
    import torch
    import torch.distributed as dist

    from hhrs_tpu_torch.config import ModelConfig, TrainConfig
    from hhrs_tpu_torch.ops import cross
    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.train.trainer import train_dcn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(spec["device"]) if spec["device"] == "cpu" else torch.device("cuda", torch.cuda.current_device())
    rank, W = dist.get_rank(), dist.get_world_size()
    mine = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
            "kernel": rank_rows_kernel_check(cross, dev, rank, W, dist.group.WORLD)}
    in_collectives = {"s": 0.0, "calls": 0}
    names = ("all_reduce", "all_gather_into_tensor", "all_to_all_single", "broadcast", "barrier")
    originals = {n: getattr(dist, n) for n in names}

    def timed(fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                in_collectives["s"] += time.perf_counter() - t
                in_collectives["calls"] += 1
        return wrapped

    for label, shape, exchange, factor, changes, epochs, where, rows in MESH_TRAIN_RUNS:
        run_dev = torch.device(where) if where else dev
        mcfg = dataclasses.replace(ModelConfig(**spec["model"]), **changes)
        tcfg = dataclasses.replace(TrainConfig(**spec["train"]), n_epochs=epochs)
        mesh = make_mesh(*shape, run_dev)
        first = label == TIMED_MESH_RUN
        if first and rank == 0:
            for n, fn in originals.items():
                setattr(dist, n, timed(fn))
        _sync(dev)
        reset_cross_counts(cross)
        t0 = time.perf_counter()
        try:
            r = train_dcn(_first_rows(spec["splits"], rows), spec["dims"], mcfg, tcfg, mesh=mesh,
                          explicit_exchange=exchange, exchange_capacity_factor=factor, device=run_dev)
            _sync(dev)
        finally:
            for n, fn in originals.items():
                setattr(dist, n, fn)
        mine[label] = {"history": r.history, "final": r.final_metrics, "launches": cross_counts(cross),
                       "wall_s": time.perf_counter() - t0, "step_ms": r.step_ms, "digest": _digest(r.model),
                       "shards": {k: tuple(v.shape) for k, v in r.model.state_dict().items()
                                  if k in r.model.layout.sharded}}
        if first and rank == 0:
            mine[label]["collectives"] = dict(in_collectives)
    every = [None] * W
    dist.all_gather_object(every, mine)
    return every if rank == 0 else None


def _held_history(label: str, got: list, want: list, bar: dict, noise: float = 0.0) -> float:
    """Fail unless every val loss is within ``bar`` of ``want``'s, or within
    ``noise`` (twice the trajectory's own rounding noise: see
    ``_trajectory_noise``) where that is larger, and the LR traces are
    equal → the largest val-loss |Δ|."""
    import numpy as np

    g, w = np.array([h["val_loss"] for h in got]), np.array([h["val_loss"] for h in want])
    allowed = np.maximum(bar["atol"] + bar["rtol"] * np.abs(w), noise)
    if len(g) != len(w) or not (np.abs(g - w) <= allowed).all():
        raise SmokeFailure(f"14 {label}: val losses {g.tolist()} against {w.tolist()} outside {bar} "
                           f"and the trajectory's rounding noise {noise:.3e}")
    if [h["lr"] for h in got] != [h["lr"] for h in want]:
        raise SmokeFailure(f"14 {label}: the LR trace differs")
    return float(np.abs(g - w).max())


ORDER_TWIN_BLOCKS = 32  # the order twin's backward plan: B = 512 rows in tiles of 16, not 8
SCALE_TWIN = 1.0 + 2.0 ** -23  # the scale twin's train loss factor: one ulp above 1


def _trajectory_noise(splits, dims, mcfg, tcfg, single: list, dev, bf16: bool = False) -> dict:
    """How far rounding alone moves this trajectory: four single-device
    runs that differ by rounding only, ``single`` and three twins of it:
    the one-ulp twin (``_one_ulp_init``: one weight one ulp up at the
    start), the order twin (every cross backward under a plan of
    ``ORDER_TWIN_BLOCKS`` blocks, so dw and db are summed in another
    order, as ``_sequential_runs`` does in phase 11b; on the CPU the plain
    version has one order, and the order twin is ``single`` again) and the
    scale twin (every train loss times ``SCALE_TWIN``, so every gradient of
    every step is rounded anew, as a mesh's sums in another order round
    them; Adam's update does not see the scale) → each twin's largest
    val-loss gap to ``single`` and ``noise``, twice the largest gap between
    any two of the four (``_default_run_bar``'s rule). At hpo_r5's LR
    (6.4e-3, Adam) and dropout 0.6 the trajectory amplifies such rounding
    far past rtol 1e-4 within the first epoch (phase 11b's lane 7: 4.39e-3 at
    epoch 0 from the backward's sum order alone)."""
    from hhrs_tpu_torch.ops import cross
    from hhrs_tpu_torch.train import trainer
    from hhrs_tpu_torch.train.trainer import train_dcn

    twin = train_dcn(splits, dims, mcfg, tcfg, init_state=_one_ulp_init(dims, mcfg, tcfg.seed, bf16=bf16), device=dev)
    real_plan, real_loss = cross._plan, trainer.bce_with_logits

    def other_order(B, device_index, d, backward, dtype):
        if backward:
            return cross.cross_plan(B, ORDER_TWIN_BLOCKS, cross.CLUSTER, cross.ROW_ALIGN[dtype])
        return real_plan(B, device_index, d, backward, dtype)

    def scaled_train_loss(logits, y):
        loss = real_loss(logits, y)
        return loss * SCALE_TWIN if logits.requires_grad else loss

    cross._plan = other_order
    try:
        order = train_dcn(splits, dims, mcfg, tcfg, device=dev)
    finally:
        cross._plan = real_plan
    trainer.bce_with_logits = scaled_train_loss
    try:
        scale = train_dcn(splits, dims, mcfg, tcfg, device=dev)
    finally:
        trainer.bce_with_logits = real_loss
    runs = [[h["val_loss"] for h in r] for r in (single, twin.history, order.history, scale.history)]
    gap = lambda a, b: max(abs(x - y) for x, y in zip(a, b))  # noqa: E731
    return {"twin": gap(runs[1], runs[0]), "order": gap(runs[2], runs[0]), "scale": gap(runs[3], runs[0]),
            "noise": 2 * max(gap(a, b) for a in runs for b in runs)}


def mesh_train_nccl(splits, bundle, preproc, model_cfg, train_cfg, parity: list, dev, card: str) -> dict:
    """Phase 14a: a world of one rank on NCCL (gloo on the CPU, to
    rehearse) in this process: the golden parity run through
    ``train_dcn(mesh=1x1)`` against phase 6's single-device run and the
    golden trajectory, its cross launches counted from 0; then the hpo_r5
    run's step p50 and ``examples_per_s`` beside the single-device
    trainer's, in turns."""
    import torch
    import torch.distributed as dist

    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.ops import cross
    from hhrs_tpu_torch.parallel.distributed import init_world
    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.train.trainer import train_dcn

    golden = json.loads((REPO / TRAIN_GOLDEN).read_text())
    gcfg = {k: golden[k] for k in ("model_config", "train_config")}
    from hhrs_tpu_torch.config import ModelConfig, TrainConfig

    store = PHASE14_DIR / "nccl_store"
    store.unlink(missing_ok=True)
    init_world(0, 1, f"file://{store}", dev)
    try:
        backend = dist.get_backend()
        mesh = make_mesh(1, 1, dev)
        mcfg, tcfg = ModelConfig(**gcfg["model_config"]), TrainConfig(**gcfg["train_config"])
        _sync(dev)
        reset_cross_counts(cross)
        r = train_dcn(splits, bundle.dims, mcfg, tcfg, mesh=mesh, init_state=(bundle.params, bundle.bn_state),
                      device=dev)
        _sync(dev)
        launches = cross_counts(cross)
        steps = splits.n_train // tcfg.batch_size
        chunks = -(-splits.n_val // tcfg.eval_batch_size)
        want = {"fwd": tcfg.n_epochs * steps + (tcfg.n_epochs + 1) * chunks, "bwd": tcfg.n_epochs * steps,
                "fwd_bf16": 0, "bwd_bf16": 0}
        if dev.type == "cpu":  # a rehearsal: the plain versions, no launch
            want = dict.fromkeys(want, 0)
        if launches != want:
            raise SmokeFailure(f"14a: cross launches {launches}, expected {want}")
        gap = _held_history("a (against phase 6)", r.history, parity, dict(rtol=1e-4, atol=1e-6))
        bars = [VAL_TOL] + [LATER_EPOCH_TOL] * (len(golden["history"]) - 1)
        for h, w, bar in zip(r.history, golden["history"], bars):
            _held_history("a (against the golden trajectory)", [h], [w], bar)
        fm, gm = r.final_metrics, golden["final_metrics"]
        if abs(fm["val_logloss"] - gm["val_logloss"]) > 2e-3 or abs(fm["val_auc"] - gm["val_auc"]) > 2e-3:
            raise SmokeFailure("14a: the final val logloss / AUC differ from the JAX trainer's")
        print(f"[mesh-train] 14a: a world of 1 rank on {backend}: the golden parity run through train_dcn(mesh=1x1) "
              f"gives val losses {[round(h['val_loss'], 7) for h in r.history]} (largest |Δ| against phase 6's "
              f"single-device run {gap:.3e}, within rtol 1e-4 / atol 1e-6; C1 against the golden file), LR trace "
              f"equal; cross launches {launches} (one forward and one backward a step, one forward an eval chunk)")
        dims = ModelDims.from_artifacts(preproc)
        timing = {"single": [], "mesh": []}
        for label in ("single", "mesh", "mesh", "single"):  # in turns, on one host
            _sync(dev)
            t = train_dcn(splits, dims, model_cfg, train_cfg, mesh=mesh if label == "mesh" else None, device=dev)
            timing[label].append((statistics.median(t.step_ms), t.examples_per_s))
        print("[time] 14a: the hpo_r5 run (dropout 0.6, seeded weights, 3 epochs), in turns: step p50 single-device "
              + ", ".join(f"{p:.4f}" for p, _ in timing["single"]) + " ms, 1-rank mesh "
              + ", ".join(f"{p:.4f}" for p, _ in timing["mesh"]) + " ms; examples_per_s single-device "
              + ", ".join(f"{e:.1f}" for _, e in timing["single"]) + ", 1-rank mesh "
              + ", ".join(f"{e:.1f}" for _, e in timing["mesh"]) + f" on {card}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"backend": backend, "launches": launches, "max_dval_vs_single": gap, "timing": timing}


def mesh_train_gloo(splits, preproc, model_cfg, train_cfg, single: list, dev, card: str) -> dict:
    """Phase 14b: a gloo world of 2 ranks sharing the card. Each rank holds
    the cross kernels on its rows to the whole-batch launch, then trains
    ``MESH_TRAIN_RUNS``: one step of the hpo_r5 configuration (dropout 0.6,
    seeded weights) at 2x1, held to one single-device step at rtol 1e-4 /
    atol 1e-6; 2x1 (the default exchange) and 1x2 all_to_all, 3 epochs,
    each held to phase 7's single-device run (``single``) at rtol 1e-4 /
    atol 1e-6, or at the trajectory's rounding noise where that is larger
    (``_trajectory_noise``); one bf16 epoch held to the single-device bf16
    epoch at ``BF16_VAL_RTOL`` (or its noise); capped at factor 1.0 on the
    card and on the CPU with equal drop rates. Every run: equal LR traces,
    every rank's history equal, the replicated weights bit-identical, each
    rank's cross launches counted."""
    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.parallel.distributed import launch
    from hhrs_tpu_torch.train.trainer import train_dcn

    dims = ModelDims.from_artifacts(preproc)
    B = train_cfg.batch_size
    cfg16, cfg1 = dataclasses.replace(model_cfg, compute_dtype="bfloat16"), dataclasses.replace(train_cfg, n_epochs=1)
    one_step = train_dcn(_first_rows(splits, B), dims, model_cfg, cfg1, device=dev)
    single16 = train_dcn(splits, dims, cfg16, cfg1, device=dev)
    noise = _trajectory_noise(splits, dims, model_cfg, train_cfg, single, dev)
    noise16 = _trajectory_noise(splits, dims, cfg16, cfg1, single16.history, dev, bf16=True)
    print(f"[mesh-train] 14b: the references' rounding noise (largest val-loss gap of the one-ulp, order and "
          f"scale twins; twice the widest gap of the four runs): f32 3 epochs "
          + ", ".join(f"{noise[k]:.3e}" for k in ("twin", "order", "scale")) + f"; {noise['noise']:.3e}; bf16 1 epoch "
          + ", ".join(f"{noise16[k]:.3e}" for k in ("twin", "order", "scale")) + f"; {noise16['noise']:.3e} on {card}")
    spec = {"splits": splits, "dims": dims, "model": dataclasses.asdict(model_cfg),
            "train": dataclasses.asdict(train_cfg), "device": dev.type}
    t0 = time.perf_counter()
    ranks = launch(mesh_train_rank_main, 2, (spec,), device=dev, timeout_s=900, store_dir=str(PHASE14_DIR))
    world_s = time.perf_counter() - t0
    chunks = -(-splits.n_val // train_cfg.eval_batch_size)  # 4487 val rows: odd, replicated on both ranks
    report = {"world_s": world_s, "ranks": {}, "noise": {"f32": noise, "bf16": noise16}}
    for r in ranks:
        print(f"[mesh-train] 14b rank {r['rank']}: {r['device']}, backend {r['backend']}; cross kernels on its "
              f"{MESH_KERNEL_B // 2} rows: y and dx0 the whole-batch launch's rows bit for bit, dw / db summed over "
              f"the 2 ranks within the term-scale bar of the whole batch (largest |Δ| f32 "
              f"{r['kernel']['float32']:.3e}, bf16 {r['kernel']['bfloat16']:.3e})")
    for label, shape, exchange, factor, changes, epochs, where, rows in MESH_TRAIN_RUNS:
        runs = [r[label] for r in ranks]
        if any(x["history"] != runs[0]["history"] for x in runs):
            raise SmokeFailure(f"14b {label}: the ranks' histories differ")
        if any(x["digest"] != runs[0]["digest"] for x in runs):
            raise SmokeFailure(f"14b {label}: the ranks' replicated weights differ")
        bf16 = changes.get("compute_dtype") == "bfloat16"
        want = {"fwd": 0, "bwd": 0, "fwd_bf16": 0, "bwd_bf16": 0}
        if where != "cpu" and dev.type != "cpu":  # the CPU runs the plain versions: no launch
            k, steps = "_bf16" if bf16 else "", (rows or splits.n_train) // B
            want.update({f"fwd{k}": epochs * steps + (epochs + 1) * chunks, f"bwd{k}": epochs * steps})
        got = [x["launches"] for x in runs]
        if any(g != want for g in got):
            raise SmokeFailure(f"14b {label}: cross launches per rank {got}, expected {want} each")
        hist = runs[0]["history"]
        if rows is not None:
            gap = _held_history(f"b {label} (against one single-device step)", hist, one_step.history,
                                dict(rtol=1e-4, atol=1e-6))
        elif epochs == train_cfg.n_epochs:
            gap = _held_history(f"b {label} (against phase 7)", hist, single, dict(rtol=1e-4, atol=1e-6),
                                noise["noise"])
        elif bf16:
            gap = _held_history(f"b {label} (against the single-device bf16 epoch)", hist, single16.history,
                                dict(rtol=BF16_VAL_RTOL, atol=0.0), noise16["noise"])
        else:
            gap = None
        p50 = statistics.median(runs[0]["step_ms"]) if runs[0]["step_ms"] else None
        print(f"[mesh-train] 14b {label}: val losses {[round(h['val_loss'], 7) for h in hist]}"
              + (f" (largest |Δ| against the single-device run {gap:.3e})" if gap is not None else "")
              + (f", exchange_overflow {[h['exchange_overflow'] for h in hist]}" if exchange == "capped" else "")
              + f"; every rank's history equal, replicated weights bit-identical; table shards {runs[0]['shards']}; "
              f"cross launches per rank {got[0]}; step p50 {ms_text(p50)} ms, wall {runs[0]['wall_s']:.2f} s on {card}")
        report["ranks"][label] = {"launches": got, "max_dval": gap, "step_p50_ms": p50,
                                  "overflow": [h.get("exchange_overflow") for h in hist]}
    card_ovf, cpu_ovf = (report["ranks"][k]["overflow"] for k in ("1x2 capped", "1x2 capped cpu"))
    if card_ovf != cpu_ovf or not all(o is not None and o > 0 for o in card_ovf):
        raise SmokeFailure(f"14b: the capped exchange's drop rate on the card {card_ovf} is not the CPU's {cpu_ovf} "
                           "(or nothing was dropped at factor 1.0)")
    coll = ranks[0][TIMED_MESH_RUN]["collectives"]
    steps = splits.n_train // B
    print(f"[time] 14b {TIMED_MESH_RUN}: step p50 {ms_text(report['ranks'][TIMED_MESH_RUN]['step_p50_ms'])} ms "
          f"(CUDA events, rank 0); rank 0's host time inside collectives {coll['s']:.3f} s over {coll['calls']} calls "
          f"in the whole 3-epoch run ({coll['calls'] / (3 * steps):.1f} calls a step, evals and the final gathers "
          f"included); 2 ranks share one card over gloo: a correctness and launch check, not a multi-GPU speed; "
          f"world {world_s:.1f} s on {card}")
    report.update(collectives=coll, kernel=[r["kernel"] for r in ranks])
    return report


def mesh_train_cli(dev, card: str) -> dict:
    """Phase 14c: ``python -m hhrs_tpu_torch.train.cli --mesh 2`` trains one
    epoch on ``data/`` and writes one artifact; the single-device engine
    loads it and answers a request; no rank is left after the CLI exits."""
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    t0 = time.perf_counter()
    out = PHASE14_DIR / "cli_artifact"
    log_path = OUT_DIR / "phase14c_cli.log"
    cmd = [sys.executable, "-m", "hhrs_tpu_torch.train.cli", "--data", str(REPO / "data"), "--out", str(out),
           "--mesh", "2", "--epochs", "1"]
    if dev.type == "cpu":
        cmd += ["--device", "cpu"]
    ranks = set()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None and time.perf_counter() - t0 < 300:
                ranks.update(_ranks_of(proc.pid))
                time.sleep(0.2)
        finally:
            if proc.poll() is None:
                proc.kill()
            rc = proc.wait(timeout=60)
    left = [p for p in ranks if _alive(p)]
    if rc != 0 or len(ranks) != 2 or left:
        raise SmokeFailure(f"14c: train.cli --mesh 2 exit code {rc}, ranks {sorted(ranks)}, left {left} "
                           f"(see {log_path})")
    manifest = json.loads((out / "manifest.json").read_text())
    engine = RecommendationEngine.from_dirs(str(out), str(REPO / "data"), device=dev)
    golden = json.loads((REPO / GOLDEN).read_text())
    resp = engine.recommend(*golden["requests"][0])
    if not resp.get("ranked_hotels"):
        raise SmokeFailure(f"14c: the mesh-trained artifact gave no hotels: {resp}")
    backend = sorted(set(re.findall(r"backend (\w+) \(([^)]*)\)", log_path.read_text())))
    print(f"[mesh-train] 14c: train.cli --mesh 2 trained 1 epoch (2 ranks {sorted(ranks)}, {backend}), exit {rc}, "
          f"no rank left; artifact val_logloss {manifest['metrics']['val_logloss']:.5f}; the single-device engine "
          f"answered {len(resp['ranked_hotels'])} hotels from it; {time.perf_counter() - t0:.1f} s on {card}")
    return {"exit": rc, "ranks": len(ranks), "val_logloss": manifest["metrics"]["val_logloss"]}


def mesh_train_phase(splits, preproc, bundle, model_cfg, train_cfg, parity: list, single: list, dev,
                     card: str) -> dict:
    """Phase 14: training over a device mesh (14a–14c, the times of 14d
    printed with them). ``parity``: phase 6's single-device history,
    ``single``: phase 7's."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    PHASE14_DIR.mkdir(parents=True)
    out = {"nccl": mesh_train_nccl(splits, bundle, preproc, model_cfg, train_cfg, parity, dev, card),
           "gloo": mesh_train_gloo(splits, preproc, model_cfg, train_cfg, single, dev, card),
           "cli": mesh_train_cli(dev, card)}
    print(f"[mesh-train] phase 14 took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(REPO))
    try:
        from hhrs_tpu_torch.models.convert import dcnr_from_jax
        from hhrs_tpu_torch import runtime
        from hhrs_tpu_torch.ops import cross, cuda_build, tower
        from hhrs_tpu_torch.serve.engine import RecommendationEngine
        from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
    except ImportError as e:
        return fail(f"the hhrs_tpu_torch package is not beside this script: {e}")

    import numpy as np

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:  # one nvcc per source and g++ for the reader, together
        reader = pool.submit(runtime.build)
        lib_paths = list(pool.map(lambda a: cuda_build.build(*a),
                                  [("tower_eval", ["tower_eval.cu"]),
                                   ("cross_stack", ["cross_stack.cu"])]))
        reader_path = reader.result()
    print(f"[build] {', '.join(p.name for p in lib_paths)} and the native CSV reader {reader_path.name} in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib_path in lib_paths:
        log_file = lib_path.with_suffix(".log")
        if not log_file.exists():
            print(f"[build] {lib_path.name}: reused an existing library")
            continue
        (OUT_DIR / f"ptxas_{lib_path.stem}.log").write_text(log_file.read_text())
        for kernel, regs, spills in ptxas_summary(log_file.read_text()):
            print(f"[build] {kernel}: {regs} registers, {spills} bytes spilled")
        spilled = [k for k, _, n in ptxas_summary(log_file.read_text()) if n and k.startswith("cross_")]
        if spilled:
            return fail(f"ptxas spilled registers in the cross kernel instances {spilled}")

    # ---- phase 3: kernel against its plain version ----------------------
    limits = tower._device_limits(torch.cuda.current_device())
    print(f"[build] {limits[0]} bytes of shared memory per block; clusters of blocks that each take "
          f"an SM, resident at once, by size: {limits[1]}")
    bundle = load_artifact_bundle(str(REPO / ARTIFACT))
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg, dev)
    folded = tower.fold_eval_params(model)
    no_res = dict(folded, w1=folded["w1"][:0].contiguous(), b1=folded["b1"][:0].contiguous(),
                  w2=folded["w2"][:0].contiguous(), b2=folded["b2"][:0].contiguous())
    gen = np.random.default_rng(SEED)

    def features(B: int):
        cats = [n for _, n in bundle.dims.cat_dims]
        with torch.no_grad():
            return tower.build_x0(
                model,
                torch.as_tensor(gen.integers(0, bundle.dims.n_users, B), device=dev),
                torch.as_tensor(gen.integers(0, bundle.dims.n_items, B), device=dev),
                torch.as_tensor(np.stack([gen.integers(0, n, B) for n in cats], 1), device=dev),
                torch.as_tensor(gen.random((B, bundle.dims.n_num_features), np.float32), device=dev),
            ).contiguous()

    max_err = 0.0
    n_checks = 0
    x0_all = features(max(TOWER_PARITY_B))
    # The first call at given widths times one full wave of every plan;
    # tower_plan picks from these times.
    for label, f in (("dcnr", folded), ("n_res=0", no_res)):
        d_in, H = f["w0"].shape
        waves = tower._wave_ms(torch.cuda.current_device(), d_in, H, f["w1"].shape[0], f["cross_w"].shape[0])
        print(f"[plan] {label}: ms of one full wave, by plan: "
              + ", ".join(f"{p} {ms:.4f}" for p, ms in sorted(waves.items())))
    launches_before = tower.tower_eval.launches
    outs = {}
    for B in TOWER_PARITY_B:  # prefixes of one batch: each B takes its own plan
        x0 = x0_all[:B].contiguous()
        for label, f in (("dcnr", folded), ("n_res=0", no_res)):
            for variant in ("code", "canonical"):
                with torch.no_grad():
                    out = tower.tower_eval(f, x0, variant)
                    again = tower.tower_eval(f, x0, variant)
                    ref = tower.tower_eval_ref(f, x0, variant)
                torch.cuda.synchronize()
                n_checks += 2
                outs[(B, label, variant)] = out
                err = (out - ref).abs()
                bad = int((err > TOL + TOL * ref.abs()).sum())
                max_err = max(max_err, float(err.max()))
                print(f"[parity] B={B} plan {tower.plan_of(f, x0)} "
                      f"{label} {variant}: max|kernel-plain|={float(err.max()):.3e} outside tol={bad}")
                if bad or not torch.isfinite(out).all():
                    return fail(f"kernel disagrees with its plain version at B={B} {label} {variant}")
                if not torch.equal(again, out):
                    return fail(f"a repeated launch is not bit-identical at B={B} {label} {variant}")
        # equal rows give equal logits wherever they sit in the batch
        with torch.no_grad():
            for _ in range(2):
                flipped = tower.tower_eval(folded, x0.flip(0).contiguous(), "code").flip(0)
                n_checks += 1
                if not torch.equal(flipped, outs[(B, "dcnr", "code")]):
                    return fail(f"a row's logit depends on its position (B={B})")
    # Every B scored a prefix of the largest batch with another plan: the
    # logits must be those of the same rows inside it, bit for bit.
    big = max(TOWER_PARITY_B)
    for (B, label, variant), out in outs.items():
        if not torch.equal(out, outs[(big, label, variant)][:B]):
            return fail(f"the logits of B={B} {label} {variant} depend on the plan")
    if tower.tower_eval.launches - launches_before != n_checks:
        return fail("the launch counter did not count every parity launch")
    print(f"[parity] {n_checks} launches held to rtol=atol={TOL}; max abs err {max_err:.3e}; every launch "
          f"repeated bit for bit; flip and plan invariance bit for bit (B in {TOWER_PARITY_B})")
    cross_err = cross_parity(cross, model, features, dev)
    cross_err_bf16 = bf16_cross_parity(cross, model, features, dev)

    # ---- phase 4: the serving path --------------------------------------
    golden = json.loads((REPO / GOLDEN).read_text())
    tower.tower_eval.launches = 0
    t0 = time.perf_counter()
    engine = RecommendationEngine.from_dirs(str(REPO / ARTIFACT), str(REPO / "data"))
    build_s = time.perf_counter() - t0
    if engine.device.type != "cuda" or engine._folded is None:
        return fail("the engine is not serving dcnr through the tower kernel on cuda")
    swaps = 0
    for req, want, logits in zip(golden["requests"], golden["responses"], golden["logits"]):
        got = json.loads(json.dumps(engine.recommend(*req)))
        s = compare_response(got, want, logits)
        if s is None:
            return fail(f"recommend{tuple(req)} differs from the golden response")
        swaps += s
    many = [golden["requests"][i] for i in golden["many"]]
    for batch, pad_to in ((many, None), (many[:5], 8)):
        for i, got in zip(golden["many"], engine.recommend_many(batch, pad_to=pad_to)):
            s = compare_response(json.loads(json.dumps(got)), golden["responses"][i], golden["logits"][i])
            if s is None:
                return fail(f"recommend_many(K={len(batch)}, pad_to={pad_to}) differs from the golden response {i}")
            swaps += s
    for item, n, want in golden["similar"]:
        if engine.similar_items(item, n) != want:
            return fail(f"similar_items({item}, {n}) differs from the golden answer")
    torch.cuda.synchronize()
    path_launches = tower.tower_eval.launches
    n_req = len(golden["requests"])
    buckets = sorted(engine._buckets)
    print(f"[serve] engine built in {build_s:.2f} s; {n_req} recommend + recommend_many(K={len(many)}) + "
          f"recommend_many(K=5, pad_to=8) + {len(golden['similar'])} similar_items match the golden file; "
          f"tie swaps: {swaps}")
    print(f"[serve] tower_eval launches on the serving path: {path_launches} (an eager run and a capture for each "
          f"batch bucket {buckets}; the {n_req + 2} requests and batches ran as graph replays)")
    if path_launches <= 0 or buckets != [(1, False), (8, False)]:
        return fail("the serving path did not run the tower kernel through a graph per bucket")
    # The graphed path against the same launches run eagerly, request by request.
    differ = [req for req in golden["requests"] if engine._recommend_eager([req]) != [engine.recommend(*req)]]
    differ += [b for b in (many, many[:5])
               if engine._recommend_eager(b, pad_to=8) != engine.recommend_many(b, pad_to=8)]
    if differ:
        return fail(f"the graphed serving path differs from the eager one for {differ[:3]}")
    print(f"[serve] graphed JSON equals the eager path's for all {n_req} requests and 2 padded batches")

    # ---- phase 5: timings -------------------------------------------------
    kernels = []
    rows = {}
    for B, iters in TOWER_TIMED_B:
        x0 = features(B)
        with torch.no_grad():
            kernel = lambda: tower.tower_eval(folded, x0)  # noqa: E731
            ms = time_cuda(kernel, iters)
            plain_ms = time_cuda(lambda: tower.tower_eval_ref(folded, x0), iters)

            def products():  # the tower's 1 + 2R matrix products alone, in cuBLAS
                deep = torch.addmm(folded["b0"], x0, folded["w0"])
                for r in range(folded["w1"].shape[0]):
                    h = torch.addmm(folded["b1"][r], deep, folded["w1"][r])
                    deep = torch.addmm(folded["b2"][r], h, folded["w2"][r])
                return deep

            library_ms = time_cuda(products, iters)
            device_ms = device_ms_per_call(kernel, 50, "tower_eval_kernel")
            library_device_ms = device_ms_per_call(products, 50)
        flops, nbytes = tower_work(folded, B)
        bound_ms, bound_by = bound(flops, nbytes)
        plan = tower.plan_of(folded, x0)
        rows[B] = dict(B=B, plan=list(plan), ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                       library_ms=library_ms, library_device_ms=library_device_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        print(f"[time] tower B={B} plan {plan}: kernel {ms:.4f} ms (device {ms_text(device_ms)} ms), plain "
              f"{plain_ms:.4f} ms, cuBLAS products {library_ms:.4f} ms (device {ms_text(library_device_ms)} ms), "
              f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) on {card}")

    serve_timings(engine, golden["requests"], card)

    # ---- phase 5b: the engine's options ----------------------------------
    options = serve_options(engine, golden, dev, card)

    # ---- phase 6: training, parity run against the JAX trainer ----------
    from hhrs_tpu_torch.config import Config, ModelConfig, TrainConfig
    from hhrs_tpu_torch.train.cli import build_dataset

    t0 = time.perf_counter()
    splits, preproc = build_dataset(str(REPO / "data"), Config())
    print(f"[train] data/: {splits.n_train} train / {splits.n_val} val rows in "
          f"{time.perf_counter() - t0:.2f} s")
    parity_history = training_parity(splits, bundle, dev, card)

    # ---- phase 7: training, timing run (the main path of this slice) ------
    golden_t = json.loads((REPO / TRAIN_GOLDEN).read_text())
    model_cfg = ModelConfig(**dict(golden_t["model_config"], dropout=bundle.model_cfg.dropout))
    train_cfg = TrainConfig(**dict(golden_t["train_config"], n_epochs=3))
    cross_launches = train_timing(splits, preproc, model_cfg, train_cfg, golden, dev, card)
    bf16_launches = bf16_training(splits, preproc, model_cfg, train_cfg, dev, card)

    # ---- phase 8: cross kernel timings ------------------------------------
    cross_rows = cross_timings(cross, dev, card)
    cross_rows_bf16 = cross_timings(cross, dev, card, torch.bfloat16)

    # ---- phase 9: the HTTP server and its serving stack ------------------
    http = http_phase(golden, str(OUT_DIR / "train_smoke_artifact"), dev, card)

    # ---- phase 10: the retraining path ------------------------------------
    retrain = retrain_phase(cross, splits, preproc, model_cfg, train_cfg, dev, card)
    retrain_f32 = {**retrain["options"]["launches"],
                   **{f"pipeline cycle {i + 1}": c for i, c in enumerate(retrain["pipeline"]["cycles"])}}
    retrain_bf16 = {f"tuned {label}": {"fwd": r["fwd"], "bwd": r["bwd"]} for label, r in retrain["tuned"].items()}

    # ---- phase 11: the tuning operator's path, the exported ranker, the batch CLI
    tuning = tuning_phase(cross, splits, preproc, bundle, engine, dev, card)

    # ---- phase 12: the two-tower retriever, every exported arch, the native reader
    phase12 = retriever_export_ingest_phase(splits, preproc, bundle, dev, card)

    # ---- phase 13: serving over a device mesh ------------------------------
    mesh = mesh_phase(golden, engine, dev, card)

    # ---- phase 14: training over a device mesh -----------------------------
    mesh_train = mesh_train_phase(splits, preproc, bundle, model_cfg, train_cfg, parity_history,
                                  cross_launches["history"], dev, card)

    r = rows[128]
    kernels.append({
        "name": "tower_eval", "route": "cuda", "source": "hhrs_tpu_torch/csrc/tower_eval.cu",
        "replaces": "hhrs_tpu/ops/pallas/tower_kernel.py:133", "launches": path_launches,
        "max_abs_err": max_err, "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
        "by_batch": [rows[B] for B, _ in TOWER_TIMED_B if B != 128],
        "launches_by_option": {k: options[k]["launches"]["tower"] for k in ("int8", "cap16", "cap16_all_rows")},
        "retrain_launches": retrain["pipeline"]["tower_launches"],
        "http_launches": http["launches"], "http_timings": http["timings"], "http_memory_mib": http["memory_mib"],
        "export_launches": tuning["export"]["launches"], "export_timings": tuning["export"]["timings"],
        "batch_cli_launches": tuning["batch"]["launches"], "batch_cli_replays": tuning["batch"]["replays"],
        "batch_cli_users_per_s": tuning["batch"]["users_per_s"],
        "two_tower_serve_launches": phase12["serve"]["launches"],
        "export_all_launches": phase12["export"]["launches"]["tower"],
        "mesh_launches": {"13a_eager": mesh["nccl"]["eager_launches"], "13a_graphed": mesh["nccl"]["graphed_launches"],
                          "13b_per_rank": mesh["gloo"]["launches"], "13c_per_rank": mesh["padded"]["launches"]},
        "mesh_max_dlogit": {"13b": mesh["gloo"]["max_dlogit"], "13c": mesh["padded"]["max_dlogit"]},
    })
    for kind, replaces in (("fwd", "hhrs_tpu/ops/pallas/cross_kernel.py:56"),
                           ("bwd", "hhrs_tpu/ops/pallas/cross_kernel.py:82")):
        r = cross_rows[(kind, 512)]
        kernels.append({
            "name": f"cross_stack_{kind}", "route": "cuda", "source": "hhrs_tpu_torch/csrc/cross_stack.cu",
            "replaces": replaces, "launches": cross_launches["per_step"][kind],
            "fused_epoch_launches": cross_launches["fused"][kind], "max_abs_err": cross_err[kind],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "device_ms": r["device_ms"],
            "by_batch": [cross_rows[(kind, B)] for B, _ in CROSS_TIMED_B if B != 512],
            "retrain_launches": {k: v[kind] for k, v in retrain_f32.items()},
            "mesh_train_launches": {"14a_1_rank": mesh_train["nccl"]["launches"][kind],
                                    **{f"14b_{k}_per_rank": [x[kind] for x in v["launches"]]
                                       for k, v in mesh_train["gloo"]["ranks"].items() if "bf16" not in k}},
            "mesh_rank_rows_max_abs_err": max(k["float32"] for k in mesh_train["gloo"]["kernel"]),
            **({"export_all_launches": phase12["export"]["launches"]["cross_fwd"]} if kind == "fwd" else {}),
        })
    for kind, replaces in (("fwd", "hhrs_tpu/ops/pallas/cross_kernel.py:56"),
                           ("bwd", "hhrs_tpu/ops/pallas/cross_kernel.py:82")):
        r = cross_rows_bf16[(kind, 512)]
        # launches: the bf16 serving path's for the forward (its main path), the
        # bf16 per-step training run's for the backward
        launches = options["bf16"]["launches"]["cross_fwd_bf16"] if kind == "fwd" else bf16_launches["per_step"][kind]
        kernels.append({
            "name": f"cross_stack_{kind}_bf16", "route": "cuda", "source": "hhrs_tpu_torch/csrc/cross_stack.cu",
            "replaces": replaces, "launches": launches,
            "training_launches": bf16_launches["per_step"][kind],
            "fused_epoch_launches": bf16_launches["fused"][kind], "max_abs_err": cross_err_bf16[kind],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "device_ms": r["device_ms"],
            "by_batch": [cross_rows_bf16[(kind, B)] for B, _ in CROSS_TIMED_B if B != 512],
            "retrain_launches": {k: v[kind] for k, v in retrain_bf16.items()},
            "mesh_train_launches_per_rank": [x[f"{kind}_bf16"]
                                             for x in mesh_train["gloo"]["ranks"]["2x1 bf16"]["launches"]],
            "mesh_rank_rows_max_abs_err": max(k["bfloat16"] for k in mesh_train["gloo"]["kernel"]),
            **({"export_all_launches": phase12["export"]["launches"]["cross_fwd_bf16"],
                "mesh_launches_per_rank": [r["fwd_bf16"] for r in mesh["gloo"]["bf16_launches"]]}
               if kind == "fwd" else {}),
        })
    trial_rows = tuning["trials"]["rows"]
    for kind, replaces in (("fwd", "hhrs_tpu/ops/pallas/cross_kernel.py:56"),
                           ("bwd", "hhrs_tpu/ops/pallas/cross_kernel.py:82")):
        r = trial_rows[(kind, TRIAL_SHAPES[0][0])]
        kernels.append({
            "name": f"cross_stack_{kind}_trials", "route": "cuda", "source": "hhrs_tpu_torch/csrc/cross_stack.cu",
            "replaces": replaces, "launches": tuning["group"]["launches"][kind],
            "max_abs_err": tuning["trials"]["errs"][kind], "bf16_max_abs_err": tuning["trials"]["errs"][f"{kind}_bf16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "device_ms": r["device_ms"],
            "graph_ms": r["graph_ms"], "k_single_launch_ms": r["k_single_launch_ms"],
            "k_single_device_ms": r["k_single_device_ms"], "k_single_graph_ms": r["k_single_graph_ms"], "K": r["K"],
            "plan": r["plan"] if kind == "fwd" else r["trial_plan"], "waves": r["waves"], "bf16": r["bf16"],
            "by_shape": [trial_rows[(kind, B)] for B, *_ in TRIAL_SHAPES[1:]],
            "bf16_group_launches": tuning["group"]["bf16"]["launches"][f"{kind}_bf16"],
            **({"full_bound_check": tuning["trials"]["c5"]} if kind == "bwd" else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--http-client"]:
            sys.exit(http_client_main(sys.argv[2:]))
        sys.exit(export_check_main(sys.argv[2:]) if sys.argv[1:2] == ["--export-check"] else main())
    except SmokeFailure as e:
        sys.exit(fail(str(e)))
