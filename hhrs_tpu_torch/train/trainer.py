"""Single-device DCN-R trainer (counterpart of
``hhrs_tpu/train/trainer.py::train_dcn``, its resident per-step path).

The reference loop's semantics are kept: shuffled minibatches, Adam/AdamW,
BCE-with-logits, ReduceLROnPlateau on the val loss, early stopping, the
best state by val loss, and a per-epoch prune hook for HPO. Mechanics:

* the train and val splits are uploaded once; each epoch uploads one
  index vector, ``np.random.default_rng(seed).permutation`` as in the JAX
  trainer, so both trainers see the same batches. ``drop_remainder`` drops
  the ragged tail; otherwise the permutation wraps to fill the last batch;
* a step gathers its batch on the device, runs ``DCNR`` in train mode
  (BatchNorm statistics update in place; the cross stack runs through its
  CUDA kernels, forward and backward), and takes one ``torch.optim`` step;
* the val loss is the BCE over the full val split, scored in
  ``eval_batch_size`` chunks in eval mode; ``eval_every`` skips it (and
  every decision that reads it) on the epochs between;
* dropout draws from one ``torch.Generator`` on the device (Philox on a
  card), seeded from ``train_cfg.seed``. It cannot give JAX's bits, so runs
  meant to match the JAX trainer use dropout 0. ``train.rng_impl`` is
  checked as JAX checks it (``threefry2x32`` or ``rbg``), and both draw
  that one stream: the JAX package's ``rbg`` picks a faster TPU generator,
  and the port has no second one;
* ``train.stream_slab_steps = K`` keeps the train split on the host (a
  ``np.memmap`` too) and uploads ``[K, B, ·]`` slabs of the epoch's
  batches, double-buffered from pinned staging buffers on a copy stream
  (:class:`SlabStream`); the batches and the dropout draws are the
  resident run's, so the run is the resident run bit for bit;
* ``train.lazy_table_updates`` updates only the table rows a batch touches
  (``train/lazy.py``); ``train.moment_dtype=bfloat16`` stores Adam's first
  moment in bf16 (``train/optimizers.py::AdamBf16Moment``);
* ``train.debug_nans`` raises ``FloatingPointError`` when a step leaves a
  NaN in the loss, the parameters, the optimizer's moments or the
  BatchNorm state, or an eval gives one; under ``fused_epoch`` the graph
  gathers a NaN flag and the host reads it once after each replay (the
  granularity at which ``jax_debug_nans`` sees the JAX trainer's fused
  ``lax.scan``). Off by default: a check after every step syncs the host;
* ``train.eval_catalog_recall`` adds ``catalog_recall_at_100``
  (``train/eval_retrieval.py``) to the final metrics, and a
  ``metrics_logger`` (``utils/logging.py::MetricsLogger``) gets one JSONL
  record an eval epoch;
* ``train.fused_epoch`` runs each epoch as one function over static
  device buffers (:class:`FusedEpoch`, the JAX trainer's ``lax.scan``
  epoch): on a card one CUDA-graph replay an epoch, with the same batches
  and loss as the per-step path; eval, plateau, early stopping and the
  best state stay host decisions between epochs;
* ``checkpoint_dir`` saves the whole loop state after every epoch
  (``train/checkpoint.py``) and a rerun resumes from the last one;
* under a ``torch.profiler`` session each epoch is a ``train.epoch`` span
  over ``train.shuffle``, ``train.replay``, ``train.eval`` (up to its
  blocking read, which also waits for the asynchronous steps) and
  ``train.bookkeeping`` (with ``train.checkpoint``); on a card, CUDA
  events just around each fused epoch's graph replay and around the val
  eval book their device times (``train.device.replay_ms``,
  ``train.device.eval_ms``). ``utils/profiling.py`` holds both;
* the best state is a copy on the device; the final metrics are computed
  on it. ``examples_per_s`` is the median per-epoch rate after the first
  epoch this process ran;
* with ``mesh`` (the JAX trainer's mesh mode) every rank trains on its
  rows of each batch through ``parallel/trainer.py``'s step: the tables
  row-sharded over ``model``, BatchNorm synced and gradients summed over
  ``data``, the same batches and dropout masks as one device (lazy table
  updates and slab streaming too); the val
  logits are gathered, so every rank takes the same decisions, and
  checkpoints and ``params`` are gathered, in the single-device format.
"""

from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.data.preprocess import DatasetSplits
from hhrs_tpu_torch.device import capture_stream, resolve_device
from hhrs_tpu_torch.models.convert import dcnr_from_jax, jax_from_dcnr
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.parallel.mesh import all_gather, all_reduce, axis_size
from hhrs_tpu_torch.parallel.multiprocess import epoch_rows, host_rows, val_rows
from hhrs_tpu_torch.parallel.sharding import (gathered_optimizer_state, gathered_state_dict,
                                              sharded_optimizer_state, sharded_state_dict)
from hhrs_tpu_torch.parallel.trainer import make_parallel_train_step, shard_train_state
from hhrs_tpu_torch.retrieval.similarity import require_full_f32_matmul
from hhrs_tpu_torch.train.checkpoint import TrainCheckpointer
from hhrs_tpu_torch.train.lazy import LazyTableOptimizer, dense_parameters, lazy_train_step
from hhrs_tpu_torch.train.metrics import auc_score, bce_with_logits, recall_at_k, rmse_of_probs
from hhrs_tpu_torch.train.optimizers import PlateauScheduler, make_optimizer, set_learning_rate
from hhrs_tpu_torch.utils.profiling import book_elapsed, count, device_event, span

RNG_IMPLS = ("threefry2x32", "rbg")
SPLIT_DTYPES = {"user": torch.int64, "item": torch.int64, "cat": torch.int64, "num": torch.float32,
                 "y": torch.float32}

log = logging.getLogger(__name__)


@dataclass
class TrainResult:
    params: dict  # the best state as JAX-layout numpy trees (gathered on a mesh)
    bn_state: dict
    model: DCNR  # the best state, in eval mode, on the run's device (this rank's shards on a mesh)
    history: list = field(default_factory=list)  # per-epoch dicts
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    final_metrics: dict = field(default_factory=dict)
    examples_per_s: float = 0.0
    # After the first epoch this process ran: per-step times (CUDA events on
    # a card, the host clock on the CPU); under fused_epoch one entry an
    # epoch, the epoch's time divided by its steps (a step has no time of
    # its own inside one graph replay).
    step_ms: list = field(default_factory=list)
    pruned: bool = False


def split_tensors(splits: DatasetSplits, prefix: str, device: torch.device) -> dict:
    """One split's arrays as tensors on ``device`` (indices int64)."""
    return {name: torch.as_tensor(getattr(splits, f"{prefix}_{name}"), dtype=dtype, device=device)
            for name, dtype in SPLIT_DTYPES.items()}


@torch.no_grad()
def eval_logits(model: DCNR, data: dict, eval_batch: int) -> torch.Tensor:
    """Eval-mode logits of a whole split, scored in chunks of ``eval_batch``
    rows → ``[n]``. Leaves the model in eval mode."""
    model.eval()
    n = data["y"].shape[0]
    chunks = [
        model(data["user"][i:i + eval_batch], data["item"][i:i + eval_batch],
              data["cat"][i:i + eval_batch], data["num"][i:i + eval_batch])
        for i in range(0, n, eval_batch)
    ]
    return torch.cat(chunks) if chunks else torch.zeros(0, device=data["y"].device)


def train_step(model: DCNR, opt, batch: dict, generator: torch.Generator | None) -> torch.Tensor:
    """One optimizer step on a batch (``user``, ``item``, ``cat``, ``num``,
    ``y`` tensors) with the model in train mode → the detached loss. ``opt``
    is a ``torch.optim`` optimizer, or a ``train/lazy.py::
    LazyTableOptimizer`` for the lazy table updates."""
    if isinstance(opt, LazyTableOptimizer):
        return lazy_train_step(model, opt, batch, generator)
    logits = model(batch["user"], batch["item"], batch["cat"], batch["num"], generator=generator)
    loss = bce_with_logits(logits, batch["y"])
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def _optimizer_tensors(opt) -> list:
    if isinstance(opt, LazyTableOptimizer):
        return opt.state_tensors()
    return [t for state in opt.state.values() for k, t in state.items() if k != "step" and torch.is_tensor(t)]


def nan_flag(model: DCNR, opt, loss: torch.Tensor) -> torch.Tensor:
    """A device bool: whether the loss, a parameter, a buffer (the
    BatchNorm state) or an optimizer moment holds a NaN (a NaN element
    makes its tensor's norm NaN; an inf does not)."""
    tensors = [loss, *model.parameters(), *model.buffers(), *_optimizer_tensors(opt)]
    norms = torch._foreach_norm([t for t in tensors if t.is_floating_point()])
    return torch.isnan(torch.stack([n.float() for n in norms]).sum())


def _raise_on_nan(flag: torch.Tensor, where: str) -> None:
    if bool(flag):
        raise FloatingPointError(f"NaN in the training state {where} (train.debug_nans)")


class SlabStream:
    """The train split kept on the host (numpy arrays, or ``np.memmap``)
    and an epoch's batches uploaded as ``[k, B, ·]`` slabs of up to ``K``
    steps (``train.stream_slab_steps``; counterpart of the JAX trainer's
    out-of-core branch). :meth:`epoch` yields the slabs in order, each
    ready to read on the current stream.

    On a mesh (``layout``) a slab holds this rank's rows of each of its
    batches, ``[k, B/D, ·]``, cut as ``parallel/multiprocess.py::
    epoch_rows`` cuts an epoch; each rank has its own staging buffers and
    copy stream.

    On a card each slab is gathered on the host into one of two pinned
    staging buffers and copied on a copy stream of its own; slab ``j + 1``
    is gathered and copied after slab ``j``'s steps are enqueued, so its
    copy overlaps them. A staging buffer is refilled only after its last
    copy has finished (host wait on that copy's event); a slab read on the
    compute stream waits for its copy's event there and is marked with
    ``record_stream``, so the caching allocator keeps its memory until the
    compute stream has used it. On the CPU the same code gathers each slab
    into tensors, with no streams. Either way a slab's step ``s`` holds the
    rows and dtypes the resident path gathers for that step."""

    def __init__(self, splits: DatasetSplits, batch_size: int, slab_steps: int, device: torch.device,
                 layout=None):
        self.host = {name: getattr(splits, f"train_{name}") for name in SPLIT_DTYPES}
        self.B, self.K, self.device, self.layout = batch_size, slab_steps, device, layout
        self.n = batch_size if layout is None else batch_size // layout.data_size  # a rank's rows of a batch
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.copy_stream = torch.cuda.Stream(device)
            self.staging = [
                {name: torch.empty((slab_steps * self.n, *a.shape[1:]), dtype=SPLIT_DTYPES[name],
                                   pin_memory=True) for name, a in self.host.items()}
                for _ in range(2)]
            self.copied = [None, None]  # the event of each staging buffer's last copy

    def _upload(self, perm: np.ndarray, j: int, steps: int):
        i0, i1 = j * self.K, min((j + 1) * self.K, steps)
        rows = perm[i0 * self.B:i1 * self.B]
        if self.layout is not None:
            rows = epoch_rows(rows, i1 - i0, self.B, self.layout).reshape(-1)
        shape = lambda a: (i1 - i0, self.n, *a.shape[1:])  # noqa: E731
        if not self.on_card:
            return {name: torch.as_tensor(np.asarray(a[rows]), dtype=SPLIT_DTYPES[name]).reshape(shape(a))
                    for name, a in self.host.items()}, None
        buf, done = self.staging[j % 2], self.copied[j % 2]
        if done is not None:
            done.synchronize()  # its previous copy has left the buffer
        n = len(rows)
        for name, a in self.host.items():
            buf[name].numpy()[:n] = a[rows]
        with torch.cuda.stream(self.copy_stream):
            slab = {name: buf[name][:n].to(self.device, non_blocking=True).view(shape(a))
                    for name, a in self.host.items()}
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        self.copied[j % 2] = event
        return slab, event

    def epoch(self, perm: np.ndarray, steps: int):
        """Yield the slabs of one epoch's ``steps`` batches of ``perm``."""
        n_slabs = -(-steps // self.K)
        slab, event = self._upload(perm, 0, steps)
        for j in range(n_slabs):
            if event is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(event)
                for t in slab.values():
                    t.record_stream(compute)
            yield slab
            if j + 1 < n_slabs:
                slab, event = self._upload(perm, j + 1, steps)


class FusedEpoch:
    """One epoch of training steps as one function over static device
    buffers (counterpart of ``hhrs_tpu/train/trainer.py::make_epoch_fn``):
    the permutation ``perm [steps·B]``, the per-step losses ``losses
    [steps]`` and the resident train split; step ``s`` trains on
    ``perm[s·B:(s+1)·B]``, so the batches are the per-step path's.

    On the CPU the function runs as it stands. On a card its first run is
    eager, on a capture stream of its own (:func:`device.capture_stream`),
    and warms up what a capture cannot create (the optimizer's state, the
    cross kernels' plans, cuBLAS's workspace); then the function is
    captured there into one CUDA graph, and every later epoch is one
    replay. A capture that fails raises. Dropout draws from ``generator``,
    which the graph advances on every replay; the optimizer's LR is a
    tensor the graph reads, so a plateau decay between epochs reaches it.
    With ``debug_nans`` every step ORs :func:`nan_flag` into ``self.nan``,
    which the caller reads after the run. While a profiler records, a
    replay keeps the timing events just around it in ``self.replayed``."""

    def __init__(self, model: DCNR, opt, data: dict, batch_size: int,
                 steps: int, generator: torch.Generator, debug_nans: bool = False):
        self.model, self.opt, self.data, self.generator = model, opt, data, generator
        self.batch_size, self.steps, self.debug_nans = batch_size, steps, debug_nans
        dev = data["y"].device
        self.perm = torch.zeros(steps * batch_size, dtype=torch.int64, device=dev)
        self.losses = torch.zeros(steps, device=dev)
        self.nan = torch.zeros((), dtype=torch.bool, device=dev)
        self.graph = None
        self.replayed = (None, None)  # the last replay's device_event pair
        if dev.type == "cuda":
            self.stream = capture_stream(self, dev)

    def _epoch(self) -> None:
        B = self.batch_size
        for s in range(self.steps):
            idx = self.perm[s * B:(s + 1) * B]
            loss = train_step(self.model, self.opt, {k: v[idx] for k, v in self.data.items()},
                              self.generator)
            self.losses[s].copy_(loss)
            if self.debug_nans:
                self.nan.logical_or_(nan_flag(self.model, self.opt, loss))

    def run(self, perm: np.ndarray) -> torch.Tensor:
        """Train one epoch on the batches of ``perm`` (host, ``[steps·B]``)
        → the mean loss, a device scalar. On a card the first run also
        captures the graph."""
        self.perm.copy_(torch.from_numpy(np.ascontiguousarray(perm, dtype=np.int64)))
        self.nan.zero_()
        self.model.train()
        if self.perm.device.type != "cuda":
            self._epoch()
        elif self.graph is not None:
            start = device_event(self.perm.device)
            self.graph.replay()
            self.replayed = (start, device_event(self.perm.device))
        else:
            side = self.stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._epoch()
            torch.cuda.current_stream().wait_stream(side)
            self._capture()
        return self.losses.mean()

    def _capture(self) -> None:
        count("build.graph_capture")
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)  # each replay draws new dropout masks
        # Recording runs nothing: the state the last epoch left stays as it is.
        with torch.cuda.graph(graph, stream=self.stream):
            self._epoch()
        self.graph = graph


def _new_model(dims: ModelDims, model_cfg: ModelConfig, seed: int, init_state,
               device: torch.device) -> DCNR:
    if init_state is not None:
        params, bn_state = init_state
        return dcnr_from_jax(params, bn_state, dims, model_cfg, device, train=True)
    return DCNR(dims, model_cfg, generator=torch.Generator().manual_seed(seed)).to(device).train()


def make_train_optimizer(model: DCNR, train_cfg: TrainConfig, capturable_on: torch.device | None = None):
    """The trainer's optimizer for ``model``: Adam/AdamW over every parameter
    (its first moment in ``train.moment_dtype``), or with
    ``train.lazy_table_updates`` a :class:`LazyTableOptimizer` of that
    optimizer over the non-table parameters and the tables' row-wise
    state (f32, as in the JAX package). ``capturable_on``: the card whose
    CUDA graph replays the step."""
    lazy = train_cfg.lazy_table_updates
    dense = make_optimizer(train_cfg.optimizer, dense_parameters(model) if lazy else model.parameters(),
                           train_cfg.lr, train_cfg.weight_decay, capturable_on=capturable_on,
                           moment_dtype=train_cfg.moment_dtype)
    if not lazy:
        return dense
    return LazyTableOptimizer(model, dense, train_cfg.optimizer, train_cfg.weight_decay,
                              capturable=capturable_on is not None)


def train_dcn(
    splits: DatasetSplits,
    dims: ModelDims,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    mesh=None,
    explicit_exchange: str | None = None,
    exchange_capacity_factor: float = 1.25,
    report_fn: Callable[[int, float], bool] | None = None,
    checkpoint_dir: str | None = None,
    init_state: tuple | None = None,
    device: str | torch.device | None = None,
    metrics_logger=None,
) -> TrainResult:
    """Full training run; returns the best state (by val loss) and history.

    ``report_fn(epoch, val_loss) -> should_prune`` is the HPO pruning hook;
    ``metrics_logger`` gets one record per evaluated epoch.
    ``init_state=(params, bn_state)`` (JAX-layout numpy trees) replaces the
    fresh initialization; the optimizer moments start at zero and the
    shuffle and dropout streams are those of a fresh run. With
    ``checkpoint_dir`` the whole loop state is saved after every epoch and
    a rerun resumes from the last saved epoch; a run that had finished,
    early-stopped or been pruned trains no further. ``device`` defaults to
    ``cuda`` and raises without a card; pass ``"cpu"`` to train on the CPU.

    ``mesh`` (``parallel/mesh.py::make_mesh``; every rank of its world calls
    this with the same arguments): the tables row-sharded over ``model``,
    each batch's rows split over ``data`` (``parallel/trainer.py``). Each
    rank uploads only its rows of every epoch (streaming), or the whole
    train split once with ``train.mesh_resident_data`` (the same batches,
    bit for bit); the val split is split over ``data`` when it divides and
    replicated when not, and its logits are gathered, so every rank takes
    the same plateau and early-stop decisions and returns the same
    ``history``. ``explicit_exchange`` picks the table exchange
    (``parallel/embedding.py``; default psum); ``capped`` at
    ``exchange_capacity_factor`` records each epoch's drop rate as
    ``exchange_overflow``. The best state stays on the shards; checkpoints
    and the result's ``params`` are gathered, in the single-device format,
    and only rank 0 writes. There is no fused epoch on a mesh, as in the
    JAX trainer. ``train.lazy_table_updates`` runs on a mesh through the
    psum exchange (``parallel/trainer.py::make_lazy_mesh_step``; an explicit
    exchange with it raises ``ValueError``, as in JAX), its row moments
    gathered into checkpoints; ``train.stream_slab_steps`` uploads each
    rank's rows of every slab (and wins over ``mesh_resident_data``, as the
    JAX trainer's slab branch does)."""
    if explicit_exchange and mesh is None:
        raise ValueError("train.explicit_exchange requires --mesh")
    if explicit_exchange not in (None, "", "all_to_all", "psum", "capped"):
        raise ValueError(f"unknown mesh.explicit_exchange {explicit_exchange!r}; "
                         "expected 'all_to_all', 'psum' or 'capped'")
    if train_cfg.fused_epoch and train_cfg.stream_slab_steps:
        raise ValueError("train.fused_epoch and train.stream_slab_steps are mutually exclusive: a fused epoch "
                         "scans a device-resident dataset, slab streaming exists so the dataset is NOT "
                         "device-resident")
    if mesh is not None and train_cfg.lazy_table_updates and explicit_exchange:
        raise ValueError("train.lazy_table_updates and mesh.explicit_exchange are mutually exclusive (lazy "
                         "differentiates w.r.t. gathered rows; the exchange differentiates w.r.t. sharded tables)")
    if train_cfg.rng_impl not in RNG_IMPLS:
        raise ValueError(f"unknown train.rng_impl {train_cfg.rng_impl!r}; expected 'threefry2x32' or 'rbg'")
    if train_cfg.eval_every < 1:
        raise ValueError(f"train.eval_every must be >= 1, got {train_cfg.eval_every}")
    B = train_cfg.batch_size
    if mesh is not None and B % axis_size(mesh, "data"):
        raise ValueError(f"batch_size {B} must divide over the data axis ({axis_size(mesh, 'data')} devices)")
    dev = resolve_device(device)
    require_full_f32_matmul(dev)

    model = _new_model(dims, model_cfg, train_cfg.seed, init_state, dev)
    layout = None
    if mesh is None:
        graphed = train_cfg.fused_epoch and dev.type == "cuda"
        opt = make_train_optimizer(model, train_cfg, capturable_on=dev if graphed else None)
    else:
        if train_cfg.fused_epoch:
            log.info("train.fused_epoch is off on a mesh: the mesh trainer steps eagerly, as the JAX trainer does")
        state = shard_train_state(mesh, model, lambda m: make_train_optimizer(m, train_cfg))
        opt, layout = state.opt, state.layout
        mesh_step = make_parallel_train_step(state, explicit_exchange or None, exchange_capacity_factor)
    capped = explicit_exchange == "capped"
    writer = layout is None or dist.get_rank() == 0  # the rank that writes checkpoints
    dropout_gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    slabs = train_data = None
    if train_cfg.stream_slab_steps > 0:  # the train split stays on the host
        slabs = SlabStream(splits, B, train_cfg.stream_slab_steps, dev, layout)
    elif layout is None or train_cfg.mesh_resident_data:
        train_data = split_tensors(splits, "train", dev)
    # else a mesh streams: each epoch uploads this rank's rows of its batches
    D = 1 if layout is None else layout.data_size
    n_local = B // D  # this rank's rows of each batch: [start, start + n_local)
    start = 0 if layout is None else layout.data_rank * n_local
    val_sharded = D > 1 and splits.n_val % D == 0
    if layout is None:
        val_data = split_tensors(splits, "val", dev)
    else:
        val_data = host_rows(splits, "val", val_rows(splits.n_val, layout), SPLIT_DTYPES, dev)
    val_y = (torch.as_tensor(splits.val_y, dtype=torch.float32, device=dev) if val_sharded else val_data["y"])
    debug_nans = train_cfg.debug_nans

    n_train = splits.n_train
    steps_per_epoch = n_train // B if train_cfg.drop_remainder else -(-n_train // B)
    if steps_per_epoch == 0:
        raise ValueError(f"batch_size {B} > n_train {n_train} (set drop_remainder=False)")
    perm_len = steps_per_epoch * B

    plateau = PlateauScheduler(train_cfg.lr, train_cfg.lr_plateau_patience,
                               train_cfg.lr_plateau_factor)
    result = TrainResult(params={}, bn_state={}, model=model)
    best_state = None
    epochs_no_improve = 0
    shuffle_rng = np.random.default_rng(train_cfg.seed)
    start_epoch = 0

    ckpt = TrainCheckpointer(checkpoint_dir) if checkpoint_dir is not None else None
    if ckpt is not None and ckpt.latest_epoch() is not None:
        state, meta = ckpt.restore(ckpt.latest_epoch(), dev)
        model_state, opt_state, best_state = state["model"], state["optimizer"], state["best"]
        if layout is not None:  # the file holds the whole state: take this rank's slice
            model_state = sharded_state_dict(model, model_state)
            opt_state = sharded_optimizer_state(model, opt, opt_state)
            best_state = None if best_state is None else sharded_state_dict(model, best_state)
        model.load_state_dict(model_state)
        opt.load_state_dict(opt_state)
        dropout_gen.set_state(state["dropout_generator"].cpu())
        start_epoch = meta["epoch"] + 1
        result.history = meta["history"]
        result.best_val_loss = meta["best_val_loss"]
        result.best_epoch = meta["best_epoch"]
        result.pruned = meta["pruned"]
        epochs_no_improve = meta["epochs_no_improve"]
        plateau.lr, plateau.best, plateau.num_bad = (meta["plateau"][k] for k in ("lr", "best", "num_bad"))
        set_learning_rate(opt, plateau.lr)
        shuffle_rng.bit_generator.state = meta["shuffle_rng_state"]
        log.info("resumed from checkpoint epoch %d", meta["epoch"])
        # The loop checks its stop conditions at the end of an epoch: a run
        # that had already stopped must not train again.
        if epochs_no_improve >= train_cfg.early_stop_patience or result.pruned:
            log.info("resumed run had already stopped; skipping the training loop")
            start_epoch = train_cfg.n_epochs

    fused = (FusedEpoch(model, opt, train_data, B, steps_per_epoch, dropout_gen, debug_nans=debug_nans)
             if train_cfg.fused_epoch and layout is None else None)
    cur_lr = plateau.lr
    epoch_times: list = []
    timed = dev.type == "cuda"
    epochs_run = 0

    def step(batch: dict, where: str) -> tuple:
        """One step → (the loss, the capped exchange's overflow or None)."""
        overflow = None
        if layout is None:
            loss = train_step(model, opt, batch, dropout_gen)
        else:
            loss = mesh_step(batch, dropout_gen)
            if capped:
                loss, overflow = loss
        if debug_nans:
            _raise_on_nan(any_rank(nan_flag(model, opt, loss), layout), where)
        return loss, overflow

    def val_logits() -> torch.Tensor:
        logits = eval_logits(model, val_data, train_cfg.eval_batch_size)
        return all_gather(logits, layout.data_group).flatten() if val_sharded else logits

    def eval_loss() -> torch.Tensor:
        logits = val_logits()
        if debug_nans:
            _raise_on_nan(torch.isnan(logits).any(), "in the val logits")
        return bce_with_logits(logits, val_y)

    for epoch in range(start_epoch, train_cfg.n_epochs):
        with span("train.epoch"):
            t_epoch = time.perf_counter()
            epochs_run += 1
            with span("train.shuffle"):
                perm_host = shuffle_rng.permutation(n_train)
                if perm_len > n_train:
                    perm_host = np.resize(perm_host, perm_len)  # wrap-pad the ragged tail
                perm_host = perm_host[:perm_len]
            marks = []  # timestamps: CUDA events on a card, host seconds on the CPU
            overflows = []  # the capped exchange's (dropped, total) of each step
            with span("train.replay"):
                if fused is not None:
                    marks.append(_mark(timed))
                    mean_loss = fused.run(perm_host)
                    marks.append(_mark(timed))
                    if debug_nans:
                        _raise_on_nan(fused.nan, f"during epoch {epoch} (checked once a fused epoch)")
                else:
                    model.train()
                    losses = []

                    def run(batch: dict) -> None:
                        marks.append(_mark(timed))
                        loss, overflow = step(batch, f"after step {len(losses)} of epoch {epoch}")
                        losses.append(loss)
                        if overflow is not None:
                            overflows.append(overflow)

                    if slabs is not None:
                        for slab in slabs.epoch(perm_host, steps_per_epoch):
                            for k in range(slab["y"].shape[0]):
                                run({name: t[k] for name, t in slab.items()})
                    elif train_data is None:  # a mesh's streamed epoch: this rank's rows only
                        rows = epoch_rows(perm_host, steps_per_epoch, B, layout).reshape(-1)
                        epoch_data = host_rows(splits, "train", rows, SPLIT_DTYPES, dev)
                        for s in range(steps_per_epoch):
                            run({k: v[s * n_local:(s + 1) * n_local] for k, v in epoch_data.items()})
                    else:
                        perm = torch.as_tensor(perm_host, dtype=torch.int64, device=dev)
                        for s in range(steps_per_epoch):
                            idx = perm[s * B + start:s * B + start + n_local]
                            run({k: v[idx] for k, v in train_data.items()})
                    marks.append(_mark(timed))
                    mean_loss = torch.stack(losses).mean()

            is_eval = (epoch + 1) % train_cfg.eval_every == 0 or epoch + 1 == train_cfg.n_epochs
            pruned_now = False
            if is_eval:
                with span("train.eval"):
                    before = device_event(dev)
                    val = eval_loss()
                    after = device_event(dev)
                    val_loss, train_loss = (float(v) for v in torch.stack([val, mean_loss]).tolist())
                    book_elapsed("train.device.eval_ms", before, after)
            with span("train.bookkeeping"):
                if is_eval:
                    lr = plateau.step(val_loss)
                    if lr != cur_lr:
                        set_learning_rate(opt, lr)
                        cur_lr = lr
                    rec = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss, "lr": lr}
                    if overflows:
                        dropped, total = (int(v) for v in torch.stack(overflows).sum(dim=0).tolist())
                        rec["exchange_overflow"] = dropped / total if total else 0.0
                        log.info("capped exchange: %.4f%% of lookups dropped this epoch (%d of %d)",
                                 100 * rec["exchange_overflow"], dropped, total)
                    result.history.append(rec)
                    if metrics_logger is not None:
                        metrics_logger.log(**rec)
                    log.info("epoch %d: train_loss %.4f val_loss %.4f lr %.2e", epoch, train_loss, val_loss, lr)
                    if val_loss < result.best_val_loss:
                        result.best_val_loss = val_loss
                        result.best_epoch = epoch
                        epochs_no_improve = 0
                        best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
                    else:
                        epochs_no_improve += 1
                    # before the save: a run resumed after a prune must see it and train no further
                    pruned_now = report_fn is not None and report_fn(epoch, val_loss)
                    result.pruned = result.pruned or pruned_now

                if ckpt is not None:
                    with span("train.checkpoint"):
                        model_state, opt_state, best = model.state_dict(), opt.state_dict(), best_state
                        if layout is not None:  # every rank joins the gathers; rank 0 writes the whole state
                            model_state, opt_state = gathered_state_dict(model), gathered_optimizer_state(model, opt)
                            best = None if best is None else gathered_state_dict(model, best)
                        if writer:
                            ckpt.save(epoch, {
                                "model": model_state,
                                "optimizer": opt_state,
                                "best": best,
                                "dropout_generator": dropout_gen.get_state(),
                            }, {
                                "epoch": epoch,
                                "history": result.history,
                                "best_val_loss": result.best_val_loss,
                                "best_epoch": result.best_epoch,
                                "pruned": result.pruned,
                                "epochs_no_improve": epochs_no_improve,
                                "plateau": {"lr": plateau.lr, "best": plateau.best, "num_bad": plateau.num_bad},
                                "shuffle_rng_state": shuffle_rng.bit_generator.state,
                            })
                        if layout is not None:
                            dist.barrier()  # the file is whole before any rank goes on

                if epochs_run > 1:  # the first epoch a process runs warms up (and captures)
                    if timed:
                        torch.cuda.synchronize(dev)
                        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
                    else:
                        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
                    result.step_ms += [ms[0] / steps_per_epoch] if fused is not None else ms
                    if fused is not None:
                        book_elapsed("train.device.replay_ms", *fused.replayed)
                    epoch_times.append(time.perf_counter() - t_epoch)
        if pruned_now:
            log.info("trial pruned at epoch %d", epoch)
            break
        if epochs_no_improve >= train_cfg.early_stop_patience:
            log.info("early stopping at epoch %d", epoch + 1)
            break

    if epoch_times:
        result.examples_per_s = steps_per_epoch * B / max(statistics.median(epoch_times), 1e-9)
    if best_state is not None:
        model.load_state_dict(best_state)

    # Final eval with the best state (on a mesh: the gathered val logits).
    logits = val_logits()
    if debug_nans:
        _raise_on_nan(torch.isnan(logits).any(), "in the final val logits")
    logloss = float(bce_with_logits(logits, val_y))
    logits = logits.cpu().numpy()
    y_val = splits.val_y
    result.final_metrics = {
        "val_logloss": logloss,
        "val_auc": auc_score(y_val, logits),
        "val_rmse": rmse_of_probs(y_val, logits),
        "val_recall_at_100": recall_at_k(splits.val_user, y_val, logits, 100),
    }
    result.params, result.bn_state = jax_from_dcnr(model)  # on a mesh every rank joins the gather
    if train_cfg.eval_catalog_recall:
        from hhrs_tpu_torch.train.eval_retrieval import catalog_recall_at_k

        whole = model if layout is None else dcnr_from_jax(result.params, result.bn_state, dims, model_cfg, dev)
        result.final_metrics["catalog_recall_at_100"] = catalog_recall_at_k(whole, splits, k=100)
    return result


def any_rank(flag: torch.Tensor, layout) -> torch.Tensor:
    """A device bool that is true on every rank of a mesh when ``flag`` is
    true on any (one ``all_reduce`` over every rank); ``flag`` itself
    without a mesh."""
    if layout is None:
        return flag
    return all_reduce(flag.to(torch.int32), op=dist.ReduceOp.MAX).bool()


def _mark(on_card: bool):
    if on_card:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()
