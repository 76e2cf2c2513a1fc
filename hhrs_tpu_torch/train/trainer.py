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
* dropout draws from one ``torch.Generator`` on the device, seeded from
  ``train_cfg.seed``. It cannot give JAX's bits, so runs meant to match the
  JAX trainer use dropout 0;
* the best state is a copy on the device; the final metrics are computed
  on it. ``examples_per_s`` is the median per-epoch rate after the first
  epoch; ``step_ms`` holds the per-step times of those epochs (CUDA events
  on a card, the host clock on the CPU).
"""

from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from hhrs_tpu_torch.config import ModelConfig, TrainConfig, unported_train_options
from hhrs_tpu_torch.data.preprocess import DatasetSplits
from hhrs_tpu_torch.device import resolve_device
from hhrs_tpu_torch.models.convert import dcnr_from_jax, jax_from_dcnr
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.retrieval.similarity import require_full_f32_matmul
from hhrs_tpu_torch.train.metrics import auc_score, bce_with_logits, recall_at_k, rmse_of_probs
from hhrs_tpu_torch.train.optimizers import PlateauScheduler, make_optimizer, set_learning_rate

log = logging.getLogger(__name__)


@dataclass
class TrainResult:
    params: dict  # the best state as JAX-layout numpy trees
    bn_state: dict
    model: DCNR  # the best state, in eval mode, on the run's device
    history: list = field(default_factory=list)  # per-epoch dicts
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    final_metrics: dict = field(default_factory=dict)
    examples_per_s: float = 0.0
    step_ms: list = field(default_factory=list)
    pruned: bool = False


def split_tensors(splits: DatasetSplits, prefix: str, device: torch.device) -> dict:
    """One split's arrays as tensors on ``device`` (indices int64)."""
    get = lambda name: getattr(splits, f"{prefix}_{name}")  # noqa: E731
    return {
        "user": torch.as_tensor(get("user"), dtype=torch.int64, device=device),
        "item": torch.as_tensor(get("item"), dtype=torch.int64, device=device),
        "cat": torch.as_tensor(get("cat"), dtype=torch.int64, device=device),
        "num": torch.as_tensor(get("num"), dtype=torch.float32, device=device),
        "y": torch.as_tensor(get("y"), dtype=torch.float32, device=device),
    }


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


def train_step(model: DCNR, opt: torch.optim.Optimizer, batch: dict,
               generator: torch.Generator | None) -> torch.Tensor:
    """One optimizer step on a batch (``user``, ``item``, ``cat``, ``num``,
    ``y`` tensors) with the model in train mode → the detached loss."""
    logits = model(batch["user"], batch["item"], batch["cat"], batch["num"], generator=generator)
    loss = bce_with_logits(logits, batch["y"])
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def _new_model(dims: ModelDims, model_cfg: ModelConfig, seed: int, init_state,
               device: torch.device) -> DCNR:
    if init_state is not None:
        params, bn_state = init_state
        return dcnr_from_jax(params, bn_state, dims, model_cfg, device, train=True)
    return DCNR(dims, model_cfg, generator=torch.Generator().manual_seed(seed)).to(device).train()


def train_dcn(
    splits: DatasetSplits,
    dims: ModelDims,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    mesh=None,
    explicit_exchange: str | None = None,
    report_fn: Callable[[int, float], bool] | None = None,
    checkpoint_dir: str | None = None,
    init_state: tuple | None = None,
    device: str | torch.device | None = None,
) -> TrainResult:
    """Full training run; returns the best state (by val loss) and history.

    ``report_fn(epoch, val_loss) -> should_prune`` is the HPO pruning hook.
    ``init_state=(params, bn_state)`` (JAX-layout numpy trees) replaces the
    fresh initialization; the optimizer moments start at zero and the
    shuffle and dropout streams are those of a fresh run. ``device``
    defaults to ``cuda`` and raises without a card; pass ``"cpu"`` to
    train on the CPU."""
    if mesh is not None or explicit_exchange:
        raise NotImplementedError("mesh training is not ported yet: ROADMAP A11 (multi-device training)")
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoint_dir is not ported yet: ROADMAP A6b (checkpoint and resume)")
    unported_train_options(train_cfg)
    if train_cfg.eval_every < 1:
        raise ValueError(f"train.eval_every must be >= 1, got {train_cfg.eval_every}")
    dev = resolve_device(device)
    require_full_f32_matmul(dev)

    model = _new_model(dims, model_cfg, train_cfg.seed, init_state, dev)
    opt = make_optimizer(train_cfg.optimizer, model.parameters(), train_cfg.lr,
                         train_cfg.weight_decay)
    dropout_gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    train_data = split_tensors(splits, "train", dev)
    val_data = split_tensors(splits, "val", dev)

    B = train_cfg.batch_size
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
    cur_lr = plateau.lr
    epoch_times: list = []
    timed = dev.type == "cuda"

    for epoch in range(train_cfg.n_epochs):
        t_epoch = time.perf_counter()
        perm_host = shuffle_rng.permutation(n_train)
        if perm_len > n_train:
            perm_host = np.resize(perm_host, perm_len)  # wrap-pad the ragged tail
        perm = torch.as_tensor(perm_host[:perm_len], dtype=torch.int64, device=dev)
        model.train()
        losses = []
        marks = []  # per-step timestamps: CUDA events on a card, host seconds on the CPU
        for s in range(steps_per_epoch):
            if epoch > 0:
                marks.append(_mark(timed))
            idx = perm[s * B:(s + 1) * B]
            losses.append(train_step(model, opt, {k: v[idx] for k, v in train_data.items()},
                                     dropout_gen))
        if epoch > 0:
            marks.append(_mark(timed))
        mean_loss = torch.stack(losses).mean()

        is_eval = (epoch + 1) % train_cfg.eval_every == 0 or epoch + 1 == train_cfg.n_epochs
        pruned_now = False
        if is_eval:
            val_loss = bce_with_logits(eval_logits(model, val_data, train_cfg.eval_batch_size),
                                       val_data["y"])
            val_loss, train_loss = (float(v) for v in torch.stack([val_loss, mean_loss]).tolist())
            lr = plateau.step(val_loss)
            if lr != cur_lr:
                set_learning_rate(opt, lr)
                cur_lr = lr
            rec = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss, "lr": lr}
            result.history.append(rec)
            log.info("epoch %d: train_loss %.4f val_loss %.4f lr %.2e", epoch, train_loss, val_loss, lr)
            if val_loss < result.best_val_loss:
                result.best_val_loss = val_loss
                result.best_epoch = epoch
                epochs_no_improve = 0
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            else:
                epochs_no_improve += 1
            pruned_now = report_fn is not None and report_fn(epoch, val_loss)
            result.pruned = result.pruned or pruned_now

        if epoch > 0:
            if timed:
                torch.cuda.synchronize(dev)
                result.step_ms += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            else:
                result.step_ms += [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
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

    # Final eval with the best state.
    val_logits = eval_logits(model, val_data, train_cfg.eval_batch_size)
    logloss = float(bce_with_logits(val_logits, val_data["y"]))
    val_logits = val_logits.cpu().numpy()
    y_val = splits.val_y
    result.final_metrics = {
        "val_logloss": logloss,
        "val_auc": auc_score(y_val, val_logits),
        "val_rmse": rmse_of_probs(y_val, val_logits),
        "val_recall_at_100": recall_at_k(splits.val_user, y_val, val_logits, 100),
    }
    result.params, result.bn_state = jax_from_dcnr(model)
    return result


def _mark(on_card: bool):
    if on_card:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()
