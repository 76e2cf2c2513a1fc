"""Retraining: one run of ``train/trainer.py::train_dcn``, as the retraining
pipeline calls it, on the world the traffic names, from seeded weights
handed in as its ``init_state``. The traffic runs the fused epoch
(``train.fused_epoch``): on a card epoch 0 runs eagerly, then every epoch
is one replay of the CUDA graph captured after it.

The run is one call. Its first epochs are the set-up (they build the
kernels, their launch plans, the graph and the allocator's pools); the
window is the whole epochs that follow, each with its val evaluation and
bookkeeping as ``train_dcn`` does them, up to the first epoch end past
``--seconds``. The harness reads the clock at epoch ends through the
trainer's per-epoch hook (``report_fn``) and ends the run there; the call's
final evaluation comes after the window. The run is cut by time, so its
epoch limit and early stop are set out of reach.

Two stretches of the same call are observed as they run. The first three
steps (in the eager epoch 0): each step's loss, every parameter's first
gradient as the optimizer holds it after one step (AdamW's first moment,
(1 − β1)·g), and the parameters after the third step. And the window's
first epoch, a graph replay: its per-step losses (the fused epoch's loss
buffer) and the parameters at its end. The reference follows the same
epochs from the same weights after the run.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import prep, spec, tracing, weights, world

OBSERVED_STEPS = 3
BETA1 = 0.9


class Observer:
    """Wraps the trainer's step for its first three calls, then puts the
    trainer's own step back; and keeps a handle on the fused epoch that
    ``train_dcn`` builds, so that the window's first epoch can be read."""

    def __init__(self, trainer_module):
        self.mod = trainer_module
        self.step = trainer_module.train_step
        self.fused_class = trainer_module.FusedEpoch
        self.losses, self.grad_norms, self.params, self.model, self.fused = [], None, None, None, None
        trainer_module.train_step = self
        obs = self

        class Tapped(self.fused_class):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                obs.fused = self
        trainer_module.FusedEpoch = Tapped

    def restore(self) -> None:
        self.mod.train_step, self.mod.FusedEpoch = self.step, self.fused_class

    def __call__(self, model, opt, batch, generator):
        loss = self.step(model, opt, batch, generator)
        self.model = model
        self.losses.append(loss)
        if len(self.losses) == 1:
            self.grad_norms = {n: torch.linalg.vector_norm(opt.state[p]["exp_avg"].double()) / (1 - BETA1)
                               if "exp_avg" in opt.state.get(p, {}) else torch.zeros(())
                               for n, p in model.named_parameters()}
        if len(self.losses) == OBSERVED_STEPS:
            self.params = {n: p.detach().clone() for n, p in model.named_parameters()}
            self.mod.train_step = self.step
        return loss


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device, clock) -> dict:
    tr, cfg = cell.traffic, cell.config
    s_world, s_weights, s_train = world.seeds(seed, 3)
    reviews, _ = world.build(tr["world"], s_world)
    marks = [("world drawn", clock())]
    gc_clock = tracing.GcClock()

    from hhrs_tpu_torch.config import ModelConfig, TrainConfig
    from hhrs_tpu_torch.data.features import add_engineered_features
    from hhrs_tpu_torch.data.ingest import noise_filter
    from hhrs_tpu_torch.data.preprocess import Preprocessor
    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.train import trainer

    splits, art = Preprocessor().fit_transform(add_engineered_features(noise_filter(dict(reviews))))
    dims = ModelDims.from_artifacts(art)
    cat_dims = [n for _, n in dims.cat_dims]
    m, t = cfg["model"], cfg["train"]
    flat = weights.make(m, dims.n_users, dims.n_items, cat_dims, dims.n_num_features, s_weights, device,
                        trained=False)
    init = weights.to_trees(flat, m["n_res_blocks"], len(cat_dims))
    marks.append(("vocabularies and weights", clock()))
    train_cfg = TrainConfig(**t, **tr["train_options"], seed=s_train, n_epochs=tr["epoch_limit"],
                            early_stop_patience=tr["epoch_limit"])
    B = train_cfg.batch_size
    steps = splits.n_train // B
    val_chunks = [min(train_cfg.eval_batch_size, splits.n_val - s)
                  for s in range(0, splits.n_val, train_cfg.eval_batch_size)]

    warm, trace_s = tr["warm_epochs"], tr["trace_seconds"]
    if warm > t["lr_plateau_patience"] + 1 or not tr["train_options"].get("fused_epoch"):
        raise ValueError("the reference follows a fused run at the configured LR: the window's first "
                         "epoch must come before the plateau can first decay")
    epoch_read = {}
    clock_state = {"setup_s": None, "t_start": None, "window_s": None, "epochs": 0, "traced_epochs": 0}
    win = tracing.Window(device) if trace else None

    def report(epoch: int, _val_loss: float) -> bool:
        now = time.perf_counter()
        st = clock_state
        if epoch + 1 < warm:
            marks.append((f"epoch {epoch}", clock()))
            return False
        if st["t_start"] is None:
            gc.collect()
            st["setup_s"] = clock()
            gc_clock.recording = True
            st["t_start"] = time.perf_counter()
            return False
        if st["window_s"] is None:
            st["epochs"] += 1
            if st["epochs"] == 1:  # the window's first epoch, a replay: its losses and parameters
                epoch_read["losses"] = obs.fused.losses.clone()
                epoch_read["params"] = {n: p.detach().clone() for n, p in obs.model.named_parameters()}
            if now - st["t_start"] < seconds:
                return False
            st["window_s"] = now - st["t_start"]
            gc_clock.recording = False
            if win is None:
                return True
            gc_clock.tracing = True
            win.start()
            return False
        st["traced_epochs"] += 1
        if time.perf_counter() - win.t0 < trace_s:
            return False
        win.stop()
        gc_clock.tracing = False
        return True

    obs = Observer(trainer)
    try:
        result = trainer.train_dcn(splits, dims, ModelConfig(**m), train_cfg, report_fn=report,
                                   init_state=init, device=device)
    finally:
        obs.restore()
    if clock_state["window_s"] is None:
        raise RuntimeError("the run ended before its window closed")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace_out = win.reduce() if win is not None else None
    program = {"losses": [float(x) for x in obs.losses[:OBSERVED_STEPS]],
               "grad_norms": {k: float(v) for k, v in obs.grad_norms.items()},
               "changes": {k: float(torch.linalg.vector_norm(obs.params[k].double() - flat[k].double()))
                           for k in obs.params},
               "replay_losses": [float(x) for x in epoch_read["losses"].tolist()],
               "replay_changes": {k: float(torch.linalg.vector_norm(v.double() - flat[k].double()))
                                  for k, v in epoch_read["params"].items()}}
    del result, obs, epoch_read
    gc_clock.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = spec.reference(cfg)
    epochs = warm + 1
    ref_out = reference_steps(ref, cfg, reviews, flat, s_train, epochs, device, ref.reference_prec(cfg["model"]))
    numbers = gaps(ref_out, flat, program)
    numbers["reference_s"] = time.perf_counter() - t_ref
    d = weights.input_dim(m, cat_dims, dims.n_num_features)
    rows = clock_state["epochs"] * steps * B
    return {
        "setup_s": clock_state["setup_s"], "window_s": clock_state["window_s"], "rows_stepped": rows,
        "epochs": clock_state["epochs"], "steps_per_epoch": steps, "batch": B, "val_chunks": val_chunks,
        "traced_epochs": clock_state["traced_epochs"], "gc_pauses": list(gc_clock.pauses), "trace": trace_out,
        "widths": {"d": d, "H": m["hidden_dim"], "R": m["n_res_blocks"], "L": m["n_cross_layers"]},
        "dtype": m["compute_dtype"], "memory_peak_bytes": peak,
        "attempted": clock_state["epochs"] * steps, "failed": 0, "numbers": numbers,
        "judge_inputs": (ref, cfg, reviews, flat, s_train, epochs, ref_out), "setup_marks": marks,
    }


def reference_steps(ref, cfg: dict, reviews: dict, flat: dict, train_seed: int, epochs: int,
                    device: torch.device, P, half_batch: bool = False) -> dict:
    """The reference's first ``epochs`` epochs: its own splits of the world,
    each epoch's batches from the next ``default_rng(seed).permutation``
    (the ragged tail dropped), the dropout masks of a generator seeded
    alike on the device, from the same initial weights. The parameters are
    kept after the third step and after the last."""
    t = cfg["train"]
    sp = prep.splits(prep.noise_filtered(reviews), prep.fit(prep.noise_filtered(reviews)))["train"]
    n, B = len(sp["y"]), t["batch_size"]
    steps = n // B
    rng = np.random.default_rng(train_seed)
    gen = torch.Generator(device=device).manual_seed(train_seed)
    H, R = cfg["model"]["hidden_dim"], cfg["model"]["n_res_blocks"]
    keep = 1.0 - cfg["model"]["dropout"]
    data = {k: torch.as_tensor(v, device=device) for k, v in sp.items()}

    def batches():
        for _ in range(epochs):
            perm = torch.as_tensor(rng.permutation(n)[:steps * B], device=device)
            for s in range(steps):
                rows = perm[s * B:(s + 1) * B]
                masks = [torch.rand((B, H), generator=gen, device=device) < keep for _ in range(R)]
                yield {k: v[rows] for k, v in data.items()}, masks

    out = ref.train_steps(flat, batches(), cfg["model"], t, P, half_batch=half_batch,
                          keep=(OBSERVED_STEPS, epochs * steps))
    out["steps_per_epoch"] = steps
    return out


def _change_gaps(changes: dict, c_ref: dict, leaves: list) -> tuple[list, int]:
    """Each leaf's gap of change norms, against the larger of its reference
    change and the median leaf's; and how many leaves moved by less than
    half or more than one and a half times the reference's change."""
    med_c = float(np.median([c_ref[k] for k in leaves]))
    gaps_ = [abs(changes[k] - c_ref[k]) / max(c_ref[k], med_c) for k in leaves]
    off = sum(abs(changes[k] / c_ref[k] - 1.0) > 0.5 for k in leaves if c_ref[k] > 0)
    return gaps_, int(off)


def gaps(ref_out: dict, flat: dict, program: dict) -> dict:
    """The program's readings against the reference's → the numbers. After
    the first three steps: the widest relative gap of a step's loss
    (``loss_gap``) and of the first step's (``loss_gap_step1``); of each
    leaf's first-gradient norm and change norm, by the worst leaf
    (``grad_gap``, ``change_gap``) and the median leaf
    (``change_gap_median``), each against the larger of that leaf's
    reference norm and the median leaf's; and ``leaves_off``, the leaves
    the program moves by less than half or more than one and a half times
    the reference's change (a leaf left unmoved, or moved double). Over the
    window's first epoch, a graph replay: the widest relative gap of its
    steps' losses (``loss_gap_replay``), and the change gaps and leaves off
    at its end (``change_gap_replay``, ``change_gap_replay_median``,
    ``leaves_off_replay``). Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out: they move by round-off
    alone."""
    losses, steps = ref_out["losses"], ref_out["steps_per_epoch"]
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], losses))
    replay = max(abs(a - b) / abs(b) for a, b in zip(program["replay_losses"], losses[-steps:]))
    g_ref = ref_out["grad_norms"]
    med_g = float(np.median(list(g_ref.values())))
    leaves = [k for k, v in g_ref.items() if v >= 1e-3 * med_g]
    grad = [abs(program["grad_norms"][k] - g_ref[k]) / max(g_ref[k], med_g) for k in leaves]
    out = {}
    for tag, at, changes in (("", OBSERVED_STEPS, program["changes"]),
                             ("_replay", max(ref_out["params"]), program["replay_changes"])):
        p_ref = ref_out["params"][at]
        c_ref = {k: float(torch.linalg.vector_norm(p_ref[k].double() - flat[k].double())) for k in leaves}
        change, off = _change_gaps(changes, c_ref, leaves)
        out.update({f"change_gap{tag}": max(change), f"change_gap{tag}_median": float(np.median(change)),
                    f"leaves_off{tag}": off})
    first = abs(program["losses"][0] - losses[0]) / abs(losses[0])
    return {"loss_gap": loss, "loss_gap_step1": first, "grad_gap": max(grad), "loss_gap_replay": replay, **out,
            "leaves_compared": len(leaves), "leaves_left_out": sorted(set(g_ref) - set(leaves))}


def readings_of(ref_out: dict, flat: dict) -> dict:
    """A reference run's own readings, in the form of the program's, so that
    a control or a planted fault is judged by the same :func:`gaps`."""
    change = lambda at: {k: float(torch.linalg.vector_norm(v.double() - flat[k].double()))  # noqa: E731
                         for k, v in ref_out["params"][at].items()}
    return {"losses": ref_out["losses"][:OBSERVED_STEPS], "grad_norms": ref_out["grad_norms"],
            "changes": change(OBSERVED_STEPS), "replay_losses": ref_out["losses"][-ref_out["steps_per_epoch"]:],
            "replay_changes": change(max(ref_out["params"]))}
