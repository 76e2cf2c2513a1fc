"""HPO parity: the port's search space, samplers, pruners, study and journal
against hhrs_tpu's (bit for bit), its K-lane ``run_group`` against its
sequential ``train_dcn`` (dropout on) and against the JAX ``run_group``
(dropout 0), and its HPO CLI on the CPU.

Bars. A lane of the port's group against the port's sequential trial: the
JAX package's own bars (tests/test_hpo_vectorized.py: val and train loss
rel 2e-3, LR decisions and best epoch equal, AUC abs 5e-3); on the CPU at
these sizes the largest gap is 5.9e-4 with AdamW (its lr-5e-2 lane) and
2.1e-5 with Adam (recorded as ``max_rel_gap``). The port's
group against JAX's at dropout 0: the trainer's trajectory bars (rtol 2e-3
/ atol 2e-4 after epoch 0, rtol 5e-3 after later epochs, fault C1 in
ROADMAP §C)."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hhrs_tpu.config import ModelConfig as JaxModelConfig
from hhrs_tpu.config import TrainConfig as JaxTrainConfig
from hhrs_tpu.data.synthetic import write_synthetic_dataset
from hhrs_tpu.hpo import plots as jax_plots
from hhrs_tpu.hpo import pruner as jax_pruner
from hhrs_tpu.hpo import sampler as jax_sampler
from hhrs_tpu.hpo import space as jax_space
from hhrs_tpu.hpo import study as jax_study
from hhrs_tpu.hpo.vectorized import run_group as jax_run_group
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims
from hhrs_tpu.models.dcn import init_dcn
from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.hpo import cli as hpo_cli
from hhrs_tpu_torch.hpo import plots, pruner, sampler, space, study
from hhrs_tpu_torch.hpo.vectorized import (ARCH_KEYS, LaneAdam, LaneDCNR, arch_key, group_trials,
                                           run_group)
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.train.trainer import train_dcn
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_port_train import REVIEWS, jax_splits, port_dims, port_splits

REPO = Path(__file__).resolve().parents[1]
HPO_R5_JOURNAL = REPO / "benchmarks/results/hpo_r5/journal.jsonl"
LANE_BAR = dict(rel=2e-3)  # tests/test_hpo_vectorized.py's bar, val and train loss
AUC_BAR = 5e-3
TRAJECTORY = [dict(rel=2e-3, abs=2e-4)] + [dict(rel=5e-3, abs=2e-4)] * 3  # C1's bars, by epoch
ARCH = {"emb_dim": 8, "hidden_dim": 32, "n_cross_layers": 2, "n_res_blocks": 1, "batch_size": 64,
        "optimizer": "adamw"}


def _trial(lr, wd, dropout, optimizer="adamw", patience=1, factor=0.5):
    return dict(ARCH, lr=lr, weight_decay=wd, dropout=dropout, optimizer=optimizer,
                lr_plateau_patience=patience, lr_plateau_factor=factor)


def _cfgs(params, n_epochs=3, **train):
    kw = dict(emb_dim=params["emb_dim"], hidden_dim=params["hidden_dim"],
              n_cross_layers=params["n_cross_layers"], n_res_blocks=params["n_res_blocks"],
              dropout=float(params["dropout"]))
    tkw = dict(lr=float(params["lr"]), batch_size=params["batch_size"],
               weight_decay=float(params["weight_decay"]), optimizer=params["optimizer"],
               lr_plateau_patience=params["lr_plateau_patience"],
               lr_plateau_factor=params["lr_plateau_factor"], n_epochs=n_epochs, early_stop_patience=5,
               eval_batch_size=512, **train)
    return kw, tkw


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> str:
    d = tmp_path_factory.mktemp("hpo_data")
    write_synthetic_dataset(str(d), n_users=200, n_items=80, n_reviews=3000, seed=11)
    return str(d)


@pytest.fixture(scope="module")
def port_data(data_dir):
    splits, art = port_splits(os.path.join(data_dir, REVIEWS))
    return splits, ModelDims.from_artifacts(art)


# ---- space, samplers, pruners, study: copies of the JAX modules -------------


def test_reference_space_is_jaxs():
    want, got = jax_space.reference_search_space(), space.reference_search_space()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name]), name


def _history(n: int, seed: int) -> list:
    """``n`` (params, value) pairs drawn from the JAX random sampler, some
    values non-finite (skipped by TPE) and one param missing."""
    rng = np.random.default_rng(seed)
    s = jax_sampler.RandomSampler(seed)
    hist = [(s.sample(jax_space.reference_search_space(), []), float(rng.uniform(0.4, 0.7))) for _ in range(n)]
    if n > 5:
        hist[3] = (hist[3][0], float("nan"))
        del hist[5][0]["lr"]
    return hist


@pytest.mark.parametrize("kind,n_hist", [("random", 0), ("tpe", 4), ("tpe", 30), ("tpe", 120)])
def test_samplers_propose_jaxs_params_bit_for_bit(kind, n_hist):
    hist = _history(n_hist, seed=n_hist)
    make = {"random": lambda m: m.RandomSampler(5), "tpe": lambda m: m.TPESampler(5)}[kind]
    ours, theirs = make(sampler), make(jax_sampler)
    sp, jsp = space.reference_search_space(), jax_space.reference_search_space()
    for _ in range(12):
        assert ours.sample(sp, hist) == theirs.sample(jsp, hist)


@pytest.mark.parametrize("mode", ["independent", "shared", "fixed"])
def test_study_ask_is_jaxs(mode):
    """Study.ask, plain, with ``shared=ARCH_KEYS`` and with ``fixed=``, after
    the same told trials: the same proposals, in the same numbering."""
    fixed = {k: v for k, v in _trial(1e-3, 1e-5, 0.2).items() if k in ARCH_KEYS}
    fixed["batch_size"] = 512
    kw = {"independent": {}, "shared": {"shared": ARCH_KEYS}, "fixed": {"fixed": fixed}}[mode]
    ours, theirs = study.Study(seed=9), jax_study.Study(seed=9)
    for round_ in range(4):
        a = ours.ask(space.reference_search_space(), 8, **kw)
        b = theirs.ask(jax_space.reference_search_space(), 8, **kw)
        assert [(t.number, t.params) for t in a] == [(t.number, t.params) for t in b]
        for i, (ta, tb) in enumerate(zip(a, b)):
            value = 0.5 + 0.01 * ((7 * i + round_) % 11)
            ta.report(value, 0)
            tb.report(value, 0)
            ours.tell(ta, "complete" if i % 3 else "pruned", value)
            theirs.tell(tb, "complete" if i % 3 else "pruned", value)
    assert ours.trials == theirs.trials


@pytest.mark.parametrize("make", [
    lambda m: m.MedianPruner(), lambda m: m.MedianPruner(n_startup_trials=2, n_warmup_steps=1),
    lambda m: m.SuccessiveHalvingPruner(), lambda m: m.SuccessiveHalvingPruner(2, 2), lambda m: m.NopPruner()],
    ids=["median", "median-warmup", "asha", "asha-2-2", "nop"])
def test_pruners_decide_as_jaxs(make):
    rng = np.random.default_rng(4)
    ours, theirs = make(pruner), make(jax_pruner)
    for _ in range(200):
        n = int(rng.integers(0, 12))
        curves = [{s: (float("nan") if rng.random() < 0.05 else float(rng.uniform(0.4, 0.8)))
                   for s in range(int(rng.integers(0, 6)))} for _ in range(n)]
        step, value = int(rng.integers(0, 5)), float(rng.uniform(0.4, 0.8))
        done, everyone = curves[: n // 2], curves
        assert ours.should_prune(step, value, done, everyone) == theirs.should_prune(step, value, done, everyone)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_of_either_package_resumes_in_the_other(tmp_path, writer):
    path = str(tmp_path / "j.jsonl")
    write_mod = jax_study if writer == "jax" else study
    write_space = (jax_space if writer == "jax" else space).reference_search_space()
    w = write_mod.Study(journal_path=path, seed=2)
    for i, t in enumerate(w.ask(write_space, 6, shared=ARCH_KEYS)):
        t.report(0.6 - 0.01 * i, 0)
        t.report(float("nan") if i == 4 else 0.55, 1)
        t.set_user_attr("val_auc", 0.8)
        w.tell(t, ["complete", "pruned", "failed"][i % 3], 0.5 + 0.01 * i, error="boom" if i % 3 == 2 else None)
    w.tell(w.ask(write_space, 1)[0], "complete", float("inf"))  # recorded as failed
    ours, theirs = study.Study(journal_path=path, seed=2), jax_study.Study(journal_path=path, seed=2)
    assert len(ours.trials) == len(theirs.trials) == 7
    assert json.dumps(ours.trials, sort_keys=True) == json.dumps(theirs.trials, sort_keys=True)
    assert ours.best_value == theirs.best_value
    a = ours.ask(space.reference_search_space(), 4)
    b = theirs.ask(jax_space.reference_search_space(), 4)
    assert [(t.number, t.params) for t in a] == [(t.number, t.params) for t in b]


@pytest.mark.parametrize("shared", [(), ARCH_KEYS], ids=["independent", "arch-major"])
def test_port_study_resumes_the_hpo_r5_journal_and_asks_as_jax(tmp_path, shared):
    """The shipped 300-trial journal (JAX-written) resumes in the port's
    Study; the next 8 asks equal the JAX Study's, and so do the best trial
    and the parameter importances."""
    ours = study.Study(journal_path=str(HPO_R5_JOURNAL), seed=0)
    theirs = jax_study.Study(journal_path=str(HPO_R5_JOURNAL), seed=0)
    assert len(ours.trials) == 300
    assert ours.best_params == theirs.best_params and ours.best_value == theirs.best_value
    a = ours.ask(space.reference_search_space(), 8, shared=shared)
    b = theirs.ask(jax_space.reference_search_space(), 8, shared=shared)
    assert [(t.number, t.params) for t in a] == [(t.number, t.params) for t in b]
    assert a[0].number == 300
    assert plots.param_importances(ours.trials) == jax_plots.param_importances(theirs.trials)


def test_optuna_backend_is_gated_as_in_jax(monkeypatch):
    """backend="optuna" imports optuna only when asked; without it, both
    packages raise ImportError there and fall back from "auto"."""
    import builtins

    real = builtins.__import__

    def no_optuna(name, *a, **kw):
        if name == "optuna":
            raise ImportError("no optuna")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_optuna)
    monkeypatch.setenv("HHRS_HPO_OPTUNA", "1")
    for mod in (study, jax_study):
        with pytest.raises(ImportError):
            mod.create_study(None, backend="optuna")
        assert isinstance(mod.create_study(None, backend="auto"), mod.Study)


# ---- run_group ----------------------------------------------------------------


def test_group_trials_partitions_by_shape_and_optimizer():
    trials = [_trial(1e-3, 1e-5, 0.2), _trial(3e-3, 1e-4, 0.5), _trial(1e-3, 1e-5, 0.2, optimizer="adam"),
              {**_trial(1e-3, 1e-5, 0.2), "hidden_dim": 64}]
    groups = group_trials(trials)
    assert sorted(len(v) for v in groups.values()) == [1, 1, 2]
    assert groups[arch_key(trials[0])] == [0, 1]


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_lanes_reproduce_the_sequential_trainer_with_dropout(port_data, optimizer, record_property):
    """Each lane of a 3-trial group reproduces the port's sequential
    train_dcn with the same hyperparams, dropout on: one uniform draw per
    dropout site and step, each lane keeping its own probability."""
    splits, dims = port_data
    trials = [_trial(3e-3, 1e-5, 0.2, optimizer), _trial(1e-3, 1e-4, 0.5, optimizer, patience=2, factor=0.1),
              _trial(5e-2, 1e-6, 0.1, optimizer, patience=0)]  # hot lr, patience 0: the plateau decays
    mkw, tkw = _cfgs(trials[0])
    group = run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), trials, device="cpu")
    worst = 0.0
    for t, lane in zip(trials, group):
        mkw, tkw = _cfgs(t)
        seq = train_dcn(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), device="cpu")
        assert len(lane.history) == len(seq.history) == 3
        for a, b in zip(lane.history, seq.history):
            assert a["val_loss"] == pytest.approx(b["val_loss"], **LANE_BAR)
            assert a["train_loss"] == pytest.approx(b["train_loss"], **LANE_BAR)
            assert a["lr"] == b["lr"]
            worst = max(worst, abs(a["val_loss"] / b["val_loss"] - 1), abs(a["train_loss"] / b["train_loss"] - 1))
        assert lane.best_epoch == seq.best_epoch
        assert lane.best_val_loss == pytest.approx(seq.best_val_loss, **LANE_BAR)
        assert lane.final_metrics["val_auc"] == pytest.approx(seq.final_metrics["val_auc"], abs=AUC_BAR)
        assert lane.final_metrics["val_logloss"] == pytest.approx(seq.final_metrics["val_logloss"], **LANE_BAR)
        for key in ("params", "bn_state"):
            want = getattr(seq, key)
            assert jax.tree.structure(getattr(lane, key)) == jax.tree.structure(want)
    assert len({h["lr"] for h in group[2].history}) > 1  # a plateau decision was taken
    assert group[0].group_examples_per_s == pytest.approx(3 * group[0].examples_per_s)
    record_property("max_rel_gap", worst)


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_group_matches_jax_run_group_at_dropout_0(data_dir, optimizer):
    """The port's run_group against JAX's from the same initialization
    (JAX's init of PRNGKey(seed), handed to the port as init_state), the
    same splits and batches, dropout 0: each lane at the trajectory bars."""
    csv = os.path.join(data_dir, REVIEWS)
    jsplits, art = jax_splits(csv)
    jdims = JaxModelDims.from_artifacts(art)
    splits, _ = port_splits(csv)
    trials = [_trial(3e-3, 1e-5, 0.0, optimizer), _trial(1e-2, 1e-4, 0.0, optimizer, patience=0)]
    mkw, tkw = _cfgs(trials[0], n_epochs=3, seed=3)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(3))
    params, bn_state = jax.tree.map(np.asarray, init_dcn(init_rng, jdims, JaxModelConfig(**mkw)))
    want = jax_run_group(jsplits, jdims, JaxModelConfig(**mkw), JaxTrainConfig(**tkw), trials)
    got = run_group(splits, port_dims(jdims), ModelConfig(**mkw), TrainConfig(**tkw), trials,
                    init_state=(params, bn_state), device="cpu")
    for a, b in zip(got, want):
        assert len(a.history) == len(b.history)
        for ha, hb, bar in zip(a.history, b.history, TRAJECTORY):
            assert ha["val_loss"] == pytest.approx(hb["val_loss"], **bar)
            assert ha["lr"] == pytest.approx(hb["lr"])
        assert a.best_epoch == b.best_epoch
        assert a.final_metrics["val_logloss"] == pytest.approx(b.final_metrics["val_logloss"], **TRAJECTORY[-1])


# C4: the K-lane group at model.compute_dtype=bfloat16 (storage bf16 too).
# Bars: the bf16 trainer's bar, BF16_VAL_RTOL (1e-2 on the val loss; one
# bf16 ulp is 2^-7 relative), on every epoch; LR decisions and the best epoch
# equal. Measured on the CPU: the lanes equal their sequential bf16 trials
# (val loss gap 0, train loss ≤ 1.4e-7 relative); against JAX's bf16 group at
# dropout 0 up to 9.4e-3, where JAX's own bf16 group differs from its f32
# group by up to 1.2e-2 (XLA's CPU bf16 sums accumulate in bf16).
BF16 = dict(compute_dtype="bfloat16", storage_dtype="bfloat16")
BF16_BAR = dict(rel=1e-2)  # tests/test_torch_port_train.py BF16_VAL_RTOL


def test_bf16_lanes_reproduce_the_sequential_bf16_trainer(port_data, record_property):
    """C4: each lane of a 3-trial bf16 group (dropout on, a plateau decay)
    against the port's sequential bf16 train_dcn of its trial, at the bf16
    trainer's bar; the lanes' cross stack runs the trial axis on bf16 tensors."""
    splits, dims = port_data
    trials = [_trial(3e-3, 1e-5, 0.2), _trial(1e-3, 1e-4, 0.5, patience=2, factor=0.1),
              _trial(5e-2, 1e-6, 0.1, patience=0)]
    mkw, tkw = _cfgs(trials[0])
    group = run_group(splits, dims, ModelConfig(**mkw, **BF16), TrainConfig(**tkw), trials, device="cpu")
    worst = 0.0
    for t, lane in zip(trials, group):
        mkw, tkw = _cfgs(t)
        seq = train_dcn(splits, dims, ModelConfig(**mkw, **BF16), TrainConfig(**tkw), device="cpu")
        assert len(lane.history) == len(seq.history) == 3
        for a, b in zip(lane.history, seq.history):
            assert a["val_loss"] == pytest.approx(b["val_loss"], **BF16_BAR)
            assert a["train_loss"] == pytest.approx(b["train_loss"], **BF16_BAR)
            assert a["lr"] == b["lr"]
            worst = max(worst, abs(a["val_loss"] / b["val_loss"] - 1), abs(a["train_loss"] / b["train_loss"] - 1))
        assert lane.best_epoch == seq.best_epoch
        assert lane.final_metrics["val_logloss"] == pytest.approx(seq.final_metrics["val_logloss"], **BF16_BAR)
        assert lane.final_metrics["val_auc"] == pytest.approx(seq.final_metrics["val_auc"], abs=AUC_BAR)
        assert all(v.dtype == np.float32 for v in jax.tree.leaves(lane.params))
    assert len({h["lr"] for h in group[2].history}) > 1  # a plateau decision was taken
    record_property("max_rel_gap", worst)


def test_bf16_group_matches_jax_bf16_run_group_at_dropout_0(data_dir, record_property):
    """C4: the port's bf16 run_group against JAX's bf16 run_group from the
    same initialization, splits and batches, dropout 0: each lane's val loss
    at the bf16 trainer's bar in every epoch, the same LR decisions and best
    epoch."""
    csv = os.path.join(data_dir, REVIEWS)
    jsplits, art = jax_splits(csv)
    jdims = JaxModelDims.from_artifacts(art)
    splits, _ = port_splits(csv)
    trials = [_trial(3e-3, 1e-5, 0.0), _trial(1e-2, 1e-4, 0.0, patience=0)]
    mkw, tkw = _cfgs(trials[0], n_epochs=3, seed=3)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(3))
    params, bn_state = jax.tree.map(np.asarray, init_dcn(init_rng, jdims, JaxModelConfig(**mkw)))
    want = jax_run_group(jsplits, jdims, JaxModelConfig(**mkw, **BF16), JaxTrainConfig(**tkw), trials)
    got = run_group(splits, port_dims(jdims), ModelConfig(**mkw, **BF16), TrainConfig(**tkw), trials,
                    init_state=(params, bn_state), device="cpu")
    worst = 0.0
    for a, b in zip(got, want):
        assert len(a.history) == len(b.history)
        for ha, hb in zip(a.history, b.history):
            assert ha["val_loss"] == pytest.approx(hb["val_loss"], **BF16_BAR)
            assert ha["lr"] == pytest.approx(hb["lr"])
            worst = max(worst, abs(ha["val_loss"] / hb["val_loss"] - 1))
        assert a.best_epoch == b.best_epoch
        assert a.final_metrics["val_logloss"] == pytest.approx(b.final_metrics["val_logloss"], **BF16_BAR)
    record_property("max_rel_gap", worst)


def test_lane_pruning_and_early_stop_stay_isolated(port_data):
    """A pruned lane stops reporting while its siblings run to the cap; a
    lane that stops improving early-stops alone."""
    splits, dims = port_data
    trials = [_trial(1e-3, 1e-5, 0.2), _trial(3e-3, 1e-4, 0.3), _trial(1e-1, 1e-6, 0.1)]
    mkw, tkw = _cfgs(trials[0], n_epochs=4)
    tkw["early_stop_patience"] = 1
    reports = {0: [], 1: [], 2: []}

    def rf(k):
        def f(epoch, vl):
            reports[k].append(epoch)
            return k == 0 and epoch >= 1  # prune lane 0 at epoch 1

        return f

    res = run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), trials, report_fns=[rf(k) for k in range(3)],
                    device="cpu")
    assert res[0].pruned and not res[1].pruned and not res[2].pruned
    assert reports[0] == [0, 1] and len(res[0].history) == 2
    assert res[0].params is None and res[0].final_metrics == {}  # pruned lanes are not finalized
    for k in (1, 2):
        mkw_k, tkw_k = _cfgs(trials[k], n_epochs=4)
        tkw_k["early_stop_patience"] = 1
        seq = train_dcn(splits, dims, ModelConfig(**mkw_k), TrainConfig(**tkw_k), device="cpu")
        assert len(res[k].history) == len(seq.history) == len(reports[k])
        assert res[k].best_epoch == seq.best_epoch
    assert len(res[2].history) < 4  # lr 0.1 stops improving: early stop


def test_lane_reset_restores_the_fresh_init(port_data):
    """A refill's lane reset: its parameters, BatchNorm state, moments and
    step count back to the shared initialization; the other lanes keep
    theirs."""
    splits, dims = port_data
    mkw, _ = _cfgs(_trial(1e-3, 0.0, 0.0))
    model = DCNR(dims, ModelConfig(**mkw), generator=torch.Generator().manual_seed(0))
    lane = LaneDCNR(model, dims, 3)
    opt = LaneAdam(lane.flat, [1e-2] * 3, [1e-3] * 3, decoupled=True)
    batch = {"user": torch.as_tensor(splits.train_user[:64]), "item": torch.as_tensor(splits.train_item[:64]),
             "cat": torch.as_tensor(splits.train_cat[:64]), "num": torch.as_tensor(splits.train_num[:64])}
    logits = lane.forward(*batch.values(), train=True)
    grads = torch.autograd.grad(logits.square().sum(), lane.leaves)
    opt.step(lane.flat, torch.cat([g.reshape(3, -1) for g in grads], dim=1))
    before = (lane.flat.clone(), lane.flat_state.clone(), opt.m.clone())
    lane.reset_lane(1)
    opt.reset_lane(1)
    assert torch.equal(lane.flat[1], lane.init) and torch.equal(lane.flat_state[1], lane.init_state)
    assert not opt.m[1].any() and not opt.v[1].any() and float(opt.t[1]) == 0
    for k in (0, 2):
        assert torch.equal(lane.flat[k], before[0][k]) and torch.equal(lane.flat_state[k], before[1][k])
        assert torch.equal(opt.m[k], before[2][k]) and float(opt.t[k]) == 1
    assert not torch.equal(before[0][1], lane.init)  # the step had moved it


def test_reclamation_refills_dead_lanes(port_data):
    """With refill_fn a pruned lane is finalized and refilled at the epoch
    boundary with a new trial that trains a full epoch budget on its own
    clock; results hold every trial ever run, the initial K first."""
    splits, dims = port_data
    trials = [_trial(1e-3, 1e-5, 0.2), _trial(3e-3, 1e-4, 0.3)]
    mkw, tkw = _cfgs(trials[0], n_epochs=2)
    refills = [_trial(2e-3, 1e-5, 0.4)]
    epochs = {}

    def report(k):
        def f(epoch, vl):
            epochs.setdefault(k, []).append(epoch)
            return k == 0 and epoch == 0  # prune lane 0's first trial at once

        return f

    def refill_fn():
        if not refills:
            return None
        return refills.pop(), report("refill")

    res = run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), trials,
                    report_fns=[report(0), report(1)], refill_fn=refill_fn, device="cpu")
    assert len(res) == 3 and res[0].pruned and not res[1].pruned and not res[2].pruned
    assert epochs["refill"] == [0, 1] and [h["epoch"] for h in res[2].history] == [0, 1]
    assert res[2].history[0]["lr"] == pytest.approx(2e-3)
    assert res[2].params is not None and "val_auc" in res[2].final_metrics


def test_group_rejects_mixed_architectures_and_a_foreign_refill(port_data):
    splits, dims = port_data
    mkw, tkw = _cfgs(_trial(1e-3, 1e-5, 0.2), n_epochs=1)
    with pytest.raises(ValueError, match="architectures"):
        run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw),
                  [_trial(1e-3, 1e-5, 0.2), {**_trial(1e-3, 1e-5, 0.2), "hidden_dim": 64}], device="cpu")
    foreign = [{**_trial(1e-3, 1e-5, 0.2), "hidden_dim": 64}]
    with pytest.raises(ValueError, match="different architecture"):
        run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), [_trial(1e-3, 1e-5, 0.2)],
                  refill_fn=lambda: (foreign.pop(), None) if foreign else None, device="cpu")


def test_unported_group_options_raise(port_data):
    """``shard_lanes`` runs: outside a world this process is the one rank, and
    the group is the unsharded one bit for bit (the 2- and 4-rank worlds are
    ``tests/test_torch_port_mesh_hpo.py``'s); ``lazy_table_updates`` stays
    refused in groups, as in JAX."""
    splits, dims = port_data
    mkw, tkw = _cfgs(_trial(1e-3, 1e-5, 0.2), n_epochs=1)
    trials = [_trial(1e-3, 1e-5, 0.2), _trial(2e-3, 1e-5, 0.3)]
    sharded = run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), trials, shard_lanes=True, device="cpu")
    whole = run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), trials, device="cpu")
    for a, b in zip(sharded, whole):
        assert a.history == b.history and a.final_metrics == b.final_metrics
    with pytest.raises(ValueError, match="lazy_table_updates"):
        run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw, lazy_table_updates=True), trials,
                  device="cpu")


# ---- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sequential", "vectorized", "reclaim"])
def test_cli_runs_on_the_cpu(data_dir, tmp_path, mode):
    extra = {"sequential": [], "vectorized": ["--vectorize", "2"],
             "reclaim": ["--vectorize", "2", "--reclaim-lanes", "--pruner", "asha"]}[mode]
    journal, out = tmp_path / "j.jsonl", tmp_path / "best"
    rc = hpo_cli.main(["--data", data_dir, "--trials", "4", "--epochs", "2", "--out", str(out),
                       "--journal", str(journal), "--device", "cpu", *extra, "train.eval_batch_size=512"])
    assert rc == 0
    records = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["number"] for r in records] == [0, 1, 2, 3]
    done = [r for r in records if r["state"] == "complete"]
    assert done and all("val_auc" in r["user_attrs"] for r in done)
    manifest = json.loads((out / "manifest.json").read_text())
    best = min(done, key=lambda r: r["value"])
    assert manifest["model_config"]["dropout"] == pytest.approx(best["params"]["dropout"])
    assert manifest["model_config"]["hidden_dim"] == best["params"]["hidden_dim"]
    if mode != "sequential":
        assert all(r["user_attrs"]["group_examples_per_s"] >= r["user_attrs"]["examples_per_s"] for r in done)
    # resumed: the journal already holds the budget, so nothing more runs
    assert hpo_cli.main(["--data", data_dir, "--trials", "4", "--out", str(out), "--journal", str(journal),
                         "--device", "cpu", *extra]) == 0
    assert len(journal.read_text().splitlines()) == 4


@pytest.mark.parametrize("flags", [["--mesh", "2x1"], ["--vectorize", "2", "--vectorize-shard"]])
def test_cli_refuses_multi_device_flags_naming_a11(data_dir, tmp_path, flags, capsys):
    """The multi-device flags run (once refused naming ROADMAP A11c):
    ``--mesh 2x1`` launches a world of 2 CPU ranks, ``--vectorize-shard``
    on the CPU runs its one rank here; each writes one journal of its
    trials, and no usage error names A11."""
    journal = tmp_path / "j.jsonl"
    rc = hpo_cli.main(["--data", data_dir, "--device", "cpu", "--trials", "2", "--epochs", "1", "--journal",
                       str(journal), "--out", str(tmp_path / "best"), *flags, "train.eval_batch_size=512"])
    assert rc == 0 and "A11" not in capsys.readouterr().err
    records = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["number"] for r in records] == [0, 1]
    assert (tmp_path / "best" / "manifest.json").exists()


def test_cli_and_group_without_a_card_raise(port_data, data_dir, tmp_path, monkeypatch):
    """The device defaults to cuda: without a card the CLI and run_group
    raise, before any trial is journaled."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    splits, dims = port_data
    mkw, tkw = _cfgs(_trial(1e-3, 1e-5, 0.2), n_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_group(splits, dims, ModelConfig(**mkw), TrainConfig(**tkw), [_trial(1e-3, 1e-5, 0.2)])
    journal = tmp_path / "j.jsonl"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hpo_cli.main(["--data", data_dir, "--trials", "1", "--journal", str(journal), "--out", str(tmp_path)])
    assert not journal.exists()


def test_model_and_train_configs_from_params_are_jaxs():
    from hhrs_tpu.hpo import cli as jax_cli

    p = _trial(1e-3, 1e-5, 0.25, optimizer="adam")
    assert dataclasses.asdict(hpo_cli.model_cfg_from_params(p)) == dataclasses.asdict(
        jax_cli.model_cfg_from_params(p))
    assert dataclasses.asdict(hpo_cli.train_cfg_from_params(p)) == dataclasses.asdict(
        jax_cli.train_cfg_from_params(p))
