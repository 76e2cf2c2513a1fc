"""Training-slice parity: the port's Preprocessor, trainer, weight carrier,
artifact export and trainer CLI (on the CPU) against hhrs_tpu's.

The golden file ``hhrs_tpu_torch/testdata/train_golden_hpo_r5.json`` holds
the JAX trainer's trajectory (per-epoch val loss, LR, final metrics) from
the hpo_r5 artifact's weights with the hpo_r5 trial-139 hyperparameters and
dropout 0; ``chip_smoke.py`` holds a training run on the card against it.
Regenerate it with ``python tests/test_torch_port_train.py --write``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # for the --write entry point
    sys.path.insert(0, str(REPO))

from hhrs_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from hhrs_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from hhrs_tpu.data.features import add_engineered_features as jax_features  # noqa: E402
from hhrs_tpu.data.ingest import load_reviews_csv as jax_load_reviews  # noqa: E402
from hhrs_tpu.data.ingest import noise_filter as jax_noise_filter  # noqa: E402
from hhrs_tpu.data.preprocess import Preprocessor as JaxPreprocessor  # noqa: E402
from hhrs_tpu.data.synthetic import write_synthetic_dataset  # noqa: E402
from hhrs_tpu.models.dcn import ModelDims as JaxModelDims  # noqa: E402
from hhrs_tpu.models.dcn import init_dcn  # noqa: E402
from hhrs_tpu.train.artifacts import export_artifacts as jax_export  # noqa: E402
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle  # noqa: E402
from hhrs_tpu.train.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from hhrs_tpu.train.trainer import _device_put_splits, make_train_step  # noqa: E402
from hhrs_tpu.train.trainer import train_dcn as jax_train_dcn  # noqa: E402
from hhrs_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from hhrs_tpu_torch.data.features import add_engineered_features  # noqa: E402
from hhrs_tpu_torch.data.ingest import load_reviews_csv, noise_filter  # noqa: E402
from hhrs_tpu_torch.data.preprocess import Preprocessor  # noqa: E402
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree, jax_from_dcnr  # noqa: E402
from hhrs_tpu_torch.models.dcn import ARCHS, ModelDims  # noqa: E402
from hhrs_tpu_torch.train import cli  # noqa: E402
from hhrs_tpu_torch.train.artifacts import export_artifacts, load_artifact_bundle  # noqa: E402
from hhrs_tpu_torch.train.serialization import msgpack_serialize  # noqa: E402
from hhrs_tpu_torch.train.checkpoint import TrainCheckpointer  # noqa: E402
from hhrs_tpu_torch.train.optimizers import make_optimizer  # noqa: E402
from hhrs_tpu_torch.train.trainer import split_tensors, train_dcn, train_step  # noqa: E402
from hhrs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests.test_torch_port_model import one_torch_thread  # noqa: E402,F401 — module fixture
from tests.torch_port_mesh_train_world import one_rank_world  # noqa: E402

ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
DATA = REPO / "data"
GOLDEN = REPO / "hhrs_tpu_torch/testdata/train_golden_hpo_r5.json"
REVIEWS = "hackathon_augmented_data.csv"
VAL_TOL = dict(rtol=2e-3, atol=2e-4)  # the bar of tests/test_parity_train.py
# The golden run's epochs after the first carry ~1e-3 of rounding noise
# (chip_smoke.py LATER_EPOCH_TOL). Its growth is measured leaf by leaf in
# test_training_steps_track_jax_leaf_by_leaf (PERF.md §6): float32
# gradient elements that are pure rounding noise become whole Adam steps
# of ±lr, and the trajectory amplifies them as it amplifies a one-ulp
# change of the JAX run's own start; it is not in the port.
LATER_EPOCH_TOL = dict(rtol=5e-3, atol=2e-4)
SMALL_MODEL = dict(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=1, dropout=0.0)
# The checkpoint tests' run (tests/test_checkpoint.py's, for the JAX trainer).
CKPT_TRAIN = dict(lr=3e-3, batch_size=256, n_epochs=6, early_stop_patience=10, eval_batch_size=1024)


def jax_splits(csv: str, **kw):
    return JaxPreprocessor(**kw).fit_transform(jax_features(jax_noise_filter(jax_load_reviews(csv))))


def port_splits(csv: str, **kw):
    return Preprocessor(**kw).fit_transform(add_engineered_features(noise_filter(load_reviews_csv(csv))))


def assert_same_splits(got, want) -> None:
    for name, ref in vars(want).items():
        arr = getattr(got, name)
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)


def port_dims(jdims: JaxModelDims) -> ModelDims:
    return ModelDims(jdims.n_users, jdims.n_items, jdims.cat_dims, jdims.n_num_features)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory) -> str:
    """~6k synthetic reviews (the size of tests/test_parity_train.py)."""
    data = tmp_path_factory.mktemp("synthetic")
    write_synthetic_dataset(str(data), n_users=300, n_items=80, n_reviews=6000, seed=11)
    return str(data)


def test_preprocessor_matches_jax_on_data_and_hpo_r5():
    csv = str(DATA / REVIEWS)
    want_splits, want_art = jax_splits(csv)
    splits, art = port_splits(csv)
    assert (splits.n_train, splits.n_val) == (want_splits.n_train, want_splits.n_val) == (17945, 4487)
    assert_same_splits(splits, want_splits)
    shipped = json.loads((ARTIFACT / "preproc.json").read_text())
    assert json.loads(json.dumps(art.to_json_dict())) == shipped
    assert json.loads(json.dumps(want_art.to_json_dict())) == shipped


def test_preprocessor_without_leakage_compat(synthetic):
    csv = os.path.join(synthetic, REVIEWS)
    want_splits, want_art = jax_splits(csv, leakage_compat=False)
    splits, art = port_splits(csv, leakage_compat=False)
    assert_same_splits(splits, want_splits)
    assert json.loads(json.dumps(art.to_json_dict())) == json.loads(json.dumps(want_art.to_json_dict()))


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_trainer_matches_jax_trainer(synthetic, optimizer):
    splits, art = jax_splits(os.path.join(synthetic, REVIEWS))
    jdims = JaxModelDims.from_artifacts(art)
    # lr high enough, and patience 0, that the plateau scheduler decays once
    tkw = dict(optimizer=optimizer, lr=0.01, batch_size=256, n_epochs=3, seed=3,
               eval_batch_size=1024, lr_plateau_patience=0, lr_plateau_factor=0.5,
               early_stop_patience=10)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(5), jdims, JaxModelConfig(**SMALL_MODEL)))

    want = jax_train_dcn(splits, jdims, JaxModelConfig(**SMALL_MODEL), JaxTrainConfig(**tkw),
                         init_state=(params, bn_state))
    got = train_dcn(splits, port_dims(jdims), ModelConfig(**SMALL_MODEL), TrainConfig(**tkw),
                    init_state=(params, bn_state), device="cpu")

    np.testing.assert_allclose([h["val_loss"] for h in got.history],
                               [h["val_loss"] for h in want.history], **VAL_TOL)
    lrs = [h["lr"] for h in want.history]
    assert [h["lr"] for h in got.history] == lrs and len(set(lrs)) > 1
    assert got.final_metrics["val_logloss"] == pytest.approx(want.final_metrics["val_logloss"], **{
        "rel": VAL_TOL["rtol"], "abs": VAL_TOL["atol"]})
    assert got.final_metrics["val_auc"] == pytest.approx(want.final_metrics["val_auc"], abs=2e-3)
    assert got.best_epoch == want.best_epoch
    assert len(got.step_ms) == 2 * (splits.n_train // 256) and got.examples_per_s > 0


def test_golden_file_matches_its_recorded_config():
    golden = json.loads(GOLDEN.read_text())
    want = golden_configs()
    assert golden["model_config"] == dataclasses.asdict(want[0])
    assert golden["train_config"] == dataclasses.asdict(want[1])
    assert [h["lr"] for h in golden["history"]] == [want[1].lr] * want[1].n_epochs
    assert golden["n_train"] == 17945 and golden["n_val"] == 4487


def test_port_reproduces_the_golden_trajectory_on_the_cpu():
    golden = json.loads(GOLDEN.read_text())
    model_cfg, train_cfg = golden_configs()
    bundle = load_artifact_bundle(str(ARTIFACT))
    splits, _ = port_splits(str(DATA / REVIEWS))
    got = train_dcn(splits, bundle.dims, model_cfg, train_cfg,
                    init_state=(bundle.params, bundle.bn_state), device="cpu")
    want = golden["history"]
    assert len(got.history) == len(want)
    for h, w, bar in zip(got.history, want, [VAL_TOL] + [LATER_EPOCH_TOL] * (len(want) - 1)):
        assert h["val_loss"] == pytest.approx(w["val_loss"], rel=bar["rtol"], abs=bar["atol"])
        assert h["lr"] == w["lr"]
    fm, gm = got.final_metrics, golden["final_metrics"]
    assert fm["val_logloss"] == pytest.approx(gm["val_logloss"], rel=VAL_TOL["rtol"], abs=VAL_TOL["atol"])
    assert fm["val_auc"] == pytest.approx(gm["val_auc"], abs=2e-3)


def test_fused_epoch_equals_the_per_step_run(synthetic):
    """train.fused_epoch runs the same batches through the same steps: at
    dropout 0 the CPU runs are bit-identical."""
    splits, art = port_splits(os.path.join(synthetic, REVIEWS))
    dims, mcfg = ModelDims.from_artifacts(art), ModelConfig(**SMALL_MODEL)
    tcfg = TrainConfig(**dict(CKPT_TRAIN, n_epochs=3))
    per_step = train_dcn(splits, dims, mcfg, tcfg, device="cpu")
    fused = train_dcn(splits, dims, mcfg, dataclasses.replace(tcfg, fused_epoch=True), device="cpu")
    assert fused.history == per_step.history
    assert_same_weights(fused, per_step)
    assert len(fused.step_ms) == 2 and fused.examples_per_s > 0  # one time an epoch after the first


def test_fused_epoch_with_dropout_learns(synthetic):
    splits, art = port_splits(os.path.join(synthetic, REVIEWS))
    mcfg = ModelConfig(**dict(SMALL_MODEL, dropout=0.2))
    res = train_dcn(splits, ModelDims.from_artifacts(art), mcfg,
                    TrainConfig(**dict(CKPT_TRAIN, n_epochs=3, fused_epoch=True)), device="cpu")
    assert np.isfinite(res.best_val_loss)
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]


def test_fused_epoch_matches_jax_fused_epoch(synthetic):
    """Both trainers with train.fused_epoch=True (JAX: the whole-epoch
    lax.scan) from the same weights, at the bars of the per-step parity test."""
    splits, art = jax_splits(os.path.join(synthetic, REVIEWS))
    jdims = JaxModelDims.from_artifacts(art)
    tkw = dict(lr=0.01, batch_size=256, n_epochs=3, seed=3, eval_batch_size=1024, lr_plateau_patience=0,
               lr_plateau_factor=0.5, early_stop_patience=10, fused_epoch=True)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(5), jdims, JaxModelConfig(**SMALL_MODEL)))
    want = jax_train_dcn(splits, jdims, JaxModelConfig(**SMALL_MODEL), JaxTrainConfig(**tkw),
                         init_state=(params, bn_state))
    got = train_dcn(splits, port_dims(jdims), ModelConfig(**SMALL_MODEL), TrainConfig(**tkw),
                    init_state=(params, bn_state), device="cpu")
    np.testing.assert_allclose([h["val_loss"] for h in got.history],
                               [h["val_loss"] for h in want.history], **VAL_TOL)
    np.testing.assert_allclose([h["train_loss"] for h in got.history],
                               [h["train_loss"] for h in want.history], **VAL_TOL)
    assert [h["lr"] for h in got.history] == [h["lr"] for h in want.history]
    assert got.best_epoch == want.best_epoch


def test_fused_epoch_and_slab_streaming_are_exclusive():
    tcfg = TrainConfig(fused_epoch=True, stream_slab_steps=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_dcn(None, ModelDims(4, 4, (), 1), ModelConfig(), tcfg, device="cpu")


def assert_same_weights(a, b) -> None:
    fa, fb = flatten_tree({"p": a.params, "s": a.bn_state}), flatten_tree({"p": b.params, "s": b.bn_state})
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_resume_matches_uninterrupted(synthetic, tmp_path, fused):
    """A run killed after 3 epochs and rerun to 6 from its checkpoints equals
    the uninterrupted 6-epoch run bit for bit (dropout on: the generator's
    state round-trips too)."""
    splits, art = port_splits(os.path.join(synthetic, REVIEWS))
    dims, mcfg = ModelDims.from_artifacts(art), ModelConfig(**dict(SMALL_MODEL, dropout=0.2))
    tcfg = TrainConfig(**dict(CKPT_TRAIN, fused_epoch=fused))
    full = train_dcn(splits, dims, mcfg, tcfg, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    part1 = train_dcn(splits, dims, mcfg, dataclasses.replace(tcfg, n_epochs=3), checkpoint_dir=ckpt,
                      device="cpu")
    assert len(part1.history) == 3
    part2 = train_dcn(splits, dims, mcfg, tcfg, checkpoint_dir=ckpt, device="cpu")
    assert [h["epoch"] for h in part2.history] == list(range(6))
    assert part2.history == full.history
    assert (part2.best_val_loss, part2.best_epoch) == (full.best_val_loss, full.best_epoch)
    assert part2.final_metrics == full.final_metrics
    assert_same_weights(part2, full)
    assert TrainCheckpointer(ckpt).epochs() == [3, 4, 5]  # the last three are kept


def test_resume_of_a_finished_run_trains_nothing(synthetic, tmp_path):
    splits, art = port_splits(os.path.join(synthetic, REVIEWS))
    dims, mcfg = ModelDims.from_artifacts(art), ModelConfig(**SMALL_MODEL)
    tcfg = TrainConfig(**dict(CKPT_TRAIN, n_epochs=3))
    first = train_dcn(splits, dims, mcfg, tcfg, checkpoint_dir=str(tmp_path), device="cpu")
    again = train_dcn(splits, dims, mcfg, tcfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert [h["epoch"] for h in again.history] == [0, 1, 2]
    assert again.step_ms == [] and again.examples_per_s == 0.0
    assert again.best_val_loss == first.best_val_loss
    assert_same_weights(again, first)


@pytest.mark.parametrize("stop", ["early_stop", "pruned"])
def test_resume_after_a_stop_trains_no_extra_epochs(synthetic, tmp_path, stop):
    """A run that early-stopped, or was pruned, and is resumed trains no
    further: the loop's stop conditions are checked again before it."""
    splits, art = port_splits(os.path.join(synthetic, REVIEWS))
    dims, mcfg = ModelDims.from_artifacts(art), ModelConfig(**SMALL_MODEL)
    if stop == "early_stop":  # patience 0: the first epoch without improvement stops
        tcfg, report = TrainConfig(**dict(CKPT_TRAIN, early_stop_patience=0)), None
    else:
        tcfg, report = TrainConfig(**CKPT_TRAIN), (lambda epoch, loss: epoch == 1)
    first = train_dcn(splits, dims, mcfg, tcfg, report_fn=report, checkpoint_dir=str(tmp_path), device="cpu")
    assert len(first.history) < 6
    second = train_dcn(splits, dims, mcfg, tcfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert second.history == first.history and second.pruned == first.pruned
    assert second.best_val_loss == first.best_val_loss
    assert_same_weights(second, first)


def test_cli_resumes_from_its_checkpoint_dir(synthetic, tmp_path):
    args = ["--data", synthetic, "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "model.hidden_dim=32", "train.batch_size=256"]
    assert cli.main([*args, "--out", str(tmp_path / "a"), "--epochs", "1"]) == 0
    assert TrainCheckpointer(str(tmp_path / "ckpt")).epochs() == [0]
    assert cli.main([*args, "--out", str(tmp_path / "b"), "--epochs", "2"]) == 0
    assert TrainCheckpointer(str(tmp_path / "ckpt")).epochs() == [0, 1]


PRE_BN_BIAS = re.compile(r"params\.res_blocks\.\d+\.layer[12]\.bias")


def _largest(rel: dict) -> tuple:
    return max(rel.items(), key=lambda kv: kv[1])


def _rel_gaps(got: dict, want: dict) -> dict:
    """Each leaf's relative difference in norm, ``got`` against ``want``."""
    return {k: float(np.linalg.norm(got[k].astype(np.float64) - want[k]) / np.linalg.norm(want[k])) for k in want}


def test_training_steps_track_jax_leaf_by_leaf(record_property):
    """The port's train_step beside the JAX step function on the same
    batches, from the hpo_r5 weights with dropout 0: after one step every
    parameter and running statistic is within 1e-5 of JAX's (relative, in
    norm), except the biases of the linears that feed a BatchNorm. Their
    exact gradient is zero, so Adam turns rounding noise into steps of
    about the LR whose sign neither side controls; they are recorded, with
    the largest difference after steps 5 and 35 (PERF.md §6). Recorded
    beside them: the same growth of JAX against itself, started one ulp
    apart in one element of ``final.kernel``, and the port's first
    float32 gradient against its float64 one."""
    model_cfg, train_cfg = golden_configs()
    B = train_cfg.batch_size
    jb, bundle = jax_load_bundle(str(ARTIFACT)), load_artifact_bundle(str(ARTIFACT))
    splits, _ = port_splits(str(DATA / REVIEWS))
    tx = jax_make_optimizer(train_cfg.optimizer, train_cfg.lr, train_cfg.weight_decay)
    jcfg = JaxModelConfig(**dataclasses.asdict(model_cfg))
    raw = make_train_step(jcfg, B, None, JaxTrainConfig(**dataclasses.asdict(train_cfg)))
    jstep = jax.jit(lambda p, b, o, d, perm, s, r: raw(p, b, o, tx.update, d, perm, s, r))
    params = jax.tree.map(jax.numpy.asarray, jb.params)
    bn, opt_state = jax.tree.map(jax.numpy.asarray, jb.bn_state), tx.init(params)
    twin = np_tree(jb.params)  # one ulp away from JAX's start
    kernel = twin["final"]["kernel"] = twin["final"]["kernel"].copy()
    kernel.flat[0] = np.nextafter(kernel.flat[0], np.float32(np.inf))
    twin = jax.tree.map(jax.numpy.asarray, twin)
    twin_bn, twin_opt = bn, tx.init(twin)
    perm = np.random.default_rng(train_cfg.seed).permutation(splits.n_train)[:splits.n_train // B * B]
    jdata, jperm, s = _device_put_splits(splits)[0], jax.numpy.asarray(perm, np.int32), np.int32(0)

    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, model_cfg, "cpu", train=True)
    opt = make_optimizer(train_cfg.optimizer, model.parameters(), train_cfg.lr, train_cfg.weight_decay)
    data, tperm = split_tensors(splits, "train", torch.device("cpu")), torch.as_tensor(perm)
    first = {k: v[tperm[:B]] for k, v in data.items()}
    grads = []
    for m in (copy.deepcopy(model), copy.deepcopy(model).double()):  # copies: a train-mode pass moves BN stats
        logits = m(first["user"], first["item"], first["cat"], first["num"].to(next(m.parameters()).dtype))
        torch.nn.functional.binary_cross_entropy_with_logits(logits, first["y"].to(logits.dtype)).backward()
        grads.append({n: p.grad.double().numpy() for n, p in m.named_parameters()})
        m.zero_grad(set_to_none=True)
    grad_rel = _rel_gaps(*grads)
    record_property("grad_f32_vs_f64_largest_rel", _largest({k: v for k, v in grad_rel.items()
                                                             if not PRE_BN_BIAS.fullmatch("params." + k)}))
    record_property("grad_pre_bn_bias_f32_vs_f64_rel", sorted(v for k, v in grad_rel.items()
                                                              if PRE_BN_BIAS.fullmatch("params." + k)))
    for step in range(1, 36):
        params, bn, opt_state, jloss, s_next = jstep(params, bn, opt_state, jdata, jperm, s, jax.random.PRNGKey(0))
        twin, twin_bn, twin_opt, _, _ = jstep(twin, twin_bn, twin_opt, jdata, jperm, s, jax.random.PRNGKey(0))
        s = s_next
        idx = tperm[(step - 1) * B: step * B]
        loss = train_step(model, opt, {k: v[idx] for k, v in data.items()}, None)
        if step not in (1, 5, 35):
            continue
        got = flatten_tree(dict(zip(("params", "bn_state"), jax_from_dcnr(model))))
        want = flatten_tree({"params": np_tree(params), "bn_state": np_tree(bn)})
        rel = _rel_gaps(got, want)
        noise = {k: v for k, v in rel.items() if PRE_BN_BIAS.fullmatch(k)}
        held = {k: v for k, v in rel.items() if k not in noise}
        assert len(noise) == 2 * model_cfg.n_res_blocks
        record_property(f"step{step}_largest_rel", _largest(held))
        record_property(f"step{step}_pre_bn_bias_rel", sorted(noise.values()))
        twin_rel = _rel_gaps(flatten_tree({"params": np_tree(twin), "bn_state": np_tree(twin_bn)}), want)
        record_property(f"step{step}_jax_one_ulp_twin_largest_rel", _largest({k: twin_rel[k] for k in held}))
        record_property(f"step{step}_jax_one_ulp_twin_pre_bn_bias_rel", sorted(twin_rel[k] for k in noise))
        if step == 1:
            assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
            assert max(held.values()) <= 1e-5, sorted(held.items(), key=lambda kv: -kv[1])[:5]


# bf16 training (compute + storage bf16). XLA's CPU reductions of bf16
# tensors (the VJP's bias and row sums) accumulate in bf16, the port's in
# f32 as the card's do, so the two bf16 backward passes differ by a share
# of the bf16 effect itself: measured on the hpo_r5 step below, up to 0.90
# of |JAX bf16 − JAX f32| per leaf (0.04 to 0.90), while the port's bf16
# gradients are no farther from JAX's f32 ones than JAX's bf16 ones are
# (0.52 to 1.04 of it).
BF16_GRAD_BAR = 1.0  # rel(port, JAX bf16) <= BF16_GRAD_BAR · rel(JAX bf16, JAX f32)
BF16_GRAD_F32_BAR = 1.25  # rel(port, JAX f32) <= BF16_GRAD_F32_BAR · rel(JAX bf16, JAX f32)
BF16_VAL_RTOL = 1e-2  # epoch 0's val loss against JAX's bf16 trainer (one bf16 ulp is 2^-7 relative)


def test_bf16_step_gradients_track_jax_leaf_by_leaf(record_property):
    """One step's gradients at compute + storage bf16 from the hpo_r5
    weights on a batch of data/, dropout 0, against jax.grad of the same
    loss through apply_dcn, leaf by leaf (relative, in norm), except the
    pre-BN biases (zero exact gradient, C1)."""
    from hhrs_tpu.models.dcn import apply_dcn

    model_cfg, train_cfg = golden_configs()
    B = train_cfg.batch_size
    jb, bundle = jax_load_bundle(str(ARTIFACT)), load_artifact_bundle(str(ARTIFACT))
    splits, _ = port_splits(str(DATA / REVIEWS))
    rows = np.random.default_rng(train_cfg.seed).permutation(splits.n_train)[:B]
    batch = {k: getattr(splits, f"train_{k}")[rows] for k in ("user", "item", "cat", "num", "y")}

    def jax_grads(cfg):
        def loss(p):
            x, _ = apply_dcn(p, jb.bn_state, batch["user"], batch["item"], batch["cat"], batch["num"],
                             cfg=cfg, train=True)
            y = batch["y"]
            return jax.numpy.mean(jax.numpy.maximum(x, 0) - x * y + jax.numpy.log1p(jax.numpy.exp(-abs(x))))
        return flatten_tree(np_tree(jax.grad(loss)(jax.tree.map(jax.numpy.asarray, jb.params))))

    bf16 = dict(compute_dtype="bfloat16", storage_dtype="bfloat16")
    jcfg = JaxModelConfig(**dataclasses.asdict(model_cfg))
    want32, want = jax_grads(jcfg), jax_grads(dataclasses.replace(jcfg, **bf16))
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, dataclasses.replace(model_cfg, **bf16),
                          "cpu", train=True)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(t["user"], t["item"], t["cat"], t["num"])
    assert logits.dtype == torch.float32
    torch.nn.functional.binary_cross_entropy_with_logits(logits, t["y"]).backward()
    got = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert got.keys() == want.keys()
    held = [k for k in want if not PRE_BN_BIAS.fullmatch("params." + k)]
    assert len(want) - len(held) == 2 * model_cfg.n_res_blocks
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    to_jax = {k: rel(got[k], want[k]) / rel(want[k], want32[k]) for k in held}
    to_f32 = {k: rel(got[k], want32[k]) / rel(want[k], want32[k]) for k in held}
    record_property("largest_share_to_jax_bf16", _largest(to_jax))
    record_property("largest_share_to_jax_f32", _largest(to_f32))
    assert max(to_jax.values()) <= BF16_GRAD_BAR, _largest(to_jax)
    assert max(to_f32.values()) <= BF16_GRAD_F32_BAR, _largest(to_f32)


def test_bf16_train_dcn_two_epochs_per_step_and_fused(synthetic):
    """train_dcn at compute + storage bf16, per step and under
    train.fused_epoch (bit-identical on the CPU): finite losses, f32
    exported params and BN state, and epoch 0's val loss within
    BF16_VAL_RTOL of JAX's bf16 trainer from the same weights."""
    splits, art = jax_splits(os.path.join(synthetic, REVIEWS))
    jdims = JaxModelDims.from_artifacts(art)
    bf16 = dict(SMALL_MODEL, compute_dtype="bfloat16", storage_dtype="bfloat16")
    tkw = dict(lr=0.01, batch_size=256, n_epochs=2, seed=3, eval_batch_size=1024, early_stop_patience=10)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(5), jdims, JaxModelConfig(**SMALL_MODEL)))
    want = jax_train_dcn(splits, jdims, JaxModelConfig(**bf16), JaxTrainConfig(**tkw), init_state=(params, bn_state))
    runs = [train_dcn(splits, port_dims(jdims), ModelConfig(**bf16), TrainConfig(**tkw, fused_epoch=fused),
                      init_state=(params, bn_state), device="cpu") for fused in (False, True)]
    assert runs[0].history == runs[1].history
    assert_same_weights(runs[0], runs[1])
    got = runs[0]
    assert len(got.history) == 2 and all(np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in got.history)
    leaves = {**flatten_tree(got.params), **flatten_tree(got.bn_state)}
    assert all(v.dtype == np.float32 for v in leaves.values())
    assert got.history[0]["val_loss"] == pytest.approx(want.history[0]["val_loss"], rel=BF16_VAL_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reverse_carrier_inverts_dcnr_from_jax(arch):
    jdims = JaxModelDims(n_users=30, n_items=20, cat_dims=(("city", 6), ("hotel_type", 5)),
                         n_num_features=11)
    kw = dict(SMALL_MODEL, arch=arch)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(1), jdims, JaxModelConfig(**kw)))
    got_params, got_bn = jax_from_dcnr(dcnr_from_jax(params, bn_state, port_dims(jdims), ModelConfig(**kw)))
    assert jax.tree.structure(got_params) == jax.tree.structure(params)
    assert jax.tree.structure(got_bn) == jax.tree.structure(bn_state)
    for a, b in zip(jax.tree.leaves((got_params, got_bn)), jax.tree.leaves((params, bn_state))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and into a module left in train mode
    model = dcnr_from_jax(params, bn_state, port_dims(jdims), ModelConfig(**kw), train=True)
    assert model.training and all(m.training for m in model.modules())
    for a, b in zip(jax.tree.leaves(jax_from_dcnr(model)), jax.tree.leaves((params, bn_state))):
        np.testing.assert_array_equal(a, b)


def test_port_export_loads_in_jax_bit_identically(tmp_path):
    bundle = load_artifact_bundle(str(ARTIFACT))
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg)
    params, bn_state = jax_from_dcnr(model)
    export_artifacts(str(tmp_path), params, bn_state, bundle.model_cfg, bundle.dims, bundle.preproc,
                     bundle.metrics, train_cfg=TrainConfig())
    theirs = jax_load_bundle(str(tmp_path))
    want = flatten_tree({"params": bundle.params, "bn_state": bundle.bn_state})
    got = flatten_tree(np_tree({"params": theirs.params, "bn_state": theirs.bn_state}))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert vars(theirs.model_cfg) == vars(bundle.model_cfg)
    assert theirs.dims.to_dict() == bundle.dims.to_dict()
    assert theirs.preproc.to_json_dict() == bundle.preproc.to_json_dict()
    np.testing.assert_array_equal(theirs.item_embeddings, bundle.item_embeddings)
    assert (tmp_path / "params.msgpack").read_bytes() == (ARTIFACT / "params.msgpack").read_bytes()


def test_msgpack_encoder_writes_the_bytes_of_the_jax_export():
    from flax import serialization

    rng = np.random.default_rng(0)
    tree = {"z": [rng.standard_normal((3, 4)).astype(np.float32), np.zeros((0, 7), np.float32)],
            "a": {f"k{i}": np.ones(i, np.uint8) for i in range(20)},
            "m": {"big": np.ones(70000, np.float32), "x" * 40: np.arange(5, dtype=np.int32)},
            "e": {}, "l": []}
    assert msgpack_serialize(tree) == serialization.to_bytes(jax.device_get(tree))


def test_jax_export_loads_in_the_port(tmp_path):
    jdims = JaxModelDims(n_users=30, n_items=20, cat_dims=(("city", 6),), n_num_features=11)
    params, bn_state = np_tree(init_dcn(jax.random.PRNGKey(2), jdims, JaxModelConfig(**SMALL_MODEL)))
    preproc = jax_load_bundle(str(ARTIFACT)).preproc
    jax_export(str(tmp_path), params, bn_state, JaxModelConfig(**SMALL_MODEL), jdims, preproc, {"x": 1.0})
    ours = load_artifact_bundle(str(tmp_path))
    got = flatten_tree({"params": ours.params, "bn_state": ours.bn_state})
    want = flatten_tree({"params": params, "bn_state": bn_state})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ours.metrics == {"x": 1.0} and ours.dims == port_dims(jdims)
    np.testing.assert_array_equal(ours.item_embeddings, params["item_embedding"])


def test_cli_trains_and_exports_on_the_cpu(synthetic, tmp_path):
    out = tmp_path / "artifact"
    assert cli.main(["--data", synthetic, "--out", str(out), "--epochs", "1", "--device", "cpu",
                     "model.hidden_dim=32", "train.batch_size=256"]) == 0
    theirs = jax_load_bundle(str(out))
    assert theirs.model_cfg.hidden_dim == 32
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["train_config"]["batch_size"] == 256 and manifest["train_config"]["n_epochs"] == 1
    assert np.isfinite(manifest["metrics"]["val_logloss"])
    assert load_artifact_bundle(str(out)).item_embeddings.shape == (theirs.dims.n_items, 16)


def test_cli_rejects_an_unknown_section(synthetic, tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--data", synthetic, "--out", str(tmp_path), "meshes.data_axis=2"])


@pytest.mark.parametrize("option,value,item", [
    ("mesh_resident_data", True, "ROADMAP A11"),
    ("mesh", "1x1", "ROADMAP A11"),
    ("explicit_exchange", "all_to_all", "ROADMAP A11"),
], ids=["mesh_resident_data-True-ROADMAP A11", "mesh-value1-ROADMAP A11",
        "explicit_exchange-all_to_all-ROADMAP A11"])
def test_unported_options_name_their_roadmap_item(synthetic, tmp_path, option, value, item):
    """Each mesh option runs (on a 1x1 mesh over a world of this process);
    beside lazy table updates, which a mesh does not run yet, it is refused
    naming its ROADMAP item (A11b2)."""
    splits, art = port_splits(os.path.join(synthetic, REVIEWS))
    dims = ModelDims.from_artifacts(art)
    tcfg = TrainConfig(batch_size=256, n_epochs=1, eval_batch_size=1024)
    kwargs = {}
    if option == "mesh_resident_data":
        tcfg.mesh_resident_data = value
    elif option == "explicit_exchange":
        kwargs[option] = value
    with one_rank_world(str(tmp_path)):
        mesh = make_mesh(1, 1, "cpu")
        result = train_dcn(splits, dims, ModelConfig(**SMALL_MODEL), tcfg, mesh=mesh, device="cpu", **kwargs)
        assert len(result.history) == 1 and np.isfinite(result.final_metrics["val_logloss"])
        with pytest.raises(NotImplementedError, match=item + "b2"):
            train_dcn(splits, dims, ModelConfig(**SMALL_MODEL), dataclasses.replace(tcfg, lazy_table_updates=True),
                      mesh=mesh, device="cpu", **kwargs)


def test_trainer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dcn(None, ModelDims(4, 4, (), 1), ModelConfig(), TrainConfig())


def golden_configs() -> tuple:
    """hpo_r5's winner (trial 139 of benchmarks/results/hpo_r5/journal.jsonl)
    with dropout 0 and 2 epochs: the parity run of chip_smoke.py."""
    manifest = json.loads((ARTIFACT / "manifest.json").read_text())
    model_cfg = ModelConfig(**dict(manifest["model_config"], dropout=0.0))
    train_cfg = TrainConfig(lr=0.006412302371102712, batch_size=512, weight_decay=0.10000000000000006,
                            optimizer="adamw", lr_plateau_patience=3, lr_plateau_factor=0.1,
                            n_epochs=2)
    return model_cfg, train_cfg


def make_golden() -> dict:
    model_cfg, train_cfg = golden_configs()
    bundle = jax_load_bundle(str(ARTIFACT))
    splits, _ = jax_splits(str(DATA / REVIEWS))
    result = jax_train_dcn(splits, bundle.dims, JaxModelConfig(**dataclasses.asdict(model_cfg)),
                           JaxTrainConfig(**dataclasses.asdict(train_cfg)),
                           init_state=(bundle.params, bundle.bn_state))
    return {
        "artifact": "benchmarks/results/hpo_r5/best",
        "data": "data",
        "model_config": dataclasses.asdict(model_cfg),
        "train_config": dataclasses.asdict(train_cfg),
        "n_train": splits.n_train,
        "n_val": splits.n_val,
        "history": result.history,
        "final_metrics": result.final_metrics,
    }


if __name__ == "__main__":
    if "--write" not in sys.argv:
        raise SystemExit("usage: python tests/test_torch_port_train.py --write")
    jax.config.update("jax_platforms", "cpu")
    GOLDEN.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
