"""The rest of serve (ROADMAP A8): the exported ranker and the batch CLI of
the port against hhrs_tpu's, on the CPU.

* ``serve/export.py``: the hpo_r5 ranker recorded with ``torch.export``
  (``build_x0`` then ``hhrs::tower_eval``, symbolic batch) scores as JAX's
  StableHLO ``ExportedRanker`` at the tower's bar, 2e-5, from one file at
  several batch sizes; loading it needs no model code. Every other
  architecture, and every arch at bf16, records ``DCNR.forward`` with the
  operator ``hhrs::cross_stack_fwd``: f32 at 2e-5, bf16 at the bf16 model
  bar of ``tests/test_torch_port_model.py``, each bit for bit the engine's
  direct route.
* ``serve/batch_cli.py``: home cities are JAX's on ``data/``; every JSONL
  line is the port engine's ``recommend`` of the same request and the JAX
  batch CLI's line on the same artifact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hhrs_tpu.data.features import add_engineered_features as jax_features
from hhrs_tpu.data.ingest import load_reviews_csv as jax_load_reviews
from hhrs_tpu.serve.batch_cli import home_cities as jax_home_cities
from hhrs_tpu.serve.batch_cli import main as jax_batch_main
from hhrs_tpu.serve.export import ExportedRanker as JaxExportedRanker
from hhrs_tpu.serve.export import save_ranker as jax_save_ranker
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle
from hhrs_tpu_torch.serve import batch_cli, export
from hhrs_tpu_torch.serve.engine import RecommendationEngine, load_frames
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
DATA = REPO / "data"
TOL = dict(rtol=2e-5, atol=2e-5)  # the tower kernel's parity bar


def _batch(dims, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, dims.n_users, n).astype(np.int32), rng.integers(0, dims.n_items, n).astype(np.int32),
            np.stack([rng.integers(0, d, n) for _, d in dims.cat_dims], axis=1).astype(np.int32),
            rng.normal(size=(n, dims.n_num_features)).astype(np.float32))


@pytest.fixture(scope="module")
def exported(tmp_path_factory) -> dict:
    """The hpo_r5 ranker exported by both packages (JAX lowered for the CPU)."""
    tmp = tmp_path_factory.mktemp("export")
    paths = {"port": str(tmp / export.RANKER_FILE), "jax": str(tmp / "ranker.stablehlo")}
    export.save_ranker(load_artifact_bundle(str(ARTIFACT)), paths["port"], device="cpu")
    jax_save_ranker(jax_load_bundle(str(ARTIFACT)), paths["jax"], platforms=("cpu",))
    return paths


def test_exported_ranker_scores_as_jaxs_from_one_file(exported):
    """One program, batches of 1, 7 and 300 rows (the batch is symbolic):
    the logits of JAX's exported ranker at 2e-5; the program holds the
    registered tower operator and no model module."""
    dims = load_artifact_bundle(str(ARTIFACT)).dims
    ours = export.ExportedRanker.load(exported["port"], device="cpu")
    theirs = JaxExportedRanker.load(exported["jax"])
    ops = {str(n.target) for n in ours.program.graph.nodes if n.op == "call_function"}
    assert "hhrs.tower_eval.default" in ops
    for n in (1, 7, 300):
        batch = _batch(dims, n, seed=n)
        got = ours(*batch)
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs(*batch)), **TOL)


def test_loading_the_ranker_imports_no_model_code(exported):
    """A fresh process that imports the export module, loads the program
    and scores with it never imports ``hhrs_tpu_torch.models``."""
    code = (
        "import sys, torch\n"
        "from hhrs_tpu_torch.serve.export import ExportedRanker\n"
        f"r = ExportedRanker.load({exported['port']!r}, device='cpu')\n"
        "out = r([0, 1], [0, 1], [[0, 0], [1, 1]], torch.zeros(2, 11))\n"
        "assert out.shape == (2,) and bool(torch.isfinite(out).all())\n"
        "assert not [m for m in sys.modules if m.startswith('hhrs_tpu_torch.models')], 'model code imported'\n"
        "assert 'hhrs_tpu' not in sys.modules and 'jax' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_export_cli_writes_ranker_pt2(tmp_path, capsys):
    adir = tmp_path / "art"
    shutil.copytree(ARTIFACT, adir)
    assert export.main(["--artifacts", str(adir), "--device", "cpu"]) == 0
    ranker = export.ExportedRanker.load(str(adir / "ranker.pt2"), device="cpu")
    batch = _batch(load_artifact_bundle(str(adir)).dims, 5)
    assert torch.isfinite(ranker(*batch)).all()
    with pytest.raises(SystemExit):
        export.main(["--artifacts", str(adir), "--device", "cpu", "--platforms", "tpu,cpu"])
    assert "takes cuda and cpu only" in capsys.readouterr().err


# ---- every architecture and dtype (A8b) -----------------------------------------

ARCHS = ("dcnr", "cross_only", "deep_only", "dcn_mlp")
VARIANTS = ("code", "canonical")
DTYPES = ("float32", "bfloat16")  # compute and storage alike, as the tuned preset trains
CASES = [(a, d, v) for a in ARCHS for d in DTYPES for v in VARIANTS]
CASE_BATCHES = (1, 7, 300)


def random_artifact(out: str, arch: str, variant: str, dtype: str, seed: int = 0) -> str:
    """An artifact dir at hpo_r5's vocabulary with small seeded random
    weights of ``arch`` (BatchNorm state drawn too) at ``dtype``."""
    from hhrs_tpu_torch.config import ModelConfig
    from hhrs_tpu_torch.models.convert import jax_from_dcnr
    from hhrs_tpu_torch.models.dcn import DCNR
    from hhrs_tpu_torch.train.artifacts import export_artifacts

    base = load_artifact_bundle(str(ARTIFACT))
    cfg = ModelConfig(emb_dim=8, hidden_dim=32, n_cross_layers=2, n_res_blocks=2, arch=arch, cross_variant=variant,
                      compute_dtype=dtype, storage_dtype=dtype)
    params, bn_state = jax_from_dcnr(DCNR(base.dims, cfg, torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for block in bn_state["res_blocks"]:
        for bn in block.values():
            bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    export_artifacts(out, params, bn_state, cfg, base.dims, base.preproc, {})
    return out


def direct_route(bundle):
    """The engine's scoring route for a bundle, on the CPU: ``build_x0`` +
    the tower's plain version for an f32 dcnr bundle, ``DCNR.forward``
    otherwise."""
    from hhrs_tpu_torch.models.convert import dcnr_from_jax
    from hhrs_tpu_torch.ops import tower

    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg)
    ids = lambda a: torch.as_tensor(a, dtype=torch.int64)  # noqa: E731

    @torch.no_grad()
    def score(u, i, c, n):
        args = (ids(u), ids(i), ids(c), torch.as_tensor(n))
        if tower.uses_tower(bundle.model_cfg):
            return tower.tower_eval_ref(tower.fold_eval_params(model), tower.build_x0(model, *args),
                                        bundle.model_cfg.cross_variant)
        return model(*args)

    return score


@pytest.fixture(scope="module")
def case_exports(tmp_path_factory) -> dict:
    """(arch, dtype, variant) → (artifact dir, the port's ranker.pt2)."""
    tmp = tmp_path_factory.mktemp("cases")
    out = {}
    for arch, dtype, variant in CASES:
        adir = random_artifact(str(tmp / f"{arch}_{dtype}_{variant}"), arch, variant, dtype)
        out[(arch, dtype, variant)] = (adir, export.save_ranker(load_artifact_bundle(adir),
                                                                 os.path.join(adir, export.RANKER_FILE), "cpu"))
    return out


@pytest.mark.parametrize("arch,dtype,variant", CASES)
def test_every_arch_and_dtype_scores_as_jaxs_exported_ranker(case_exports, arch, dtype, variant):
    """Each arch × dtype × variant, exported by both packages, at B = 1, 7,
    300, bit for bit the engine's direct route for that bundle. f32: JAX's
    exported ranker at 2e-5. bf16, with dev = JAX's own largest |bf16 − f32|
    logit over the 308 rows: JAX's bf16 model (``apply_dcn``) within
    BF16_BAR · dev, the bf16 model bar; JAX's exported bf16 ranker is a
    separately compiled program that rounds bf16 intermediates elsewhere
    than ``apply_dcn`` (its 99th-percentile gap to ``apply_dcn`` is 0.31 ·
    dev for cross_only), so each row is held within JAX's own exported-to-
    model gap on that row plus BF16_BAR · dev."""
    from hhrs_tpu.models.dcn import apply_dcn
    from tests.test_torch_port_model import BF16_BAR

    adir, path = case_exports[(arch, dtype, variant)]
    jb = jax_load_bundle(adir)
    jpath = os.path.join(adir, "ranker.stablehlo")
    jax_save_ranker(jb, jpath, platforms=("cpu",))
    theirs = JaxExportedRanker.load(jpath)
    ours = export.ExportedRanker.load(path, device="cpu")
    direct = direct_route(load_artifact_bundle(adir))
    f32 = dataclasses.replace(jb.model_cfg, compute_dtype="float32", storage_dtype="float32")
    got, exported, applied, ref32 = [], [], [], []
    for n in CASE_BATCHES:
        batch = _batch(jb.dims, n, seed=n)
        out = ours(*batch)
        assert out.shape == (n,) and out.dtype == torch.float32
        assert torch.equal(out, direct(*batch)), "the exported program is not the direct route bit for bit"
        got.append(out.numpy())
        exported.append(np.asarray(theirs(*batch)))
        if dtype == "float32":
            np.testing.assert_allclose(got[-1], exported[-1], **TOL)
        else:
            applied.append(np.asarray(apply_dcn(jb.params, jb.bn_state, *batch, cfg=jb.model_cfg, train=False)[0]))
            ref32.append(np.asarray(apply_dcn(jb.params, jb.bn_state, *batch, cfg=f32, train=False)[0]))
    if dtype == "bfloat16":
        got, exported, applied, ref32 = (np.concatenate(a) for a in (got, exported, applied, ref32))
        dev = np.abs(applied - ref32).max()
        assert dev > 0 and np.abs(got - applied).max() <= BF16_BAR * dev
        jax_gap = np.abs(exported - applied)
        excess = np.abs(got - exported) - jax_gap
        assert excess.max() <= BF16_BAR * dev, (excess.max() / dev, jax_gap.max() / dev)


@pytest.mark.parametrize("arch,dtype,variant", CASES)
def test_exported_graph_holds_the_operators(case_exports, arch, dtype, variant):
    """``hhrs::cross_stack_fwd`` in every program with a cross stack,
    ``hhrs::tower_eval`` in the f32 dcnr program (whose cross stack is
    inside the tower), neither in deep_only's; no model module."""
    ranker = export.ExportedRanker.load(case_exports[(arch, dtype, variant)][1], device="cpu")
    ops = {str(n.target) for n in ranker.program.graph.nodes if n.op == "call_function"}
    tower_case = arch == "dcnr" and dtype == "float32"
    assert ("hhrs.tower_eval.default" in ops) == tower_case
    assert ("hhrs.cross_stack_fwd.default" in ops) == (arch != "deep_only" and not tower_case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cross_stack_fwd_operator_cpu_and_fake(dtype, variant):
    """The operator's CPU implementation is the plain stack bit for bit (and
    never aliases x0, even at L = 0); its fake gives ``[B, d]`` in x0's
    dtype for a symbolic batch; torch.library's checks pass."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from hhrs_tpu_torch.ops.cross import cross_stack_apply

    g = torch.Generator().manual_seed(0)
    x0, w, b = (torch.randn(s, generator=g).to(dtype) for s in ((37, 19), (3, 19), (3, 19)))
    got = torch.ops.hhrs.cross_stack_fwd(x0, w, b, variant)
    assert got.dtype == dtype and torch.equal(got, cross_stack_apply(w, b, x0, variant))
    empty = torch.ops.hhrs.cross_stack_fwd(x0, w[:0], b[:0], variant)
    assert torch.equal(empty, x0) and empty.data_ptr() != x0.data_ptr()
    with FakeTensorMode() as mode:
        fake = torch.ops.hhrs.cross_stack_fwd(mode.from_tensor(x0), mode.from_tensor(w), mode.from_tensor(b), variant)
    assert fake.shape == x0.shape and fake.dtype == dtype
    torch.library.opcheck(torch.ops.hhrs.cross_stack_fwd.default, (x0, w, b, variant))


def test_cross_stack_module_uses_the_operator_only_without_gradients():
    """``CrossStack`` calls the operator under no_grad (what export records)
    and the autograd path when a gradient is needed: the same values."""
    from hhrs_tpu_torch.ops.cross import CrossStack

    stack = CrossStack(3, 19, "code", torch.Generator().manual_seed(1))
    x0 = torch.randn(11, 19, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        traced = torch.export.export(stack, (x0,))
    ops = {str(n.target) for n in traced.graph.nodes if n.op == "call_function"}
    assert "hhrs.cross_stack_fwd.default" in ops
    y = stack(x0)
    assert y.requires_grad and y.grad_fn is not None
    with torch.no_grad():
        assert torch.equal(stack(x0), y.detach())


def test_export_cli_takes_every_arch_and_dtype(case_exports, tmp_path):
    """``serve.export``'s CLI on a bf16 cross_only and an f32 dcn_mlp bundle."""
    for key in (("cross_only", "bfloat16", "code"), ("dcn_mlp", "float32", "canonical")):
        out = str(tmp_path / f"{key[0]}.pt2")
        assert export.main(["--artifacts", case_exports[key][0], "--out", out, "--device", "cpu"]) == 0
        batch = _batch(load_artifact_bundle(case_exports[key][0]).dims, 5)
        assert torch.isfinite(export.ExportedRanker.load(out, device="cpu")(*batch)).all()


def test_engine_scores_a_bf16_artifact_through_dcnr_forward(case_exports):
    """An artifact trained at bf16 (the tuned preset) is scored at bf16 by
    ``DCNR.forward``, as the JAX engine scores it with ``apply_dcn``, not by
    the f32 tower; an f32 dcnr artifact through the tower."""
    frames = load_frames(str(DATA))
    for dtype, tower_route in (("bfloat16", False), ("float32", True)):
        adir = case_exports[("dcnr", dtype, "code")][0]
        eng = RecommendationEngine.from_dirs(adir, str(DATA), device="cpu", frames=frames)
        assert (eng._folded is not None) == tower_route
        batch = _batch(eng.bundle.dims, 9, seed=3)
        ids = lambda a: torch.as_tensor(a, dtype=torch.int64)  # noqa: E731
        with torch.no_grad():
            got = eng._logits(ids(batch[0]), ids(batch[1]), ids(batch[2]), torch.as_tensor(batch[3]))
        assert torch.equal(got, direct_route(eng.bundle)(*batch))


def test_export_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_ranker(load_artifact_bundle(str(ARTIFACT)))


# ---- the batch CLI ------------------------------------------------------------------


def test_home_cities_are_jaxs_on_data():
    got = batch_cli.home_cities(load_frames(str(DATA))[0])
    want = jax_home_cities(jax_features(jax_load_reviews(str(DATA / "hackathon_augmented_data.csv"))))
    assert got == {int(k): v for k, v in want.items()} and len(got) == 2000


def test_home_cities_break_ties_by_first_review():
    table = {"user_id": np.array([1, 1, 2, 1, 2, 2, 3]),
             "city": np.array(["B", "A", "C", "A", "D", "C", np.nan], dtype=object)}
    assert batch_cli.home_cities(table) == {1: "A", 2: "C"}
    table["city"][3] = "B"
    assert batch_cli.home_cities(table) == {1: "B", 2: "C"}


@pytest.fixture(scope="module")
def engine():
    return RecommendationEngine.from_dirs(str(ARTIFACT), str(DATA), device="cpu")


@pytest.mark.parametrize("case", ["limit", "city", "users"])
def test_batch_cli_lines_are_the_engines_and_jaxs(engine, tmp_path, case):
    users_file = tmp_path / "users.txt"
    users_file.write_text("\n".join(str(u) for u in (5, 17, 999999, 42, 1200, 7)))
    args = {"limit": ["--limit", "40", "--chunk", "16"],
            "city": ["--limit", "12", "--city", "Sochi", "--mode", "personal", "--lambda-param", "1.0",
                     "--chunk", "8"],
            "users": ["--users", str(users_file), "--chunk", "4"]}[case]
    common = ["--artifacts", str(ARTIFACT), "--data", str(DATA)]
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert batch_cli.main([*common, "--out", str(ours), "--device", "cpu", *args]) == 0
    assert jax_batch_main([*common, "--out", str(theirs), *args]) == 0
    lines = [json.loads(line) for line in ours.read_text().splitlines()]
    assert lines == [json.loads(line) for line in theirs.read_text().splitlines()]
    assert len(lines) == {"limit": 40, "city": 12, "users": 5}[case]  # the unknown user has no home city
    mode = "personal" if case == "city" else "friends"
    lam = 1.0 if case == "city" else 0.7
    for rec in lines:
        online = engine.recommend(rec["user_id"], rec["city"], mode, lam)
        assert rec["hotels"] == online.get("ranked_hotels", []), rec["user_id"]
    assert any(rec["hotels"] for rec in lines)
