"""The CUDA kernels (the fused tower, the cross stack forward and backward)
against their plain PyTorch versions, and a few training steps, on a card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
only torch and the port, so it also runs where JAX is absent::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import gc
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hhrs_tpu_torch import device as device_module
from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.device import capture_stream
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.ops import cross, tower
from hhrs_tpu_torch.train.optimizers import make_optimizer, set_learning_rate
from hhrs_tpu_torch.train.trainer import FusedEpoch, train_step

DIMS = ModelDims(n_users=2000, n_items=600, cat_dims=(("city", 6), ("hotel_type", 5)),
                 n_num_features=11)
TOL = dict(rtol=2e-5, atol=2e-5)  # the JAX kernel's own parity bar


def _model_and_x0(n_res: int, variant: str, B: int, seed: int = 0, hidden: int = 320):
    g = torch.Generator().manual_seed(seed)
    cfg = ModelConfig(emb_dim=48, hidden_dim=hidden, n_cross_layers=3, n_res_blocks=n_res,
                      cross_variant=variant)
    model = DCNR(DIMS, cfg, generator=g).eval()
    with torch.no_grad():  # non-trivial running statistics
        for block in model.res_blocks:
            for bn in (block.bn1, block.bn2):
                bn.mean.uniform_(-0.5, 0.5, generator=g)
                bn.var.uniform_(0.5, 2.0, generator=g)
    model = model.cuda()
    inputs = (
        torch.randint(0, DIMS.n_users, (B,), generator=g),
        torch.randint(0, DIMS.n_items, (B,), generator=g),
        torch.stack([torch.randint(0, 6, (B,), generator=g),
                     torch.randint(0, 5, (B,), generator=g)], dim=1),
        torch.rand(B, 11, generator=g),
    )
    with torch.no_grad():
        x0 = tower.build_x0(model, *(t.cuda() for t in inputs))
    return tower.fold_eval_params(model), x0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("hidden", [96, 100, 320])
@pytest.mark.parametrize("n_res,B", [(2, 1), (1, 33), (3, 128), (0, 200), (3, 1024), (3, 8192)])
def test_cuda_kernel_matches_plain_version(variant, hidden, n_res, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    f, x0 = _model_and_x0(n_res, variant, B, hidden=hidden)
    tower.plan_of(f, x0)  # the first call at these widths times every plan's wave
    before = tower.tower_eval.launches
    with torch.no_grad():
        out = tower.tower_eval(f, x0, variant)
        again = tower.tower_eval(f, x0, variant)
        torch.cuda.synchronize()
        assert tower.tower_eval.launches == before + 2
        assert torch.equal(again, out)  # a repeated launch repeats bit for bit
        ref = tower.tower_eval_ref(f, x0, variant)
        torch.testing.assert_close(out, ref, **TOL)
        # a row's logit does not depend on its position in the batch
        flipped = tower.tower_eval(f, x0.flip(0).contiguous(), variant).flip(0)
        assert torch.equal(flipped, out)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [100, 320])
def test_cuda_kernel_logits_do_not_depend_on_the_plan(hidden):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    f, x0 = _model_and_x0(3, "code", 8192, hidden=hidden)
    with torch.no_grad():
        full = tower.tower_eval(f, x0)
        for n in (1, 33, 128, 200, 1024):  # each prefix takes another plan than B = 8192
            assert torch.equal(tower.tower_eval(f, x0[:n].contiguous()), full[:n]), n
        part = x0[:200].contiguous()
        d, H = f["w0"].shape
        for plan in tower.tower_plans(d, H, f["cross_w"].shape[0], tower._device_limits(0)[0]):
            assert torch.equal(tower.launch(f, part, "code", plan), full[:200]), plan


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    f, x0 = _model_and_x0(1, "code", 16)
    with pytest.raises(TypeError, match="float32"):
        tower.tower_eval(f, x0.double())
    with pytest.raises(ValueError, match="contiguous"):
        tower.tower_eval(f, x0.t().contiguous().t())
    with pytest.raises(ValueError, match="features"):
        tower.tower_eval(f, x0[:, :-1].contiguous())
    with pytest.raises(ValueError, match="is on cpu"):
        tower.tower_eval(dict(f, b0=f["b0"].cpu()), x0)


CROSS_TOL = dict(rtol=1e-5, atol=1e-6)  # against cross_stack_term_scale


def _cross_inputs(B: int, d: int, L: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    return (f32(rng.uniform(-1, 1, (L, d)) / np.sqrt(d)), f32(0.1 * rng.standard_normal((L, d))),
            f32(rng.standard_normal((B, d))), f32(rng.standard_normal((B, d))))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L", [(1, 113, 3), (3, 113, 3), (5, 33, 2), (512, 113, 3), (1000, 33, 1),
                                   (4487, 113, 3), (8192, 113, 3), (77, 256, 6)])
def test_cuda_cross_kernels_match_plain_versions(variant, B, d, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(B, d, L)
    before = (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
    y = cross.cross_stack_forward(w, b, x0, variant)
    grads = cross.cross_stack_backward(w, b, x0, dy, variant)
    again = cross.cross_stack_backward(w, b, x0, dy, variant)
    torch.cuda.synchronize()
    assert (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches) == (
        before[0] + 1, before[1] + 2)
    ref = (cross.cross_stack_apply(w, b, x0, variant), *cross.cross_stack_backward_ref(w, b, x0, dy, variant))
    scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)
    for name, got, want, sc in zip(("y", "dx0", "dw", "db"), (y, *grads), ref, scale):
        cross.assert_close_to_scale(got, want, sc, **CROSS_TOL, what=name)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))  # deterministic sums


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L", [(4487, 113, 3), (1003, 256, 6), (37, 33, 1)])
def test_cuda_cross_outputs_do_not_depend_on_the_plan(variant, B, d, L):
    """y and dx0 are bit for bit the same under every plan: tile heights,
    rings of 1 to 3 stages that the blocks refill; dw and db follow the
    plan's sum order and stay at the term-scale bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(B, d, L, seed=3)
    y = cross.cross_stack_forward(w, b, x0, variant)
    dx0 = cross.cross_stack_backward(w, b, x0, dy, variant)[0]
    scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)
    ref = cross.cross_stack_backward_ref(w, b, x0, dy, variant)
    cap = cross.capacity(x0, True)
    for rows in (4, 8, 20, 32):
        tiles = -(-B // rows)
        for grid, stages in ((1, 1), (3, 3), (7, 2), (tiles, 1)):
            plan = cross.CrossPlan(rows, min(grid, tiles, cap), stages)
            assert torch.equal(cross.cross_stack_forward(w, b, x0, variant, plan), y), plan
            # the backward runs whole clusters of blocks
            plan = plan._replace(grid=-(-plan.grid // cross.CLUSTER) * cross.CLUSTER)
            got = cross.cross_stack_backward(w, b, x0, dy, variant, plan)
            assert torch.equal(got[0], dx0), plan
            for name, g, want, sc in zip(("dw", "db"), got[1:], ref[1:], scale[2:]):
                cross.assert_close_to_scale(g, want, sc, **CROSS_TOL, what=f"{name} {plan}")


@pytest.mark.cuda
def test_cuda_cross_capacity_is_asked_of_the_card():
    """The blocks a plan takes are those the card runs at once at the
    largest plan's shared memory: at d = 256 (about 108 KB a forward block)
    fewer than the 4 an SM that narrower rows get."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (33, 113, 256):
        x0 = torch.empty((1, d), device="cuda")
        for backward in (False, True):
            n = cross.capacity(x0, backward)
            assert 1 <= n <= cross.plan_capacity(sms, backward), (d, backward, n)
            assert cross.plan_of(torch.empty((100000, d), device="cuda"), backward).grid <= n
    assert cross.capacity(torch.empty((1, 256), device="cuda"), False) < cross.FWD_BLOCKS_PER_SM * sms


@pytest.mark.cuda
def test_cuda_cross_graph_replay_equals_eager_calls():
    """Forward and backward captured in a CUDA graph (the backward's scratch
    allocated in the capture, from the graph's pool) and replayed give the
    eager results bit for bit, also after the cache is emptied: the graph
    owns its scratch, and the tickets are back at 0 after every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(512, 113, 3, seed=4)
    want = (cross.cross_stack_forward(w, b, x0, "code"), *cross.cross_stack_backward(w, b, x0, dy, "code"))
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = cross.cross_stack_forward(w, b, x0, "code")
        grads = cross.cross_stack_backward(w, b, x0, dy, "code")
    for _ in range(3):
        for t in (y, *grads):
            t.fill_(float("nan"))
        torch.cuda.empty_cache()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, e) for g, e in zip((y, *grads), want))


@pytest.mark.cuda
def test_cuda_cross_backward_graphs_of_one_stream_replay_at_once():
    """Two backward graphs captured on one stream each own a scratch, so
    replayed at the same time on two streams (B = 8192: the launches
    overlap) each gives its eager dx0/dw/db bit for bit, 20 times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cases = [_cross_inputs(8192, 113, 3, seed=s) for s in (8, 9)]
    want = [cross.cross_stack_backward(w, b, x0, dy, "code") for w, b, x0, dy in cases]
    capture, graphs = torch.cuda.Stream(), []
    for w, b, x0, dy in cases:
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
        for (_, outs), w in zip(graphs, want):
            assert all(torch.equal(o, e) for o, e in zip(outs, w))


def _backward_step(model, batch) -> None:
    """One training step's forward and backward (no optimizer); nothing of
    its autograd graph outlives the call, so the next backward's gradient
    accumulators follow the stream it runs on."""
    logits = model(batch["user"], batch["item"], batch["cat"], batch["num"])
    torch.nn.functional.binary_cross_entropy_with_logits(logits, batch["y"]).backward()


def _step_graph(model, batch, stream):
    """Capture :func:`_backward_step` of ``model`` on ``stream``, after an
    eager one there."""
    def step():
        _backward_step(model, batch)

    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream().wait_stream(stream)
    model.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        step()
    return graph


def _random_batch(B: int, g: torch.Generator) -> dict:
    batch = {
        "user": torch.randint(0, DIMS.n_users, (B,), generator=g),
        "item": torch.randint(0, DIMS.n_items, (B,), generator=g),
        "cat": torch.stack([torch.randint(0, 6, (B,), generator=g),
                            torch.randint(0, 5, (B,), generator=g)], dim=1),
        "num": torch.rand(B, 11, generator=g),
        "y": (torch.rand(B, generator=g) < 0.4).float(),
    }
    return {k: v.cuda() for k, v in batch.items()}


HPO_R5_MODEL = ModelConfig(emb_dim=48, hidden_dim=320, n_cross_layers=3, n_res_blocks=3, dropout=0.0)


@pytest.mark.cuda
def test_cuda_two_step_graphs_replay_at_once():
    """Two training-step graphs of two models (seeds 0 and 1), each
    captured on its model's stream from device.capture_stream, replayed at
    the same time on two other streams 20 times: every gradient of each
    equals its eager step's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    models, batches, want = [], [], []
    for seed in (0, 1):
        g = torch.Generator().manual_seed(seed)
        model, batch = DCNR(DIMS, HPO_R5_MODEL, generator=g).cuda().train(), _random_batch(8192, g)
        _backward_step(model, batch)
        want.append({n: p.grad.clone() for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
        models.append(model)
        batches.append(batch)
    graphs = [_step_graph(m, bt, capture_stream(m, torch.device("cuda"))) for m, bt in zip(models, batches)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(20):
        for graph, stream in zip(graphs, streams):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        for stream in streams:
            torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        assert [n for m, w in zip(models, want) for n, p in m.named_parameters() if not torch.equal(p.grad, w[n])] == []


class _Owner:
    pass


@pytest.mark.cuda
def test_cuda_capture_streams_are_never_shared():
    """device.capture_stream gives no two live owners one stream, frees an
    owner's stream when it is collected, and raises when every stream of
    PyTorch's pool has a live owner; engines and fused epochs take theirs
    from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    owners, handles = [], set()
    with pytest.raises(RuntimeError, match="captures for a live owner"):
        for _ in range(200):
            owners.append(_Owner())
            handles.add(capture_stream(owners[-1], dev).cuda_stream)
    assert len(handles) == len(owners) - 1  # the last claim found none free
    freed = owners.pop(0)
    index = torch.cuda.current_device()
    stream = {h for h in handles if device_module._capture_owners[(index, h)]() is freed}
    del freed
    gc.collect()
    assert capture_stream(_Owner(), dev).cuda_stream in stream
    del owners
    gc.collect()
    g = torch.Generator().manual_seed(0)
    model = DCNR(DIMS, HPO_R5_MODEL, generator=g).cuda().train()
    data = _random_batch(1024, g)
    fused = [FusedEpoch(model, make_optimizer("adamw", model.parameters(), 1e-3, 0.0, capturable_on=dev), data,
                        512, 2, torch.Generator(device=dev).manual_seed(0)) for _ in range(2)]
    assert fused[0].stream.cuda_stream != fused[1].stream.cuda_stream


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
def test_cuda_double_backward_is_exact(variant):
    """create_graph=True through CrossStackFn on the card: the first-order
    values come from one backward kernel launch, the second derivative
    from the closed form, so a Hessian-vector product equals the float64
    one; an ordinary backward launches the kernel too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, c = _cross_inputs(512, 113, 3, seed=6)
    v = _cross_inputs(512, 113, 3, seed=7)[:3]

    def hvp(fn, inputs, c, v):
        leaves = [t.clone().requires_grad_() for t in inputs]
        grads = torch.autograd.grad((fn(*leaves, variant) * c).sum(), leaves, create_graph=True)
        return torch.autograd.grad(sum((g * d).sum() for g, d in zip(grads, v)), leaves,
                                   materialize_grads=True)

    before = cross.cross_stack_backward.launches
    got = hvp(cross.CrossStackFn.apply, (w, b, x0), c, v)
    assert cross.cross_stack_backward.launches == before + 1  # the first-order values: one kernel launch
    exact = hvp(cross.cross_stack_apply, [t.double() for t in (w, b, x0)], c.double(), [t.double() for t in v])
    for name, g, ex in zip(("w", "b", "x0"), got, exact):
        cross.assert_close_to_scale(g, ex, ex.abs().max().expand_as(ex), **CROSS_TOL, what=f"HVP {name}")
    leaves = [t.clone().requires_grad_() for t in (w, b, x0)]
    (cross.CrossStackFn.apply(*leaves, variant) * c).sum().backward()
    assert cross.cross_stack_backward.launches == before + 2


@pytest.mark.cuda
def test_cuda_cross_backward_is_one_kernel_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    w, b, x0, dy = _cross_inputs(8192, 113, 3)
    cross.cross_stack_backward(w, b, x0, dy, "code")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cross.cross_stack_backward(w, b, x0, dy, "code")
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "cross_" in e.key}
    assert sum(kernels.values()) == 3 and all("cross_bwd_kernel" in k for k in kernels), kernels


@pytest.mark.cuda
def test_cuda_cross_fn_matches_autograd_of_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(300, 113, 3, seed=1)
    grads = []
    for fn in (cross.CrossStackFn.apply, cross.cross_stack_apply):
        leaves = [t.clone().requires_grad_() for t in (w, b, x0)]
        fn(*leaves, "code").backward(dy)
        grads.append([t.grad for t in leaves])
    scale = cross.cross_stack_term_scale(w, b, x0, dy, "code")
    for got, want, sc, name in zip(grads[0], grads[1], (scale[2], scale[3], scale[1]), ("w", "b", "x0")):
        cross.assert_close_to_scale(got, want, sc, **CROSS_TOL, what=name)


@pytest.mark.cuda
def test_cuda_cross_wrapper_rejects_what_the_kernels_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(16, 33, 2)
    with pytest.raises(TypeError, match="float32"):
        cross.cross_stack(w.double(), b.double(), x0.double(), "code")
    with pytest.raises(ValueError, match="contiguous"):
        cross.cross_stack_forward(w, b, x0.t().contiguous().t(), "code")
    with pytest.raises(ValueError, match="contiguous"):
        cross.cross_stack_backward(w, b, x0, dy.t().contiguous().t(), "code")
    with pytest.raises(ValueError, match="is on cpu"):
        cross.cross_stack(w.cpu(), b, x0, "code")
    with pytest.raises(ValueError, match="d <= 256"):
        cross.cross_stack_forward(*_cross_inputs(4, 257, 1)[:3], "code")
    # contiguous but not on a 16-byte boundary: the kernels bulk-copy whole rows
    misaligned = torch.empty(16 * 33 + 1, device="cuda")[1:].view(16, 33).copy_(x0)
    with pytest.raises(ValueError, match="16-byte"):
        cross.cross_stack_forward(w, b, misaligned, "code")
    with pytest.raises(ValueError, match="16-byte"):
        cross.cross_stack_backward(w, b, misaligned, dy, "code")
    with pytest.raises(ValueError, match="16-byte"):
        cross.cross_stack_backward(w, b, x0, misaligned, "code")
    # CrossStackFn copies a misaligned input instead
    torch.testing.assert_close(cross.cross_stack(w, b, misaligned, "code"),
                               cross.cross_stack_forward(w, b, x0, "code"), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_training_steps_reduce_the_loss():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = torch.Generator().manual_seed(0)
    cfg = ModelConfig(emb_dim=48, hidden_dim=320, n_cross_layers=3, n_res_blocks=3, dropout=0.0)
    model = DCNR(DIMS, cfg, generator=g).cuda().train()
    tcfg = TrainConfig(lr=3e-3)
    opt = make_optimizer(tcfg.optimizer, model.parameters(), tcfg.lr, tcfg.weight_decay)
    B = 512
    batch = {
        "user": torch.randint(0, DIMS.n_users, (B,), generator=g),
        "item": torch.randint(0, DIMS.n_items, (B,), generator=g),
        "cat": torch.stack([torch.randint(0, 6, (B,), generator=g),
                            torch.randint(0, 5, (B,), generator=g)], dim=1),
        "num": torch.rand(B, 11, generator=g),
        "y": (torch.rand(B, generator=g) < 0.4).float(),
    }
    batch = {k: v.cuda() for k, v in batch.items()}
    before = (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
    losses = [float(train_step(model, opt, batch, None)) for _ in range(5)]
    assert (cross.cross_stack_forward.launches - before[0], cross.cross_stack_backward.launches - before[1]) == (5, 5)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
GOLDEN_SERVE = REPO / "hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json"
GOLDEN_TRAIN = REPO / "hhrs_tpu_torch/testdata/train_golden_hpo_r5.json"


@pytest.mark.cuda
def test_cuda_serving_graphs_equal_the_eager_path():
    """Every request of the golden sweep, served through the buckets' CUDA
    graphs, gives the eager path's JSON and the golden response (no tie
    swaps); batches of 3 and 8 with and without pad_to do too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    golden = json.loads(GOLDEN_SERVE.read_text())
    engine = RecommendationEngine.from_dirs(str(ARTIFACT), str(REPO / "data"), device="cuda")
    engine.warmup(batch_pad=8)
    assert set(engine._buckets) == {(1, False), (8, False)}
    for req, want in zip(golden["requests"], golden["responses"]):
        got = engine.recommend(*req)
        assert got == engine._recommend_eager([req])[0], req
        assert json.loads(json.dumps(got)) == want, req
    for K, pad_to in ((3, None), (3, 8), (8, None), (8, 8)):
        reqs = [golden["requests"][i] for i in golden["many"]][:K]
        got = engine.recommend_many(reqs, pad_to=pad_to)
        assert got == engine._recommend_eager(reqs, pad_to=pad_to)
        assert json.loads(json.dumps(got)) == [golden["responses"][i] for i in golden["many"]][:K]
    assert set(engine._buckets) == {(1, False), (4, False), (8, False)}


@pytest.mark.cuda
def test_cuda_fused_epoch_meets_the_golden_bars_and_repeats():
    """train.fused_epoch on the card (one graph replay an epoch after the
    first) from the hpo_r5 weights: the golden trajectory's bars, and a
    second run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.config import Config, TrainConfig as TC
    from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
    from hhrs_tpu_torch.train.cli import build_dataset
    from hhrs_tpu_torch.train.trainer import train_dcn

    golden = json.loads(GOLDEN_TRAIN.read_text())
    bundle = load_artifact_bundle(str(ARTIFACT))
    splits, _ = build_dataset(str(REPO / "data"), Config())
    mcfg, tcfg = ModelConfig(**golden["model_config"]), TC(**dict(golden["train_config"], fused_epoch=True))
    runs = [train_dcn(splits, bundle.dims, mcfg, tcfg, init_state=(bundle.params, bundle.bn_state),
                      device="cuda") for _ in range(2)]
    assert runs[0].history == runs[1].history
    for a, b in zip(runs[0].model.state_dict().values(), runs[1].model.state_dict().values()):
        assert torch.equal(a, b)
    bars = [dict(rtol=2e-3, atol=2e-4)] + [dict(rtol=5e-3, atol=2e-4)] * (len(golden["history"]) - 1)
    for h, w, bar in zip(runs[0].history, golden["history"], bars):
        assert h["val_loss"] == pytest.approx(w["val_loss"], rel=bar["rtol"], abs=bar["atol"])
        assert h["lr"] == w["lr"]


@pytest.mark.cuda
def test_cuda_fused_epoch_graph_reads_the_learning_rate():
    """The fused epoch's graph reads the LR from the optimizer's tensor: a
    replay after set_learning_rate(0) leaves every parameter bit for bit
    (AdamW at LR 0 moves nothing), one at the LR again moves them, and at
    a tenth of it they move less."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    model = DCNR(DIMS, HPO_R5_MODEL, generator=g).cuda().train()
    data, B, steps, lr = _random_batch(4096, g), 512, 8, 3e-3
    opt = make_optimizer("adamw", model.parameters(), lr, 0.1, capturable_on=dev)
    fused = FusedEpoch(model, opt, data, B, steps, torch.Generator(device=dev).manual_seed(0))
    perm = np.random.default_rng(0).permutation(4096)
    fused.run(perm)  # eager, then the capture
    assert fused.graph is not None

    def moved(rate: float) -> float:
        set_learning_rate(opt, rate)
        before = [p.detach().clone() for p in model.parameters()]
        fused.run(perm)
        torch.cuda.synchronize()
        return max(float((p.detach() - q).abs().max()) for p, q in zip(model.parameters(), before))

    assert moved(lr) > 0
    assert moved(0.0) == 0.0
    full, tenth = moved(lr), moved(lr / 10)
    assert 0 < tenth < full / 3, (tenth, full)


@pytest.mark.cuda
def test_cuda_fused_epoch_plateau_decay_meets_the_per_step_run():
    """From the hpo_r5 weights with lr_plateau_patience 0, the val loss
    rises after epoch 1 and the LR decays tenfold: the fused epochs replay
    the graph at the decayed LR and stay at the golden bars of the per-step
    run, with the same LR trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.config import Config, TrainConfig as TC
    from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
    from hhrs_tpu_torch.train.cli import build_dataset
    from hhrs_tpu_torch.train.trainer import train_dcn

    golden = json.loads(GOLDEN_TRAIN.read_text())
    bundle = load_artifact_bundle(str(ARTIFACT))
    splits, _ = build_dataset(str(REPO / "data"), Config())
    mcfg = ModelConfig(**golden["model_config"])
    runs = {}
    for fused in (False, True):
        tcfg = TC(**dict(golden["train_config"], n_epochs=4, lr_plateau_patience=0, fused_epoch=fused))
        runs[fused] = train_dcn(splits, bundle.dims, mcfg, tcfg, init_state=(bundle.params, bundle.bn_state),
                                device="cuda")
    lrs = [h["lr"] for h in runs[False].history]
    assert [h["lr"] for h in runs[True].history] == lrs
    assert min(lrs[:-1]) < lrs[0]  # a later epoch of the graph ran at a decayed LR
    bars = [dict(rtol=2e-3, atol=2e-4)] + [dict(rtol=5e-3, atol=2e-4)] * 3
    for h, w, bar in zip(runs[True].history, runs[False].history, bars):
        assert h["val_loss"] == pytest.approx(w["val_loss"], rel=bar["rtol"], abs=bar["atol"])


# ---- bf16 and the engine's options -----------------------------------------

CROSS_BF16_TOL = dict(rtol=2.0 ** -8, atol=0.0)  # bf16's unit roundoff, against the term scale


def _bf16(*tensors):
    return [t.to(torch.bfloat16).contiguous() for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L", [(1, 113, 3), (7, 113, 3), (9, 33, 2), (512, 113, 3), (1000, 33, 1),
                                   (4487, 113, 3), (8192, 113, 3), (77, 256, 6)])
def test_cuda_bf16_cross_kernels_match_plain_versions(variant, B, d, L):
    """The bf16 instantiation against the plain versions on the same bf16
    tensors, each launch counted as a bf16 launch; repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _bf16(*_cross_inputs(B, d, L, seed=5))
    before = (cross.cross_stack_forward.launches_bf16, cross.cross_stack_backward.launches_bf16,
              cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
    y = cross.cross_stack_forward(w, b, x0, variant)
    grads = cross.cross_stack_backward(w, b, x0, dy, variant)
    again = cross.cross_stack_backward(w, b, x0, dy, variant)
    torch.cuda.synchronize()
    assert (cross.cross_stack_forward.launches_bf16, cross.cross_stack_backward.launches_bf16,
            cross.cross_stack_forward.launches, cross.cross_stack_backward.launches) == (
        before[0] + 1, before[1] + 2, before[2], before[3])
    assert all(t.dtype == torch.bfloat16 for t in (y, *grads))
    ref = (cross.cross_stack_apply(w, b, x0, variant), *cross.cross_stack_backward_ref(w, b, x0, dy, variant))
    scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)
    for name, got, want, sc in zip(("y", "dx0", "dw", "db"), (y, *grads), ref, scale):
        cross.assert_close_to_scale(got, want, sc, **CROSS_BF16_TOL, what=name)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.cuda
def test_cuda_bf16_cross_graph_replay_and_mixed_dtypes():
    """bf16 forward and backward replayed from a CUDA graph equal the eager
    calls bit for bit; inputs of two dtypes raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _bf16(*_cross_inputs(512, 113, 3, seed=6))
    want = (cross.cross_stack_forward(w, b, x0, "code"), *cross.cross_stack_backward(w, b, x0, dy, "code"))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        outs = (cross.cross_stack_forward(w, b, x0, "code"), *cross.cross_stack_backward(w, b, x0, dy, "code"))
    for _ in range(2):
        for t in outs:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, want))
    with pytest.raises(TypeError, match="one dtype"):
        cross.cross_stack_forward(w.float(), b, x0, "code")


def _option_golden(name: str) -> dict:
    return json.loads((REPO / f"hhrs_tpu_torch/testdata/serve_golden_hpo_r5_{name}.json").read_text())


def _swaps(got: dict, want: dict, logits: list, tol: float) -> int:
    """Tie swaps of ``got`` against ``want``; raises outside the rule."""
    assert json.loads(json.dumps(got)).keys() == want.keys() and got.get("message") == want.get("message")
    g, w = json.loads(json.dumps(got))["ranked_hotels"], want["ranked_hotels"]
    assert len(g) == len(w)
    logit = {h["hotel_id"]: x for h, x in zip(w, logits)}
    payload = {h["hotel_id"]: h for h in w}
    swaps = 0
    for gh, wh in zip(g, w):
        assert gh == payload[gh["hotel_id"]]
        if gh["hotel_id"] != wh["hotel_id"]:
            assert abs(logit[gh["hotel_id"]] - logit[wh["hotel_id"]]) < tol
            swaps += 1
    return swaps


@pytest.mark.cuda
def test_cuda_option_engines_meet_their_golden_files():
    """quantize_tables against its golden file with 0 tie swaps (tower
    kernel); bf16 against its golden file under the bf16 swap bar, scored
    through the bf16 cross forward kernel; candidate_cap=16, city-bounded
    and not, equal to the uncapped engine, both branches taken; graphed
    equal to eager for each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    build = lambda **kw: RecommendationEngine.from_dirs(str(ARTIFACT), str(REPO / "data"), device="cuda", **kw)  # noqa: E731
    golden = json.loads(GOLDEN_SERVE.read_text())
    int8, bf16 = _option_golden("int8"), _option_golden("bf16")
    dev = max(abs(a - c) for xs, ys in zip(bf16["logits"], bf16["logits_f32"]) for a, c in zip(xs, ys))
    for engine, want, tol, no_swaps in ((build(quantize_tables=True), int8, 1e-4, True),
                                        (build(bf16=True), bf16, 0.05 * dev, False)):
        before = (tower.tower_eval.launches, cross.cross_stack_forward.launches_bf16)
        swaps = 0
        for req, resp, logits in zip(want["requests"], want["responses"], want["logits"]):
            got = engine.recommend(*req)
            assert got == engine._recommend_eager([req])[0], req
            swaps += _swaps(got, resp, logits, tol)
        assert swaps == 0 or not no_swaps
        grew = (tower.tower_eval.launches > before[0], cross.cross_stack_forward.launches_bf16 > before[1])
        assert grew == ((True, False) if no_swaps else (False, True))
    for cb in (True, False):
        capped, full = build(candidate_cap=16, city_bounded=cb), build(city_bounded=cb)
        for req in golden["requests"]:
            got = capped.recommend(*req)
            assert got == full.recommend(*req) == capped._recommend_eager([req], capped=True)[0], req
        assert min(capped.cap_branches.values()) > 0
        assert set(capped._buckets) == {(1, True), (1, False)}


# ---- the retraining path: the trainer's options and the tuned batch ---------

RETRAIN_MODEL = dict(emb_dim=16, hidden_dim=64, n_cross_layers=2, n_res_blocks=1, dropout=0.3)
RETRAIN_TRAIN = dict(batch_size=256, n_epochs=3, seed=7, eval_batch_size=1024, early_stop_patience=10)
CATALOG_RECALL_TOL = 0.01  # chip_smoke.py's bar: card against CPU on the same weights


@pytest.fixture(scope="module")
def retrain_data(tmp_path_factory):
    from hhrs_tpu_torch.config import Config
    from hhrs_tpu_torch.data.synthetic import write_synthetic_dataset
    from hhrs_tpu_torch.train.cli import build_dataset

    d = tmp_path_factory.mktemp("retrain")
    write_synthetic_dataset(str(d), n_users=400, n_items=300, n_reviews=12000, seed=21)
    splits, art = build_dataset(str(d), Config())
    return splits, ModelDims.from_artifacts(art)


def _retrain(splits, dims, **kw):
    from hhrs_tpu_torch.train.trainer import train_dcn

    return train_dcn(splits, dims, ModelConfig(**RETRAIN_MODEL), TrainConfig(**{**RETRAIN_TRAIN, **kw}),
                     device="cuda")


@pytest.mark.cuda
def test_cuda_slab_streaming_is_the_resident_run_bitwise(retrain_data):
    """Slabs of K steps copied from pinned buffers on a copy stream: the
    resident run's history and weights bit for bit, a ragged last slab too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    splits, dims = retrain_data
    resident = _retrain(splits, dims)
    for K in (3, 8):
        slab = _retrain(splits, dims, stream_slab_steps=K)
        assert slab.history == resident.history
        for a, b in zip(slab.model.state_dict().values(), resident.model.state_dict().values()):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_lazy_tables_train_through_the_cross_kernels(retrain_data):
    """Lazy table updates on the card: the cross kernels carry the row
    gradients; per step and from a CUDA graph (capturable row step) the
    runs meet each other at the trainer's bars and learn."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    splits, dims = retrain_data
    before = (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
    per_step = _retrain(splits, dims, lazy_table_updates=True)
    assert cross.cross_stack_forward.launches > before[0] and cross.cross_stack_backward.launches > before[1]
    fused = _retrain(splits, dims, lazy_table_updates=True, fused_epoch=True)
    bars = [dict(rel=2e-3, abs=2e-4)] + [dict(rel=5e-3, abs=2e-4)] * 2
    for a, b, bar in zip(fused.history, per_step.history, bars):
        assert a["val_loss"] == pytest.approx(b["val_loss"], **bar)
    assert per_step.history[-1]["val_loss"] < per_step.history[0]["val_loss"]


@pytest.mark.cuda
def test_cuda_lazy_row_step_is_deterministic(retrain_data):
    """The lazy row step sums a batch's duplicate rows in one order on the
    card (``index_add_``'s atomics would not): a row step with heavy
    duplicates, and a whole lazy run, repeat bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.train.lazy import row_adam_

    gen = np.random.default_rng(5)
    table0 = torch.as_tensor(gen.standard_normal((50, 16)), dtype=torch.float32, device="cuda")
    ids = torch.as_tensor(gen.integers(0, 10, 4096), device="cuda")  # ~400 copies of each id
    g_rows = torch.as_tensor(gen.standard_normal((4096, 16)), dtype=torch.float32, device="cuda")
    outs = []
    for _ in range(2):
        table, m, v = table0.clone(), torch.zeros_like(table0), torch.zeros_like(table0)
        row_adam_(table, m, v, ids, g_rows, 1, 1e-2, 0.1, True)
        outs.append((table, m, v))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert torch.equal(outs[0][0][10:], table0[10:])  # untouched rows frozen
    splits, dims = retrain_data
    a, b = (_retrain(splits, dims, lazy_table_updates=True) for _ in range(2))
    assert a.history == b.history
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_bf16_moments_per_step_and_fused(retrain_data, tmp_path):
    """moment_dtype=bfloat16 on the card: the fused (capturable) run meets
    the per-step run at the trainer's bars, and the checkpoint holds bf16
    first moments and f32 second moments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.train.checkpoint import TrainCheckpointer
    from hhrs_tpu_torch.train.trainer import train_dcn

    splits, dims = retrain_data
    per_step = _retrain(splits, dims, moment_dtype="bfloat16")
    fused = _retrain(splits, dims, moment_dtype="bfloat16", fused_epoch=True)
    bars = [dict(rel=2e-3, abs=2e-4)] + [dict(rel=5e-3, abs=2e-4)] * 2
    for a, b, bar in zip(fused.history, per_step.history, bars):
        assert a["val_loss"] == pytest.approx(b["val_loss"], **bar)
    train_dcn(splits, dims, ModelConfig(**RETRAIN_MODEL),
              TrainConfig(**{**RETRAIN_TRAIN, "n_epochs": 1}, moment_dtype="bfloat16", fused_epoch=True),
              checkpoint_dir=str(tmp_path), device="cuda")
    state, _ = TrainCheckpointer(str(tmp_path)).restore(0, torch.device("cpu"))
    for st in state["optimizer"]["state"].values():
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_debug_nans_raises_on_a_poisoned_batch(retrain_data, fused):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import dataclasses

    from hhrs_tpu_torch.train.trainer import train_dcn

    splits, dims = retrain_data
    num = splits.train_num.copy()
    num[5, 1] = np.nan
    tcfg = TrainConfig(**{**RETRAIN_TRAIN, "n_epochs": 1}, debug_nans=True, fused_epoch=fused)
    with pytest.raises(FloatingPointError):
        train_dcn(dataclasses.replace(splits, train_num=num), dims, ModelConfig(**RETRAIN_MODEL), tcfg, device="cuda")
    clean = train_dcn(splits, dims, ModelConfig(**RETRAIN_MODEL), tcfg, device="cuda")
    assert np.isfinite(clean.best_val_loss)


@pytest.mark.cuda
def test_cuda_catalog_recall_matches_the_cpu_on_the_same_weights(retrain_data):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.models.convert import dcnr_from_jax
    from hhrs_tpu_torch.train.eval_retrieval import catalog_recall_at_k

    splits, dims = retrain_data
    run = _retrain(splits, dims, eval_catalog_recall=True, n_epochs=2)
    cpu = catalog_recall_at_k(dcnr_from_jax(run.params, run.bn_state, dims, ModelConfig(**RETRAIN_MODEL)), splits)
    assert 0.0 < cpu < 1.0
    assert abs(run.final_metrics["catalog_recall_at_100"] - cpu) <= CATALOG_RECALL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["code", "canonical"])
def test_cuda_cross_kernels_at_the_tuned_batch(dtype, variant):
    """B = 32768, the tuned preset's batch: both instantiations against the
    plain versions at their bars, a repeated backward bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(32768, 113, 3, seed=9)
    tol = CROSS_TOL
    if dtype == "bfloat16":
        w, b, x0, dy = _bf16(w, b, x0, dy)
        tol = CROSS_BF16_TOL
    y = cross.cross_stack_forward(w, b, x0, variant)
    grads = cross.cross_stack_backward(w, b, x0, dy, variant)
    again = cross.cross_stack_backward(w, b, x0, dy, variant)
    ref = (cross.cross_stack_apply(w, b, x0, variant), *cross.cross_stack_backward_ref(w, b, x0, dy, variant))
    scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)
    for name, got, want, sc in zip(("y", "dx0", "dw", "db"), (y, *grads), ref, scale):
        cross.assert_close_to_scale(got, want, sc, **tol, what=name)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


# ---- the trial axis (vectorized HPO) and the exported ranker -----------------


def _trial_inputs(K: int, B: int, d: int, L: int, seed: int = 0):
    """K lanes of cross inputs, ``[K, L, d]`` weights and ``[K, B, d]`` rows."""
    lanes = [_cross_inputs(B, d, L, seed=seed + k) for k in range(K)]
    return tuple(torch.stack(t).contiguous() for t in zip(*lanes))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("K,B,d,L", [(8, 512, 113, 3), (3, 4487, 113, 3), (8, 4096, 209, 6), (2, 5, 33, 1)])
def test_cuda_trial_axis_lanes_are_the_single_trial_kernels(dtype, variant, K, B, d, L):
    """One trial-axis launch each way for K lanes: every lane's y and dx0 bit
    for bit the single-trial kernels' on that lane's inputs, its dw and db
    bit for bit the single-trial backward's under the trial plan (the same
    plan and sum order), a lane stride that is not a multiple of 16 bytes (B
    = 4487, 5) included; the launch counters count one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _trial_inputs(K, B, d, L, seed=11)
    if dtype == "bfloat16":
        w, b, x0, dy = _bf16(w, b, x0, dy)
    count = "launches_bf16" if dtype == "bfloat16" else "launches"
    before = (getattr(cross.cross_stack_forward_trials, count), getattr(cross.cross_stack_backward_trials, count))
    y = cross.cross_stack_forward_trials(w, b, x0, variant)
    grads = cross.cross_stack_backward_trials(w, b, x0, dy, variant)
    torch.cuda.synchronize()
    assert (getattr(cross.cross_stack_forward_trials, count),
            getattr(cross.cross_stack_backward_trials, count)) == (before[0] + 1, before[1] + 1)
    trial = cross.trial_plan_of(x0)
    for k in range(K):
        lane = [t[k].clone() for t in (w, b, x0, dy)]  # a lane of its own (the wrappers take 16-byte-aligned rows)
        assert torch.equal(y[k], cross.cross_stack_forward(*lane[:3], variant)), k
        assert torch.equal(grads[0][k], cross.cross_stack_backward(*lane, variant)[0]), k
        under = cross.cross_stack_backward(*lane, variant, plan=trial)
        assert all(torch.equal(g[k], u) for g, u in zip(grads, under)), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,B,d,L,bound", [(8, 512, 113, 3, 1.0), (8, 4096, 145, 6, 0.25), (64, 512, 113, 3, 1.0)])
def test_cuda_trial_plan_fits_the_card_and_sums_to_the_bar(dtype, K, B, d, L, bound):
    """The trial-axis backward's plan puts the K grids on the card at once
    (whole clusters of the size it chose, K x grid within the capacity at
    that size while some size fits them, a cluster of 8 a trial past it);
    each lane's dx0 is the single-trial kernel's
    under plan_of bit for bit, and its dw, db, summed in the trial plan's
    order, within the term-scale bar of the single-trial kernel's under
    plan_of and of the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(13)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous()  # noqa: E731
    x0, dy = f32(rng.standard_normal((K, B, d))), f32(rng.standard_normal((K, B, d)))
    w, b = f32(rng.uniform(-bound, bound, (K, L, d)) / np.sqrt(d)), f32(0.1 * rng.standard_normal((K, L, d)))
    tol = CROSS_TOL
    if dtype == "bfloat16":
        w, b, x0, dy = _bf16(w, b, x0, dy)
        tol = CROSS_BF16_TOL
    plan = cross.trial_plan_of(x0)
    caps = {c: cross.capacity(x0[0], True, c) for c in cross.CLUSTER_SIZES}
    assert plan.cluster in caps and plan.grid % plan.cluster == 0 and plan.grid >= plan.cluster
    assert plan == cross.trial_plan(B, K, tuple(caps.items()), cross.ROW_ALIGN[x0.dtype])
    if any(caps[c] // K >= c for c in caps):  # some cluster size puts the K grids on the card at once
        assert K * plan.grid <= caps[plan.cluster]
    else:
        assert (plan.cluster, plan.grid) == (cross.CLUSTER, cross.CLUSTER)
    dx0, dw, db = cross.cross_stack_backward_trials(w, b, x0, dy, "code")
    for k in (0, K - 1):
        single = cross.cross_stack_backward(w[k], b[k], x0[k], dy[k], "code")
        assert torch.equal(dx0[k], single[0])
        ref = cross.cross_stack_backward_ref(w[k], b[k], x0[k], dy[k], "code")
        scale = cross.cross_stack_term_scale(w[k], b[k], x0[k], dy[k], "code")
        for name, got, want, plain, sc in zip(("dw", "db"), (dw[k], db[k]), single[1:], ref[1:], scale[2:]):
            cross.assert_close_to_scale(got, want, sc, **tol, what=f"{name} lane {k} against plan_of's")
            cross.assert_close_to_scale(got, plain, sc, **tol, what=f"{name} lane {k} against the plain version")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("K,B,d,L", [(8, 512, 113, 3), (3, 4487, 113, 3), (8, 4096, 145, 6), (2, 5, 33, 1)])
def test_cuda_trial_forward_lanes_are_the_single_trial_kernel_under_every_plan(dtype, variant, K, B, d, L):
    """The trial-axis forward under its trial plan (the default: the K grids
    on the card at once), under the single-trial plan and under a small
    forced plan (three blocks, two tiles in flight, a warp's rows two at a
    time): every lane's y bit for bit the single-trial kernel's on its
    inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, _ = _trial_inputs(K, B, d, L, seed=29)
    if dtype == "bfloat16":
        w, b, x0 = _bf16(w, b, x0)
    cap = cross.capacity(x0[0], False)
    trial = cross.fwd_trial_plan_of(x0)
    assert trial == cross.fwd_trial_plan(B, K, cap, cross.ROW_ALIGN[x0.dtype]) and K * trial.grid <= cap
    single = [cross.cross_stack_forward(w[k], b[k], x0[k].clone(), variant) for k in range(K)]
    for plan in (None, cross.plan_of(x0[0], False), cross.CrossPlan(8, 3, 2)):
        y = cross.cross_stack_forward_trials(w, b, x0, variant, plan=plan)
        torch.cuda.synchronize()
        assert all(torch.equal(y[k], single[k]) for k in range(K)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L,seed", [(1, 113, 3, 5), (7, 113, 3, 5), (9, 33, 2, 5), (32768, 113, 3, 9)])
def test_cuda_bf16_forward_on_pairs_meets_the_plain_version(variant, B, d, L, seed):
    """The bf16 forward on bf16x2 pairs, a warp's rows two at a time where it
    has two (B = 9: warp 0 has rows 0 and 8): y within CROSS_BF16_TOL of the
    plain bf16 version on the inputs of the bf16 and tuned-batch tests, bit
    for bit under plan_of's plan, one block of 8-row tiles and a repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _bf16(*_cross_inputs(B, d, L, seed=seed))
    y = cross.cross_stack_forward(w, b, x0, variant)
    ref = cross.cross_stack_apply(w, b, x0, variant)
    scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)[0]
    cross.assert_close_to_scale(y, ref, scale, **CROSS_BF16_TOL, what="y")
    for plan in (None, cross.CrossPlan(8, 1, 3)):
        assert torch.equal(cross.cross_stack_forward(w, b, x0, variant, plan=plan), y), plan


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L,bound", [(512, 113, 3, 1.0), (4487, 113, 3, 1.0), (8192, 113, 1, 1.0),
                                         (32768, 113, 3, 1.0), (4096, 145, 6, 0.25), (1003, 256, 6, 0.25)])
def test_cuda_bf16_backward_repeats_and_meets_the_plain_version(variant, B, d, L, bound):
    """The bf16 backward on bf16x2 pairs, a warp's rows two at a time where
    it has them: a repeated launch bit for bit, dx0, dw and db within
    CROSS_BF16_TOL of the plain bf16 version against the term scale, and one
    bf16 launch counted each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(17)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous()  # noqa: E731
    w, b = f32(rng.uniform(-bound, bound, (L, d)) / np.sqrt(d)), f32(0.1 * rng.standard_normal((L, d)))
    w, b, x0, dy = _bf16(w, b, f32(rng.standard_normal((B, d))), f32(rng.standard_normal((B, d))))
    before = cross.cross_stack_backward.launches_bf16
    grads = cross.cross_stack_backward(w, b, x0, dy, variant)
    again = cross.cross_stack_backward(w, b, x0, dy, variant)
    torch.cuda.synchronize()
    assert cross.cross_stack_backward.launches_bf16 == before + 2
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    ref = cross.cross_stack_backward_ref(w, b, x0, dy, variant)
    scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)[1:]
    for name, got, want, sc in zip(("dx0", "dw", "db"), grads, ref, scale):
        cross.assert_close_to_scale(got, want, sc, **CROSS_BF16_TOL, what=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paired_row_backwards_replay_from_a_graph(dtype):
    """The single-trial backward at B = 4487 (two rows a warp at once, then
    the last alone) and the trial-axis backward at K = 8, B = 512 under its
    trial plan, captured in one CUDA graph, replay their eager outputs bit
    for bit three times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    single = _cross_inputs(4487, 113, 3, seed=21)
    trials = _trial_inputs(8, 512, 113, 3, seed=23)
    if dtype == "bfloat16":
        single, trials = _bf16(*single), _bf16(*trials)
    want = (*cross.cross_stack_backward(*single, "code"), *cross.cross_stack_backward_trials(*trials, "code"))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        outs = (*cross.cross_stack_backward(*single, "code"), *cross.cross_stack_backward_trials(*trials, "code"))
    for _ in range(3):
        for t in outs:
            t.fill_(float("nan"))
        torch.cuda.empty_cache()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, want))


@pytest.mark.cuda
def test_cuda_trial_axis_graph_replay_equals_eager_calls():
    """The trial-axis forward and backward captured in a CUDA graph (one
    scratch slice and ticket per lane, allocated in the capture) replay the
    eager results bit for bit, three times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _trial_inputs(8, 512, 113, 3, seed=5)
    want = (cross.cross_stack_forward_trials(w, b, x0, "code"),
            *cross.cross_stack_backward_trials(w, b, x0, dy, "code"))
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = (cross.cross_stack_forward_trials(w, b, x0, "code"),
                *cross.cross_stack_backward_trials(w, b, x0, dy, "code"))
    for _ in range(3):
        for t in outs:
            t.fill_(float("nan"))
        torch.cuda.empty_cache()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, e) for g, e in zip(outs, want))


@pytest.mark.cuda
def test_cuda_run_group_lanes_track_sequential_trials(retrain_data):
    """run_group on the card: each lane of a 3-lane group (dropout on)
    meets the sequential train_dcn of its trial at the trajectory bars
    (tests/test_hpo_vectorized.py's, with rtol 5e-3 after epoch 0 as the
    card's trajectory bar, PERF.md §2), with the same LR decisions and best
    epoch, through one trial-axis launch each way a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.hpo.vectorized import run_group
    from hhrs_tpu_torch.train.trainer import train_dcn

    splits, dims = retrain_data
    arch = dict(emb_dim=16, hidden_dim=64, n_cross_layers=2, n_res_blocks=1, batch_size=256, optimizer="adamw")
    trials = [dict(arch, lr=lr, weight_decay=wd, dropout=dr, lr_plateau_patience=0, lr_plateau_factor=0.5)
              for lr, wd, dr in ((3e-3, 1e-5, 0.2), (1e-3, 1e-4, 0.5), (2e-2, 1e-6, 0.1))]

    def cfgs(p):
        return (ModelConfig(emb_dim=16, hidden_dim=64, n_cross_layers=2, n_res_blocks=1, dropout=p["dropout"]),
                TrainConfig(lr=p["lr"], weight_decay=p["weight_decay"], optimizer="adamw", lr_plateau_patience=0,
                            lr_plateau_factor=0.5, **RETRAIN_TRAIN))

    before = (cross.cross_stack_forward_trials.launches, cross.cross_stack_backward_trials.launches)
    group = run_group(splits, dims, *cfgs(trials[0]), trials, device="cuda")
    steps, chunks = splits.n_train // 256, -(-splits.n_val // RETRAIN_TRAIN["eval_batch_size"])
    assert cross.cross_stack_backward_trials.launches - before[1] == 3 * steps
    # a launch a step, a launch an eval chunk of each epoch and of the final eval
    assert cross.cross_stack_forward_trials.launches - before[0] == 3 * (steps + chunks) + chunks
    for p, lane in zip(trials, group):
        seq = train_dcn(splits, dims, *cfgs(p), device="cuda")
        bars = [dict(rel=2e-3, abs=2e-4)] + [dict(rel=5e-3, abs=2e-4)] * (len(seq.history) - 1)
        for a, b, bar in zip(lane.history, seq.history, bars):
            assert a["val_loss"] == pytest.approx(b["val_loss"], **bar)
            assert a["lr"] == b["lr"]
        assert lane.best_epoch == seq.best_epoch
        assert lane.final_metrics["val_auc"] == pytest.approx(seq.final_metrics["val_auc"], abs=5e-3)


@pytest.mark.cuda
def test_cuda_exported_ranker_is_the_tower_kernel(tmp_path):
    """The hpo_r5 ranker exported on the card and loaded back: at B = 1, 128
    and 8192 its logits equal build_x0 + tower_eval bit for bit, one tower
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.models.convert import dcnr_from_jax
    from hhrs_tpu_torch.serve.export import ExportedRanker, save_ranker
    from hhrs_tpu_torch.train.artifacts import load_artifact_bundle

    bundle = load_artifact_bundle(str(Path(__file__).resolve().parents[1] / "benchmarks/results/hpo_r5/best"))
    path = save_ranker(bundle, str(tmp_path / "ranker.pt2"))
    ranker = ExportedRanker.load(path)
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg, "cuda")
    folded = tower.fold_eval_params(model)
    rng = np.random.default_rng(3)
    for B in (1, 128, 8192):
        ids = [torch.as_tensor(rng.integers(0, n, B), device="cuda")
               for n in (bundle.dims.n_users, bundle.dims.n_items)]
        cats = torch.as_tensor(np.stack([rng.integers(0, n, B) for _, n in bundle.dims.cat_dims], 1), device="cuda")
        num = torch.as_tensor(rng.random((B, bundle.dims.n_num_features), np.float32), device="cuda")
        with torch.no_grad():  # the first call at these widths also times the launch plans
            want = tower.tower_eval(folded, tower.build_x0(model, *ids, cats, num))
        before = tower.tower_eval.launches
        got = ranker(*ids, cats, num)
        assert tower.tower_eval.launches == before + 1
        assert torch.equal(got, want), B


# ---- the registered cross operator, exports of every arch, the retriever -----


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B", [1, 5, 513, 8192])
def test_cuda_cross_operator_is_cross_stack_fn_bit_for_bit(dtype, variant, B):
    """``hhrs::cross_stack_fwd`` on the card launches the same forward as
    ``CrossStackFn``: the same bits, one counted launch each, also on a
    misaligned x0 (copied inside the operator)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = torch.Generator().manual_seed(B)
    w = (torch.rand(3, 113, generator=g) * 0.2 - 0.1).to(dtype).cuda()
    b = (torch.rand(3, 113, generator=g) * 0.2 - 0.1).to(dtype).cuda()
    base = torch.rand(B * 113 + 1, generator=g).to(dtype).cuda()
    for x0 in (base[:-1].view(B, 113), base[1:].view(B, 113)):  # the second starts off a 16-byte boundary
        counter = "launches_bf16" if dtype == torch.bfloat16 else "launches"
        before = getattr(cross.cross_stack_forward, counter)
        with torch.no_grad():
            got = torch.ops.hhrs.cross_stack_fwd(x0, w, b, variant)
        want = cross.CrossStackFn.apply(w, b, x0, variant)
        torch.cuda.synchronize()
        assert getattr(cross.cross_stack_forward, counter) == before + 2
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dcnr", "cross_only", "deep_only", "dcn_mlp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_exported_ranker_of_every_arch_is_the_direct_route(arch, dtype, tmp_path):
    """Each arch at f32 and bf16 (both variants) exported on the card and
    loaded back: B = 1, 128, 8192 bit for bit the engine's route for the
    bundle, the cross operator launched where the program has one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.models.convert import dcnr_from_jax, jax_from_dcnr
    from hhrs_tpu_torch.serve.export import ExportedRanker, save_ranker
    from hhrs_tpu_torch.train.artifacts import ArtifactBundle, load_artifact_bundle

    base = load_artifact_bundle(str(ARTIFACT))
    for variant in ("code", "canonical"):
        cfg = ModelConfig(emb_dim=48, hidden_dim=320, n_cross_layers=3, n_res_blocks=3, arch=arch,
                          cross_variant=variant, compute_dtype=dtype, storage_dtype=dtype)
        params, bn_state = jax_from_dcnr(DCNR(base.dims, cfg, torch.Generator().manual_seed(5)))
        bundle = ArtifactBundle(params, bn_state, cfg, base.dims, base.preproc, base.item_embeddings, {})
        ranker = ExportedRanker.load(save_ranker(bundle, str(tmp_path / f"{variant}.pt2")))
        model = dcnr_from_jax(params, bn_state, base.dims, cfg, "cuda")
        rng = np.random.default_rng(4)
        for B in (1, 128, 8192):
            inputs = (torch.as_tensor(rng.integers(0, base.dims.n_users, B), device="cuda"),
                      torch.as_tensor(rng.integers(0, base.dims.n_items, B), device="cuda"),
                      torch.as_tensor(np.stack([rng.integers(0, n, B) for _, n in base.dims.cat_dims], 1),
                                      device="cuda"),
                      torch.as_tensor(rng.random((B, base.dims.n_num_features), np.float32), device="cuda"))
            with torch.no_grad():
                if tower.uses_tower(cfg):
                    folded = tower.fold_eval_params(model)
                    want = tower.tower_eval(folded, tower.build_x0(model, *inputs), variant)
                else:
                    want = model(*inputs)
            counts = (cross.cross_stack_forward.launches + cross.cross_stack_forward.launches_bf16,
                      tower.tower_eval.launches)
            got = ranker(*inputs)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (variant, B)
            grew = (cross.cross_stack_forward.launches + cross.cross_stack_forward.launches_bf16 - counts[0],
                    tower.tower_eval.launches - counts[1])
            assert grew == ((0, 1) if tower.uses_tower(cfg) else (int(arch != "deep_only"), 0)), grew


@pytest.mark.cuda
def test_cuda_two_tower_tracks_the_jax_run_and_serves():
    """The retriever from the JAX init (testdata) for 3 epochs on data/ on
    the card: losses at C1's bars against the JAX run; the engine with the
    JAX-exported embeddings answers the two-tower golden sweep under the
    tie rule, graphed equal to eager, through the tower kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.config import Config
    from hhrs_tpu_torch.models.convert import two_tower_from_jax
    from hhrs_tpu_torch.retrieval import two_tower
    from hhrs_tpu_torch.serve.engine import RecommendationEngine
    from hhrs_tpu_torch.train.cli import build_dataset

    testdata = REPO / "hhrs_tpu_torch/testdata"
    splits, art = build_dataset(str(REPO / "data"), Config())
    dims = ModelDims.from_artifacts(art)
    cfg = two_tower.TwoTowerConfig(n_epochs=3)
    init = two_tower_from_jax(dict(np.load(testdata / "two_tower_init_data.npz")), dims, cfg)
    r = two_tower.train_two_tower(splits, dims, cfg, device="cuda", init=init)
    want = json.loads((testdata / "two_tower_golden_data.json").read_text())["train_loss"][:3]
    got = [h["train_loss"] for h in r.history]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got[1:], want[1:], rtol=5e-3, atol=2e-4)
    golden = json.loads((testdata / "serve_golden_hpo_r5_two_tower.json").read_text())
    engine = RecommendationEngine.from_dirs(str(ARTIFACT), str(REPO / "data"), device="cuda",
                                            retrieval_embeddings_path=str(testdata / "retrieval_embeddings_hpo_r5.npy"))
    before = tower.tower_eval.launches
    for req, resp, logits in zip(golden["requests"], golden["responses"], golden["logits"]):
        got = engine.recommend(*req)
        assert got == engine._recommend_eager([req])[0], req
        _swaps(got, resp, logits, 1e-4)
    for item, n, want_similar in golden["similar"]:
        assert engine.similar_items(item, n) == want_similar
    assert tower.tower_eval.launches > before


# ---- serving over a device mesh ---------------------------------------------


@pytest.mark.cuda
def test_cuda_mesh_engine_on_one_nccl_rank_equals_single_device(tmp_path):
    """A world of one rank on NCCL: the mesh engine's buckets are CUDA
    graphs with the collectives inside, and every response, graphed and
    eager, equals the single-device engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import torch.distributed as dist

    from hhrs_tpu_torch.parallel.distributed import init_world
    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    golden = json.loads(GOLDEN_SERVE.read_text())
    single = RecommendationEngine.from_dirs(str(ARTIFACT), str(REPO / "data"), device="cuda")
    init_world(0, 1, f"file://{tmp_path / 'store'}", "cuda")
    try:
        assert dist.get_backend() == "nccl"
        engine = RecommendationEngine.from_dirs(str(ARTIFACT), str(REPO / "data"), mesh=make_mesh(1, 1, "cuda"))
        assert engine.graphs
        for req in golden["requests"][:48]:
            got = engine.recommend(*req)
            assert got == single.recommend(*req) == engine._recommend_eager([req])[0], req
        many = [golden["requests"][i] for i in golden["many"]]
        assert engine.recommend_many(many, pad_to=8) == single.recommend_many(many, pad_to=8)
        assert engine._recommend_eager(many[:5], pad_to=8) == single.recommend_many(many[:5], pad_to=8)
        assert set(engine._buckets) == {(1, False), (8, False)}
        for item, n, want in golden["similar"]:
            assert engine.similar_items(item, n) == want
        engine.close()
        with pytest.raises(RuntimeError, match="shut down"):
            engine.recommend(*golden["requests"][0])
    finally:
        dist.destroy_process_group()


def _mesh_rank_golden(n: int):
    """A rank of a gloo world on the card: the first ``n`` golden requests
    through the mesh engine (rank 0 answers; the others follow)."""
    import torch.distributed as dist

    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    golden = json.loads(GOLDEN_SERVE.read_text())
    engine = RecommendationEngine.from_dirs(str(ARTIFACT), str(REPO / "data"), mesh=make_mesh(-1, 1, "cuda"))
    if dist.get_rank():
        engine.follow()
        return None
    try:
        return engine.graphs, dist.get_backend(), [engine.recommend(*r) for r in golden["requests"][:n]]
    finally:
        engine.shutdown()


@pytest.mark.cuda
def test_cuda_mesh_engine_on_two_ranks_sharing_the_card(tmp_path):
    """Two ranks on one card: gloo, eager, and the golden responses under
    the golden tie rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from hhrs_tpu_torch.parallel.distributed import launch

    golden = json.loads(GOLDEN_SERVE.read_text())
    graphs, backend, got = launch(_mesh_rank_golden, 2, (48,), device="cuda", timeout_s=300,
                                  store_dir=str(tmp_path))
    assert (graphs, backend) == (False, "gloo")
    for resp, want, logits in zip(got, golden["responses"], golden["logits"]):
        _swaps(resp, want, logits, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks", [2, 4])
def test_cuda_cross_kernels_on_ranks_rows(dtype, ranks):
    """A training batch split over ``ranks`` data ranks (hpo_r5's B = 512,
    d = 113, L = 3): each rank's y and dx0 are the whole-batch launch's
    rows bit for bit (the kernels are row-local), and dw, db summed over
    the ranks are the whole-batch backward's within the term-scale bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = torch.Generator().manual_seed(14)
    B, d, L = 512, 113, 3
    x0, dy = (torch.randn(B, d, generator=g).cuda().to(dtype) for _ in range(2))
    w = ((torch.rand(L, d, generator=g) * 2 - 1) / d ** 0.5).cuda().to(dtype)
    b = (0.1 * torch.randn(L, d, generator=g)).cuda().to(dtype)
    with torch.no_grad():
        y_all = cross.cross_stack_forward(w, b, x0, "code")
        dx0_all, dw_all, db_all = cross.cross_stack_backward(w, b, x0, dy, "code")
        dw, db = torch.zeros(L, d, device="cuda"), torch.zeros(L, d, device="cuda")
        n = B // ranks
        for r in range(ranks):
            rows = slice(r * n, (r + 1) * n)
            y = cross.cross_stack_forward(w, b, x0[rows].contiguous(), "code")
            dx0, dw_r, db_r = cross.cross_stack_backward(w, b, x0[rows].contiguous(), dy[rows].contiguous(), "code")
            assert torch.equal(y, y_all[rows]) and torch.equal(dx0, dx0_all[rows])
            dw += dw_r.float()
            db += db_r.float()
        scale = cross.cross_stack_term_scale(w, b, x0, dy, "code")
    tol = CROSS_TOL if dtype == torch.float32 else CROSS_BF16_TOL
    cross.assert_close_to_scale(dw, dw_all.float(), scale[2], **tol, what="dw")
    cross.assert_close_to_scale(db, db_all.float(), scale[3], **tol, what="db")


@pytest.mark.cuda
def test_cuda_mesh_training_on_one_nccl_rank(retrain_data, tmp_path):
    """A world of one rank on NCCL: ``train_dcn(mesh=1x1)`` launches the
    cross kernels (one forward and one backward a step) and trains the
    single-device run's trajectory at the mesh bar (rtol 1e-4 / atol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import torch.distributed as dist

    from hhrs_tpu_torch.parallel.distributed import init_world
    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.train.trainer import train_dcn

    torch.backends.cuda.matmul.allow_tf32 = False
    splits, dims = retrain_data
    mcfg, tcfg = ModelConfig(**RETRAIN_MODEL), TrainConfig(**RETRAIN_TRAIN)
    single = train_dcn(splits, dims, mcfg, tcfg, device="cuda")
    init_world(0, 1, f"file://{tmp_path / 'store'}", "cuda")
    try:
        assert dist.get_backend() == "nccl"
        before = (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
        meshed = train_dcn(splits, dims, mcfg, tcfg, mesh=make_mesh(1, 1, "cuda"), device="cuda")
        torch.cuda.synchronize()
        steps = splits.n_train // tcfg.batch_size
        assert cross.cross_stack_backward.launches - before[1] == tcfg.n_epochs * steps
        assert cross.cross_stack_forward.launches - before[0] > tcfg.n_epochs * steps
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose([h["val_loss"] for h in meshed.history], [h["val_loss"] for h in single.history],
                               rtol=1e-4, atol=1e-6)
    assert [h["lr"] for h in meshed.history] == [h["lr"] for h in single.history]
