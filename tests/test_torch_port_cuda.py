"""The CUDA kernels (the fused tower, the cross stack forward and backward)
against their plain PyTorch versions, and a few training steps, on a card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
only torch and the port, so it also runs where JAX is absent::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.ops import cross, tower
from hhrs_tpu_torch.train.optimizers import make_optimizer
from hhrs_tpu_torch.train.trainer import train_step

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
    """Forward and backward captured in a CUDA graph and replayed twice give
    the eager results bit for bit: the backward's tickets are back at 0
    after every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(512, 113, 3, seed=4)
    want = (cross.cross_stack_forward(w, b, x0, "code"), *cross.cross_stack_backward(w, b, x0, dy, "code"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up on the capture stream: its scratch exists before capture
        cross.cross_stack_backward(w, b, x0, dy, "code")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = cross.cross_stack_forward(w, b, x0, "code")
        grads = cross.cross_stack_backward(w, b, x0, dy, "code")
    for _ in range(2):
        for t in (y, *grads):
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, e) for g, e in zip((y, *grads), want))


@pytest.mark.cuda
def test_cuda_cross_backward_refuses_a_capture_before_its_scratch_exists():
    """A backward's first call on a stream allocates its scratch; inside a
    capture that allocation would join the graph, so it raises instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    w, b, x0, dy = _cross_inputs(64, 33, 2, seed=5)
    cross.cross_stack_backward(w, b, x0, dy, "code")  # the device's plans and limits are known
    side = torch.cuda.Stream()
    cross._scratch.pop((x0.get_device(), side.cuda_stream), None)  # streams come from a pool
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(graph, stream=side):
            cross.cross_stack_backward(w, b, x0, dy, "code")
    assert (x0.get_device(), side.cuda_stream) not in cross._scratch


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
