"""Cross-stack parity: the port's plain forward and closed-form backward
against the JAX Pallas kernel (interpret mode) and its ``jax.grad``, and
the autograd wiring of :class:`CrossStackFn` and the kernels' launch plan
on the CPU. The CUDA kernels
themselves are held to these plain versions on a card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

The bar is the JAX kernel's, rtol 1e-5 / atol 1e-6, with the rtol taken
against the scale of the terms (``ops/cross.py::cross_stack_term_scale``):
the two sides are float32 programs that add in different orders, so where
terms cancel they differ by ulps of the terms, not of the result.

At bf16 (``model.compute_dtype=bfloat16``) the plain forward is JAX's bit
for bit. The backward is held to the term-scale bar with bf16's unit
roundoff in place of 1e-5: rtol ``BF16_VJP_RTOL`` = 8 · 2⁻⁸ against
``jax.vjp``, whose bf16 row and batch sums XLA's CPU backend accumulates in
bf16 where the port sums in f32, with dx0's scale widened by the row sums'
terms (``_row_sum_scale``)."""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hhrs_tpu.ops.cross import cross_stack_apply as jax_cross_stack_apply
from hhrs_tpu.ops.pallas.cross_kernel import cross_stack_pallas
from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.ops import cross
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX kernel's bar, tests/test_pallas_kernels.py
BF16_U = 2.0 ** -8  # bf16's unit roundoff
BF16_VJP_RTOL = 8 * BF16_U  # measured: up to 4.9 · 2⁻⁸ of the scale
SHAPES = [(64, 57, 3), (300, 128, 1), (32, 33, 2)]


def _inputs(B: int, d: int, L: int, seed: int = 0):
    """x0 ~ N(0, 1), w ~ U(±1/sqrt(d)) as the JAX init draws it, and a
    non-zero b so the bias gradient path is exercised."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, d)).astype(np.float32)
    w = (rng.uniform(-1, 1, (L, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((L, d))).astype(np.float32)
    return x0, w, b


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L", SHAPES)
def test_plain_forward_and_backward_match_pallas_kernel(variant, B, d, L):
    x0, w, b = _inputs(B, d, L)

    def loss(p, x):
        return jnp.sum(cross_stack_pallas(p, x, variant, True) ** 2)

    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    out = cross_stack_pallas(params, jnp.asarray(x0), variant, True)
    g_params, g_x0 = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x0))

    tw, tb, tx0 = (torch.from_numpy(a) for a in (w, b, x0))
    y = cross.cross_stack_apply(tw, tb, tx0, variant)
    got = (y, *cross.cross_stack_backward_ref(tw, tb, tx0, 2 * y, variant))
    want = [np.array(a) for a in (out, g_x0, g_params["w"], g_params["b"])]
    scales = cross.cross_stack_term_scale(tw, tb, tx0, 2 * y, variant)
    for name, g, ref, scale in zip(("y", "dx0", "dw", "db"), got, want, scales):
        cross.assert_close_to_scale(g, torch.from_numpy(ref), scale, **TOL, what=name)


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L", SHAPES + [(512, 113, 3)])
def test_plain_bf16_forward_is_jaxs_bit_for_bit(variant, B, d, L):
    """cross_stack_apply on bf16 tensors against the jnp stack at
    compute_dtype=bfloat16 and cross_stack_pallas (interpret mode) on bf16
    refs: equal bit for bit."""
    x0, w, b = _inputs(B, d, L)
    tw, tb, tx0 = _bf16(w, b, x0)
    y = cross.cross_stack_apply(tw, tb, tx0, variant)
    assert y.dtype == torch.bfloat16
    bf = jnp.bfloat16
    jnp_y = jax_cross_stack_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x0), variant,
                                  compute_dtype=bf)
    pallas_y = cross_stack_pallas({"w": jnp.asarray(w).astype(bf), "b": jnp.asarray(b).astype(bf)},
                                  jnp.asarray(x0).astype(bf), variant, True)
    got = y.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp_y.astype(jnp.float32)))
    np.testing.assert_array_equal(got, np.asarray(pallas_y.astype(jnp.float32)))


def _row_sum_scale(w, b, x0, dy, variant) -> torch.Tensor:
    """dx0's share of the scale that a bf16 row sum's rounding reaches: the
    row sum s_l = dx . x_l (code) or dx . x0 (canonical) enters dx as
    s_l · w_l, so its terms' scale, sum |dx| |x|, times |w_l|, in float64.
    The f32 term scale leaves it out: there a row sum's rounding is far
    below 1e-5 of the scale, in bf16 it is not."""
    w, b, x0, dy = (t.double() for t in (w, b, x0, dy))
    terms, _, _, _ = cross._walk_back(w, b, x0, dy, variant)
    out = torch.zeros_like(x0)
    for l, x_l, _, dx in terms:
        other = x_l if variant == "code" else x0
        out = torch.maximum(out, (dx.abs() * other.abs()).sum(dim=1, keepdim=True) * w[l].abs())
    return out


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("B,d,L", SHAPES + [(512, 113, 3)])
def test_plain_bf16_backward_matches_jax_vjp(variant, B, d, L, record_property):
    """cross_stack_backward_ref on bf16 tensors against jax.vjp of the jnp
    stack on bf16 inputs and the VJP of cross_stack_pallas (interpret
    mode) on bf16 refs, at BF16_VJP_RTOL against the term scale."""
    x0, w, b = _inputs(B, d, L)
    dy = np.random.default_rng(7).standard_normal((B, d)).astype(np.float32)
    bf = jnp.bfloat16
    params = {"w": jnp.asarray(w).astype(bf), "b": jnp.asarray(b).astype(bf)}
    jx0, jdy = jnp.asarray(x0).astype(bf), jnp.asarray(dy).astype(bf)
    _, vjp = jax.vjp(lambda p, x: jax_cross_stack_apply(p, x, variant), params, jx0)
    _, pallas_vjp = jax.vjp(lambda p, x: cross_stack_pallas(p, x, variant, True), params, jx0)
    tw, tb, tx0, tdy = _bf16(w, b, x0, dy)
    got = cross.cross_stack_backward_ref(tw, tb, tx0, tdy, variant)
    assert all(g.dtype == torch.bfloat16 for g in got)
    scales = list(cross.cross_stack_term_scale(tw, tb, tx0, tdy, variant)[1:])
    scales[0] = torch.maximum(scales[0], _row_sum_scale(tw, tb, tx0, tdy, variant))
    share = 0.0
    for jgrads in (vjp(jdy), pallas_vjp(jdy)):
        (jp, jx) = jgrads
        want = [torch.tensor(np.asarray(a.astype(jnp.float32))) for a in (jx, jp["w"], jp["b"])]
        for name, g, ref, scale in zip(("dx0", "dw", "db"), got, want, scales):
            share = max(share, cross.assert_close_to_scale(g, ref, scale, rtol=BF16_VJP_RTOL, atol=0.0,
                                                           what=name)[1])
    record_property("largest_share_of_the_allowance", share)


@pytest.mark.parametrize("variant", ["code", "canonical"])
def test_cross_stack_bf16_compute_keeps_f32_weight_gradients(variant):
    """CrossStack at compute_dtype=bfloat16 casts x0, w and b as JAX does:
    a bf16 output, and f32 gradients for w, b and x0 that are the bf16
    gradients of its leaves, cast up."""
    x0, w, b = (torch.from_numpy(a) for a in _inputs(48, 41, 3, seed=3))
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal((48, 41)).astype(np.float32))
    layer = cross.CrossStack(3, 41, variant)
    with torch.no_grad():
        layer.w.copy_(w)
        layer.b.copy_(b)
    xin = x0.clone().requires_grad_()
    y = layer(xin, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y.backward(dy.to(torch.bfloat16))
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (w, b, x0)]
    want = cross.cross_stack_apply(*leaves, variant)
    assert torch.equal(y, want)
    want.backward(dy.to(torch.bfloat16))
    for got, leaf in zip((layer.w.grad, layer.b.grad, xin.grad), leaves):
        assert got.dtype == torch.float32 and torch.equal(got, leaf.grad.float())


@pytest.mark.parametrize("variant", ["code", "canonical"])
def test_cross_stack_fn_equals_autograd_on_cpu(variant):
    x0, w, b = (torch.from_numpy(a) for a in _inputs(48, 41, 3, seed=1))
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal((48, 41)).astype(np.float32))

    leaves = [t.clone().requires_grad_() for t in (w, b, x0)]
    cross.cross_stack_apply(*leaves, variant).backward(dy)
    want = [t.grad for t in leaves]

    leaves = [t.clone().requires_grad_() for t in (w, b, x0)]
    y = cross.CrossStackFn.apply(*leaves, variant)
    torch.testing.assert_close(y, cross.cross_stack_apply(w, b, x0, variant), rtol=0, atol=0)
    y.backward(dy)
    for got, ref, name in zip((t.grad for t in leaves), want, ("w", "b", "x0")):
        torch.testing.assert_close(got, ref, **TOL, msg=name)


def test_cpu_tensors_never_launch_a_kernel():
    x0, w, b = (torch.from_numpy(a) for a in _inputs(16, 33, 2))
    before = (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches)
    w.requires_grad_()
    cross.cross_stack(w, b, x0, "code").sum().backward()
    assert (cross.cross_stack_forward.launches, cross.cross_stack_backward.launches) == before
    with pytest.raises(ValueError, match="cuda"):
        cross.cross_stack_forward(w.detach(), b, x0, "code")
    with pytest.raises(ValueError, match="cuda"):
        cross.cross_stack_backward(w.detach(), b, x0, x0, "code")
    with pytest.raises(ValueError, match="variant"):
        cross.cross_stack(w, b, x0, "diagonal")


def test_model_cross_goes_through_the_wrapper(monkeypatch):
    calls = []
    real = cross.cross_stack

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(cross, "cross_stack", spy)
    dims = ModelDims(n_users=20, n_items=10, cat_dims=(("city", 6),), n_num_features=3)
    model = DCNR(dims, ModelConfig(emb_dim=4, hidden_dim=8, dropout=0.0, cross_variant="canonical"),
                 generator=torch.Generator().manual_seed(0))
    u = torch.arange(4)
    for mode in (model.train(), model.eval()):
        mode(u, u, u[:, None] % 6, torch.ones(4, 3))
    with torch.no_grad():  # the operator's route: patching cross_stack reaches it too
        model(u, u, u[:, None] % 6, torch.ones(4, 3))
    assert calls == ["canonical", "canonical", "canonical"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sm_count", [132, 114, 1])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 511, 512, 4487, 8192, 100000])
def test_launch_plan_covers_every_row_once_in_16_byte_copies(B, sm_count, backward, dtype):
    blocks = cross.plan_capacity(sm_count, backward)
    cluster = cross.CLUSTER if backward else 1
    align = cross.ROW_ALIGN[dtype]
    plan = cross.cross_plan(B, blocks, cluster, align)
    _assert_plan_covers_every_row_once(plan, B, blocks, cluster, dtype)
    # the plan is a function of B, the card's capacity and the dtype's row alignment alone: the
    # sum order of dw/db follows it
    assert list(inspect.signature(cross.cross_plan).parameters) == ["B", "blocks", "cluster", "align"]
    assert cross.cross_plan.__wrapped__(B, blocks, cluster, align) == plan
    if dtype == torch.float32:  # the float32 plans are the ones taken before bfloat16 existed
        assert cross.cross_plan(B, blocks, cluster) == plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sm_count", [132, 120, 60, 1])
@pytest.mark.parametrize("K", [1, 2, 8, 64])
@pytest.mark.parametrize("B", [1, 5, 512, 4096, 4487, 100000])
def test_trial_plan_covers_every_row_once_in_16_byte_copies(B, K, sm_count, dtype):
    """The trial-axis backward's plan: each trial's grid a whole number of
    clusters (at least one), of 8 unless they leave more than
    TRIAL_IDLE_SHARE of the card idle, then of the size that leaves the most
    blocks a trial (the largest among equals), covering the trial's rows
    once in 16-byte copies: the single-trial plan of B rows over capacity //
    K blocks at that size; the K grids fit the card at once whenever K <=
    capacity / 8 (past every size's capacity, a cluster of 8 a trial, in
    waves); K = 1 is the single-trial plan."""
    align = cross.ROW_ALIGN[dtype]
    capacities = tuple((c, cross.plan_capacity(sm_count, True, c)) for c in cross.CLUSTER_SIZES)
    plan = cross.trial_plan(B, K, capacities, align)
    blocks = dict(capacities)[plan.cluster]
    _assert_plan_covers_every_row_once(plan, B, blocks, plan.cluster, dtype)
    assert plan.grid >= plan.cluster and plan.grid % plan.cluster == 0
    if K <= capacities[0][1] // cross.CLUSTER:
        assert K * plan.grid <= blocks
    eights = capacities[0][1] // K // 8 * 8
    if eights >= 8 and K * eights >= (1 - cross.TRIAL_IDLE_SHARE) * capacities[0][1]:
        per_trial, cluster = eights, 8
    else:
        fits = [(b // K // c * c, c) for c, b in capacities if b // K // c * c >= c]
        per_trial, cluster = max(fits) if fits else (8, 8)
    assert plan == cross.cross_plan(B, per_trial, cluster, align)._replace(cluster=cluster)
    if K == 1:
        assert plan == cross.cross_plan(B, capacities[0][1], cross.CLUSTER, align)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_sm", [4, 3])
@pytest.mark.parametrize("sm_count", [132, 120, 60, 1])
@pytest.mark.parametrize("K", [1, 2, 8, 64])
@pytest.mark.parametrize("B", [1, 5, 512, 4096, 4487, 100000])
def test_forward_trial_plan_covers_every_row_once_and_fits_one_wave(B, K, sm_count, per_sm, dtype):
    """The trial-axis forward's plan on a card that runs ``per_sm`` forward
    blocks an SM: the single-trial forward plan of B rows over capacity // K
    blocks (at least one), covering each trial's rows once in 16-byte copies
    with at most FWD_RING rows in flight a block; no block carries more tiles
    than its share of the rows needs; the K grids fit the card at once
    whenever K <= capacity; where K single-trial grids already fit it, the
    single-trial plan itself (so K = 1 is the single-trial plan); where a
    block's share is at most MAX_ROWS rows, the backward's kind of plan."""
    align = cross.ROW_ALIGN[dtype]
    blocks = per_sm * sm_count
    per_trial = max(1, blocks // K)
    plan = cross.fwd_trial_plan(B, K, blocks, align)
    _assert_plan_covers_every_row_once(plan, B, per_trial, 1, dtype)
    assert plan == cross.fwd_plan(B, per_trial, align) and plan.stages * plan.rows <= cross.FWD_RING
    tiles, share = -(-B // plan.rows), -(-B // per_trial)
    assert -(-tiles // plan.grid) <= -(-share // plan.rows)
    if share <= cross.MAX_ROWS:
        assert plan == cross.cross_plan(B, per_trial, 1, align)
    if K <= blocks:
        assert K * plan.grid <= blocks
    single = cross.fwd_plan(B, blocks, align)
    if K * single.grid <= blocks:
        assert plan == single


def _assert_plan_covers_every_row_once(plan, B: int, blocks: int, cluster: int, dtype) -> None:
    align, elem = cross.ROW_ALIGN[dtype], torch.finfo(dtype).bits // 8
    rows, grid, stages = plan.rows, plan.grid, plan.stages
    tiles = -(-B // rows)
    # block k walks tiles k, k + grid, …: every row lies in exactly one tile
    covered = np.zeros(B, dtype=np.int64)
    for k in range(grid):
        for t in range(k, tiles, grid):
            covered[t * rows:(t + 1) * rows] += 1
    assert (covered == 1).all()
    # the backward's scratch, allocated once per device and stream, holds every cluster's sums
    assert 1 <= grid <= blocks and grid % cluster == 0 and grid - cluster < tiles
    assert 1 <= stages <= min(cross.MAX_STAGES, -(-tiles // grid)) and stages * rows <= cross.MAX_RING
    last = B - (tiles - 1) * rows
    copied = last & ~(align - 1)  # the kernel's bulk-copied prefix of the last tile
    for d in (1, 33, 113, 256):
        assert rows * d * elem % 16 == 0  # a full tile is one bulk copy, and every tile starts 16-byte aligned
        assert copied * d * elem % 16 == 0  # so is the bulk-copied prefix of the last tile
    assert align <= rows <= cross.MAX_ROWS and rows % align == 0 and 0 <= last - copied < align


def hvp_inputs(B: int, d: int, L: int, seed: int):
    """Inputs, an output weight ``c`` and a direction ``v`` over (w, b, x0)
    for a Hessian-vector product."""
    x0, w, b = _inputs(B, d, L, seed)
    rng = np.random.default_rng(seed + 100)
    c = rng.standard_normal(x0.shape).astype(np.float32)
    v = [rng.standard_normal(a.shape).astype(np.float32) for a in (w, b, x0)]
    return (w, b, x0), c, v


def torch_hvp(fn, inputs, c, v, variant):
    """Hessian of ``<fn(w, b, x0), c>`` times ``v``: the gradient of
    <grad, v>, differentiating through the first backward."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    grads = torch.autograd.grad((fn(*leaves, variant) * c).sum(), leaves, create_graph=True)
    return torch.autograd.grad(sum((g * d).sum() for g, d in zip(grads, v)), leaves, materialize_grads=True)


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("L", [1, 3])
def test_double_backward_matches_jax_grad_of_grad(variant, L):
    """A second derivative through CrossStackFn is exact: its Hessian-vector
    product equals JAX's grad of grad through the jnp cross stack, the
    function whose VJP ``cross_stack_pallas`` takes (its ``_bwd``), at d =
    33, against the scale of the float64 product (each leaf's largest
    entry). JAX itself refuses a grad of grad through ``cross_stack_pallas``
    (the Pallas forward cannot be linearized), so the jnp stack is the
    reference."""
    (w, b, x0), c, v = hvp_inputs(64, 33, L, seed=L)

    def loss(p, x):
        return jnp.sum(jax_cross_stack_apply(p, x, variant) * c)

    def grad_dot_v(p, x):
        gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
        return jnp.vdot(gp["w"], v[0]) + jnp.vdot(gp["b"], v[1]) + jnp.vdot(gx, v[2])

    hp, hx = jax.grad(grad_dot_v, argnums=(0, 1))({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x0))
    want = [np.array(a) for a in (hp["w"], hp["b"], hx)]

    tin, tc, tv = [torch.from_numpy(a) for a in (w, b, x0)], torch.from_numpy(c), [torch.from_numpy(a) for a in v]
    got = torch_hvp(cross.CrossStackFn.apply, tin, tc, tv, variant)
    exact = torch_hvp(cross.cross_stack_apply, [t.double() for t in tin], tc.double(), [t.double() for t in tv],
                      variant)
    for name, g, ref, ex in zip(("w", "b", "x0"), got, want, exact):
        scale = ex.abs().max().expand_as(ex)
        cross.assert_close_to_scale(g, torch.from_numpy(ref), scale, **TOL, what=f"HVP {name} vs JAX")
        cross.assert_close_to_scale(g, ex, scale, **TOL, what=f"HVP {name} vs float64")


@pytest.mark.parametrize("variant", ["code", "canonical"])
def test_third_derivative_through_cross_fn_is_exact(variant):
    """The backward's own backward keeps the graph of its inputs, so a third
    derivative through CrossStackFn (float64 on the CPU, through
    CrossBackwardFn as on the card) equals autograd's through the plain
    stack, to float64 rounding."""
    (w, b, x0), c, v = hvp_inputs(16, 9, 2, seed=5)
    tin = [torch.from_numpy(a).double() for a in (w, b, x0)]
    tc, tv = torch.from_numpy(c).double(), [torch.from_numpy(a).double() for a in v]

    def third(fn):
        leaves = [t.clone().requires_grad_() for t in tin]
        grads = torch.autograd.grad((fn(*leaves, variant) * tc).sum(), leaves, create_graph=True)
        hv = torch.autograd.grad(sum((g * d).sum() for g, d in zip(grads, tv)), leaves, create_graph=True)
        return torch.autograd.grad(sum((h * d).sum() for h, d in zip(hv, tv)), leaves, materialize_grads=True)

    for got, want in zip(third(cross.CrossStackFn.apply), third(cross.cross_stack_apply)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


# ---- the trial axis (vectorized HPO) ----------------------------------------------


def _trial_inputs(K: int, B: int, d: int, L: int, seed: int = 0):
    lanes = [_inputs(B, d, L, seed=seed + k) for k in range(K)]
    x0, w, b = (np.stack(a) for a in zip(*lanes))
    dy = np.random.default_rng(seed + 100).standard_normal(x0.shape).astype(np.float32)
    return x0, w, b, dy


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("K,B,d,L", [(8, 64, 57, 3), (3, 37, 33, 6), (1, 16, 113, 1)])
def test_plain_trial_axis_is_k_single_trial_calls(variant, K, B, d, L):
    """The plain trial-axis forward and backward are the single-trial plain
    versions lane by lane, bit for bit: each lane's dw and db summed over its
    own rows only."""
    x0, w, b, dy = (torch.from_numpy(a) for a in _trial_inputs(K, B, d, L))
    y = cross.cross_stack_apply_trials(w, b, x0, variant)
    grads = cross.cross_stack_backward_ref_trials(w, b, x0, dy, variant)
    for k in range(K):
        assert torch.equal(y[k], cross.cross_stack_apply(w[k], b[k], x0[k], variant))
        single = cross.cross_stack_backward_ref(w[k], b[k], x0[k], dy[k], variant)
        assert all(torch.equal(g[k], s) for g, s in zip(grads, single))


@pytest.mark.parametrize("variant", ["code", "canonical"])
@pytest.mark.parametrize("K,B,d,L", [(4, 64, 57, 3), (3, 32, 33, 2)])
def test_plain_trial_axis_matches_vmapped_pallas_kernel(variant, K, B, d, L):
    """Against ``jax.vmap`` of ``cross_stack_pallas`` (interpret mode; Pallas
    batches the ``pallas_call`` with a grid axis) and ``jax.vmap`` of its
    ``jax.grad``, lane by lane at the JAX kernel's term-scale bar."""
    x0, w, b, dy = _trial_inputs(K, B, d, L, seed=7)

    def lane_out(p, x):
        return cross_stack_pallas(p, x, variant, True)

    def lane_vjp(p, x, g):
        return jax.grad(lambda pp, xx: jnp.sum(cross_stack_pallas(pp, xx, variant, True) * g), argnums=(0, 1))(p, x)

    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    out = jax.vmap(lane_out)(params, jnp.asarray(x0))
    g_params, g_x0 = jax.vmap(lane_vjp)(params, jnp.asarray(x0), jnp.asarray(dy))

    tw, tb, tx0, tdy = (torch.from_numpy(a) for a in (w, b, x0, dy))
    got = (cross.cross_stack_apply_trials(tw, tb, tx0, variant),
           *cross.cross_stack_backward_ref_trials(tw, tb, tx0, tdy, variant))
    want = [np.array(a) for a in (out, g_x0, g_params["w"], g_params["b"])]
    for k in range(K):
        scales = cross.cross_stack_term_scale(tw[k], tb[k], tx0[k], tdy[k], variant)
        for name, g, ref, scale in zip(("y", "dx0", "dw", "db"), got, want, scales):
            cross.assert_close_to_scale(g[k], torch.from_numpy(ref[k]), scale, **TOL, what=f"{name} lane {k}")


# C5: the reference space's widest trial shape (emb 64: d = 145, 6 layers) at
# the JAX init's full weight bound, where rows grow to |y| ~1e17. There the
# float32 programs themselves sit outside the term-scale bar against float64,
# so the bar is stated from their measured spreads: the largest |f32 −
# float64| / term scale of the port's plain version and of JAX's vmapped
# Pallas kernel (interpret mode) over 48 lanes (K = 8 at _trial_inputs' seeds
# 7–10, and two K = 8 draws of one generator): y 3.60e-4, dx0 4.80e-4,
# dw 5.57e-6, db 1.15e-4 (the port's alone: 1.58e-4, 3.14e-4, 3.62e-6,
# 9.86e-5). Each program is held to about twice the largest (C5_SPREAD), the
# two programs to each other to the sum of their two bars (chip_smoke.py's
# phase 11a holds the kernel to the plain version on the card so too).
C5_SPREAD = {"y": 8e-4, "dx0": 1e-3, "dw": 1.2e-5, "db": 2.5e-4}


def test_plain_trial_axis_matches_vmapped_pallas_kernel_at_full_init_bound(record_property):
    """C5: cross_stack_apply_trials / cross_stack_backward_ref_trials
    against jax.vmap of cross_stack_pallas (interpret mode) and of its
    jax.grad at K = 8, B = 4096, d = 145, L = 6, w ~ U(±1/sqrt(d)), float32
    on both sides: each within C5_SPREAD of float64 (the plain version in
    float64), the two within twice that of each other, against the term
    scale."""
    K, B, d, L = 8, 4096, 145, 6
    x0, w, b, dy = _trial_inputs(K, B, d, L, seed=7)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}

    def lane_vjp(p, x, g):
        return jax.grad(lambda pp, xx: jnp.sum(cross_stack_pallas(pp, xx, "code", True) * g), argnums=(0, 1))(p, x)

    out = jax.vmap(lambda p, x: cross_stack_pallas(p, x, "code", True))(params, jnp.asarray(x0))
    g_params, g_x0 = jax.vmap(lane_vjp)(params, jnp.asarray(x0), jnp.asarray(dy))
    want = [torch.from_numpy(np.array(a)) for a in (out, g_x0, g_params["w"], g_params["b"])]
    tw, tb, tx0, tdy = (torch.from_numpy(a) for a in (w, b, x0, dy))
    got = (cross.cross_stack_apply_trials(tw, tb, tx0, "code"),
           *cross.cross_stack_backward_ref_trials(tw, tb, tx0, tdy, "code"))
    exact = (cross.cross_stack_apply_trials(tw.double(), tb.double(), tx0.double(), "code"),
             *cross.cross_stack_backward_ref_trials(tw.double(), tb.double(), tx0.double(), tdy.double(), "code"))
    assert float(exact[0].abs().max()) > 1e14  # the draw that makes rows grow doubly exponentially
    shares = dict.fromkeys(C5_SPREAD, 0.0)
    for k in range(K):
        scales = cross.cross_stack_term_scale(tw[k], tb[k], tx0[k], tdy[k], "code")
        for i, name in enumerate(C5_SPREAD):
            bar = dict(rtol=C5_SPREAD[name], atol=0.0)
            cross.assert_close_to_scale(got[i][k], exact[i][k], scales[i], **bar, what=f"port {name} lane {k}")
            cross.assert_close_to_scale(want[i][k], exact[i][k], scales[i], **bar, what=f"JAX {name} lane {k}")
            _, share = cross.assert_close_to_scale(got[i][k], want[i][k], scales[i], rtol=2 * C5_SPREAD[name],
                                                   atol=0.0, what=f"port against JAX {name} lane {k}")
            shares[name] = max(shares[name], share)
    record_property("largest_share_port_against_jax", shares)


@pytest.mark.parametrize("variant", ["code", "canonical"])
def test_trial_axis_fn_equals_autograd_on_cpu(variant):
    """CrossStackTrialsFn on CPU tensors: the plain forward, and the closed
    form backward against autograd through the plain stack; the model's call
    (cross_stack_trials) is autograd through the plain stack and launches
    nothing."""
    x0, w, b, dy = (torch.from_numpy(a) for a in _trial_inputs(3, 40, 41, 3, seed=3))
    leaves = [t.clone().requires_grad_() for t in (w, b, x0)]
    before = (cross.cross_stack_forward_trials.launches, cross.cross_stack_backward_trials.launches)
    cross.cross_stack_trials(*leaves, variant).backward(dy)
    want = [t.grad for t in leaves]
    leaves = [t.clone().requires_grad_() for t in (w, b, x0)]
    y = cross.CrossStackTrialsFn.apply(*leaves, variant)
    assert torch.equal(y, cross.cross_stack_apply_trials(w, b, x0, variant))
    y.backward(dy)
    for k in range(3):
        _, dx0_scale, dw_scale, db_scale = cross.cross_stack_term_scale(w[k], b[k], x0[k], dy[k], variant)
        for got, ref, scale, name in zip((t.grad for t in leaves), want, (dw_scale, db_scale, dx0_scale),
                                         ("w", "b", "x0")):
            cross.assert_close_to_scale(got[k], ref[k], scale, **TOL, what=f"{name} lane {k}")
    assert (cross.cross_stack_forward_trials.launches, cross.cross_stack_backward_trials.launches) == before
    with pytest.raises(ValueError, match="cuda"):
        cross.cross_stack_forward_trials(w, b, x0, variant)
    with pytest.raises(ValueError, match="trial axis"):
        cross.cross_stack_apply_trials(w[0], b[0], x0[0], variant)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,B,d", [(1, 7, 33), (8, 512, 113), (3, 4487, 113), (2, 5, 33), (4, 9, 16)])
def test_trial_lanes_start_on_16_byte_boundaries(dtype, K, B, d):
    """Every lane of a trial-axis launch starts on a 16-byte boundary (the
    kernels bulk-copy each lane's rows): the lane stride is B·d where that
    allows it, else each lane padded to the dtype's row alignment; a copy
    laid out so keeps the rows."""
    t = torch.randn(K, B, d).to(dtype)
    stride = cross._lane_stride(t)
    assert stride % d == 0 and stride >= B * d and (K == 1 or stride * t.element_size() % 16 == 0)
    if B * d * t.element_size() % 16 == 0:
        assert stride == B * d
    out = cross._laid_out(t, stride)
    assert out.data_ptr() % 16 == 0 and out.stride(0) == stride
    assert torch.equal(out[:, :B], t)
