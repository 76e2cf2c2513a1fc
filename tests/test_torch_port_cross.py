"""Cross-stack parity: the port's plain forward and closed-form backward
against the JAX Pallas kernel (interpret mode) and its ``jax.grad``, and
the autograd wiring of :class:`CrossStackFn` and the kernels' launch plan
on the CPU. The CUDA kernels
themselves are held to these plain versions on a card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

The bar is the JAX kernel's, rtol 1e-5 / atol 1e-6, with the rtol taken
against the scale of the terms (``ops/cross.py::cross_stack_term_scale``):
the two sides are float32 programs that add in different orders, so where
terms cancel they differ by ulps of the terms, not of the result."""

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
    assert calls == ["canonical", "canonical"]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sm_count", [132, 114, 1])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 511, 512, 4487, 8192, 100000])
def test_launch_plan_covers_every_row_once_in_16_byte_copies(B, sm_count, backward):
    blocks = cross.plan_capacity(sm_count, backward)
    cluster = cross.CLUSTER if backward else 1
    plan = cross.cross_plan(B, blocks, cluster)
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
    for d in (1, 33, 113, 256):
        assert rows * d * 4 % 16 == 0  # a full tile is one bulk copy, and every tile starts 16-byte aligned
        assert (last & ~3) * d * 4 % 16 == 0  # so is the bulk-copied prefix of the last tile
    assert 4 <= rows <= cross.MAX_ROWS and 0 <= last - (last & ~3) <= 3
    # the plan is a function of B and the card's capacity alone: the sum order of dw/db follows it
    assert list(inspect.signature(cross.cross_plan).parameters) == ["B", "blocks", "cluster"]
    assert cross.cross_plan.__wrapped__(B, blocks, cluster) == plan


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
