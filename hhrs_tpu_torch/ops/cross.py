"""Feature-cross stack: the plain version, its closed-form backward, the kernels.

Counterpart of ``hhrs_tpu/ops/cross.py`` and
``hhrs_tpu/ops/pallas/cross_kernel.py``. Weights for all L layers are
stacked ``[L, d]``. Two variants:
``code``: ``x_{l+1} = x_l + x_l * (w_l · x_l) + b_l``;
``canonical``: ``x_{l+1} = x_0 * (w_l · x_l) + b_l + x_l``.

* :func:`cross_stack_apply` is the plain forward;
* :func:`cross_stack_backward_ref` is the closed-form backward in plain
  PyTorch, recomputing the layer inputs from ``x0``;
* :func:`cross_stack_forward` and :func:`cross_stack_backward` launch
  ``csrc/cross_stack.cu`` on CUDA tensors and count their launches;
* :class:`CrossStackFn` ties them into autograd, and :func:`cross_stack`
  is what the model calls: the plain version on a CPU tensor, the kernels
  on a CUDA tensor. It never falls back from one to the other: a CUDA
  input that the kernels cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch import nn

from hhrs_tpu_torch.ops import cuda_build

CROSS_VARIANTS = ("code", "canonical")
_LIB_NAME, _LIB_SOURCES = "cross_stack", ["cross_stack.cu"]


def cross_stack_apply(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str) -> torch.Tensor:
    if variant not in CROSS_VARIANTS:
        raise ValueError(f"unknown cross variant {variant!r}")
    x = x0
    for l in range(w.shape[0]):
        gate = (x * w[l]).sum(dim=1, keepdim=True)  # [B, 1] scalar gate per row
        if variant == "code":
            x = x + x * gate + b[l]
        else:
            x = x0 * gate + b[l] + x
    return x


def _walk_back(w, b, x0, dy, variant) -> tuple:
    """Recompute the layer inputs ``x_l`` and gates ``g_l`` from ``x0``, then
    walk back from the last layer → (``[(l, x_l, s_l, dx_{l+1})]`` for
    l = L-1 … 0, ``dx0``, ``[x_0 … x_L]``, ``[dx_L … dx_0]``)."""
    if variant not in CROSS_VARIANTS:
        raise ValueError(f"unknown cross variant {variant!r}")
    xs, gates = [], []
    x = x0
    for l in range(w.shape[0]):
        xs.append(x)
        gate = (x * w[l]).sum(dim=1, keepdim=True)
        gates.append(gate)
        x = x + x * gate + b[l] if variant == "code" else x0 * gate + b[l] + x
    terms, dxs = [], [dy]
    dx, dx0 = dy, torch.zeros_like(x0)
    for l in reversed(range(w.shape[0])):
        s = (dx * (xs[l] if variant == "code" else x0)).sum(dim=1, keepdim=True)
        terms.append((l, xs[l], s, dx))
        if variant == "code":
            dx = dx * (1 + gates[l]) + s * w[l]
        else:
            dx0 = dx0 + dx * gates[l]
            dx = dx + s * w[l]
        dxs.append(dx)
    return terms, dx0 + dx, xs + [x], dxs + [dx0]


def cross_stack_backward_ref(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                             dy: torch.Tensor, variant: str) -> tuple:
    """Gradients of ``cross_stack_apply`` for the output gradient ``dy``
    → ``(dx0 [B, d], dw [L, d], db [L, d])``, in closed form: the layer
    inputs ``x_l`` and gates ``g_l`` are recomputed from ``x0``, then
    walked back from the last layer."""
    terms, dx0, _, _ = _walk_back(w, b, x0, dy, variant)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    for l, x_l, s, dx in terms:
        dw[l] = (s * x_l).sum(dim=0)
        db[l] = dx.sum(dim=0)
    return dx0, dw, db


def cross_stack_term_scale(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                           dy: torch.Tensor, variant: str) -> tuple:
    """The scale that each output's float32 rounding error is measured
    against, ``(y, dx0, dw, db)``, from the plain versions in float64:

    * ``dw``, ``db`` (sums over the batch): the same sums of the absolute
      values of the terms, the bound of a summation's rounding error;
    * ``y``, ``dx0`` (row outputs): the largest absolute value in the row
      over every layer's ``x_l`` (for ``y``) or ``dx_l`` (for ``dx0``),
      since a gate's rounding error reaches each element scaled by the
      layer's row.

    Two float32 computations that add in different orders differ by a few
    ulps of this scale, not of the output, wherever terms cancel."""
    w, b, x0, dy = (t.detach().double() for t in (w, b, x0, dy))
    terms, _, xs, dxs = _walk_back(w, b, x0, dy, variant)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    for l, x_l, s, dx in terms:
        dw[l] = (s * x_l).abs().sum(dim=0)
        db[l] = dx.abs().sum(dim=0)

    def row_max(ts):
        return torch.stack([t.abs().amax(dim=1) for t in ts]).amax(dim=0)[:, None].expand_as(x0)

    if x0.shape[0] == 0 or x0.shape[1] == 0:
        return torch.zeros_like(x0), torch.zeros_like(x0), dw, db
    return row_max(xs), row_max(dxs), dw, db


def assert_close_to_scale(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor,
                          rtol: float, atol: float, what: str) -> tuple[float, float]:
    """Raise unless ``|got − want| <= atol + rtol · scale`` everywhere;
    returns the largest ``|got − want|`` and the largest share of the
    allowance that an entry used."""
    err = (got.double() - want.double()).abs()
    share = err / (atol + rtol * scale)
    bad = int((share > 1).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {bad} of {err.numel()} entries outside atol={atol} + "
                             f"rtol={rtol}·scale; max |Δ| {float(err.max()):.3e}")
    if not err.numel():
        return 0.0, 0.0
    return float(err.max()), float(share.max())


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/cross_stack.cu``, with typed entry points."""
    lib = cuda_build.load(_LIB_NAME, _LIB_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hhrs_cross_fwd.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.hhrs_cross_fwd.restype = i
    lib.hhrs_cross_bwd.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.hhrs_cross_bwd.restype = i
    lib.hhrs_cross_bwd_blocks.argtypes = [i]
    lib.hhrs_cross_bwd_blocks.restype = i
    lib.hhrs_cross_max_dim.restype = i
    lib.hhrs_cross_max_layers.restype = i
    lib.hhrs_cross_error_string.argtypes = [i]
    lib.hhrs_cross_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(tensors: dict, variant: str) -> tuple:
    """Device, dtype, shape and contiguity checks → ``(B, d, L)``."""
    if variant not in CROSS_VARIANTS:
        raise ValueError(f"unknown cross variant {variant!r}")
    x0, w = tensors["x0"], tensors["w"]
    if x0.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x0 must be [B, d] and w [L, d], got {tuple(x0.shape)} and {tuple(w.shape)}")
    (B, d), L = x0.shape, w.shape[0]
    want = {"x0": (B, d), "w": (L, d), "b": (L, d), "dy": (B, d)}
    for name, t in tensors.items():
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    return B, d, L


def _check_limits(lib, d: int, L: int) -> None:
    if not 1 <= d <= lib.hhrs_cross_max_dim():
        raise ValueError(f"the cross kernels take 1 <= d <= {lib.hhrs_cross_max_dim()}, got d={d}")
    if L > lib.hhrs_cross_max_layers():
        raise ValueError(f"the cross kernels take at most {lib.hhrs_cross_max_layers()} layers, got {L}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.hhrs_cross_error_string(err).decode()}")


def cross_stack_forward(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors (current stream,
    asynchronous) → ``[B, d]``; ``cross_stack_forward.launches`` counts them."""
    if x0.device.type != "cuda":
        raise ValueError(f"cross_stack_forward runs on cuda tensors, got {x0.device}")
    B, d, L = _check_inputs({"x0": x0, "w": w, "b": b}, variant)
    lib = _library()
    _check_limits(lib, d, L)
    y = torch.empty_like(x0)
    if B == 0:
        return y
    with torch.cuda.device(x0.device):
        err = lib.hhrs_cross_fwd(
            x0.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, d, L,
            int(variant == "canonical"), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "cross_stack forward")
    cross_stack_forward.launches += 1
    return y


def cross_stack_backward(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                         dy: torch.Tensor, variant: str) -> tuple:
    """The backward kernels on CUDA tensors → ``(dx0, dw, db)``. dw and db
    are summed over the batch in a fixed order, so two calls on the same
    inputs give bit-identical gradients. ``cross_stack_backward.launches``
    counts the calls (each is the row kernel and the block-sum kernel)."""
    if x0.device.type != "cuda":
        raise ValueError(f"cross_stack_backward runs on cuda tensors, got {x0.device}")
    B, d, L = _check_inputs({"x0": x0, "w": w, "b": b, "dy": dy}, variant)
    lib = _library()
    _check_limits(lib, d, L)
    dx0, dw, db = torch.empty_like(x0), torch.empty_like(w), torch.empty_like(b)
    if B == 0 or L == 0:
        return (dy.clone() if L == 0 else dx0), dw.zero_(), db.zero_()
    partial = torch.empty((lib.hhrs_cross_bwd_blocks(B), 2, L, d), dtype=torch.float32,
                          device=x0.device)
    with torch.cuda.device(x0.device):
        err = lib.hhrs_cross_bwd(
            x0.data_ptr(), w.data_ptr(), b.data_ptr(), dy.data_ptr(), dx0.data_ptr(),
            dw.data_ptr(), db.data_ptr(), partial.data_ptr(), B, d, L,
            int(variant == "canonical"), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "cross_stack backward")
    cross_stack_backward.launches += 1
    return dx0, dw, db


cross_stack_forward.launches = 0
cross_stack_backward.launches = 0


class CrossStackFn(torch.autograd.Function):
    """The cross stack under autograd: the forward saves ``w, b, x0`` only
    and the backward recomputes the layer inputs. CUDA tensors go through
    the kernels, CPU tensors through the plain versions."""

    @staticmethod
    def forward(ctx, w, b, x0, variant):
        ctx.variant = variant
        ctx.save_for_backward(w, b, x0)
        if x0.device.type == "cuda":
            return cross_stack_forward(w, b, x0, variant)
        return cross_stack_apply(w, b, x0, variant)

    @staticmethod
    def backward(ctx, dy):
        w, b, x0 = ctx.saved_tensors
        dy = dy.contiguous()  # the output's gradient may be a strided slice
        if dy.device.type == "cuda":
            dx0, dw, db = cross_stack_backward(w, b, x0, dy, ctx.variant)
        else:
            dx0, dw, db = cross_stack_backward_ref(w, b, x0, dy, ctx.variant)
        return dw, db, dx0, None


def cross_stack(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str) -> torch.Tensor:
    """The cross stack as the model runs it: :func:`cross_stack_apply` on a
    CPU tensor; :class:`CrossStackFn` (the kernels) on a CUDA tensor."""
    if x0.device.type == "cpu":
        return cross_stack_apply(w, b, x0, variant)
    if x0.device.type != "cuda":
        raise ValueError(f"cross_stack runs on cpu or cuda tensors, got {x0.device}")
    _check_inputs({"x0": x0, "w": w, "b": b}, variant)
    return CrossStackFn.apply(w, b, x0, variant)


class CrossStack(nn.Module):
    def __init__(self, n_layers: int, dim: int, variant: str = "code",
                 generator: torch.Generator | None = None):
        super().__init__()
        if variant not in CROSS_VARIANTS:
            raise ValueError(f"unknown cross variant {variant!r}")
        self.variant = variant
        bound = 1.0 / math.sqrt(dim)
        self.w = nn.Parameter(torch.empty(n_layers, dim))
        self.b = nn.Parameter(torch.zeros(n_layers, dim))
        with torch.no_grad():
            self.w.uniform_(-bound, bound, generator=generator)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        return cross_stack(self.w, self.b, x0, self.variant)
