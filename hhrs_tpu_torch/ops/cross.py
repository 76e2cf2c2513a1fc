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
  ``csrc/cross_stack.cu`` on CUDA tensors, one kernel each, and count their
  launches; :func:`cross_plan` lays out the tiles and blocks of a launch;
* :class:`CrossStackFn` ties them into autograd; the forward is also the
  operator ``torch.ops.hhrs.cross_stack_fwd`` (:func:`cross_stack_fwd_op`;
  CPU: the plain version), which ``torch.export`` records. Both launch
  through :func:`_forward_launch`;
* :func:`cross_stack` is what :class:`CrossStack`, and so the model, calls:
  where a gradient is needed the plain version on a CPU tensor and
  :class:`CrossStackFn` on a CUDA tensor, elsewhere the operator. It never
  falls back from the kernels to the plain version: a CUDA input that the
  kernels cannot take raises;
* the trial axis, for K same-architecture HPO trials run as one program
  (``hpo/vectorized.py``, the counterpart of ``jax.vmap`` of
  ``cross_stack_pallas``): x0 ``[K, B, d]`` with w, b ``[K, L, d]``.
  :func:`cross_stack_apply_trials` and :func:`cross_stack_backward_ref_trials`
  are the plain versions (K single-trial calls); :func:`cross_stack_forward_trials`
  and :func:`cross_stack_backward_trials` launch the kernels once for all K
  trials: the forward under :func:`fwd_trial_plan`, the backward under
  :func:`trial_plan` (each the K grids in one wave), so lane k's y and dx0
  are bit for bit the single-trial kernels' on lane k's inputs, and its dw
  and db those of :func:`cross_stack_backward` under the trial plan;
  :class:`CrossStackTrialsFn` and :func:`cross_stack_trials` are the
  autograd function and the model's call.

Every function takes float32 or bfloat16 tensors (one dtype for all
inputs) and computes in their dtype as the JAX stack and its VJP do:
elementwise operations round to the dtype, a gate or row sum is summed in
f32 and rounded once, dw and db are f32 batch sums rounded once. For f32
the plain versions are the earlier ones, operation for operation; the
kernels have an f32 and a bf16 instantiation of the same code.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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
        gate = _gate(x, w[l])
        if variant == "code":
            x = x + x * gate + b[l]
        else:
            x = x0 * gate + b[l] + x
    return x


def _wide(t: torch.Tensor) -> torch.Tensor:
    """bf16 → f32 for a sum; f32 and f64 as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _gate(x: torch.Tensor, w_l: torch.Tensor) -> torch.Tensor:
    """The ``[B, 1]`` gate ``x . w_l`` in x's dtype: products summed in f32
    and rounded once (the product of two bf16 values is exact in f32), as
    JAX's einsum of bf16 operands gives it."""
    return (_wide(x) * _wide(w_l)).sum(dim=1, keepdim=True).to(x.dtype)


def _row_sum(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sum(a * c)`` over a row as the JAX VJP takes it: the product in the
    operands' dtype, summed in f32, rounded once."""
    return _wide(a * c).sum(dim=1, keepdim=True).to(a.dtype)


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
        gate = _gate(x, w[l])
        gates.append(gate)
        x = x + x * gate + b[l] if variant == "code" else x0 * gate + b[l] + x
    terms, dxs = [], [dy]
    dx, dx0 = dy, torch.zeros_like(x0)
    for l in reversed(range(w.shape[0])):
        s = _row_sum(dx, xs[l] if variant == "code" else x0)
        terms.append((l, xs[l], s, dx))
        if variant == "code" and x0.dtype == torch.bfloat16:
            dx = (dx + dx * gates[l]) + s * w[l]  # the VJP's own operations, each rounded to bf16
        elif variant == "code":
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
        dw[l] = (_wide(s) * _wide(x_l)).sum(dim=0)  # summed in f32, rounded once into dw's dtype
        db[l] = _wide(dx).sum(dim=0)
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
    share = torch.where(err == 0, 0.0, err / (atol + rtol * scale))  # 0, not 0/0, where both are 0
    bad = int((share > 1).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {bad} of {err.numel()} entries outside atol={atol} + "
                             f"rtol={rtol}·scale; max |Δ| {float(err.max()):.3e}")
    if not err.numel():
        return 0.0, 0.0
    return float(err.max()), float(share.max())


class _Kernels(NamedTuple):
    lib: ctypes.CDLL
    max_dim: int
    max_layers: int


@functools.cache
def _kernels() -> _Kernels:
    """Build (first use) and load ``csrc/cross_stack.cu``, with typed entry
    points and its limits, read once."""
    lib = cuda_build.load(_LIB_NAME, _LIB_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hhrs_cross_fwd.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.hhrs_cross_fwd.restype = i
    lib.hhrs_cross_bwd.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.hhrs_cross_bwd.restype = i
    q = ctypes.c_longlong
    lib.hhrs_cross_fwd_trials.argtypes = [p] * 4 + [i, q] + [i] * 8 + [p]
    lib.hhrs_cross_fwd_trials.restype = i
    lib.hhrs_cross_bwd_trials.argtypes = [p] * 9 + [i, q] + [i] * 9 + [p]
    lib.hhrs_cross_bwd_trials.restype = i
    lib.hhrs_cross_prepare.restype = i
    lib.hhrs_cross_capacity.argtypes = [i, i, i, i]
    lib.hhrs_cross_capacity.restype = i
    lib.hhrs_cross_max_dim.restype = i
    lib.hhrs_cross_max_layers.restype = i
    lib.hhrs_cross_error_string.argtypes = [i]
    lib.hhrs_cross_error_string.restype = ctypes.c_char_p
    return _Kernels(lib, lib.hhrs_cross_max_dim(), lib.hhrs_cross_max_layers())


# The launch plan. csrc/cross_stack.cu runs 8 warps a block and takes tiles
# of up to 48 rows (a multiple of ROW_ALIGN[dtype], 4 float32 rows or 8
# bfloat16 rows: a bulk copy moves a multiple of 16 bytes at any width),
# up to 3 tiles and 96 rows in flight per block (the forward's plans 64,
# FWD_RING, at whose shared memory the card's capacity for it is asked, so
# four blocks of it fit an SM at d = 145 in float32). A plan takes as
# many blocks as the card reports it runs at once, at the largest plan's
# shared memory: for the forward at most 4 an SM; for the backward, with
# its per-warp gradient sums in registers, at most 2 (up to d = 128; the
# kernel's launch bounds), in clusters of 8 blocks, which the card places
# within groups of SMs (a trial plan may take clusters of 2: CLUSTER_SIZES,
# each a kernel instance).
WARPS = 8
MAX_ROWS = 48
MAX_STAGES = 3
MAX_RING = 96
FWD_RING = 64
FWD_BLOCKS_PER_SM = 4
BWD_BLOCKS_PER_SM = 2
CLUSTER = 8
CLUSTER_SIZES = (8, 2)  # the backward's instances' clusters, CLUSTER first
ROW_ALIGN = {torch.float32: 4, torch.bfloat16: 8}


class CrossPlan(NamedTuple):
    rows: int  # rows per tile, a multiple of the dtype's ROW_ALIGN
    grid: int  # blocks; block k walks tiles k, k + grid, …
    stages: int  # a block's tiles in flight (its ring of tile buffers)
    cluster: int = CLUSTER  # backward: blocks a cluster, summed on chip (the forward has none)


def plan_capacity(sm_count: int, backward: bool, cluster: int = CLUSTER) -> int:
    """The most blocks of a kernel that a plan takes on a card with
    ``sm_count`` SMs: ``FWD_BLOCKS_PER_SM`` an SM for the forward; for the
    backward whole clusters of ``cluster`` blocks, at most
    ``BWD_BLOCKS_PER_SM`` an SM."""
    if backward:
        return max(cluster, BWD_BLOCKS_PER_SM * sm_count // cluster * cluster)
    return FWD_BLOCKS_PER_SM * sm_count


@functools.cache
def cross_plan(B: int, blocks: int, cluster: int = 1, align: int = 4) -> CrossPlan:
    """The plan of a kernel for ``B >= 1`` rows on a card that runs
    ``blocks`` blocks of it at once (a multiple of ``cluster``): tiles of
    8 rows, or as many more (a multiple of ``align``, the dtype's
    ``ROW_ALIGN``, up to ``MAX_ROWS``) as put
    the whole batch in one wave of those blocks, so a small batch still
    spreads over the card and a large one leaves no block a second tile; a
    batch larger than one such wave keeps up to ``MAX_STAGES`` tiles in
    flight per block. The grid is a whole number of clusters; blocks past
    the last tile only join their cluster's sums."""
    per_block = -(-B // blocks)
    rows = min(MAX_ROWS, max(WARPS, -(-per_block // align) * align))
    tiles = -(-B // rows)
    grid = -(-min(tiles, blocks) // cluster) * cluster
    return CrossPlan(rows, grid, min(MAX_STAGES, MAX_RING // rows, -(-tiles // grid)))


@functools.cache
def fwd_plan(B: int, blocks: int, align: int = 4) -> CrossPlan:
    """The forward's plan for ``B >= 1`` rows on a card that runs ``blocks``
    forward blocks at once: :func:`cross_plan`'s (no clusters), except where
    a block's share of the batch is more than ``MAX_ROWS`` rows. There the
    tiles are the fewest of at most ``FWD_RING / 2`` rows that hold a
    block's share, of equal rows (a multiple of ``align``), so two are in
    flight at once and no block carries a tile more than another where
    tiles of ``MAX_ROWS`` would (at 4096 rows over 66 blocks: two tiles of 48
    rows on 20 blocks, one on 46; here two of 32 on every block). At most
    ``FWD_RING`` rows are in flight a block."""
    per_block = -(-B // blocks)
    if per_block <= MAX_ROWS:
        plan = cross_plan(B, blocks, 1, align)
    else:
        share = -(-per_block // -(-per_block // (FWD_RING // 2)))
        rows = -(-share // align) * align
        tiles = -(-B // rows)
        grid = min(tiles, blocks)
        plan = CrossPlan(rows, grid, -(-tiles // grid))
    return plan._replace(stages=min(plan.stages, MAX_STAGES, FWD_RING // plan.rows))


@functools.cache
def fwd_trial_plan(B: int, K: int, blocks: int, align: int = 4) -> CrossPlan:
    """The plan of the trial-axis forward for ``K`` trials of ``B >= 1``
    rows on a card that runs ``blocks`` forward blocks at once: the
    single-trial :func:`fwd_plan` of B rows over ``blocks // K`` blocks (at
    least one). The K grids then fit the card together, in one wave,
    whenever ``K <= blocks``, and each block carries more rows (the
    kernel's warps walk two of them at once), where the single-trial plan of
    B rows took the whole card for each trial and the K grids ran in waves.
    Where K single-trial grids already fit the card, this is the
    single-trial plan."""
    return fwd_plan(B, max(1, blocks // K), align)


# A trial plan leaves clusters of 8 for clusters of 2 only where clusters of
# 8 would leave more than this share of the card's blocks idle: a smaller
# cluster sums more partial rows, which costs where a block has few rows
# (PERF.md section 6, kernel_ab.py on an H100: at K = 8, B = 512, d = 113,
# clusters of 8 leave 20 % of the blocks idle and beat clusters of 2; at B =
# 4096, d = 145, L = 6 they leave 47 % idle and take 1.6x as long; at K = 16
# and 64, both shapes, the rule picks clusters of 2, 1.25-1.97x faster).
TRIAL_IDLE_SHARE = 1 / 3


@functools.cache
def trial_plan(B: int, K: int, capacities: tuple, align: int = 4) -> CrossPlan:
    """The plan of the trial-axis backward for ``K`` trials of ``B >= 1``
    rows on a card that runs, for each cluster size c of ``capacities``
    (``((c, blocks), ...)``, ``CLUSTER`` first), ``blocks`` blocks of it at
    once in clusters of c: the single-trial :func:`cross_plan` of B rows over
    ``blocks // K`` blocks rounded down to whole clusters. The K grids then
    fit the card together, in one wave, and each block carries more rows
    (the kernel's warps walk two of them at once), where the single-trial
    plan of B rows took the whole card for each trial and the K grids ran in
    waves. Clusters of ``CLUSTER`` unless their rounding leaves more than
    ``TRIAL_IDLE_SHARE`` of the card idle (at d = 145 the card holds 15
    clusters of 8, so 8 trials would get 8 blocks each); then the size that
    leaves the most blocks a trial, the largest among equals. Where no size
    fits K trials at once, a cluster of ``CLUSTER`` a trial, in waves."""
    blocks = dict(capacities)
    per_trial = {c: n // K // c * c for c, n in capacities}
    if per_trial[CLUSTER] >= CLUSTER and K * per_trial[CLUSTER] >= (1 - TRIAL_IDLE_SHARE) * blocks[CLUSTER]:
        cluster = CLUSTER
    else:
        fits = [(n, c) for c, n in per_trial.items() if n >= c]
        cluster = max(fits)[1] if fits else CLUSTER
    return cross_plan(B, max(per_trial[cluster], cluster), cluster, align)._replace(cluster=cluster)


def capacity(x0: torch.Tensor, backward: bool, cluster: int = CLUSTER) -> int:
    """Blocks of the forward or backward kernel that the device of a CUDA
    ``x0`` runs at once at x0's width and dtype, as its plans take them (the
    backward in clusters of ``cluster`` blocks)."""
    return _capacity(x0.get_device(), x0.shape[1], backward, x0.dtype, cluster)


def plan_of(x0: torch.Tensor, backward: bool) -> CrossPlan:
    """The plan the forward or backward kernel takes for a CUDA ``x0``."""
    return _plan(max(x0.shape[0], 1), x0.get_device(), x0.shape[1], backward, x0.dtype)


@functools.cache
def _plan(B: int, device_index: int, d: int, backward: bool, dtype: torch.dtype) -> CrossPlan:
    if backward:
        return cross_plan(B, _capacity(device_index, d, True, dtype), CLUSTER, ROW_ALIGN[dtype])
    return fwd_plan(B, _capacity(device_index, d, False, dtype), ROW_ALIGN[dtype])


def fwd_trial_plan_of(x0: torch.Tensor) -> CrossPlan:
    """The plan the trial-axis forward takes for a CUDA ``x0 [K, B, d]``:
    :func:`fwd_trial_plan` on the card's capacity."""
    K, B, d = x0.shape
    return _fwd_trial_plan(max(B, 1), K, x0.get_device(), d, x0.dtype)


@functools.cache
def _fwd_trial_plan(B: int, K: int, device_index: int, d: int, dtype: torch.dtype) -> CrossPlan:
    return fwd_trial_plan(B, K, _capacity(device_index, d, False, dtype), ROW_ALIGN[dtype])


def trial_plan_of(x0: torch.Tensor) -> CrossPlan:
    """The plan the trial-axis backward takes for a CUDA ``x0 [K, B, d]``:
    :func:`trial_plan` on the card's capacity."""
    K, B, d = x0.shape
    return _trial_plan(max(B, 1), K, x0.get_device(), d, x0.dtype)


@functools.cache
def _trial_plan(B: int, K: int, device_index: int, d: int, dtype: torch.dtype) -> CrossPlan:
    capacities = tuple((c, _capacity(device_index, d, True, dtype, c)) for c in CLUSTER_SIZES)
    return trial_plan(B, K, capacities, ROW_ALIGN[dtype])


@functools.cache
def _sm_count(device_index: int) -> int:
    """The device's SM count, read once; lets the kernels there take the
    shared memory of the largest plan."""
    k = _kernels()
    with torch.cuda.device(device_index):
        err = k.lib.hhrs_cross_prepare()
    _raise_on(k.lib, err, "cross_stack set-up")
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _capacity(device_index: int, d: int, backward: bool, dtype: torch.dtype, cluster: int = CLUSTER) -> int:
    """Blocks of the forward or backward for rows of width ``d`` and
    ``dtype`` that the device runs at once (the backward in whole clusters
    of ``cluster`` blocks), asked of the card once, up to
    :func:`plan_capacity`."""
    most = plan_capacity(_sm_count(device_index), backward, cluster)
    lib = _kernels().lib
    with torch.cuda.device(device_index):
        n = lib.hhrs_cross_capacity(d, backward, dtype == torch.bfloat16, cluster)
    if n < 0:
        _raise_on(lib, -n, "asking for the cross kernels' occupancy")
    if n < (cluster if backward else 1):
        raise RuntimeError(f"the card runs {n} blocks of the cross {'backward' if backward else 'forward'} "
                           "at once")
    return min(n, most)


class BackwardScratch(NamedTuple):
    """The backward's clusters' partial sums and its ticket counter (at 0
    between launches: every launch leaves it so)."""

    partial: torch.Tensor
    counter: torch.Tensor


def _new_scratch(device_index: int, trials: int, floats: int) -> BackwardScratch:
    """A backward scratch on a CUDA device: ``floats`` floats of the
    clusters' partial sums and ``trials`` ticket counters at 0."""
    dev = torch.device("cuda", device_index)
    return BackwardScratch(torch.empty(floats, dtype=torch.float32, device=dev),
                           torch.zeros(trials, dtype=torch.int32, device=dev))


_scratch: dict = {}  # (device, stream) -> the eager launches' scratch


def _backward_scratch(device_index: int, stream: int, trials: int, floats: int) -> BackwardScratch:
    """The scratch of a backward launched on ``stream`` for ``trials``
    trials whose clusters' partial sums take ``floats`` floats (one slice
    and one counter a trial). Eager launches on one stream run in order, so
    they share one, allocated at the stream's first backward and grown to
    the most a launch there has needed. Inside a CUDA-graph capture every
    backward allocates a scratch of its own there, from the graph's private
    memory pool: the graph owns it as long as it lives, and its counters are
    zeroed by a memset the graph replays (the kernel leaves them at 0 in any
    case). Two graphs, even of one capture stream, never share one."""
    if torch.cuda.is_current_stream_capturing():
        return _new_scratch(device_index, trials, floats)
    key = (device_index, stream)
    have = _scratch.get(key)
    if have is None or have.counter.numel() < trials or have.partial.numel() < floats:
        if have is not None:
            trials, floats = max(trials, have.counter.numel()), max(floats, have.partial.numel())
        _scratch[key] = have = _new_scratch(device_index, trials, floats)
    return have


def _scratch_floats(plan: CrossPlan, trials: int, L: int, d: int) -> int:
    """Floats of the clusters' partial sums of a backward launch: ``2·L·d``
    for each cluster of each trial."""
    return trials * (plan.grid // plan.cluster) * 2 * L * d


def _check_inputs(tensors: dict, variant: str) -> tuple:
    """Device, dtype (float32 or bfloat16, one for all), shape, contiguity,
    alignment and size checks of CUDA inputs → ``(B, d, L)``."""
    if variant not in CROSS_VARIANTS:
        raise ValueError(f"unknown cross variant {variant!r}")
    x0, w = tensors["x0"], tensors["w"]
    if x0.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x0 must be [B, d] and w [L, d], got {tuple(x0.shape)} and {tuple(w.shape)}")
    (B, d), L = x0.shape, w.shape[0]
    where = x0.get_device()
    for name, t in tensors.items():
        if t.get_device() != where:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if t.dtype != x0.dtype or t.dtype not in ROW_ALIGN:
            raise TypeError(f"the cross kernels take float32 or bfloat16 inputs of one dtype; {name} is "
                            f"{t.dtype}, x0 {x0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = (L, d) if name in ("w", "b") else (B, d)
        if t.shape != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
        if name in ("x0", "dy") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernels bulk-copy its rows)")
    k = _kernels()
    if not 1 <= d <= k.max_dim:
        raise ValueError(f"the cross kernels take 1 <= d <= {k.max_dim}, got d={d}")
    if L > k.max_layers:
        raise ValueError(f"the cross kernels take at most {k.max_layers} layers, got {L}")
    return B, d, L


def _check_plan(plan: CrossPlan, device_index: int, backward: bool, dtype: torch.dtype) -> None:
    align, cluster = ROW_ALIGN[dtype], plan.cluster if backward else 1
    if not (plan.rows % align == 0 and align <= plan.rows <= MAX_ROWS and 1 <= plan.stages <= MAX_STAGES
            and plan.stages * plan.rows <= MAX_RING and (cluster in CLUSTER_SIZES or not backward)
            and 1 <= plan.grid <= plan_capacity(_sm_count(device_index), backward, cluster)
            and plan.grid % cluster == 0):
        raise ValueError(f"not a cross-stack plan on this device: {plan}")


def _current_stream(device_index: int) -> int:
    """The handle of the device's current stream (what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.hhrs_cross_error_string(err).decode()}")


def cross_stack_forward(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str,
                        plan: CrossPlan | None = None) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors (current stream,
    asynchronous) → ``[B, d]``, with :func:`plan_of`'s plan unless one is
    given (any valid plan gives the same ``y`` bit for bit);
    ``cross_stack_forward.launches`` counts the float32 launches,
    ``.launches_bf16`` the bfloat16 ones."""
    if not x0.is_cuda:
        raise ValueError(f"cross_stack_forward runs on cuda tensors, got {x0.device}")
    _check_inputs({"x0": x0, "w": w, "b": b}, variant)
    if plan is not None:
        _check_plan(plan, x0.get_device(), False, x0.dtype)
    return _forward(w, b, x0, variant == "canonical", plan)


def _forward(w, b, x0, canonical: bool, plan: CrossPlan | None) -> torch.Tensor:
    index = x0.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _forward(w, b, x0, canonical, plan)
    y = torch.empty_like(x0)
    B, d = x0.shape
    if B == 0:
        return y
    p = plan or _plan(B, index, d, False, x0.dtype)
    lib = _kernels().lib
    err = lib.hhrs_cross_fwd(x0.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, d, w.shape[0],
                             canonical, p.rows, p.grid, p.stages, x0.dtype == torch.bfloat16,
                             _current_stream(index))
    _raise_on(lib, err, "cross_stack forward kernel launch")
    if x0.dtype == torch.bfloat16:
        cross_stack_forward.launches_bf16 += 1
    else:
        cross_stack_forward.launches += 1
    return y


def cross_stack_backward(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, dy: torch.Tensor,
                         variant: str, plan: CrossPlan | None = None) -> tuple:
    """One launch of the backward kernel on CUDA tensors → ``(dx0, dw,
    db)``, with :func:`plan_of`'s plan unless one is given (any valid plan
    gives the same ``dx0`` bit for bit). dw and db are summed over the batch
    in an order fixed by the plan, so two calls on the same inputs give
    bit-identical gradients. ``cross_stack_backward.launches`` counts the
    float32 launches, ``.launches_bf16`` the bfloat16 ones."""
    if not x0.is_cuda:
        raise ValueError(f"cross_stack_backward runs on cuda tensors, got {x0.device}")
    _check_inputs({"x0": x0, "w": w, "b": b, "dy": dy}, variant)
    if plan is not None:
        _check_plan(plan, x0.get_device(), True, x0.dtype)
    return _backward(w, b, x0, dy, variant == "canonical", plan)


def _backward(w, b, x0, dy, canonical: bool, plan: CrossPlan | None) -> tuple:
    index = x0.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _backward(w, b, x0, dy, canonical, plan)
    dx0, dw, db = torch.empty_like(x0), torch.empty_like(w), torch.empty_like(b)
    (B, d), L = x0.shape, w.shape[0]
    if B == 0 or L == 0:
        return (dy.clone() if L == 0 else dx0), dw.zero_(), db.zero_()
    p = plan or _plan(B, index, d, True, x0.dtype)
    stream = _current_stream(index)
    partial, counter = _backward_scratch(index, stream, 1, _scratch_floats(p, 1, L, d))
    lib = _kernels().lib
    err = lib.hhrs_cross_bwd(x0.data_ptr(), w.data_ptr(), b.data_ptr(), dy.data_ptr(), dx0.data_ptr(),
                             dw.data_ptr(), db.data_ptr(), partial.data_ptr(), counter.data_ptr(),
                             B, d, L, canonical, p.rows, p.grid, p.stages, p.cluster, x0.dtype == torch.bfloat16,
                             stream)
    _raise_on(lib, err, "cross_stack backward kernel launch")
    if x0.dtype == torch.bfloat16:
        cross_stack_backward.launches_bf16 += 1
    else:
        cross_stack_backward.launches += 1
    return dx0, dw, db


# Launches of each instantiation: ``launches`` float32, ``launches_bf16`` bfloat16.
cross_stack_forward.launches = cross_stack_forward.launches_bf16 = 0
cross_stack_backward.launches = cross_stack_backward.launches_bf16 = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it: contiguous and on a 16-byte boundary
    (copied if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward_launch(w, b, x0, variant: str) -> torch.Tensor:
    """The forward launch of :class:`CrossStackFn` and of
    ``hhrs::cross_stack_fwd`` on CUDA tensors: x0 aligned, the inputs
    checked once, :func:`plan_of`'s plan."""
    xa = _aligned(x0)
    _check_inputs({"x0": xa, "w": w, "b": b}, variant)
    return _forward(w, b, xa, variant == "canonical", None)


class CrossStackFn(torch.autograd.Function):
    """The cross stack under autograd: the forward saves ``w, b, x0`` only
    and the backward recomputes the layer inputs. On CUDA tensors the
    kernels, inputs checked once (a strided or misaligned ``x0`` or ``dy``
    copied), on CPU tensors the plain versions. The backward is
    :class:`CrossBackwardFn`, itself differentiable, so a double backward
    (``create_graph=True``) is exact: the grad of grad of the jnp stack
    whose VJP ``cross_stack_pallas`` takes."""

    @staticmethod
    def forward(ctx, w, b, x0, variant):
        ctx.variant = variant
        y = _forward_launch(w, b, x0, variant) if x0.is_cuda else cross_stack_apply(w, b, x0, variant)
        ctx.save_for_backward(w, b, x0)
        return y

    @staticmethod
    def backward(ctx, dy):
        w, b, x0 = ctx.saved_tensors
        dx0, dw, db = CrossBackwardFn.apply(w, b, x0, dy, ctx.variant)
        return dw, db, dx0, None


class CrossBackwardFn(torch.autograd.Function):
    """The cross stack's backward ``(w, b, x0, dy) → (dx0, dw, db)`` as a
    function autograd can differentiate again. Its values come from the
    backward kernel on CUDA tensors (from :func:`cross_stack_backward_ref`
    on CPU tensors); its own backward differentiates the closed form
    :func:`cross_stack_backward_ref` in plain ops, with a graph of its own
    when asked, so derivatives of every order are exact. Only a second
    derivative runs plain ops on the card; the first-order values always
    come from the kernel."""

    @staticmethod
    def forward(ctx, w, b, x0, dy, variant):
        ctx.variant = variant
        ctx.save_for_backward(w, b, x0, dy)
        if not dy.is_cuda:
            return cross_stack_backward_ref(w, b, x0, dy.contiguous(), variant)
        dy = _aligned(dy)  # the output's gradient may be a strided slice
        if dy.dtype != x0.dtype or dy.shape != x0.shape or dy.device != x0.device:
            raise ValueError(f"dy must be {x0.dtype} {tuple(x0.shape)} on {x0.device}, got "
                             f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
        return _backward(w, b, _aligned(x0), dy, variant == "canonical", None)

    @staticmethod
    def backward(ctx, gdx0, gdw, gdb):
        create = torch.is_grad_enabled()  # asked for a graph of this backward too
        with torch.enable_grad():  # the inputs that carry a graph keep it: a third order stays exact
            ins = [t if t.requires_grad else t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = cross_stack_backward_ref(*ins, ctx.variant)
            grads = torch.autograd.grad(outs, ins, (gdx0, gdw, gdb), create_graph=create, allow_unused=True,
                                        materialize_grads=True)
        return (*grads, None)


def cross_stack(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str) -> torch.Tensor:
    """The cross stack as the model runs it. Where a gradient is needed:
    :class:`CrossStackFn` (the kernels) on a CUDA tensor, autograd through
    :func:`cross_stack_apply` on a CPU tensor. Elsewhere the operator
    ``hhrs::cross_stack_fwd`` (what ``torch.export`` records): the same
    forward launch on the card, the same plain version on the CPU."""
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cross_stack runs on cpu or cuda tensors, got {x0.device}")
    if torch.is_grad_enabled() and (x0.requires_grad or w.requires_grad or b.requires_grad):
        return CrossStackFn.apply(w, b, x0, variant) if x0.is_cuda else cross_stack_apply(w, b, x0, variant)
    return torch.ops.hhrs.cross_stack_fwd(x0, w, b, variant)


@torch.library.custom_op("hhrs::cross_stack_fwd", mutates_args=(), device_types="cuda")
def cross_stack_fwd_op(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor, variant: str) -> torch.Tensor:
    """``hhrs::cross_stack_fwd(x0, w, b, variant) → [B, d]`` in x0's dtype:
    the forward kernel as an operator that ``torch.export`` records. On CUDA
    tensors one launch of ``hhrs_cross_fwd`` (its bf16 instance on bf16
    inputs) under :func:`plan_of`'s plan, counted as
    :func:`cross_stack_forward` counts; a strided or misaligned ``x0`` is
    copied first. :class:`CrossStackFn`'s forward launch
    (:func:`_forward_launch`), so the same bits."""
    return _forward_launch(w, b, x0, variant)


@cross_stack_fwd_op.register_kernel("cpu")
def _cross_stack_fwd_op_cpu(x0, w, b, variant):
    y = cross_stack_apply(w, b, x0, variant)
    return y.clone() if y is x0 else y  # an operator's output never aliases its input (L = 0)


@cross_stack_fwd_op.register_fake
def _cross_stack_fwd_op_fake(x0, w, b, variant):
    return torch.empty_like(x0)


# ---- the trial axis ---------------------------------------------------------


def cross_stack_apply_trials(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str) -> torch.Tensor:
    """The plain trial-axis forward: x0 ``[K, B, d]``, w, b ``[K, L, d]`` →
    ``[K, B, d]``, lane k being :func:`cross_stack_apply` on lane k's inputs
    (``jax.vmap`` of the stack)."""
    _check_trial_shapes(w, b, x0)
    return torch.stack([cross_stack_apply(w[k], b[k], x0[k], variant) for k in range(x0.shape[0])])


def cross_stack_backward_ref_trials(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, dy: torch.Tensor,
                                    variant: str) -> tuple:
    """The plain trial-axis backward → ``(dx0 [K, B, d], dw [K, L, d], db
    [K, L, d])``, lane k's dw and db summed over lane k's rows only."""
    _check_trial_shapes(w, b, x0)
    lanes = [cross_stack_backward_ref(w[k], b[k], x0[k], dy[k], variant) for k in range(x0.shape[0])]
    return tuple(torch.stack(t) for t in zip(*lanes))


def _check_trial_shapes(w, b, x0) -> None:
    if x0.dim() != 3 or w.dim() != 3 or b.shape != w.shape or w.shape[0] != x0.shape[0] \
            or w.shape[2] != x0.shape[2] or x0.shape[0] < 1:
        raise ValueError(f"the trial axis takes x0 [K, B, d] and w, b [K, L, d] with K >= 1, got "
                         f"{tuple(x0.shape)}, {tuple(w.shape)} and {tuple(b.shape)}")


def _check_trial_inputs(tensors: dict, variant: str) -> tuple:
    """:func:`_check_inputs` for the trial axis → ``(K, B, d, L)``: each
    lane as the single-trial kernels take it, the arrays stacked and
    contiguous."""
    x0, w = tensors["x0"], tensors["w"]
    _check_trial_shapes(w, tensors["b"], x0)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"the trial-axis kernels run on cuda tensors, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != (w.shape if name in ("w", "b") else x0.shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(w.shape if name in ('w', 'b') else x0.shape)}")
    K = x0.shape[0]
    B, d, L = _check_inputs({name: t[0] for name, t in tensors.items()}, variant)
    if K > 65535:
        raise ValueError(f"the trial-axis kernels take at most 65535 trials, got {K}")
    return K, B, d, L


def _lane_stride(t: torch.Tensor) -> int:
    """Elements from one lane's rows of ``t [K, B, d]`` to the next's, so
    that every lane starts on a 16-byte boundary (the kernels bulk-copy each
    lane's rows): ``B·d``, or each lane padded to a multiple of the dtype's
    ``ROW_ALIGN`` rows."""
    K, B, d = t.shape
    if K == 1 or B * d * t.element_size() % 16 == 0:
        return B * d
    return -(-B // ROW_ALIGN[t.dtype]) * ROW_ALIGN[t.dtype] * d


def _laid_out(t: torch.Tensor, stride: int) -> torch.Tensor:
    """``t [K, B, d]`` itself where its lanes lie ``stride`` elements apart,
    else a copy laid out so (``[K, stride / d, d]``, the rows past B
    unused)."""
    K, B, d = t.shape
    if stride == B * d:
        return t
    out = torch.empty((K, stride // d, d), dtype=t.dtype, device=t.device)
    out[:, :B] = t
    return out


def cross_stack_forward_trials(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str,
                               plan: CrossPlan | None = None) -> torch.Tensor:
    """One launch of the forward kernel for K trials on CUDA tensors → y
    ``[K, B, d]``, each trial under :func:`fwd_trial_plan_of`'s plan unless
    one is given; lane k is :func:`cross_stack_forward` on lane k's inputs
    bit for bit under any plan. ``.launches`` counts the float32 launches,
    ``.launches_bf16`` the bfloat16 ones."""
    _check_trial_inputs({"x0": x0, "w": w, "b": b}, variant)
    if plan is not None:
        _check_plan(plan, x0.get_device(), False, x0.dtype)
    return _forward_trials(w, b, x0, variant == "canonical", plan)


def _forward_trials(w, b, x0, canonical: bool, plan: CrossPlan | None) -> torch.Tensor:
    index = x0.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _forward_trials(w, b, x0, canonical, plan)
    K, B, d = x0.shape
    if B == 0:
        return torch.empty_like(x0)
    stride = _lane_stride(x0)
    xa = _laid_out(x0, stride)
    y = torch.empty_like(xa)
    p = plan or _fwd_trial_plan(B, K, index, d, x0.dtype)
    lib = _kernels().lib
    err = lib.hhrs_cross_fwd_trials(xa.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), K, stride, B, d,
                                    w.shape[1], canonical, p.rows, p.grid, p.stages,
                                    x0.dtype == torch.bfloat16, _current_stream(index))
    _raise_on(lib, err, "cross_stack trial-axis forward kernel launch")
    if x0.dtype == torch.bfloat16:
        cross_stack_forward_trials.launches_bf16 += 1
    else:
        cross_stack_forward_trials.launches += 1
    return y if stride == B * d else y[:, :B]


def cross_stack_backward_trials(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, dy: torch.Tensor,
                                variant: str, plan: CrossPlan | None = None) -> tuple:
    """One launch of the backward kernel for K trials on CUDA tensors →
    ``(dx0 [K, B, d], dw [K, L, d], db [K, L, d])``, each trial under
    :func:`trial_plan_of`'s plan unless one is given, its dw and db summed
    over its own rows in that plan's order: lane k is
    :func:`cross_stack_backward` on lane k's inputs under the same plan bit
    for bit (dx0 under any plan). ``.launches`` / ``.launches_bf16`` count
    the launches."""
    _check_trial_inputs({"x0": x0, "w": w, "b": b, "dy": dy}, variant)
    if plan is not None:
        _check_plan(plan, x0.get_device(), True, x0.dtype)
    return _backward_trials(w, b, x0, dy, variant == "canonical", plan)


def _backward_trials(w, b, x0, dy, canonical: bool, plan: CrossPlan | None) -> tuple:
    index = x0.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _backward_trials(w, b, x0, dy, canonical, plan)
    (K, B, d), L = x0.shape, w.shape[1]
    dw, db = torch.empty_like(w), torch.empty_like(b)
    if B == 0 or L == 0:
        return (dy.clone() if L == 0 else torch.empty_like(x0)), dw.zero_(), db.zero_()
    stride = _lane_stride(x0)
    xa, dya = _laid_out(x0, stride), _laid_out(dy, stride)
    dx0 = torch.empty_like(xa)
    p = plan or _trial_plan(B, K, index, d, x0.dtype)
    stream = _current_stream(index)
    partial, counter = _backward_scratch(index, stream, K, _scratch_floats(p, K, L, d))
    lib = _kernels().lib
    err = lib.hhrs_cross_bwd_trials(xa.data_ptr(), w.data_ptr(), b.data_ptr(), dya.data_ptr(), dx0.data_ptr(),
                                    dw.data_ptr(), db.data_ptr(), partial.data_ptr(), counter.data_ptr(), K,
                                    stride, B, d, L, canonical, p.rows, p.grid, p.stages, p.cluster,
                                    x0.dtype == torch.bfloat16, stream)
    _raise_on(lib, err, "cross_stack trial-axis backward kernel launch")
    if x0.dtype == torch.bfloat16:
        cross_stack_backward_trials.launches_bf16 += 1
    else:
        cross_stack_backward_trials.launches += 1
    return (dx0 if stride == B * d else dx0[:, :B]), dw, db


cross_stack_forward_trials.launches = cross_stack_forward_trials.launches_bf16 = 0
cross_stack_backward_trials.launches = cross_stack_backward_trials.launches_bf16 = 0


class CrossStackTrialsFn(torch.autograd.Function):
    """The trial-axis stack under autograd: one forward and one backward
    launch for all K lanes on CUDA tensors, the plain versions on CPU
    tensors. The forward saves ``w, b, x0`` and the backward recomputes the
    layer inputs, as :class:`CrossStackFn` does; unlike it, its backward is
    not differentiable again (an HPO step takes first derivatives only)."""

    @staticmethod
    def forward(ctx, w, b, x0, variant, plan_lanes=None):
        ctx.variant, ctx.plan_lanes = variant, plan_lanes
        ctx.save_for_backward(w, b, x0)
        if x0.is_cuda:
            _check_trial_inputs({"x0": x0, "w": w, "b": b}, variant)
            plan = None
            if plan_lanes is not None:
                plan = _fwd_trial_plan(max(x0.shape[1], 1), plan_lanes, x0.get_device(), x0.shape[2], x0.dtype)
            return _forward_trials(w, b, x0, variant == "canonical", plan)
        return cross_stack_apply_trials(w, b, x0, variant)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        w, b, x0 = ctx.saved_tensors
        dy = dy.contiguous()
        if dy.is_cuda:
            if dy.dtype != x0.dtype or dy.shape != x0.shape or dy.device != x0.device:
                raise ValueError(f"dy must be {x0.dtype} {tuple(x0.shape)} on {x0.device}, got "
                                 f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
            plan = None
            if ctx.plan_lanes is not None:
                plan = _trial_plan(max(x0.shape[1], 1), ctx.plan_lanes, x0.get_device(), x0.shape[2], x0.dtype)
            dx0, dw, db = _backward_trials(w, b, x0, dy, ctx.variant == "canonical", plan)
        else:
            dx0, dw, db = cross_stack_backward_ref_trials(w, b, x0, dy, ctx.variant)
        return dw, db, dx0, None, None


def cross_stack_trials(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str,
                       plan_lanes: int | None = None) -> torch.Tensor:
    """The trial-axis stack as the K-lane model runs it: autograd through
    :func:`cross_stack_apply_trials` on CPU tensors (each lane the
    single-trial model's plain stack); :class:`CrossStackTrialsFn` (the
    kernels) on CUDA tensors. ``plan_lanes``: launch under the plans of a
    group of that many lanes (:func:`fwd_trial_plan_of`, :func:`trial_plan_of`
    at K = ``plan_lanes``) instead of this call's K, so a lane's dw and db
    are summed in that group's order (a rank's share of a sharded group)."""
    if x0.is_cuda:
        return CrossStackTrialsFn.apply(w, b, x0, variant, plan_lanes)
    if x0.device.type != "cpu":
        raise ValueError(f"cross_stack_trials runs on cpu or cuda tensors, got {x0.device}")
    return cross_stack_apply_trials(w, b, x0, variant)


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

    def forward(self, x0: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """x0 ``[B, d]`` → ``[B, d]`` through :func:`cross_stack`; with
        ``compute_dtype`` x0, w and b are cast to it first (w and b keep f32
        gradients through the cast)."""
        w, b = self.w, self.b
        if compute_dtype is not None:
            x0, w, b = x0.to(compute_dtype), w.to(compute_dtype), b.to(compute_dtype)
        return cross_stack(w, b, x0, self.variant)
