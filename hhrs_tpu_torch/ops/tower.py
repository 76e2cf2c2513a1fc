"""Fused eval-mode DCN-R tower: BN folding, the plain version, the kernel.

Counterpart of ``hhrs_tpu/ops/pallas/tower_kernel.py``. The serve engine
scores every ``dcnr`` request through :func:`tower_eval`:

* :func:`fold_eval_params` folds eval BatchNorm into the residual blocks'
  linears: ``BN(x) = a x + c`` with ``a = scale / sqrt(var + eps)`` and
  ``c = bias − mean·a``, so ``W' = W a`` and ``b' = a b + c``;
* :func:`build_x0` is the embedding-gather + concat front half;
* :func:`tower_eval_ref` is the plain PyTorch version of the tower;
* :func:`tower_eval` launches ``csrc/tower_eval.cu`` on a CUDA tensor and
  calls the plain version on a CPU tensor. It never falls back from one to
  the other: a CUDA input that the kernel cannot take raises;
* :func:`tower_plan` picks the launch plan (rows per tile, cluster size)
  from B and each plan's wave time, timed at first use per widths
  (:func:`_wave_ms`); :func:`tower_layout` lays out the block's shared
  memory;
* ``torch.ops.hhrs.tower_eval`` (:func:`tower_eval_op`) is the same
  function as a registered operator, which ``torch.export`` records in a
  program (``serve/export.py``): its CUDA implementation is
  :func:`tower_eval` (the kernel, launch plan and count included), its CPU
  implementation :func:`tower_eval_ref`, and its fake implementation gives
  the ``[B]`` output of a symbolic B. Importing this module registers it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hhrs_tpu_torch.ops import cuda_build
from hhrs_tpu_torch.ops.cross import CROSS_VARIANTS, cross_stack_apply

_FOLDED_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2", "cross_w", "cross_b", "final_w", "final_b")
_LIB_NAME, _LIB_SOURCES = "tower_eval", ["tower_eval.cu"]
TOWER_TOL = 2e-5  # kernel against the plain version, rtol and atol: the JAX kernel's parity bar


def uses_tower(cfg) -> bool:
    """Whether a model config is scored through the fused tower: ``dcnr`` at
    float32 compute and storage (the engine's route, and the exported
    program's; a bf16 model runs ``DCNR.forward``)."""
    return cfg.arch == "dcnr" and cfg.compute_dtype == "float32" and cfg.storage_dtype == "float32"


@torch.no_grad()
def fold_eval_params(model) -> dict:
    """Fold a ``dcnr`` :class:`~hhrs_tpu_torch.models.dcn.DCNR`'s eval-mode
    BatchNorm into its linears → dict of contiguous f32 tensors:
    ``w0 [d, H]``, ``b0 [H]``, ``w1``/``w2 [R, H, H]``, ``b1``/``b2 [R, H]``,
    ``cross_w``/``cross_b [L, d]``, ``final_w [H + d]``, ``final_b []``."""
    if model.cfg.arch != "dcnr":
        raise ValueError(f"fold_eval_params supports arch='dcnr' only, got {model.cfg.arch!r}")
    eps = model.cfg.bn_eps

    def fold(lin, bn):
        a = bn.scale / torch.sqrt(bn.var + eps)
        c = bn.bias - bn.mean * a
        return lin.kernel * a[None, :], lin.bias * a + c

    H = model.cfg.hidden_dim
    w1, b1, w2, b2 = [], [], [], []
    for block in model.res_blocks:
        w, b = fold(block.layer1, block.bn1)
        w1.append(w)
        b1.append(b)
        w, b = fold(block.layer2, block.bn2)
        w2.append(w)
        b2.append(b)
    dev = model.final.kernel.device
    stack = lambda ts, shape: (  # noqa: E731
        torch.stack(ts) if ts else torch.zeros(shape, device=dev)
    )
    folded = {
        "w0": model.initial_deep.kernel,
        "b0": model.initial_deep.bias,
        "w1": stack(w1, (0, H, H)),
        "b1": stack(b1, (0, H)),
        "w2": stack(w2, (0, H, H)),
        "b2": stack(b2, (0, H)),
        "cross_w": model.cross.w,
        "cross_b": model.cross.b,
        "final_w": model.final.kernel[:, 0],
        "final_b": model.final.bias[0],
    }
    return {k: v.detach().float().contiguous() for k, v in folded.items()}


def build_x0(model, user_ids, item_ids, cat_features, num_features) -> torch.Tensor:
    """``[user_emb ⊕ item_emb ⊕ cat_embs… ⊕ num_features]`` → ``[B, d]``
    (counterpart of ``tower_kernel.py::build_x0``; the model's own gather)."""
    return model.embed(user_ids, item_ids, cat_features, num_features)


def score_rows(model, folded: dict | None, users, items, x_cat, x_num) -> torch.Tensor:
    """The serving route of a model → ``[B]`` logits: the fused tower on
    :func:`build_x0` where ``folded`` (:func:`fold_eval_params`) is given,
    which :func:`uses_tower` models are, else ``DCNR.forward`` (on a card
    through the ``hhrs::cross_stack_fwd`` operator)."""
    if folded is not None:
        return tower_eval(folded, build_x0(model, users, items, x_cat, x_num), model.cfg.cross_variant)
    return model(users, items, x_cat, x_num)


def tower_eval_ref(folded: dict, x0: torch.Tensor, variant: str = "code") -> torch.Tensor:
    """Plain PyTorch version of the fused tower: ``[B, d]`` → ``[B]`` logits."""
    deep = x0 @ folded["w0"] + folded["b0"]
    for r in range(folded["w1"].shape[0]):
        h = torch.relu(deep @ folded["w1"][r] + folded["b1"][r])
        deep = torch.relu(h @ folded["w2"][r] + folded["b2"][r] + deep)
    x = cross_stack_apply(folded["cross_w"], folded["cross_b"], x0, variant)
    H = folded["w0"].shape[1]
    fw = folded["final_w"]
    return (deep * fw[:H]).sum(dim=1) + (x * fw[H:]).sum(dim=1) + folded["final_b"]


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/tower_eval.cu``, with typed entry points."""
    lib = cuda_build.load(_LIB_NAME, _LIB_SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hhrs_tower_eval.argtypes = [p] * 12 + [i] * 10 + [p]
    lib.hhrs_tower_eval.restype = i
    lib.hhrs_tower_eval_prepare.argtypes = [i] * 7
    lib.hhrs_tower_eval_prepare.restype = i
    lib.hhrs_tower_eval_smem_bytes.argtypes = [i] * 6
    lib.hhrs_tower_eval_smem_bytes.restype = ctypes.c_longlong
    lib.hhrs_tower_eval_resident_clusters.argtypes = [i] * 2
    lib.hhrs_tower_eval_resident_clusters.restype = i
    lib.hhrs_cuda_error_string.argtypes = [i]
    lib.hhrs_cuda_error_string.restype = ctypes.c_char_p
    return lib


# The launch plan. These mirror csrc/tower_eval.cu: a block has 256
# threads in 4 row groups x 2 column groups, a lane owns columns 64 apart
# (at most _MAX_LANE_COLS[rows] of them), a transposed activation has a
# stride of rows + 4, and the weights stream through a ring of panels of
# 16 to 64 k-rows.
TILE_ROWS = (16, 32, 64)
CLUSTER_SIZES = (1, 2, 4, 8)  # 8 is the portable maximum
_MAX_LANE_COLS = {16: 8, 32: 8, 64: 5}
_RING_CAP = 96 * 1024  # bytes of weight panels in flight


@functools.cache
def _device_limits(device_index: int) -> tuple[int, dict]:
    """``(smem_optin, resident)`` of a device: the dynamic shared memory one
    block may opt in to, and for each cluster size how many clusters of
    blocks that each take a whole SM it runs at once (1: the SM count)."""
    props = torch.cuda.get_device_properties(device_index)
    smem_optin = props.shared_memory_per_block_optin
    resident = {1: props.multi_processor_count}
    lib = _library()
    with torch.cuda.device(device_index):
        for c in CLUSTER_SIZES[1:]:
            n = lib.hhrs_tower_eval_resident_clusters(c, smem_optin)
            if n < 0:
                raise RuntimeError(f"cannot ask how many clusters of {c} fit: "
                                   f"{lib.hhrs_cuda_error_string(-n).decode()}")
            resident[c] = n
    return smem_optin, resident


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _lane_cols(H: int, cluster: int) -> int:
    return -(-_round4(-(-H // cluster)) // 64)


def tower_column_slices(H: int, cluster: int) -> list[tuple[int, int]]:
    """``(first column, width)`` of each block of a cluster: slices of
    ``round4(ceil(H / cluster))`` columns, so a slice starts on a multiple
    of 4; the last ones are ragged or empty."""
    nc = _round4(-(-H // cluster))
    return [(min(c * nc, H), min(nc, H - min(c * nc, H))) for c in range(cluster)]


def tower_layout(d: int, H: int, rows: int, cluster: int, smem_optin: int) -> tuple[int, int, int]:
    """``(panel_k, stages, smem_bytes)`` of one block: deep and h transposed
    (``[k][rows + 4]``; h holds x0 and the cross rows until the first
    product is done), the cross rows' partial head sums, and a ring of
    ``stages`` weight panels of ``panel_k`` rows in what is left of
    ``smem_optin`` (at most 96 KB): panels of up to 64 rows, 2 to 8 of them."""
    ld = rows + 4
    fixed = H * ld + max(H * ld, d * ld + rows * _round4(d)) + rows
    row_bytes = 4 * 64 * _lane_cols(H, cluster)  # one k-row of a panel
    ring_rows = max(0, min(_RING_CAP, smem_optin - 4 * fixed)) // row_bytes
    panel_k = min(64, max(16, ring_rows // 2 // 16 * 16))
    stages = max(2, min(8, ring_rows // panel_k))
    return panel_k, stages, 4 * fixed + stages * panel_k * row_bytes


@functools.cache
def tower_plans(d: int, H: int, L: int, smem_optin: int) -> tuple[tuple[int, int], ...]:
    """Every ``(rows_per_tile, cluster)`` the kernel takes at these widths:
    a lane holds its columns of the block's slice in registers
    (``_MAX_LANE_COLS``), the block's shared memory fits ``smem_optin``,
    and the weight ring holds the cross stack's ``2L + 1`` vectors, which
    it stages first. Raises, with the first plan's reason, when none does."""
    plans, why = [], []
    for rows in TILE_ROWS:
        for cluster in CLUSTER_SIZES:
            cn = _lane_cols(H, cluster)
            panel_k, stages, smem = tower_layout(d, H, rows, cluster, smem_optin)
            if cn > _MAX_LANE_COLS[rows]:
                why.append(f"tower_eval takes at most {64 * _MAX_LANE_COLS[rows]} columns per block at "
                           f"{rows} rows; H={H} at cluster {cluster} needs more")
            elif smem > smem_optin:
                why.append(f"tower_eval needs {smem} bytes of shared memory per block for d={d}, "
                           f"H={H} at {rows} rows; the device allows {smem_optin}")
            elif (2 * L + 1) * d > stages * panel_k * 64 * cn:
                why.append(f"tower_eval stages the cross stack's {2 * L + 1} vectors of d={d} in a "
                           f"weight ring of {stages * panel_k * 64 * cn} floats at plan {(rows, cluster)}")
            else:
                plans.append((rows, cluster))
    if not plans:
        raise ValueError(why[0])
    return tuple(plans)


def tower_plan(B: int, resident: dict, wave_ms: dict) -> tuple[int, int]:
    """``(rows_per_tile, cluster)`` for a batch of ``B`` rows: the plan of
    least time among those ``wave_ms`` holds.

    A plan runs ``ceil(B / rows)`` tiles, one cluster each, in waves of
    ``resident[cluster]`` clusters, as many as the device holds at once
    (:func:`_device_limits`). A wave takes ``wave_ms[plan]``, the time of
    one full wave (:func:`_wave_ms`), since its clusters run side by side.
    Ties go to the plan with fewer blocks."""
    plans = [p for p in wave_ms if resident.get(p[1], 0) > 0]
    if B <= 0 or not plans:
        raise ValueError(f"tower_plan needs B > 0 and a plan the device runs, got {B}, {sorted(wave_ms)}")

    def cost(plan):
        rows, cluster = plan
        tiles = -(-B // rows)
        return -(-tiles // resident[cluster]) * wave_ms[plan], tiles * cluster

    return min(plans, key=cost)


def _folded_shapes(d: int, H: int, R: int, L: int) -> dict:
    return {"w0": (d, H), "b0": (H,), "w1": (R, H, H), "b1": (R, H), "w2": (R, H, H), "b2": (R, H),
            "cross_w": (L, d), "cross_b": (L, d), "final_w": (H + d,), "final_b": ()}


@functools.cache
def _wave_ms(device_index: int, d: int, H: int, R: int, L: int) -> dict:
    """Once per process and widths: the time of one full wave of each plan
    of :func:`tower_plans` (``resident[cluster]`` tiles of zeros; CUDA
    events over 3 launches after a warm-up; the best of three passes over
    the plans, as the first also brings the card's clocks up). These
    launches count in ``tower_eval.launches``."""
    smem_optin, resident = _device_limits(device_index)
    dev = torch.device("cuda", device_index)
    folded = {k: torch.zeros(shape, device=dev) for k, shape in _folded_shapes(d, H, R, L).items()}
    plans = [p for p in tower_plans(d, H, L, smem_optin) if resident[p[1]] > 0]
    zeros = torch.zeros(max(rows * resident[c] for rows, c in plans), d, device=dev)
    times = {}
    with torch.cuda.device(dev):
        for _ in range(3):
            for rows, cluster in plans:
                x0 = zeros[:rows * resident[cluster]]
                dims = (x0.shape[0], d, H, R, L)
                _launch(folded, x0, "code", (rows, cluster), dims)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    _launch(folded, x0, "code", (rows, cluster), dims)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / 3
                times[(rows, cluster)] = min(times.get((rows, cluster), ms), ms)
    return times


@functools.cache
def _prepare(device_index: int, d: int, H: int, rows: int, cluster: int, panel_k: int, stages: int) -> None:
    """Once per plan and process: let the kernel use the shared memory it
    needs, and check that a cluster of this size fits on the card."""
    lib = _library()
    smem_optin = _device_limits(device_index)[0]
    smem = tower_layout(d, H, rows, cluster, smem_optin)[2]
    if lib.hhrs_tower_eval_smem_bytes(d, H, rows, cluster, panel_k, stages) != smem:
        raise RuntimeError("ops/tower.py and csrc/tower_eval.cu disagree on the shared-memory size")
    with torch.cuda.device(device_index):
        n = lib.hhrs_tower_eval_prepare(d, H, rows, cluster, panel_k, stages, smem_optin)
    if n < 0:
        raise RuntimeError(f"tower_eval cannot be prepared: {lib.hhrs_cuda_error_string(-n).decode()}")
    if n == 0:
        raise RuntimeError(f"a cluster of {cluster} blocks with {smem} bytes of shared memory "
                           f"each does not fit on this device")


def _check_inputs(folded: dict, x0: torch.Tensor, variant: str) -> tuple:
    if variant not in CROSS_VARIANTS:
        raise ValueError(f"unknown cross variant {variant!r}")
    if x0.dim() != 2:
        raise ValueError(f"x0 must be [B, d], got shape {tuple(x0.shape)}")
    missing = set(_FOLDED_KEYS) - set(folded)
    if missing:
        raise ValueError(f"folded weights lack {sorted(missing)}")
    B, d = x0.shape
    d_w, H = folded["w0"].shape
    if d_w != d:
        raise ValueError(f"x0 has {d} features, w0 expects {d_w}")
    R, L = folded["w1"].shape[0], folded["cross_w"].shape[0]
    want = _folded_shapes(d, H, R, L)
    for name, t in [("x0", x0)] + [(k, folded[k]) for k in _FOLDED_KEYS]:
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "x0" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    return B, d, H, R, L


def tower_eval(folded: dict, x0: torch.Tensor, variant: str = "code") -> torch.Tensor:
    """Score ``[B, d]`` features → ``[B]`` logits with the fused tower.

    On a CPU tensor: :func:`tower_eval_ref`. On a CUDA tensor: one launch
    of the hand-written kernel on the current stream (asynchronous), with
    the plan :func:`tower_plan` picks from B, after checking device, dtype,
    shape, contiguity and shared-memory size; ``tower_eval.launches``
    counts the launches."""
    if x0.device.type == "cpu":
        return tower_eval_ref(folded, x0, variant)
    if x0.device.type != "cuda":
        raise ValueError(f"tower_eval runs on cpu or cuda tensors, got {x0.device}")
    dims = _check_inputs(folded, x0, variant)
    return _launch(folded, x0, variant, _plan(x0.device, dims), dims)


def _plan(device: torch.device, dims: tuple) -> tuple[int, int]:
    B, d, H, R, L = dims
    index = device.index if device.index is not None else torch.cuda.current_device()
    return tower_plan(max(B, 1), _device_limits(index)[1], _wave_ms(index, d, H, R, L))


def plan_of(folded: dict, x0: torch.Tensor, variant: str = "code") -> tuple[int, int]:
    """The plan :func:`tower_eval` takes for a CUDA ``x0``."""
    return _plan(x0.device, _check_inputs(folded, x0, variant))


def launch(folded: dict, x0: torch.Tensor, variant: str, plan: tuple[int, int]) -> torch.Tensor:
    """One launch of the kernel on a CUDA ``x0`` with a given plan
    ``(rows_per_tile, cluster)``. :func:`tower_eval` takes
    :func:`tower_plan`'s; another valid plan gives the same logits bit for
    bit, which is how ``kernel_ab.py`` compares plans."""
    return _launch(folded, x0, variant, plan, _check_inputs(folded, x0, variant))


def _launch(folded: dict, x0: torch.Tensor, variant: str, plan: tuple[int, int], dims: tuple) -> torch.Tensor:
    B, d, H, R, L = dims
    rows, cluster = plan
    device_index = x0.device.index if x0.device.index is not None else torch.cuda.current_device()
    smem_optin = _device_limits(device_index)[0]
    if plan not in tower_plans(d, H, L, smem_optin):
        raise ValueError(f"tower_eval takes no plan {plan} at d={d}, H={H}, L={L}: it takes "
                         f"{tower_plans(d, H, L, smem_optin)}")
    panel_k, stages, _ = tower_layout(d, H, rows, cluster, smem_optin)
    out = torch.empty(B, dtype=torch.float32, device=x0.device)
    if B == 0:
        return out
    _prepare(device_index, d, H, rows, cluster, panel_k, stages)
    lib = _library()
    f = [folded[k] for k in _FOLDED_KEYS]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hhrs_tower_eval(
            x0.data_ptr(), *[t.data_ptr() for t in f], out.data_ptr(),
            B, d, H, R, L, int(variant == "canonical"), rows, cluster, panel_k, stages, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tower_eval kernel launch failed: {lib.hhrs_cuda_error_string(err).decode()}"
        )
    tower_eval.launches += 1
    return out


tower_eval.launches = 0


@torch.library.custom_op("hhrs::tower_eval", mutates_args=(), device_types="cuda")
def tower_eval_op(x0: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, cross_w: torch.Tensor, cross_b: torch.Tensor,
                  final_w: torch.Tensor, final_b: torch.Tensor, variant: str) -> torch.Tensor:
    """``hhrs::tower_eval(x0, *folded, variant) → [B]`` logits, the folded
    weights in the order of ``fold_eval_params``'s keys. On CUDA tensors:
    :func:`tower_eval` (one kernel launch, counted in
    ``tower_eval.launches``)."""
    folded = dict(zip(_FOLDED_KEYS, (w0, b0, w1, b1, w2, b2, cross_w, cross_b, final_w, final_b)))
    return tower_eval(folded, x0.contiguous(), variant)


@tower_eval_op.register_kernel("cpu")
def _tower_eval_op_cpu(x0, w0, b0, w1, b1, w2, b2, cross_w, cross_b, final_w, final_b, variant):
    folded = dict(zip(_FOLDED_KEYS, (w0, b0, w1, b1, w2, b2, cross_w, cross_b, final_w, final_b)))
    return tower_eval_ref(folded, x0, variant)


@tower_eval_op.register_fake
def _tower_eval_op_fake(x0, w0, b0, w1, b1, w2, b2, cross_w, cross_b, final_w, final_b, variant):
    return x0.new_empty((x0.shape[0],), dtype=torch.float32)


def folded_args(folded: dict) -> list:
    """The folded weights as ``tower_eval_op`` takes them, in order."""
    return [folded[k] for k in _FOLDED_KEYS]
