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
  the other: a CUDA input that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hhrs_tpu_torch.ops import cuda_build
from hhrs_tpu_torch.ops.cross import CROSS_VARIANTS, cross_stack_apply

_FOLDED_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2", "cross_w", "cross_b", "final_w", "final_b")
_LIB_NAME, _LIB_SOURCES = "tower_eval", ["tower_eval.cu"]


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
    lib.hhrs_tower_eval.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.hhrs_tower_eval.restype = i
    lib.hhrs_tower_eval_smem_bytes.argtypes = [i, i]
    lib.hhrs_tower_eval_smem_bytes.restype = ctypes.c_longlong
    lib.hhrs_tower_eval_max_threads.restype = i
    lib.hhrs_cuda_error_string.argtypes = [i]
    lib.hhrs_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _smem_optin(device_index: int) -> int:
    """Dynamic shared memory one block may opt in to on this device."""
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


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
    want = {
        "w0": (d, H), "b0": (H,), "w1": (R, H, H), "b1": (R, H), "w2": (R, H, H),
        "b2": (R, H), "cross_w": (L, d), "cross_b": (L, d), "final_w": (H + d,),
        "final_b": (),
    }
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
    of the hand-written kernel on the current stream (asynchronous), after
    checking device, dtype, shape, contiguity and shared-memory size;
    ``tower_eval.launches`` counts the launches."""
    if x0.device.type == "cpu":
        return tower_eval_ref(folded, x0, variant)
    if x0.device.type != "cuda":
        raise ValueError(f"tower_eval runs on cpu or cuda tensors, got {x0.device}")
    B, d, H, R, L = _check_inputs(folded, x0, variant)
    lib = _library()
    smem = lib.hhrs_tower_eval_smem_bytes(d, H)
    smem_max = _smem_optin(x0.device.index if x0.device.index is not None else torch.cuda.current_device())
    if smem > smem_max:
        raise ValueError(
            f"tower_eval needs {smem} bytes of shared memory per block for d={d}, "
            f"H={H}; the device allows {smem_max}"
        )
    out = torch.empty(B, dtype=torch.float32, device=x0.device)
    if B == 0:
        return out
    threads = min(lib.hhrs_tower_eval_max_threads(), -(-max(H, d) // 32) * 32)
    f = [folded[k] for k in _FOLDED_KEYS]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hhrs_tower_eval(
            x0.data_ptr(), *[t.data_ptr() for t in f], out.data_ptr(),
            B, d, H, R, L, int(variant == "canonical"), threads, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tower_eval kernel launch failed: {lib.hhrs_cuda_error_string(err).decode()}"
        )
    tower_eval.launches += 1
    return out


tower_eval.launches = 0
