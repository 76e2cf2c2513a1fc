"""The yardstick: peaks of the card and the operations and bytes a kernel
or a model step must do, counted from shapes.

Peaks are NVIDIA's published dense rates of one H100 SXM at its full power
limit (700 W). A kernel's least time is the larger of its operations over
the peak rate of its dtype and its bytes over the memory bandwidth, each
input byte read once and each output byte written once. The tower and
cross counts are those the repository's kernel timing scripts use.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ELEM = {"float32": 4, "bfloat16": 2}


def least_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def tower_weights(d: int, H: int, R: int, L: int) -> int:
    """Elements of the folded eval tower: w0, b0, w1, b1, w2, b2, the
    cross w and b, the final weights and bias."""
    return d * H + H + 2 * R * (H * H + H) + 2 * L * d + (H + d) + 1


def tower_work(B: int, d: int, H: int, R: int, L: int) -> tuple[float, float]:
    """(flops, bytes) of one fused eval-tower call on B rows of x0 [B, d]."""
    flops = 2.0 * B * (d * H + 2 * R * H * H + 3 * L * d + H + d)
    return flops, 4.0 * (tower_weights(d, H, R, L) + B * d + B)


def cross_work(B: int, d: int, L: int, kind: str, elem: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one cross-stack call (the ``code`` variant) on B
    rows of ``elem``-byte elements. A forward layer is a d-term gate (2d)
    and a 3-operation update (3d) a row; the backward recomputes the
    forward and does 8d more a layer and row."""
    if kind == "fwd":
        return 5.0 * B * L * d, elem * (2 * B * d + 2 * L * d)
    return 13.0 * B * L * d, elem * (3 * B * d + 4 * L * d)


def dcnr_forward_flops(d: int, H: int, R: int, L: int) -> float:
    """One row's forward, as the eval tower counts it: the deep tower's
    linears, the cross stack, the final linear (BatchNorm, ReLU and the
    gathers left out)."""
    return tower_work(1, d, H, R, L)[0]
