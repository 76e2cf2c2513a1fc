"""Where the port's entry points run: ``cuda`` unless the caller asks for
the CPU, and never a quiet fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as given, or ``cuda`` when it is None; with no card, None
    raises. Pass ``device="cpu"`` to an entry point to run it on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
