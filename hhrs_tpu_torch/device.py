"""Where the port's entry points run: ``cuda`` unless the caller asks for
the CPU, and never a quiet fall back to the CPU; and the streams its CUDA
graphs are captured on."""

from __future__ import annotations

import threading
import weakref

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as given, or ``cuda`` when it is None; with no card, None
    raises. Pass ``device="cpu"`` to an entry point to run it on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


_POOL_STREAMS = 32  # the streams of each priority in PyTorch's pool, handed out round robin
_capture_owners: dict = {}  # (device index, stream handle) -> a weak reference to the stream's owner
_capture_streams: dict = {}  # (device index, stream handle) -> the stream
_owners_lock = threading.Lock()


def capture_stream(owner: object, device: torch.device) -> torch.cuda.Stream:
    """A stream of PyTorch's pool on ``device`` that no other live owner
    captures CUDA graphs on, claimed for ``owner`` until it is collected.

    PyTorch gives cuBLAS one workspace per stream, and a graph keeps the
    workspace of the stream it was captured on: two graphs of one capture
    stream, replayed at the same time, would write one workspace at once.
    An owner replays its own graphs one at a time; graphs of different
    owners may replay at once, so no two owners share a capture stream.
    A stream whose owner was collected is handed out again before a new
    one, so a server that swaps engines reuses their streams (and the
    cuBLAS workspaces PyTorch keeps for each stream) instead of taking a
    new workspace at every swap. Raises when every pool stream has a live
    owner."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _owners_lock:
        for key, holder in _capture_owners.items():
            if key[0] == index and holder() is None:
                _capture_owners[key] = weakref.ref(owner)
                return _capture_streams[key]
        for priority in (0, -1):
            for _ in range(_POOL_STREAMS):
                stream = torch.cuda.Stream(index, priority=priority)
                key = (index, stream.cuda_stream)
                if key not in _capture_owners:
                    _capture_owners[key] = weakref.ref(owner)
                    _capture_streams[key] = stream
                    return stream
    raise RuntimeError(f"every stream of PyTorch's pool on cuda:{index} captures for a live owner")
