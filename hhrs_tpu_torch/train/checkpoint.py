"""Checkpoint and resume of the training loop (counterpart of
``hhrs_tpu/train/checkpoint.py``, which is built on orbax).

One file per saved epoch, ``epoch_<n>.pt``, written by ``torch.save`` to a
temporary name and renamed into place, so a run killed during a save
leaves the previous epoch's file whole. It holds the tensors of the loop
state (the model, the optimizer with its step counts and learning rate,
the best-state snapshot, the dropout generator's state) and the host
state as JSON (epoch, history, plateau, early-stopping counters, the
numpy shuffle generator's ``bit_generator.state``). The last
``max_to_keep`` files are kept, as orbax's ``max_to_keep`` does. Files are
read back with ``torch.load(weights_only=True)``: tensors, containers and
numbers only, no pickled code.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt")


class TrainCheckpointer:
    """Per-epoch loop state in ``directory``: ``save`` after an epoch,
    ``restore`` the latest on a rerun."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def epochs(self) -> list[int]:
        """The saved epochs, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(self.directory)) if m)

    def latest_epoch(self) -> int | None:
        saved = self.epochs()
        return saved[-1] if saved else None

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:06d}.pt")

    def save(self, epoch: int, state: dict, meta: dict) -> None:
        """``state``: tensors and containers of tensors; ``meta``: JSON-able
        host state. Drops the files beyond the newest ``max_to_keep``."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        try:
            torch.save({"state": state, "meta": json.dumps(meta)}, tmp)
            os.replace(tmp, self._path(epoch))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.epochs()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def restore(self, epoch: int, device: torch.device) -> tuple[dict, dict]:
        """→ ``(state, meta)`` of a saved epoch, tensors on ``device``."""
        blob = torch.load(self._path(epoch), map_location=device, weights_only=True)
        return blob["state"], json.loads(blob["meta"])
