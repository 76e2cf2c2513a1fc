"""Exported ranker: the trained DCN-R scoring program saved as a
``torch.export`` program (counterpart of ``hhrs_tpu/serve/export.py``).

``export_ranker`` records the eval-mode scoring program of an artifact
bundle, the route the engine scores that bundle by, with the weights stored
in the program and the batch dimension symbolic (one program serves any
candidate count from 1 up):

* an f32 ``dcnr`` bundle: the embedding gathers and concat of
  ``ops/tower.py::build_x0``, then the fused tower as the registered
  operator ``hhrs::tower_eval``;
* every other architecture, and every arch at bf16 compute or storage (no
  tower kernel there): ``DCNR.forward`` in eval mode, whose cross stack is
  the registered operator ``hhrs::cross_stack_fwd`` (f32 or bf16).

``save_ranker`` writes it with ``torch.export.save`` as ``ranker.pt2``;
``ExportedRanker.load`` reads it back onto a device and runs it with no
model code: loading and calling need only ``hhrs_tpu_torch.ops.tower`` and
``hhrs_tpu_torch.ops.cross``, which register the operators (the kernels on
a card, their plain versions on the CPU).

What it is NOT: the full two-stage request program. Candidate generation
and MMR close over the live review universe, which changes with every data
refresh; the exported unit is the model half (stage 2), the piece with
expensive-to-ship Python dependencies; retrieval state stays data.

The JAX package lowers one module for several platforms (``--platforms``);
a ``.pt2`` program runs on the device it is loaded onto, so the CLI takes
``--platforms`` only to refuse values other than ``cuda`` and ``cpu``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from hhrs_tpu_torch.device import resolve_device
from hhrs_tpu_torch.ops import cross, tower  # noqa: F401 — register torch.ops.hhrs.{cross_stack_fwd,tower_eval}

RANKER_FILE = "ranker.pt2"
PLATFORMS = ("cuda", "cpu")


class _Scorer(nn.Module):
    """``(user_ids, item_ids, cat_features, num_features) → [B]`` logits:
    the gathers and concat of ``build_x0`` from the model's tables, then
    ``hhrs::tower_eval`` on the folded weights. Tables and weights are
    buffers, so the exported program stores them."""

    def __init__(self, model, variant: str):
        super().__init__()
        self.variant = variant
        self.register_buffer("user_embedding", model.user_embedding.detach().clone())
        self.register_buffer("item_embedding", model.item_embedding.detach().clone())
        self.n_cat = len(model.cat_embeddings)
        for i, table in enumerate(model.cat_embeddings):
            self.register_buffer(f"cat_embedding_{i}", table.detach().clone())
        for i, t in enumerate(tower.folded_args(tower.fold_eval_params(model))):
            self.register_buffer(f"folded_{i}", t.clone())
        self.n_folded = i + 1

    def forward(self, user_ids, item_ids, cat_features, num_features):
        cats = [getattr(self, f"cat_embedding_{i}")[cat_features[:, i]] for i in range(self.n_cat)]
        x0 = torch.cat([self.user_embedding[user_ids], self.item_embedding[item_ids], *cats, num_features], dim=1)
        folded = [getattr(self, f"folded_{i}") for i in range(self.n_folded)]
        return torch.ops.hhrs.tower_eval(x0, *folded, self.variant)


def export_ranker(bundle, device: str | torch.device | None = None) -> torch.export.ExportedProgram:
    """The bundle's eval-mode scoring program, recorded on ``device``
    (default ``cuda``; raises without a card) with a symbolic batch: the
    fused tower for an f32 ``dcnr`` bundle (``ops/tower.py::uses_tower``),
    ``DCNR.forward`` for every other architecture and dtype."""
    from hhrs_tpu_torch.models.convert import dcnr_from_jax

    cfg = bundle.model_cfg
    dev = resolve_device(device)
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, cfg, dev)
    scorer = _Scorer(model, cfg.cross_variant).eval() if tower.uses_tower(cfg) else model
    n_cat, n_num = len(bundle.dims.cat_dims), bundle.dims.n_num_features
    example = (torch.zeros(2, dtype=torch.int64, device=dev), torch.zeros(2, dtype=torch.int64, device=dev),
               torch.zeros((2, n_cat), dtype=torch.int64, device=dev),
               torch.zeros((2, n_num), dtype=torch.float32, device=dev))
    b = torch.export.Dim("b", min=1)
    shapes = {"user_ids": {0: b}, "item_ids": {0: b}, "cat_features": {0: b}, "num_features": {0: b}}
    with torch.no_grad():
        return torch.export.export(scorer, example, dynamic_shapes=shapes)


def save_ranker(bundle, path: str, device: str | torch.device | None = None) -> str:
    torch.export.save(export_ranker(bundle, device), path)
    return path


class ExportedRanker:
    """A loaded scoring program. ``__call__`` takes the exported signature
    (ids as integers, numerical features as floats; lists, numpy arrays or
    tensors) and returns ``[B]`` logits on the ranker's device; no model
    code runs."""

    def __init__(self, program: torch.export.ExportedProgram, device: torch.device):
        self.program = program
        self.device = device
        self._module = program.module()

    @classmethod
    def load(cls, path: str, device: str | torch.device | None = None) -> "ExportedRanker":
        """Read ``path`` onto ``device`` (default ``cuda``; raises without a
        card)."""
        dev = resolve_device(device)
        return cls(move_to_device_pass(torch.export.load(path), dev), dev)

    @torch.no_grad()
    def __call__(self, user_ids, item_ids, cat_features, num_features) -> torch.Tensor:
        ids = lambda a: torch.as_tensor(a, dtype=torch.int64, device=self.device)  # noqa: E731
        return self._module(ids(user_ids), ids(item_ids), ids(cat_features),
                            torch.as_tensor(num_features, dtype=torch.float32, device=self.device))


def main(argv=None) -> int:
    """``python -m hhrs_tpu_torch.serve.export --artifacts DIR [--out F]
    [--device cuda|cpu]``"""
    import argparse
    import logging
    import os

    from hhrs_tpu_torch.db.registry import resolve_artifacts_dir
    from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
    from hhrs_tpu_torch.utils.logging import setup_logging

    setup_logging()
    log = logging.getLogger("hhrs_tpu_torch.serve.export")
    p = argparse.ArgumentParser(description="Export the trained ranker as a torch.export program (.pt2)")
    p.add_argument("--artifacts", required=True,
                   help="artifact dir, or 'registry:<db>' for the active model")
    p.add_argument("--out", default=None, help=f"output path (default <artifacts>/{RANKER_FILE})")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="accepted for the JAX CLI's sake: a .pt2 runs on the device it is loaded onto, "
                        "so only cuda and cpu are taken")
    p.add_argument("--device", default=None, help="device the program is recorded on: cuda (default) or cpu")
    args = p.parse_args(argv)
    platforms = tuple(s.strip() for s in args.platforms.split(",") if s.strip())
    other = [x for x in platforms if x not in PLATFORMS]
    if other:
        p.error(f"--platforms {','.join(other)}: a .pt2 program runs on the device it is loaded onto "
                f"(torch.export), not on a platform chosen at export; it takes {' and '.join(PLATFORMS)} only")

    adir = resolve_artifacts_dir(args.artifacts)
    out = args.out or os.path.join(adir, RANKER_FILE)
    bundle = load_artifact_bundle(adir)
    save_ranker(bundle, out, args.device)
    log.info("exported %s ranker -> %s (%.1f KB)", bundle.model_cfg.arch, out, os.path.getsize(out) / 1024)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
