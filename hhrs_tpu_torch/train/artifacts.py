"""Artifact export and loading — the train→serve contract, without JAX.

Counterpart of ``hhrs_tpu/train/artifacts.py`` (``export_artifacts``,
``load_artifact_bundle``). An artifact directory holds ``manifest.json``
(format version, model config, model dims, metrics, file list, and the
train config as provenance), ``params.msgpack`` (flax msgpack of
``{"params": …, "bn_state": …}``), ``preproc.json`` and
``item_embeddings.npy``. The port writes the same files as the JAX
package, so either package loads what the other exported. The weight tree
stays numpy here; ``models/convert.py`` moves it into and out of a module.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np

from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.data.preprocess import PreprocessArtifacts
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.train.serialization import msgpack_restore, msgpack_serialize

MANIFEST = "manifest.json"
PARAMS = "params.msgpack"
PREPROC = "preproc.json"
ITEM_EMB = "item_embeddings.npy"

FORMAT_VERSION = 1


@dataclass
class ArtifactBundle:
    params: dict  # nested dicts of numpy arrays (lists as "0", "1", … maps)
    bn_state: dict
    model_cfg: ModelConfig
    dims: ModelDims
    preproc: PreprocessArtifacts
    item_embeddings: np.ndarray
    metrics: dict


def export_artifacts(
    out_dir: str,
    params: dict,
    bn_state: dict,
    model_cfg: ModelConfig,
    dims: ModelDims,
    preproc: PreprocessArtifacts,
    metrics: dict | None = None,
    train_cfg=None,
) -> None:
    """Write the four files of an artifact directory. ``params`` and
    ``bn_state`` are JAX-layout numpy trees (``models/convert.py::
    jax_from_dcnr``); ``train_cfg`` is recorded as provenance only."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, PARAMS), "wb") as f:
        f.write(msgpack_serialize({"params": params, "bn_state": bn_state}))
    preproc.save(os.path.join(out_dir, PREPROC))
    np.save(os.path.join(out_dir, ITEM_EMB), np.asarray(params["item_embedding"], dtype=np.float32))
    manifest = {
        "format_version": FORMAT_VERSION,
        "model_config": dataclasses.asdict(model_cfg),
        "model_dims": dims.to_dict(),
        "metrics": metrics or {},
        "files": [PARAMS, PREPROC, ITEM_EMB],
    }
    if train_cfg is not None:
        manifest["train_config"] = dataclasses.asdict(train_cfg)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def load_artifact_bundle(out_dir: str) -> ArtifactBundle:
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"artifact format {manifest['format_version']} != {FORMAT_VERSION}")
    mc = manifest["model_config"]
    model_cfg = ModelConfig(**{k: v for k, v in mc.items() if k in ModelConfig.__dataclass_fields__})
    with open(os.path.join(out_dir, PARAMS), "rb") as f:
        restored = msgpack_restore(f.read())
    return ArtifactBundle(
        params=restored["params"],
        bn_state=restored["bn_state"],
        model_cfg=model_cfg,
        dims=ModelDims.from_dict(manifest["model_dims"]),
        preproc=PreprocessArtifacts.load(os.path.join(out_dir, PREPROC)),
        item_embeddings=np.load(os.path.join(out_dir, ITEM_EMB)),
        metrics=manifest.get("metrics", {}),
    )
