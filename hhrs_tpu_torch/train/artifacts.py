"""Artifact loading — the train→serve contract, read without JAX.

Counterpart of ``hhrs_tpu/train/artifacts.py::load_artifact_bundle``. An
artifact directory holds ``manifest.json`` (format version, model config,
model dims, metrics), ``params.msgpack`` (flax msgpack of
``{"params": …, "bn_state": …}``), ``preproc.json`` and
``item_embeddings.npy``. The weight tree stays numpy here; the serve
engine moves it into a module with ``models/convert.py``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.data.preprocess import PreprocessArtifacts
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.train.serialization import msgpack_restore

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
