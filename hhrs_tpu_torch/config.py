"""Model and retrieval hyperparameters, plus shared shape arithmetic.

Copies of ``hhrs_tpu/config.py::ModelConfig`` / ``RetrievalConfig`` and
``hhrs_tpu/utils/shapes.py::round_up``: an artifact manifest's
``model_config`` loads into :class:`ModelConfig` field for field.
"""

from __future__ import annotations

from dataclasses import dataclass


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return -(-x // m) * m


@dataclass
class ModelConfig:
    """DCN-R hyperparameters (same fields and defaults as the JAX package)."""

    emb_dim: int = 16
    hidden_dim: int = 128
    n_cross_layers: int = 2
    n_res_blocks: int = 1
    dropout: float = 0.6
    # 'dcnr' | 'cross_only' | 'deep_only' | 'dcn_mlp'
    arch: str = "dcnr"
    # 'code': x += x*(w·x) + b ; 'canonical': x = x0*(w·x) + b + x
    cross_variant: str = "code"
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    compute_dtype: str = "float32"
    storage_dtype: str = "float32"

    def cat_emb_dim(self, n_cat: int) -> int:
        # floor(sqrt(n)) + 1, the reference heuristic
        return int(n_cat**0.5) + 1


@dataclass
class RetrievalConfig:
    """Candidate-generation knobs."""

    knn_neighbors: int = 16
    expand_neighbors: int = 10  # per-positive kNN expansion, excluding self
    min_candidates: int = 20  # popularity-fallback trigger
    popular_pool: int = 100  # top-N city rows by review count
    mmr_top_k: int = 20  # MMR output size
