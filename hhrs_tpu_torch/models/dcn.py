"""DCN-R ranking model as an ``nn.Module`` (counterpart of
``hhrs_tpu/models/dcn.py``).

    x0    = [user_emb ⊕ item_emb ⊕ cat_embs… ⊕ num_features]   # [B, d_in]
    deep  = blocks( x0 @ W0 + b0 )                              # [B, H]
    cross = CrossStack(x0)                                      # [B, d_in]
    logit = [deep ⊕ cross] @ Wf + bf                            # [B]

Four architectures: ``dcnr`` (deep residual tower + cross), ``cross_only``,
``deep_only`` and ``dcn_mlp`` (plain Linear→ReLU blocks, no BN/residual).
Parameter and buffer names are the JAX tree's paths joined with dots
(``res_blocks.0.layer1.kernel``, ``res_blocks.0.bn1.mean``, ``cross.w``, …),
so ``models/convert.py`` moves a JAX weight tree in by name. Train/eval
mode is the module's ``training`` flag; in train mode the BatchNorm
buffers update in place, like the JAX package's returned ``bn_state``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.ops.cross import CrossStack
from hhrs_tpu_torch.ops.nn import Linear, embedding_table
from hhrs_tpu_torch.ops.resblock import MLPBlock, ResBlock

ARCHS = ("dcnr", "cross_only", "deep_only", "dcn_mlp")


@dataclass(frozen=True)
class ModelDims:
    n_users: int
    n_items: int
    cat_dims: tuple  # ((col_name, n_categories), ...), order fixed
    n_num_features: int

    @classmethod
    def from_dict(cls, d: dict) -> "ModelDims":
        return cls(
            n_users=d["n_users"],
            n_items=d["n_items"],
            cat_dims=tuple((c, n) for c, n in d["cat_dims"]),
            n_num_features=d["n_num_features"],
        )


def input_dim_of(dims: ModelDims, cfg: ModelConfig) -> int:
    return cfg.emb_dim * 2 + sum(cfg.cat_emb_dim(n) for _, n in dims.cat_dims) + dims.n_num_features


class DCNR(nn.Module):
    def __init__(self, dims: ModelDims, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.arch not in ARCHS:
            raise ValueError(f"unknown model.arch {cfg.arch!r}; expected one of {ARCHS}")
        if cfg.compute_dtype != "float32" or cfg.storage_dtype != "float32":
            raise NotImplementedError(
                "bfloat16 compute/storage is not ported yet (ROADMAP A1: dtype rules)"
            )
        self.cfg = cfg
        self.has_deep = cfg.arch in ("dcnr", "deep_only", "dcn_mlp")
        self.has_cross = cfg.arch in ("dcnr", "cross_only", "dcn_mlp")
        d_in = input_dim_of(dims, cfg)
        self.user_embedding = embedding_table(dims.n_users, cfg.emb_dim, generator)
        self.item_embedding = embedding_table(dims.n_items, cfg.emb_dim, generator)
        self.cat_embeddings = nn.ParameterList(
            [embedding_table(n, cfg.cat_emb_dim(n), generator) for _, n in dims.cat_dims]
        )
        if self.has_deep:
            self.initial_deep = Linear(d_in, cfg.hidden_dim, generator)
            if cfg.arch == "dcn_mlp":
                blocks = [MLPBlock(cfg.hidden_dim, generator) for _ in range(cfg.n_res_blocks)]
            else:
                blocks = [
                    ResBlock(cfg.hidden_dim, cfg.bn_momentum, cfg.bn_eps, generator)
                    for _ in range(cfg.n_res_blocks)
                ]
            self.res_blocks = nn.ModuleList(blocks)
        if self.has_cross:
            self.cross = CrossStack(cfg.n_cross_layers, d_in, cfg.cross_variant, generator)
        final_in = (cfg.hidden_dim if self.has_deep else 0) + (d_in if self.has_cross else 0)
        self.final = Linear(final_in, 1, generator)

    def embed(self, user_ids, item_ids, cat_features, num_features) -> torch.Tensor:
        """The gather + concat front half → x0 ``[B, d_in]``."""
        cats = [tab[cat_features[:, i]] for i, tab in enumerate(self.cat_embeddings)]
        return torch.cat(
            [self.user_embedding[user_ids], self.item_embedding[item_ids], *cats, num_features],
            dim=1,
        )

    def tower(self, x0: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x0 ``[B, d_in]`` → logits ``[B]``."""
        rate = self.cfg.dropout
        towers = []
        if self.has_deep:
            if self.training and rate > 0.0 and generator is None:
                raise ValueError("train mode with dropout > 0 requires a generator")
            deep = self.initial_deep(x0)
            for block in self.res_blocks:
                deep = block(deep, rate, generator)
            towers.append(deep)
        if self.has_cross:
            towers.append(self.cross(x0))
        return self.final(torch.cat(towers, dim=1))[:, 0]

    def forward(self, user_ids, item_ids, cat_features, num_features,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.tower(self.embed(user_ids, item_ids, cat_features, num_features), generator)
