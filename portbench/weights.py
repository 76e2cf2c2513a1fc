"""Seeded DCN-R weights, made on the device in a few large calls.

One ``torch.Generator`` on the run's device draws every embedding table in
one normal draw and every linear and cross weight in one uniform draw,
scaled per leaf to ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, the model's own
initialization. ``trained=True`` stands in for a trained model: BatchNorm
running statistics, scales and shifts and the cross biases are drawn too
(one more uniform draw), so that every layer of the eval path does work.

The result is the flat ``{dotted name: tensor}`` dict (the module's
state-dict names) and the same leaves as the numpy trees of the artifact
format (``params``, ``bn_state``), which the program loads.
"""

from __future__ import annotations

import math

import torch


def cat_width(n: int) -> int:
    return int(n ** 0.5) + 1


def input_dim(cfg: dict, cat_dims: list, n_num: int) -> int:
    return 2 * cfg["emb_dim"] + sum(cat_width(n) for n in cat_dims) + n_num


def shapes(cfg: dict, n_users: int, n_items: int, cat_dims: list, n_num: int) -> dict:
    """Every leaf's shape and kind: ``emb`` (normal), ``lin`` (uniform over
    ``fan_in``), ``bn_scale``, ``bn_bias``, ``bn_mean``, ``bn_var``,
    ``cross_b``."""
    E, H, L, R = cfg["emb_dim"], cfg["hidden_dim"], cfg["n_cross_layers"], cfg["n_res_blocks"]
    d = input_dim(cfg, cat_dims, n_num)
    out = {"user_embedding": ((n_users, E), "emb", 0), "item_embedding": ((n_items, E), "emb", 0)}
    for i, n in enumerate(cat_dims):
        out[f"cat_embeddings.{i}"] = ((n, cat_width(n)), "emb", 0)
    out["initial_deep.kernel"] = ((d, H), "lin", d)
    out["initial_deep.bias"] = ((H,), "lin", d)
    for r in range(R):
        for j in (1, 2):
            out[f"res_blocks.{r}.layer{j}.kernel"] = ((H, H), "lin", H)
            out[f"res_blocks.{r}.layer{j}.bias"] = ((H,), "lin", H)
            for leaf in ("scale", "bias", "mean", "var"):
                out[f"res_blocks.{r}.bn{j}.{leaf}"] = ((H,), f"bn_{leaf}", 0)
    out["cross.w"] = ((L, d), "lin", d)
    out["cross.b"] = ((L, d), "cross_b", d)
    out["final.kernel"] = ((H + d, 1), "lin", H + d)
    out["final.bias"] = ((1,), "lin", H + d)
    return out


def make(cfg: dict, n_users: int, n_items: int, cat_dims: list, n_num: int, seed: int,
         device: torch.device, trained: bool) -> dict:
    """→ ``{dotted name: f32 tensor on device}``."""
    spec = shapes(cfg, n_users, n_items, cat_dims, n_num)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    size = lambda kinds: sum(math.prod(s) for s, k, _ in spec.values() if k in kinds)  # noqa: E731
    normal = iter_split(torch.randn(size({"emb"}), generator=gen, device=device))
    uniform = iter_split(torch.rand(size({"lin"}), generator=gen, device=device) * 2 - 1)
    extra = iter_split(torch.rand(size({"bn_scale", "bn_bias", "bn_mean", "bn_var", "cross_b"}),
                                  generator=gen, device=device) * 2 - 1)
    out = {}
    for name, (shape, kind, fan_in) in spec.items():
        n = math.prod(shape)
        if kind == "emb":
            t = normal(n)
        elif kind == "lin":
            t = uniform(n) / math.sqrt(fan_in)
        else:
            u = extra(n)
            if not trained:
                t = {"bn_scale": torch.ones_like(u), "bn_var": torch.ones_like(u)}.get(kind, torch.zeros_like(u))
            elif kind == "bn_scale":
                t = 1.0 + 0.2 * u
            elif kind == "bn_var":
                t = 1.0 + 0.5 * u
            elif kind == "cross_b":
                t = u / math.sqrt(fan_in)
            else:  # bn_bias, bn_mean
                t = 0.1 * u
        out[name] = t.reshape(shape).contiguous()
    return out


def iter_split(flat: torch.Tensor):
    pos = [0]

    def take(n: int) -> torch.Tensor:
        t = flat[pos[0]:pos[0] + n]
        pos[0] += n
        return t
    return take


def to_trees(flat: dict, n_res: int, n_cat: int) -> tuple[dict, dict]:
    """The flat dict → the artifact format's ``(params, bn_state)`` numpy
    trees (lists for repeated blocks)."""
    leaf = lambda k: flat[k].detach().float().cpu().numpy()  # noqa: E731
    lin = lambda p: {"kernel": leaf(f"{p}.kernel"), "bias": leaf(f"{p}.bias")}  # noqa: E731
    params = {"user_embedding": leaf("user_embedding"), "item_embedding": leaf("item_embedding"),
              "cat_embeddings": [leaf(f"cat_embeddings.{i}") for i in range(n_cat)],
              "initial_deep": lin("initial_deep"), "res_blocks": [], "cross": {"w": leaf("cross.w"),
                                                                              "b": leaf("cross.b")},
              "final": lin("final")}
    state = {"res_blocks": []}
    for r in range(n_res):
        p = f"res_blocks.{r}"
        params["res_blocks"].append({
            "layer1": lin(f"{p}.layer1"), "layer2": lin(f"{p}.layer2"),
            "bn1": {"scale": leaf(f"{p}.bn1.scale"), "bias": leaf(f"{p}.bn1.bias")},
            "bn2": {"scale": leaf(f"{p}.bn2.scale"), "bias": leaf(f"{p}.bn2.bias")}})
        state["res_blocks"].append({
            "bn1": {"mean": leaf(f"{p}.bn1.mean"), "var": leaf(f"{p}.bn1.var")},
            "bn2": {"mean": leaf(f"{p}.bn2.mean"), "var": leaf(f"{p}.bn2.var")}})
    return params, state

