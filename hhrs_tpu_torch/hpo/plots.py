"""HPO study visualization (a copy of ``hhrs_tpu/hpo/plots.py``, which the
port does not import; reference train.py:337-350 exports Optuna's
optimization-history / param-importance / parallel-coordinate PNGs via
plotly+kaleido; neither is a dependency, so these are matplotlib
equivalents over the journal records).

Importance is fANOVA-lite: per parameter, the R² of a rank-binned
group-mean predictor of the objective — cheap, monotonic-invariant, and
good enough to reproduce the reference's convergence analysis
(Documentation.md:219-225).
"""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger(__name__)


def _completed(trials: list[dict]) -> list[dict]:
    return [t for t in trials if t.get("state") == "complete" and t.get("value") is not None]


def param_importances(trials: list[dict], n_bins: int = 4) -> dict:
    """Parameter → R² of bin-mean objective predictor (higher = matters more)."""
    done = _completed(trials)
    if len(done) < 8:
        return {}
    values = np.asarray([t["value"] for t in done], dtype=np.float64)
    total_var = values.var()
    if total_var == 0:
        return {}
    out = {}
    names = sorted({k for t in done for k in t["params"]})
    for name in names:
        xs = [t["params"].get(name) for t in done]
        # rank-encode (handles categorical + log scales uniformly)
        uniq = {v: i for i, v in enumerate(sorted(set(xs), key=lambda v: (str(type(v)), v)))}
        ranks = np.asarray([uniq[v] for v in xs], dtype=np.float64)
        bins = np.minimum(
            (ranks / max(ranks.max(), 1) * (n_bins - 1)).round().astype(int), n_bins - 1
        )
        explained = 0.0
        for b in range(n_bins):
            m = bins == b
            if m.any():
                explained += m.sum() * (values[m].mean() - values.mean()) ** 2
        out[name] = float(explained / len(values) / total_var)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def save_study_plots(trials: list[dict], out_dir: str) -> list[str]:
    """Write optimization_history.png + param_importances.png; returns paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    done = _completed(trials)
    written = []

    if done:
        fig, ax = plt.subplots(figsize=(8, 4.5))
        nums = [t["number"] for t in done]
        vals = [t["value"] for t in done]
        best = np.minimum.accumulate(vals)
        ax.scatter(nums, vals, s=12, alpha=0.5, label="trial value")
        ax.plot(nums, best, lw=2, label="best so far")
        ax.set_xlabel("trial")
        ax.set_ylabel("val logloss")
        ax.set_title("Optimization history")
        ax.legend()
        path = os.path.join(out_dir, "optimization_history.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    imp = param_importances(trials)
    if imp:
        fig, ax = plt.subplots(figsize=(8, 4.5))
        names = list(imp)[::-1]
        ax.barh(names, [imp[n] for n in names])
        ax.set_xlabel("importance (R² of bin means)")
        ax.set_title("Hyperparameter importances")
        path = os.path.join(out_dir, "param_importances.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    if len(done) >= 2:
        written.append(_parallel_coordinates(done, out_dir, plt))

    log.info("study plots: %s", written)
    return written


def _parallel_coordinates(done: list[dict], out_dir: str, plt) -> str:
    """Parallel-coordinate view (reference train.py:348-350): one polyline
    per completed trial across the parameter axes, colored sequentially
    (one hue, light→dark = worse→better objective); the best trial drawn
    on top with a direct label. Numeric params scale linearly (log for
    lr/weight_decay), categoricals by rank."""
    names = sorted({k for t in done for k in t["params"]})
    values = np.asarray([t["value"] for t in done], dtype=np.float64)

    # per-axis normalized coordinates in [0, 1]
    coords = np.zeros((len(done), len(names)))
    tick_info = []
    for j, name in enumerate(names):
        xs = [t["params"].get(name) for t in done]
        numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in xs)
        if numeric:
            arr = np.asarray(xs, np.float64)
            use_log = name in ("lr", "weight_decay") and (arr > 0).all()
            a = np.log10(arr) if use_log else arr
            lo, hi = a.min(), a.max()
            coords[:, j] = 0.5 if hi == lo else (a - lo) / (hi - lo)
            lo_lab = f"{arr.min():.3g}"
            hi_lab = f"{arr.max():.3g}"
        else:
            uniq = sorted(set(map(str, xs)))
            pos = {v: i for i, v in enumerate(uniq)}
            denom = max(len(uniq) - 1, 1)
            coords[:, j] = [pos[str(v)] / denom for v in xs]
            lo_lab, hi_lab = uniq[0], uniq[-1]
        tick_info.append((lo_lab, hi_lab))

    # sequential color: light = worst, dark = best (lower objective better)
    vspan = values.max() - values.min()
    better = 1.0 - (values - values.min()) / (vspan if vspan else 1.0)
    cmap = plt.get_cmap("Blues")
    order = np.argsort(values)[::-1]  # draw worst first, best on top

    fig, ax = plt.subplots(figsize=(max(8, 1.3 * len(names)), 5))
    xs_axis = np.arange(len(names))
    for i in order:
        ax.plot(xs_axis, coords[i], color=cmap(0.25 + 0.7 * better[i]),
                lw=1.0, alpha=0.55, zorder=2)
    best_i = int(np.argmin(values))
    ax.plot(xs_axis, coords[best_i], color=cmap(0.98), lw=2.2, zorder=3)
    ax.annotate(f"best {values[best_i]:.4f}", (xs_axis[-1], coords[best_i, -1]),
                xytext=(6, 0), textcoords="offset points", fontsize=8,
                va="center", color="0.2")

    for j, (lo_lab, hi_lab) in enumerate(tick_info):
        ax.axvline(j, color="0.85", lw=0.8, zorder=1)
        ax.text(j, -0.045, lo_lab, ha="center", va="top", fontsize=7, color="0.45")
        ax.text(j, 1.045, hi_lab, ha="center", va="bottom", fontsize=7, color="0.45")
    ax.set_xticks(xs_axis)
    ax.set_xticklabels(names, fontsize=8, rotation=15, ha="right")
    ax.set_yticks([])
    ax.set_ylim(-0.1, 1.1)
    for s in ("top", "right", "left"):
        ax.spines[s].set_visible(False)
    ax.set_title("Parallel coordinates (dark = lower val logloss)")
    sm = plt.cm.ScalarMappable(
        cmap=cmap.reversed(), norm=plt.Normalize(values.min(), values.max())
    )
    fig.colorbar(sm, ax=ax, label="val logloss", shrink=0.8)
    path = os.path.join(out_dir, "parallel_coordinates.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
