"""Engineered features shared by train and serve (counterpart of
``hhrs_tpu/data/features.py``): division by zero → 0, NaN ratio → 0;
``location_premium`` is a plain difference (NaN kept)."""

from __future__ import annotations

import numpy as np


def _safe_ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        out = num / den
    out = np.where(np.isinf(out), 0.0, out)
    return np.where(np.isnan(out), 0.0, out)


def add_engineered_features(table: dict) -> dict:
    """Add price_per_star, cleanliness_vs_service, location_premium in place."""
    f = lambda name: table[name].astype(np.float64)  # noqa: E731
    table["price_per_star"] = _safe_ratio(f("price_rub"), f("stars"))
    table["cleanliness_vs_service"] = _safe_ratio(f("rating_cleanliness"), f("rating_service"))
    table["location_premium"] = f("rating_overall") - f("rating_location")
    return table
