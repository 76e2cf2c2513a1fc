"""Median over every batch of the window of one ``recommend_many`` call
(host clock)."""

import numpy as np


def read(ctx: dict):
    return float(np.percentile(ctx["batch_s"], 50)) * 1e3
