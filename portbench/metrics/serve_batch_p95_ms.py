"""95th percentile over every batch of the window of one
``recommend_many`` call (host clock; the call ends in its device→host
copy)."""

import numpy as np


def read(ctx: dict):
    return float(np.percentile(ctx["batch_s"], 95)) * 1e3
