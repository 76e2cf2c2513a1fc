"""Readings shared by per-layer metrics of several layers."""


def idle_pct(ctx: dict):
    """100 × (1 − device busy / traced window), or nothing without a trace."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
