"""Readings of the program's own spans and counters
(``hhrs_tpu_torch/utils/profiling.py``), shared by the per-layer metrics
that read them. Each gives nothing without a traced window, and nothing
where the program has no such span, booking or registry (a program
without them, or the CPU, where no device time is booked)."""


def span_ms(ctx: dict, name: str):
    """Mean duration in ms of the program's host spans named ``name`` in
    the traced window, one a batch or an epoch. A span the window's end
    cut short (it ends where the profile stopped) is left out."""
    tr = ctx.get("trace")
    if tr is None or not tr.host:
        return None
    stop = max(h[1] for h in tr.host)
    spans = [t - s for s, t, n, user in tr.host if user and n == name and t < stop]
    return 1e-6 * sum(spans) / len(spans) if spans else None


def _counters(ctx: dict):
    """The registry's snapshot after a traced run, or None."""
    if ctx.get("trace") is None:
        return None
    from hhrs_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    snap = read()
    return snap if snap.get("stretch") else None


def booked_mean(ctx: dict, name: str):
    """Total over count of the booking ``name`` in the traced stretch."""
    snap = _counters(ctx)
    pair = None if snap is None else snap["booked"].get(name)
    return pair[1] / pair[0] if pair and pair[0] else None


def rebuilds(ctx: dict):
    """Events counted under ``build.*`` in the traced stretch (kernel
    libraries compiled, launch plans timed, graphs captured)."""
    snap = _counters(ctx)
    if snap is None:
        return None
    return sum(n for name, (n, _total) in snap["booked"].items() if name.startswith("build."))
