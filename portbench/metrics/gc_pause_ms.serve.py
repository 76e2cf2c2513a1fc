"""Total time of the Python collector's generation-2 collections inside the
serving window (``gc.callbacks``)."""


def read(ctx: dict):
    return 1e3 * sum(s for gen, s in ctx["gc_pauses"] if gen == 2)
