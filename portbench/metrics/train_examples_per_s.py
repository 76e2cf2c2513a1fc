"""Training rows stepped in the window over the window's wall seconds; the
window is whole epochs, each with its val evaluation and bookkeeping."""


def read(ctx: dict):
    return ctx["rows_stepped"] / ctx["window_s"]
