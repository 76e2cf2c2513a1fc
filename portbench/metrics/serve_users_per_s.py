"""Users answered in the window over the window's wall seconds."""


def read(ctx: dict):
    return ctx["users"] / ctx["window_s"]
