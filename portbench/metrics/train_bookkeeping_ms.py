"""Mean time of the program's ``train.bookkeeping`` span an epoch in the
traced window: the plateau, history and log, the best state's copy, the
per-epoch hook, the checkpoint and the epoch's device-time read."""

from portbench.program_readings import span_ms


def read(ctx: dict):
    return span_ms(ctx, "train.bookkeeping")
