"""Mean time of the program's ``train.shuffle`` span an epoch in the
traced window: the host permutation of the train rows
(``train/trainer.py::train_dcn``)."""

from portbench.program_readings import span_ms


def read(ctx: dict):
    return span_ms(ctx, "train.shuffle")
