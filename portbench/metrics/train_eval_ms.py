"""Mean device time an epoch of the val evaluation in the traced window:
the program's ``train.device.eval_ms`` booking, from CUDA events just
around the eval's launches (``train/trainer.py::train_dcn``)."""

from portbench.program_readings import booked_mean


def read(ctx: dict):
    return booked_mean(ctx, "train.device.eval_ms")
