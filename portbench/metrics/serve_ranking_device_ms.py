"""Mean device time a batch of the ranking stage in the traced window: the
program's ``serve.device.ranking_ms`` booking, from the timing events
captured into the bucket's CUDA graph around the x0 gather and the
scoring (``ops/tower.py::tower_eval``)."""

from portbench.program_readings import booked_mean


def read(ctx: dict):
    return booked_mean(ctx, "serve.device.ranking_ms")
