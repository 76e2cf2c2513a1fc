"""Mean device time a batch of the order and MMR stage in the traced
window: the program's ``serve.device.mmr_ms`` booking, from the timing
events captured into the bucket's CUDA graph around the stable order and
``ops/mmr.py::mmr_rerank``."""

from portbench.program_readings import booked_mean


def read(ctx: dict):
    return booked_mean(ctx, "serve.device.mmr_ms")
