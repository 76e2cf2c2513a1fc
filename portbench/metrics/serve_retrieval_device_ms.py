"""Mean device time a batch of the retrieval stage in the traced window:
the program's ``serve.device.retrieval_ms`` booking, from the timing events
captured into the bucket's CUDA graph before and after
``retrieval/candidates.py::generate_batch``."""

from portbench.program_readings import booked_mean


def read(ctx: dict):
    return booked_mean(ctx, "serve.device.retrieval_ms")
