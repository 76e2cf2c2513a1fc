"""Mean time of the program's ``serve.host_inputs`` span a batch in the
traced window: the per-request loop that packs the inputs on the host
(``serve/engine.py::_recommend``, ``_host_inputs``)."""

from portbench.program_readings import span_ms


def read(ctx: dict):
    return span_ms(ctx, "serve.host_inputs")
