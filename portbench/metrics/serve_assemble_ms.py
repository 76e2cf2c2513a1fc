"""Mean time of the program's ``serve.assemble`` span a batch in the
traced window: the answers' payloads built on the host
(``serve/engine.py::_assemble``)."""

from portbench.program_readings import span_ms


def read(ctx: dict):
    return span_ms(ctx, "serve.assemble")
