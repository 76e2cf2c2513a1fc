"""Kernel libraries compiled, launch plans timed and graphs captured by
the program inside the traced training window (its ``build.*`` counts):
0 when every epoch replays what set-up built."""

from portbench.program_readings import rebuilds as read  # noqa: F401
