"""Set-up: from the process's start to the first timed batch or step
(host clock): the world, the program's set-up, compiling and warming."""


def read(ctx: dict):
    return ctx["setup_s"]
