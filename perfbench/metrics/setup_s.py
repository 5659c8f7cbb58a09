"""Seconds from the process's start to the end of the warm call: imports,
the inputs made on the device, the program's set-up, one warm call."""


def read(ctx):
    return ctx.setup_s
