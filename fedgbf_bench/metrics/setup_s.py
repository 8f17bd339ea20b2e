"""Seconds from the process's start to the start of the window: imports,
the card, data from the seed, the warm work; the first run in a checkout
also builds the kernels."""


def read(ctx):
    return ctx["setup_s"]
