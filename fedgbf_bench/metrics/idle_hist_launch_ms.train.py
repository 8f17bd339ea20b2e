"""The device's idle time a round under ``kernel.histogram``: the
histogram kernel's wrappers on the host (checks, scratch, the launch), in
the traced jobs."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("kernel.histogram",), "rounds", 1e3)
