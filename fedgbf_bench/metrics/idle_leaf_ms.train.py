"""The device's idle time a round under ``tree.leaf`` (liveness counts,
the leaf statistics and weights), in the traced jobs."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("tree.leaf",), "rounds", 1e3)
