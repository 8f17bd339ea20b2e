"""The device's idle time a round under ``tree.split`` (the split
search and the level's tables), in the traced jobs."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("tree.split",), "rounds", 1e3)
