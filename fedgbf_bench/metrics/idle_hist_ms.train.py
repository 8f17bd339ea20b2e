"""The device's idle time a round under ``tree.histogram`` (the
histogram or child provider, the sibling subtraction, the compaction), in
the traced jobs."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("tree.histogram",), "rounds", 1e3)
