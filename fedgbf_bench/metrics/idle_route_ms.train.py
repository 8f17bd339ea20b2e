"""The device's idle time a round under ``tree.route``, in the traced
jobs."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("tree.route",), "rounds", 1e3)
