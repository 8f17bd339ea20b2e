"""The device's idle time a round under ``round.gradients`` and
``round.update`` (g/h and the masks; the margins, metrics and the
round's synchronize), in the traced jobs."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("round.gradients", "round.update"),
                                 "rounds", 1e3)
