"""The device's idle time a round under ``federation.exchange`` (making,
metering and gathering the parties' messages), in the traced jobs."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("federation.exchange",), "rounds", 1e3)
