"""The device's idle time a batch under ``serve.admit`` (the ladder,
the inf scan, padding), in the traced batches."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("serve.admit",), "batches", 1e6)
