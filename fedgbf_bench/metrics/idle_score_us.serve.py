"""The device's idle time a batch under ``serve.score`` (the traversal's
host side and the wait for it), in the traced batches."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("serve.score",), "batches", 1e6)
