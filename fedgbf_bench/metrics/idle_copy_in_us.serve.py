"""The device's idle time a batch under ``serve.copy_in`` (the rows'
copy to the card), in the traced batches."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("serve.copy_in",), "batches", 1e6)
