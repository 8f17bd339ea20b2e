"""The device's idle time a batch under ``serve.copy_out`` (the scores'
copy back and their write into the output), in the traced batches."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.per_unit(ctx, ("serve.copy_out",), "batches", 1e6)
