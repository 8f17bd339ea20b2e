"""The share of the device's idle time in the traced jobs under no
program span (the innermost span ``round N``, the harness's ``job`` or
``window``, or none), in %."""

from fedgbf_bench import idle_by_span


def read(ctx):
    return idle_by_span.unattributed_share(ctx)
