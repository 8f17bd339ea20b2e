"""The device's idle share of the traced batches, from the profiler:
1 - the union of device activity over the traced window."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.device_events == 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
