"""The least time of the traced batches (``counts.py``: rows, node tables
and scores moved once) over the profiler's device time of the traversal
kernel."""


def read(ctx):
    f, trace = ctx["facts"], ctx["trace"]
    if trace is None or not f.get("batches"):
        return None
    spent = trace.kernel_time(f["traverse_kernels"])
    if spent <= 0:
        return None
    return 100.0 * f["batch_least_s"] * (f["batches"] - f["failed"]) / spent
