"""The least time of the traced jobs' histogram work (``counts.py``, from
shapes alone) over the profiler's device time of the histogram source's
kernels."""

from fedgbf_bench import counts


def read(ctx):
    f, trace = ctx["facts"], ctx["trace"]
    if trace is None or not f.get("rounds"):
        return None
    spent = trace.kernel_time(f["hist_kernels"])
    if spent <= 0:
        return None
    jobs = f["rounds"] // f["rounds_per_job"]
    least = jobs * counts.histogram_job_least_s(f["job_shape"])
    return 100.0 * least / spent
