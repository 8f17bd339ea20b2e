"""A round's least time over its measured time: the job's operations at
the float32 peak or its inputs and outputs moved once at the HBM rate,
whichever is longer (``counts.job_least_s``), spread over its rounds,
against the traced window's time a round."""

from fedgbf_bench import counts


def read(ctx):
    f = ctx["facts"]
    if not f.get("rounds"):
        return None
    least = counts.job_least_s(f["job_shape"]) / f["rounds_per_job"]
    return 100.0 * least / (f["window_s"] / f["rounds"])
