"""Host time a batch: the traced batch calls' wall minus the device's busy
time, over the batches."""


def read(ctx):
    f, trace = ctx["facts"], ctx["trace"]
    lat = f.get("latencies_s")
    if trace is None or not lat or trace.device_events == 0:
        return None
    return (sum(lat) - trace.busy_s) / len(lat) * 1e6
