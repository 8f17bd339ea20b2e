"""All the window's time over all the boosting rounds its jobs completed:
jobs run whole, and the one in progress when the time is up ends the
window."""


def read(ctx):
    f = ctx["facts"]
    if not f.get("rounds"):
        return None
    return f["window_s"] / f["rounds"] * 1e3
