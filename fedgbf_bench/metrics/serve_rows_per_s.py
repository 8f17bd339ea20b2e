"""Rows scored in the window over the window."""


def read(ctx):
    f = ctx["facts"]
    if not f.get("rows"):
        return None
    return f["rows"] / f["window_s"]
