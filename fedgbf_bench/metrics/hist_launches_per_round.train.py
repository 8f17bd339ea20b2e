"""Histogram kernel launches a round: the program's launch counters of its
three histogram entry points over the traced jobs' rounds.  Nothing where
no kernel launched (the CPU)."""


def read(ctx):
    f = ctx["facts"]
    if not f.get("rounds") or not f.get("hist_launches"):
        return None
    return f["hist_launches"] / f["rounds"]
