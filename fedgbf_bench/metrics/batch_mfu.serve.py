"""A batch's least time (its rows and the node tables read once, its
scores written once, at the HBM rate; ``counts.batch_least_s``) over the
mean batch call of the traced window."""


def read(ctx):
    f = ctx["facts"]
    lat = f.get("latencies_s")
    if not lat or not f.get("rows"):
        return None
    return 100.0 * f["batch_least_s"] / (sum(lat) / len(lat))
