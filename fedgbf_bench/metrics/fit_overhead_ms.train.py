"""``train_fedgbf``'s wall outside its rounds (binning, the seeded mask
draw, the final fetch), the program's ``TrainHistory.overhead_s``, a mean
over the traced jobs."""


def read(ctx):
    o = ctx["facts"].get("overhead_s")
    if not o:
        return None
    return sum(o) / len(o) * 1e3
