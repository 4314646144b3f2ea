"""Mean precision@100 of the sampled served answers against the
reference's exact float32 top-100 (the check's sample: at least 256
answered queries spread evenly over the window)."""

from benchmark import check


def read(ctx):
    if len(ctx.served) == 0 or ctx.k < 100:
        return None
    return check.precision_at(ctx.served, ctx.exact, 100)
