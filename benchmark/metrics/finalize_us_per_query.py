"""Device time of the operations launched under finalize
(``finalize_topk`` / ``finalize_topk_batch``, the benchmark's
``bench.finalize`` span) per query of the traced window, in us."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.queries:
        return None
    ops = t.ops_under("bench.finalize")
    return t.seconds(ops) / t.queries * 1e6 if ops else None
