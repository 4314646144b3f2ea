"""Seconds from the start of the process until the window opens: the
corpus and queries, the engine's pack and upload, the kernels' build or
load, and the warm-up."""


def read(ctx):
    return ctx.setup_s
