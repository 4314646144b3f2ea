"""Queries answered in the window per second of the window (host clock)."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.window_s > 0 else None
