"""Packed 32-bit words on the card per nnz of the corpus: the packer's
padding and width (``hbm_bytes / 4 / nnz``, a count the engine reports)."""


def read(ctx):
    return ctx.hbm_bytes / 4 / ctx.nnz if ctx.nnz else None
