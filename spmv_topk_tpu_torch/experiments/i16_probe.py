"""int16 probe (L6) on the H100: whether 16-bit integer chains run at twice
the density of 32-bit ones (experiments/i16_probe.py), each variant timed
beside the stream probe K3 on the same bytes.

The words are NB lab blocks of SUB32 int32 rows, or of 2 * SUB32 int16
rows (the same bytes), in (8, 128) int32 or (16, 128) int16 tiles; row r
of a tile adds into the running (S, 128) sum, in the words' type (int16
wraps), from the salt row (i16_probe.py:43-63):

  s32   (w >>> 3) & 127 of int32 words
  s16   the same on int16 words (a 16-bit logical shift)
  g32   table[r][w & 127]: row r of the (8, 128) int32 table
  g16   the same on int16 words and a (16, 128) int16 table
  g16x  g16 with the index widened to int32 first

SUB32 (LAB_SUB32, 1024: 512 KiB a block), NB (LAB_NB, 2048 here: 1 GiB,
the JAX probe's 256 times 8). Integer sums do not depend on their order,
so ``i16_probe_device`` adds its CUDA blocks' partial sums and the salt
and equals ``i16_probe_plain`` bit for bit. A variant that does not build
or launch raises (the JAX probe reports a lowering failure and goes on).
``i16_probe_device`` launches ``csrc/lab_i16.cu`` on a CUDA tensor and
``i16_probe_plain`` runs on a CPU tensor.

    python -m spmv_topk_tpu_torch.experiments.i16_probe [variant ...]
        [--device cpu]      (env LAB_NB, LAB_SUB32)
"""

from __future__ import annotations

import torch

from ._common import (LANES, _STEP_WORDS, check_table, cuda_blocks, drive,
                      env_int, i16_probe_data, parse_args, wrap_int)

VARIANTS = ("s32", "s16", "g32", "g16", "g16x")   # csrc/lab_i16.cu's enum
SUB32 = 1024
DEFAULT_NB = 2048


def spec(variant: str):
    """(rows S of a tile, dtype, gather) of a variant."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    wide = "32" in variant
    return (8 if wide else 16), (torch.int32 if wide else torch.int16), \
        variant.startswith("g")


def _check(words, table, salt, variant, sub32):
    S, dt, _ = spec(variant)
    sub = sub32 if S == 8 else 2 * sub32
    if words.ndim != 2 or words.shape[1] != LANES or words.dtype != dt or \
            not words.is_contiguous() or words.shape[0] < sub or \
            words.shape[0] % sub:
        raise ValueError(f"words must be contiguous {dt} (NB * {sub}, "
                         f"{LANES}), got {words.dtype} "
                         f"{tuple(words.shape)}")
    check_table(table, S, dt, words.device)
    check_table(salt, 1, dt, words.device)
    return words.shape[0] // sub, sub


def element(w, table, variant):
    """Each word's term (int64): (w >>> 3) & 127 or table[r][w & 127] for
    the word's row r of its tile (w: (..., S, 128))."""
    S, _, gather = spec(variant)
    if gather:
        idx = (w & 0x7F).long()
        return torch.gather(table.long().expand(*w.shape[:-2], S, LANES),
                            -1, idx)
    bits = 32 if S == 8 else 16
    return ((w.long() & ((1 << bits) - 1)) >> 3) & 0x7F


def i16_sum(words, table, variant):
    """The (S, 128) sum (int64, unwrapped) of every tile's terms."""
    S = spec(variant)[0]
    tot = torch.zeros((S, LANES), dtype=torch.int64, device=words.device)
    per = max(S, _STEP_WORDS // LANES // S * S)
    for r0 in range(0, words.shape[0], per):
        tiles = words[r0:r0 + per].reshape(-1, S, LANES)
        tot += element(tiles, table, variant).sum(0)
    return tot


def i16_probe_plain(words, table, salt, *, variant: str, sub32: int = SUB32):
    """Plain PyTorch version: salt + the sum, (S, 128) in the words' type.
    words: (NB * sub, 128) int32 (sub = sub32) or int16 (sub = 2 * sub32);
    table: (S, 128), salt: (1, 128), both in the words' type."""
    _check(words, table, salt, variant, sub32)
    return wrap_int(i16_sum(words, table, variant) + salt.long(),
                    words.dtype)


def i16_probe_device(words, table, salt, *, variant: str, sub32: int = SUB32,
                     blocks=None, unmerged: bool = False):
    """The lab kernel (csrc/lab_i16.cu) on a CUDA tensor: as
    ``i16_probe_plain``, which a CPU tensor runs. ``blocks``: the CUDA
    block count (default ``_common.cuda_blocks``); ``unmerged``: the
    per-CUDA-block sums without the salt, (blocks, S, 128), the kernel
    alone (on the CPU, the plain sum less the salt as one block)."""
    nb, sub = _check(words, table, salt, variant, sub32)
    S, dt, _ = spec(variant)
    if words.device.type == "cpu":
        if unmerged:
            return wrap_int(i16_sum(words, table, variant), dt)[None]
        return i16_probe_plain(words, table, salt, variant=variant,
                               sub32=sub32)
    from ..ops.kernel import _launch

    nblk = cuda_blocks(words.device, nb, blocks)
    part = torch.empty((nblk, S, LANES), dtype=dt, device=words.device)
    _launch(words.device, "lab_i16", words.data_ptr(), table.data_ptr(), nb,
            sub, VARIANTS.index(variant), nblk, part.data_ptr())
    i16_probe_device.launches += 1
    if unmerged:
        return part
    return wrap_int(part.long().sum(0) + salt.long(), dt)


i16_probe_device.launches = 0


def main(argv=None):
    names, dev = parse_args(argv, VARIANTS, VARIANTS, __doc__)
    nb, sub32 = env_int("LAB_NB", DEFAULT_NB), env_int("LAB_SUB32", SUB32)
    w32, w16, t32, t16 = (torch.from_numpy(a).to(dev)
                          for a in i16_probe_data(nb, sub32))
    salt = {dt: torch.arange(LANES, device=dev).to(dt).reshape(1, LANES)
            for dt in (torch.int32, torch.int16)}

    def args(name):
        return (w32, t32) if "32" in name else (w16, t16)

    def call(name, unmerged=False):
        w, t = args(name)
        return i16_probe_device(w, t, salt[w.dtype], variant=name,
                                sub32=sub32, unmerged=unmerged)

    return drive("i16_probe", names, {n: args(n)[0] for n in names}, nb, 1,
                 call, lambda name: call(name, unmerged=True))


if __name__ == "__main__":
    main()
