"""Kernel lab (L7) on the H100: the inner-loop cost of the decode bodies
of experiments/kernel_lab.py, each under the lab's fold, timed beside
the stream probe K3 on the same words.

One bucket of uniform width W (LAB_W, 32) in NB (LAB_NB) blocks of SPB
(LAB_SPB, 16) slices, chunks of S = 8 rows (LAB_S); every slice's score
folded into 8 (value, tag) pairs per lane by LAB_FOLD: ``exact`` (the
first minimum slot), ``fast`` (every minimum slot) or ``top1g4`` (the
strict maximum of each group of 4 slices, then exact). The bodies keep
the JAX lab's names and compute what the TPU computes:

  stream      the bf16 value plus the table entry of the word's own lane
  h16         two nnz per word against the int4x8 row (the products'
              int32 bits added as floats: denormals, flushed, or NaN)
  f32         the f32 codec: lane lo & 127 of row hi = w >> 23 (row 0
              when hi names no row 1..7)
  int8        int8x4: row 1 when w >> 25 == 1, byte (w >> 20) & 24
  i8s         sign-select row, (entry << ((w >> 24) & 31)) >> 24
  i8s_nomask  the same shift unmasked: the TPU wraps its amount mod 32
  i8s_int     the int32 product (w & 0xFFFF) * q, its bits added as floats
  int8_sign   sign-select row, byte (w >> 24) & 24
  int8_fbits  int8_sign's byte converted through float bits
  int4        nibble (w >> 21) & 28 of row 0
  take1       row 0's f32 entry
  take2sel    the f32 entry of the sign-select row

A gather index is the field's low 7 bits (the TPU's lane gather; the
JAX lab leaves ``w >> 16`` unmasked). ``kernel_lab_device`` launches
``csrc/lab_kernel.cu`` on a CUDA tensor and ``kernel_lab_plain`` runs on
a CPU tensor.

    python -m spmv_topk_tpu_torch.experiments.kernel_lab [variant ...]
        [--device cpu]      (env LAB_S, LAB_W, LAB_SPB, LAB_NB, LAB_FOLD)

LAB_NB defaults to 4096 blocks here (1 GiB of words, 21x the card's L2);
the JAX lab's 256 (67 MB) would partly stay in L2.
"""

from __future__ import annotations

import os

import torch

from ._common import (CHUNK, DEFAULT_NB, GROUP, LANES, bf16, check_table,
                      check_words, drive, env_int, finish, float_scores,
                      fold_plain, ftz, kernel_lab_data, lsr, one_buffer,
                      parse_args, run_kernel)

# variant -> rows of its query table; the order is csrc/lab_kernel.cu's
# enum Variant
VARIANTS = {"stream": 1, "h16": 1, "f32": 8, "int8": 2, "i8s": 2,
            "i8s_nomask": 2, "i8s_int": 2, "int8_sign": 2, "int8_fbits": 2,
            "int4": 1, "take1": 1, "take2sel": 2}
FLOAT_TABLES = ("stream", "f32", "take1", "take2sel")   # f32 tables
FOLDS = ("exact", "fast", "top1g4")                      # enum Fold


# ---------------------------------------------------------------- bodies
# (words (..., S, 128) int32, table (rows, 128) as int32 bits) -> float32
# per word, flushed; the TPU semantics of experiments/kernel_lab.py:61-200

def _take(tab, row, idx):
    """Entry ``idx`` (0..127) of table row ``row``."""
    return tab.reshape(-1)[(row * LANES + idx).long()]


def _lane(w):
    """The gather index lo = w >> 16, its low 7 bits."""
    return (w >> 16) & 127


def _float(bits):
    return ftz(bits.view(torch.float32))


def _sign_row(w):
    return (w < 0).to(torch.int32)


def body_stream(w, tab):
    return ftz(bf16(w) + _float(tab[0]))


def body_f32(w, tab):
    hi = lsr(w, 23)
    row = torch.where(hi < 8, hi, 0)
    return ftz(bf16(w) * _float(_take(tab, row, _lane(w))))


def _byte_times(w, sel, sh):
    return ftz(bf16(w) * (((sel >> sh) & 0xFF) - 128).to(torch.float32))


def body_int8(w, tab):
    row = (lsr(w, 25) == 1).to(torch.int32)
    return _byte_times(w, _take(tab, row, _lane(w)), (w >> 20) & 24)


def body_int8_sign(w, tab):
    return _byte_times(w, _take(tab, _sign_row(w), _lane(w)), (w >> 24) & 24)


def body_int8_fbits(w, tab):
    sel = _take(tab, _sign_row(w), _lane(w))
    byte = (sel >> ((w >> 24) & 24)) & 0xFF
    f = (byte | 0x4B000000).view(torch.float32) - (8388608.0 + 128.0)
    return ftz(bf16(w) * f)


def body_int4(w, tab):
    nib = (_take(tab, 0, _lane(w)) >> ((w >> 21) & 28)) & 0xF
    return ftz(bf16(w) * (nib - 8).to(torch.float32))


def body_take1(w, tab):
    return ftz(bf16(w) * _float(_take(tab, 0, _lane(w))))


def body_take2sel(w, tab):
    return ftz(bf16(w) * _float(_take(tab, _sign_row(w), _lane(w))))


def _i8s_q(w, tab):
    """The sign-select entry's signed byte: a shift amount of (w >> 24)
    mod 32, as i8s masks it and as the TPU wraps i8s_nomask's."""
    return (_take(tab, _sign_row(w), _lane(w)) << ((w >> 24) & 31)) >> 24


def body_i8s(w, tab):
    return ftz(bf16(w) * _i8s_q(w, tab).to(torch.float32))


def body_i8s_int(w, tab):
    return ftz(((w & 0xFFFF) * _i8s_q(w, tab)).view(torch.float32))


def body_h16(w, tab):
    g0 = _take(tab, 0, w & 127)
    g1 = _take(tab, 0, lsr(w, 16) & 127)
    n0 = ((g0 >> ((w >> 5) & 28)) & 0xF) - 8
    n1 = ((g1 >> ((w >> 21) & 28)) & 0xF) - 8
    p = ((w << 16) >> 26) * n0 + (w >> 26) * n1
    return ftz(p.view(torch.float32))


BODIES = {"stream": body_stream, "h16": body_h16, "f32": body_f32,
          "int8": body_int8, "i8s": body_i8s, "i8s_nomask": body_i8s,
          "i8s_int": body_i8s_int, "int8_sign": body_int8_sign,
          "int8_fbits": body_int8_fbits, "int4": body_int4,
          "take1": body_take1, "take2sel": body_take2sel}


# ---------------------------------------------------------------- kernel

def _check(words, table, variant, fold, W, SPB, S):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}")
    if fold == "top1g4" and SPB % GROUP:
        raise ValueError(f"top1g4 needs SPB % {GROUP} == 0, got {SPB}")
    if S < 1 or S & (S - 1) or W < 1:
        raise ValueError(f"S={S} (a power of two), W={W}")
    nb = check_words(words, W * SPB)
    check_table(table, VARIANTS[variant],
                torch.float32 if variant in FLOAT_TABLES else torch.int32,
                words.device)
    return nb


def kernel_lab_plain(words, table, *, variant: str, fold: str = "exact",
                     W: int = 32, SPB: int = 16, S: int = CHUNK):
    """Plain PyTorch version of the lab kernel: (tv, tt), each (8, 128),
    the values the lab's sequential fold keeps, sorted descending per
    lane (``_common.fold_plain``). words: (NB * W * SPB, 128) int32;
    table: (VARIANTS[variant], 128), float32 for FLOAT_TABLES, else
    int32."""
    _check(words, table, variant, fold, W, SPB, S)
    tab = table.view(torch.int32)
    body = BODIES[variant]
    scores = float_scores(words, lambda t: body(t, tab), W=W, S=S,
                          flush=True)
    return fold_plain(scores, fold)


def kernel_lab_device(words, table, *, variant: str, fold: str = "exact",
                      W: int = 32, SPB: int = 16, S: int = CHUNK,
                      blocks=None, unmerged: bool = False):
    """The lab kernel (csrc/lab_kernel.cu) on a CUDA tensor, merged per
    lane: (tv, tt) as ``kernel_lab_plain``, which a CPU tensor runs. The
    kernel reads chunks of 8 rows (S = 8). ``blocks``: its CUDA block
    count (``_common.run_kernel``); ``unmerged``: return its (blocks, 8,
    128) buffers (``_common.finish``)."""
    nb = _check(words, table, variant, fold, W, SPB, S)
    if words.device.type == "cpu":
        return one_buffer(kernel_lab_plain(words, table, variant=variant,
                                           fold=fold, W=W, SPB=SPB, S=S),
                          unmerged)
    if S != CHUNK:
        raise ValueError(f"the lab kernels read chunks of {CHUNK} rows, "
                         f"got S={S}")
    out = run_kernel("lab_kernel", words, nb, words.data_ptr(),
                     table.data_ptr(), VARIANTS[variant], nb, W, SPB,
                     list(VARIANTS).index(variant), FOLDS.index(fold),
                     blocks=blocks)
    kernel_lab_device.launches += 1
    return finish(*out, unmerged)


kernel_lab_device.launches = 0


def lab_tables(table, table_i, dev):
    """variant -> its query table on ``dev``: the first rows of the f32 or
    the int32 table (kernel_lab.py:333-337)."""
    return {name: torch.from_numpy(
        (table if name in FLOAT_TABLES else table_i)[:rows]).to(dev)
        for name, rows in VARIANTS.items()}


def main(argv=None):
    names, dev = parse_args(argv, list(VARIANTS), list(VARIANTS), __doc__)
    S, W, SPB = env_int("LAB_S", CHUNK), env_int("LAB_W", 32), \
        env_int("LAB_SPB", 16)
    nb = env_int("LAB_NB", DEFAULT_NB)
    fold = os.environ.get("LAB_FOLD", "exact")
    words, table, table_i = kernel_lab_data(nb, W * SPB)
    words = torch.from_numpy(words).to(dev)
    tabs = lab_tables(table, table_i, dev)

    def call(name, unmerged=False):
        return kernel_lab_device(words, tabs[name], variant=name, fold=fold,
                                 W=W, SPB=SPB, S=S, unmerged=unmerged)

    return drive(f"kernel_lab/{fold}", names, words, nb, 1, call,
                 lambda name: call(name, unmerged=True))


if __name__ == "__main__":
    main()
