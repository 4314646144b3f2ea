"""h16 lab (L5) on the H100: the decode chain of the two-nnz-per-word
codec (experiments/h16_lab.py), each variant timed beside the stream
probe K3 on the same words.

Each 16-bit half of a word is col[0:10) | val6[10:16); the int4x8 query
table's one row holds nibble g of lane l = q[g, l] for column g * 128 + l.

  cur          the production decode: xor-trick nibble sign extension, f32
               accumulation (h16_lab.py:62-74)
  nsh          complement-shift nibble extraction, f32 accumulation
  int          cur's decode, int32 accumulation (one f32 convert a slice)
  nsh_int      both
  nsh_int_raw  nsh_int with raw gather indices (on the TPU the lane gather
               reads an index's low 7 bits; on this card the shared-memory
               load takes index & 127 either way, so it is nsh_int)
  v2           the v2 word layout col0[0:10) | col1[10:20) | val0[20:26) |
               val1[26:32) against a reversed-nibble table (group g at
               nibble 7 - g), int32 accumulation
  stream       no decode: the word plus its lane's table entry, as f32

W (LAB_W, 16) rows per slice, SPB (LAB_SPB, 32) slices per block, NB
(LAB_NB, 4096 here: 1 GiB of words) blocks; the fast fold (every minimum
slot). A gather index is the field's low 7 bits, as on the TPU.
``h16_lab_device`` launches ``csrc/lab_h16.cu`` on a CUDA tensor and
``h16_lab_plain`` runs on a CPU tensor.

    python -m spmv_topk_tpu_torch.experiments.h16_lab [variant ...]
        [--device cpu]

The JAX lab times v2 on v1 words (the same operations); tests build
v2-layout words for it.
"""

from __future__ import annotations

import torch

from ._common import (CHUNK, DEFAULT_NB, check_table, check_words, drive,
                      env_int, finish, float_scores, fold_plain,
                      h16_lab_data, int_scores, lsr, one_buffer, parse_args,
                      run_kernel)

# variant -> int32 accumulation; the order is csrc/lab_h16.cu's enum
VARIANTS = {"cur": False, "nsh": False, "int": True, "nsh_int": True,
            "nsh_int_raw": True, "v2": True, "stream": False}


def _take(tab, idx):
    return tab.reshape(-1)[(idx & 127).long()]


def _values(w):
    """The two 6-bit values of a v1 word: bits [10:16) and [26:32)."""
    return (w << 16) >> 26, w >> 26


def decode_cur(w, tab):
    """cur's int32 products (h16_lab.py:62-74)."""
    g0, g1 = _take(tab, w), _take(tab, lsr(w, 16))
    n0 = (((g0 >> ((w >> 5) & 28)) & 0xF) ^ 8) - 8
    n1 = (((g1 >> ((w >> 21) & 28)) & 0xF) ^ 8) - 8
    v0, v1 = _values(w)
    return v0 * n0 + v1 * n1


def decode_nsh(w, tab):
    """nsh's int32 products (h16_lab.py:77-91): the nibble moved to the
    top by the complemented shift (28 - 4 * (col >> 7)), shifted down
    arithmetically."""
    nw = ~w
    g0, g1 = _take(tab, w), _take(tab, lsr(w, 16))
    n0 = (g0 << ((nw >> 5) & 28)) >> 28
    n1 = (g1 << ((nw >> 21) & 28)) >> 28
    v0, v1 = _values(w)
    return v0 * n0 + v1 * n1


def decode_v2(w, tab):
    """v2's int32 products (h16_lab.py:124-138)."""
    g0, g1 = _take(tab, w), _take(tab, lsr(w, 10))
    n0 = (g0 << ((w >> 5) & 28)) >> 28
    n1 = (g1 << ((w >> 15) & 28)) >> 28
    return ((w << 6) >> 26) * n0 + (w >> 26) * n1


def decode_stream(w, tab):
    """The word plus its lane's table entry (int32, wrapping)."""
    return w + tab.reshape(1, -1)


DECODES = {"cur": decode_cur, "nsh": decode_nsh, "int": decode_cur,
           "nsh_int": decode_nsh, "nsh_int_raw": decode_nsh,
           "v2": decode_v2, "stream": decode_stream}


def _check(words, table, variant, W, SPB, S):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if S != CHUNK:
        raise ValueError(f"the lab reads chunks of {CHUNK} rows, got S={S}")
    nb = check_words(words, W * SPB)
    check_table(table, 1, torch.int32, words.device)
    return nb


def h16_lab_plain(words, table, *, variant: str, W: int = 16, SPB: int = 32,
                  S: int = CHUNK):
    """Plain PyTorch version of the lab: (tv, tt), each (8, 128), the
    fast fold's 8 copies of each lane's best slice score. words:
    (NB * W * SPB, 128) int32; table: (1, 128) int32."""
    _check(words, table, variant, W, SPB, S)
    decode = DECODES[variant]
    if VARIANTS[variant]:
        scores = int_scores(words, lambda t: decode(t, table), W=W, S=S)
    else:
        scores = float_scores(words, lambda t: decode(t, table).to(
            torch.float32), W=W, S=S)
    return fold_plain(scores, "fast")


def h16_lab_device(words, table, *, variant: str, W: int = 16,
                   SPB: int = 32, S: int = CHUNK, blocks=None,
                   unmerged: bool = False):
    """The lab kernel (csrc/lab_h16.cu) on a CUDA tensor, merged per
    lane: (tv, tt) as ``h16_lab_plain``, which a CPU tensor runs.
    ``blocks`` and ``unmerged`` as for kernel_lab's wrapper."""
    nb = _check(words, table, variant, W, SPB, S)
    if words.device.type == "cpu":
        return one_buffer(h16_lab_plain(words, table, variant=variant, W=W,
                                        SPB=SPB, S=S), unmerged)
    out = run_kernel("lab_h16", words, nb, words.data_ptr(),
                     table.data_ptr(), nb, W, SPB,
                     list(VARIANTS).index(variant), blocks=blocks)
    h16_lab_device.launches += 1
    return finish(*out, unmerged)


h16_lab_device.launches = 0


def main(argv=None):
    names, dev = parse_args(argv, list(VARIANTS), list(VARIANTS), __doc__)
    W, SPB = env_int("LAB_W", 16), env_int("LAB_SPB", 32)
    nb = env_int("LAB_NB", DEFAULT_NB)
    words, table = (torch.from_numpy(a).to(dev)
                    for a in h16_lab_data(nb, W * SPB))
    def call(name, unmerged=False):
        return h16_lab_device(words, table, variant=name, W=W, SPB=SPB,
                              unmerged=unmerged)

    return drive("h16_lab", names, words, nb, 2, call,
                 lambda name: call(name, unmerged=True))


if __name__ == "__main__":
    main()
