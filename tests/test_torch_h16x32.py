"""The packed h16 decode of K6 h16 (``csrc/codecs.cuh::H16x32``),
emulated in NumPy instruction by instruction, against the plain int32
products of ``ops/kernel.py::prod_h16``.

The kernel reads each word once for 32 queries: a 16-byte table entry per
column holds the 32 queries' nibbles biased by 8; one PRMT sign-extends
the bytes that hold the word's two 6-bit values, an AND clears their
column bits (a signed 16-bit pair of 4 v); per 8 queries two PRMTs put
the byte pairs of two columns side by side, ANDs keep the low or the high
nibbles, and dp2a (signed 16-bit pair times unsigned byte pair, plus the
accumulator, modulo 2^32) adds the products; ``finish`` takes the bias and
the factors back out. The emulation follows those steps on the same bits,
so exactness here is the kernel's arithmetic being exact: every sum equal
to the plain int32 sum, on random words and at the extremes (every value
-32 against nibbles -8 and 7, over a whole span of 32,768 words and over
two spans added modulo 2^32).
"""

import numpy as np
import pytest
import torch

from spmv_topk_tpu_torch.ops.kernel import prod_h16

QUERIES = 32
SPAN = 32768   # csrc/octet_topk_batch_h16.cu::kSpan
M32 = 1 << 32


def _wrap(x):
    """int64 -> the int32 of its low 32 bits."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % M32 - (1 << 31))


def _bytes(x):
    x = np.asarray(x, np.uint64)
    return [(x >> (8 * i)) & 0xFF for i in range(4)]


def prmt(a, b, sel):
    """PTX prmt.b32 (default mode): result byte i is byte sel[i] & 7 of
    (b:a), or its sign replicated where sel[i] & 8."""
    src = _bytes(a) + _bytes(b)
    out = np.zeros(np.broadcast(np.asarray(a), np.asarray(b)).shape,
                   np.uint64)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        byte = src[nib & 7]
        if nib & 8:
            byte = np.where(byte & 0x80, 0xFF, 0).astype(np.uint64)
        out |= byte << np.uint64(8 * i)
    return out


def dp2a(a, b, c, hi):
    """dp2a.lo/hi.s32.u32: c + a.lo16 * b.byte0 + a.hi16 * b.byte1 (bytes
    2 and 3 for hi), a's halves signed, b's bytes unsigned, mod 2^32."""
    a = np.asarray(a, np.uint64)
    a0 = ((a & 0xFFFF).astype(np.int64) ^ 0x8000) - 0x8000
    a1 = (((a >> 16) & 0xFFFF).astype(np.int64) ^ 0x8000) - 0x8000
    bb = _bytes(b)
    b0, b1 = (bb[2], bb[3]) if hi else (bb[0], bb[1])
    return _wrap(np.asarray(c, np.int64) + a0 * b0.astype(np.int64)
                 + a1 * b1.astype(np.int64))


def repack(tables):
    """(32, 128) int32 int4x8 tables -> (1024, 4) uint32 entries: word r
    of column c holds query 8r + j's nibble ^ 8 at bits [4j, 4j + 4)."""
    t = tables.astype(np.int64) & 0xFFFFFFFF
    tab = np.zeros((1024, 4), np.uint64)
    for c in range(1024):
        n, lane = divmod(c, 128)
        for r in range(4):
            e = 0
            for j in range(8):
                e |= ((int(t[8 * r + j, lane]) >> (4 * n) & 0xF) ^ 8) << (4 * j)
            tab[c, r] = e
    return tab


def packed_sums(words, tab):
    """The kernel's 32 sums of ``words`` (one member's words, in order):
    spans of SPAN words in packed accumulators, each finished and added
    modulo 2^32."""
    total = np.zeros(QUERIES, np.int64)
    for j0 in range(0, max(len(words), 1), SPAN):
        u = np.asarray(words[j0:j0 + SPAN], np.uint64)
        a = prmt(u, 0, 0xB391) & 0xFFFCFFFC
        vs = int(_wrap(dp2a(a, 0x0101, 0, False).sum()))
        g0, g1 = tab[u & 0x3FF], tab[(u >> 16) & 0x3FF]
        for r in range(4):
            for h in range(2):
                p = prmt(g0[:, r], g1[:, r], 0x7362 if h else 0x5140)
                for k, (mask, half) in enumerate([(0x0F0F0F0F, False),
                                                  (0xF0F0F0F0, False),
                                                  (0x0F0F0F0F, True),
                                                  (0xF0F0F0F0, True)]):
                    q = 8 * r + 4 * h + k
                    acc = int(_wrap(dp2a(a, p & mask, 0, half).sum()))
                    sh, bias = (6, 128) if q % 2 else (2, 8)
                    span = _wrap(acc - bias * vs) >> sh
                    total[q] = _wrap(total[q] + span)
    return total


def plain_sums(words, tables):
    w = torch.from_numpy(np.asarray(words, np.uint32).view(np.int32))
    return np.array([int(prod_h16(w, torch.from_numpy(tables[q]))
                         .to(torch.int64).sum()) for q in range(QUERIES)])


def _words(rng, n, vals=None):
    """n h16 words: two halves col[0:10) | val6[10:16); random values with
    a tenth of the halves zero (padding), or every value ``vals``."""
    cols = rng.integers(0, 1024, (n, 2))
    v = rng.integers(-32, 32, (n, 2)) if vals is None else np.full((n, 2),
                                                                   vals)
    half = (cols | ((v & 0x3F) << 10)).astype(np.uint32)
    if vals is None:
        half[rng.random((n, 2)) < 0.1] = 0
    return half[:, 0] | (half[:, 1] << 16)


def _tables(rng, nibble=None):
    nib = (rng.integers(-8, 8, (QUERIES, 128, 8)) if nibble is None
           else np.full((QUERIES, 128, 8), nibble))
    words = ((nib & 0xF).astype(np.uint64)
             << (4 * np.arange(8, dtype=np.uint64))).sum(-1)
    return words.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_decode_matches_plain_on_random_words(seed):
    rng = np.random.default_rng(seed)
    tables = _tables(rng)
    words = _words(rng, 3000)
    np.testing.assert_array_equal(packed_sums(words, repack(tables)),
                                  plain_sums(words, tables))


@pytest.mark.parametrize("nibble", [-8, 7])
@pytest.mark.parametrize("n", [1, SPAN, SPAN + 7000])
def test_packed_decode_exact_at_extremes(nibble, n):
    """Every value -32, every nibble -8 (the largest product, 256) or 7
    (the largest biased operands): a word, a whole span, two spans."""
    rng = np.random.default_rng(5)
    tables = _tables(rng, nibble)
    words = _words(rng, n, vals=-32)
    got = packed_sums(words, repack(tables))
    np.testing.assert_array_equal(got, plain_sums(words, tables))
    np.testing.assert_array_equal(got, np.full(QUERIES, 2 * n * -32 * nibble))
