"""What the port's measurement labs share: their data, the skeleton of
their plain versions, the launch of their kernels, and their timing.

The four fold labs (``kernel_lab``, ``fused_lab``, ``h16_lab``,
``fold_lab``; ``batch_lab`` with a buffer per query) run one bucket of
uniform width: NB blocks of SPB slices of W rows x 128
lanes of int32 words, slice j of block i on rows (i * SPB + j) * W ..,
its tag t = i * SPB + j. A lane sums its W words of a slice as W // 8
chunks of 8 rows into a score and folds the score into a buffer of
LANE_K = 8 (value, tag) pairs per lane, as the JAX labs' kernels do
(experiments/kernel_lab.py:219-275 and the others).

Data. ``kernel_lab_data``, ``h16_words``/``h16_table`` and
``fused_lab_data`` give the bits the JAX labs make from
``numpy.random.default_rng`` (kernel_lab.py:310-326, h16_lab.py:215-230
and fold_lab.py:157-170, fused_lab.py:130-137). Every integer field
those labs draw has a power-of-two range, and numpy's bounded integers
then take exactly one 32-bit draw per value (Lemire's method never
rejects), the top bits of it; the draws are the bit generator's 64-bit
outputs, low half first. So the words are built from ``random_raw``
here, which takes a second for the 1 GiB a lab uses on the card where
``integers`` takes tens; tests/test_torch_labs.py holds the two equal.
``batch_lab_data``, ``dma_lab_data``, ``i16_probe_data`` and
``mxu_lab_data`` do the same for batch_lab.py:241-254 and :298-301,
dma_lab.py:88-92, i16_probe.py:119-125 and mxu_gather_lab.py:101-106
(numpy's 16-bit integers take the two halves of one 32-bit draw, low half
first; dma_lab's range 2**31 - 1 rejects a draw whose Lemire remainder is
below 2, about one draw in 2**31; tests/test_torch_labs2.py holds them
equal).

Plain versions. The scores are summed in the kernels' order: each of a
chunk's 8 rows in two accumulators by chunk parity, the two added, then
the 8 rows as a halving tree ((r0 + r4) + (r2 + r6)) + ((r1 + r5) +
(r3 + r7)), the order XLA's CPU backend mostly takes for the JAX labs'
``jnp.sum(accs[0] + accs[1], axis=0)``; integer sums in int32. The TPU
flushes float denormals to zero, and so do the float labs' kernels
(built with ``-ftz=true``): ``ftz`` does it in the plain versions.

On the card each kernel writes one buffer per CUDA block; the lab's fold
keeps values that do not depend on the order of the slices (the exact
fold keeps the top LANE_K, the fast fold LANE_K copies of the maximum,
top1g4 the top LANE_K of the group maxima), so one per-lane
``torch.topk`` (ops/kernel.py::merge_lane_topk) merges the buffers into
the values of the TPU's sequential fold; only the tags of tied values
may differ.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

import numpy as np
import torch

from ..config import LANES
from ..ops.kernel import _device_info, _launch, merge_lane_topk
from ..ops.streamprobe import stream_words_device
from ..utils.profiling import HOLD_CYCLES

LANE_K = 8           # the labs' per-lane buffer depth
CHUNK = 8            # rows of an (8, 128) chunk (LAB_S)
GROUP = 4            # slices per group of kernel_lab's top1g4 fold
NEG_INF = float("-inf")
FLT_MIN = 2.0 ** -126
# The labs' block count on the card: 4096 blocks of 512 rows are
# 1,073,741,824 bytes of words, 21x the H100's 50 MB L2, so repeated
# launches read device memory (the JAX labs' 256 blocks, 67 MB, would
# partly stay in L2)
DEFAULT_NB = 4096
BLOCKS_PER_SM = 8    # CUDA blocks per SM of the lab kernels (128 threads)
_STEP_WORDS = 1 << 24


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


# ------------------------------------------------------------------ data

def _draws(bg, n: int) -> np.ndarray:
    """The next ``n`` (even) 32-bit draws of bit generator ``bg`` in the
    order numpy's bounded integers consume them."""
    return bg.random_raw(n // 2).view(np.uint32)


def kernel_lab_data(nb: int, block_sub: int, seed: int = 0):
    """(words (nb * block_sub, 128) int32, f32 table (8, 128), int32
    table (8, 128)) as kernel_lab.py:310-326 makes them: column bits
    [16:26) (0..1023), value bits [0:16), a random sign bit 31."""
    rng = np.random.default_rng(seed)
    bg = rng.bit_generator
    n = nb * block_sub * LANES
    bg.advance(n // 2)            # the first `words` draw, overwritten there
    w = _draws(bg, n)
    w >>= 22                      # cols = integers(0, 1024)
    w <<= 16
    w |= _draws(bg, n) >> 16      # vals = integers(0, 2**16)
    w |= _draws(bg, n) & np.uint32(0x80000000)   # integers(0, 2) << 31
    table = rng.standard_normal((8, LANES)).astype(np.float32)
    table_i = rng.integers(-2**31, 2**31 - 1, size=(8, LANES),
                           dtype=np.int64).astype(np.int32)
    return w.view(np.int32).reshape(-1, LANES), table, table_i


def h16_words(rng, n_sub: int) -> np.ndarray:
    """(n_sub, 128) int32 h16 words of h16_lab.py:215-221 (and
    fold_lab.py:157-162): two 16-bit halves of col[0:10) | val6[10:16),
    col = integers(0, 1024), val = integers(-32, 32), each (n_sub, 128,
    2), drawn from ``rng`` in that order."""
    bg = rng.bit_generator
    n = n_sub * LANES * 2
    half = _draws(bg, n) >> 22                        # col
    v = _draws(bg, n) >> 26                           # val + 32
    v ^= 32                                           # val & 0x3F
    half |= v << 10
    half = half.reshape(n_sub, LANES, 2)
    w = half[..., 0] | (half[..., 1] << 16)
    return w.view(np.int32)


def h16_table(rng):
    """The int4x8 query table of h16_lab.py:224-230 (fold_lab.py:165-170):
    ((1, 128) int32, q (8, 128)), nibble g of lane l holding q[g, l]."""
    q = rng.integers(-8, 8, size=(8, LANES), dtype=np.int64)
    tab = np.zeros((1, LANES), np.uint64)
    for g in range(8):
        tab[0] |= ((q[g] & 0xF).astype(np.uint64)) << (4 * g)
    return tab.astype(np.uint32).view(np.int32), q


def h16_lab_data(nb: int, block_sub: int, seed: int = 0):
    """(words, table) of h16_lab.py:281-284 and fold_lab.py:193-196 (the
    same bits: both draw their words, then their table, from
    default_rng(0))."""
    rng = np.random.default_rng(seed)
    words = h16_words(rng, nb * block_sub)
    return words, h16_table(rng)[0]


def fused_lab_data(nb: int, block_sub: int, slices_per_block: int,
                   nseg: int, seed: int = 0):
    """(words, int32 table (2, 128), nreal (nseg, 1)) of
    fused_lab.py:130-137: column bits [16:26), value bits [0:16), every
    segment's real count nb * slices_per_block."""
    rng = np.random.default_rng(seed)
    bg = rng.bit_generator
    n = nb * block_sub * LANES
    w = _draws(bg, n)
    w >>= 22
    w <<= 16
    w |= _draws(bg, n) >> 16
    table = rng.integers(-2**31, 2**31 - 1, size=(2, LANES),
                         dtype=np.int64).astype(np.int32)
    nreal = np.full((nseg, 1), nb * slices_per_block, np.int32)
    return w.view(np.int32).reshape(-1, LANES), table, nreal


def batch_lab_data(nb: int, block_sub: int, queries: int, seed: int = 0):
    """(words (nb * block_sub, 128) int32, tables (queries, 128) int32) of
    batch_lab.py:298-301: h16 words (``h16_words``), then ``queries``
    int4x8 rows (``_mk_tables``, :249-254), from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    words = h16_words(rng, nb * block_sub)
    # one (queries, 8, 128) draw is ``queries`` draws of (8, 128)
    return words, np.concatenate([h16_table(rng)[0]
                                  for _ in range(queries)])


def dma_lab_data(total_sub: int, seed: int = 0):
    """(words (total_sub, 128) int32, table (1, 128) f32 ones) of
    dma_lab.py:88-92: integers(0, 2**31 - 1) as int64, cast to int32."""
    bg = np.random.default_rng(seed).bit_generator
    n = total_sub * LANES
    excl = np.uint64(2**31 - 1)
    out, got = [], 0
    while got < n:                 # Lemire on 32-bit draws: a draw whose
        m = _draws(bg, min(n - got + 64, _STEP_WORDS) & ~1).astype(
            np.uint64) * excl      # remainder is below 2 is drawn again
        m = m[(m & np.uint64(0xFFFFFFFF)) >= 2] >> np.uint64(32)
        out.append(m[:n - got].astype(np.int32))
        got += out[-1].size
    return (np.concatenate(out).reshape(total_sub, LANES),
            np.ones((1, LANES), np.float32))


def i16_probe_data(nb: int, sub32: int, seed: int = 0):
    """(w32 (nb * sub32, 128) int32, w16 (2 * nb * sub32, 128) int16,
    t32 (8, 128) int32, t16 (16, 128) int16) of i16_probe.py:119-125."""
    rng = np.random.default_rng(seed)
    bg = rng.bit_generator
    n = nb * sub32 * LANES
    w32 = (_draws(bg, n) >> 12).view(np.int32).reshape(-1, LANES)
    w16 = (_draws(bg, n).view(np.uint16) >> 2).view(np.int16).reshape(
        -1, LANES)
    t32 = rng.integers(-8, 8, size=(8, LANES), dtype=np.int32)
    t16 = rng.integers(-8, 8, size=(16, LANES), dtype=np.int16)
    return w32, w16, t32, t16


def mxu_lab_data(reps: int, queries: int, columns: int = 1024,
                 seed: int = 0):
    """(words (reps * 8, 128) int32, tables (queries, 128) int32, tabq
    (columns, queries) f32) of mxu_gather_lab.py:101-106."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**31 - 1, (reps * CHUNK, LANES),
                         dtype=np.int64).astype(np.int32)
    tab = rng.integers(-(2**31), 2**31 - 1, (queries, LANES),
                       dtype=np.int64).astype(np.int32)
    tabq = rng.standard_normal((columns, queries)).astype(np.float32)
    return words, tab, tabq


CHECK_KINDS = ("integer", "real", "tiny")


def with_values(kind: str, words: np.ndarray, table_i: np.ndarray,
                table=None, seed: int = 0):
    """Check data for the float labs (kernel_lab, fused_lab): (words,
    int32 table, f32 table) with the lab's words' value bits [0:16)
    replaced; their gather fields, row bits and shift amounts stay the
    lab's. The lab's own values are random bf16 bits, so a lane's best
    scores are +inf and h16's and i8s_int's products NaN, which hides
    most of what a body computes:

      integer  small integers' bf16 (-8..8), an f32 table of small
               integers: every product and sum exact;
      real     normal values' bf16 (N(0, 1)), the f32 table as given;
      tiny     positive values near the smallest normal (2**-126 |N(0,
               1)|: bf16 denormals, and normals whose products fall below
               it), bits 7, 15, 23 and 31 clear and every int table byte
               0x08..0x0F, so that h16's and i8s_int's int32 products are
               non-negative (their bits denormals, flushed to 0, not NaN)
               and i8s's factors small: the flush decides the scores."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        vals = rng.integers(-8, 9, words.shape).astype(np.float32)
        if table is not None:
            table = rng.integers(-4, 5, table.shape).astype(np.float32)
    elif kind == "real":
        vals = rng.standard_normal(words.shape).astype(np.float32)
    elif kind == "tiny":
        vals = (np.abs(rng.standard_normal(words.shape)) * 2.0 ** -126
                ).astype(np.float32)
        table_i = (table_i & 0x0F0F0F0F) | 0x08080808
    else:
        raise ValueError(f"unknown kind {kind!r}")
    w = (words.view(np.uint32) & np.uint32(0xFFFF0000)) | (
        vals.view(np.uint32) >> 16)
    if kind == "tiny":
        w &= np.uint32(~0x80808080 & 0xFFFFFFFF)
    return w.view(np.int32), table_i, table


# --------------------------------------------------------- plain versions

def ftz(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 denormals flushed to zero of the same sign (the
    TPU's arithmetic, and the lab kernels' under ``-ftz=true``)."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def lsr(w: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 ``w`` by a constant 0 < k < 32."""
    return (w >> k) & ((1 << (32 - k)) - 1)


def bf16(w: torch.Tensor) -> torch.Tensor:
    """The bf16 value in bits [0:16) of each word as float32, flushed."""
    return ftz((w << 16).view(torch.float32))


def _tiles(words, W: int, S: int):
    """Yield the words as (m, W // S, S, 128) tiles of m slices, at most
    ~16M words at a time (a slice's last W % S rows are not read)."""
    n = words.shape[0] // W
    chunks = W // S
    per = max(1, _STEP_WORDS // (W * LANES))
    for s0 in range(0, n, per):
        m = min(per, n - s0)
        yield words[s0 * W:(s0 + m) * W].reshape(m, W, LANES)[
            :, :chunks * S].reshape(m, chunks, S, LANES)


def float_scores(words, prod, *, W: int, S: int = CHUNK,
                 flush: bool = False) -> torch.Tensor:
    """(n * W, 128) words -> (n, 128) float32 slice scores: ``prod`` of
    the (m, W // S, S, 128) tiles (float32 per word), summed in the lab
    kernels' order (module docstring), each add rounded (and flushed with
    ``flush``). S is a power of two."""
    add = (lambda a, b: ftz(a + b)) if flush else torch.add
    out = [torch.zeros((0, LANES), dtype=torch.float32, device=words.device)]
    for tiles in _tiles(words, W, S):
        p = prod(tiles)
        acc = [torch.zeros_like(p[:, 0]) for _ in range(2)]
        for u in range(p.shape[1]):
            acc[u % 2] = add(acc[u % 2], p[:, u])
        x = add(acc[0], acc[1])
        while x.shape[1] > 1:                 # the halving tree over S rows
            h = x.shape[1] // 2
            x = add(x[:, :h], x[:, h:])
        out.append(x[:, 0])
    return torch.cat(out)


def int_scores(words, prod, *, W: int, S: int = CHUNK) -> torch.Tensor:
    """(n, 128) float32 slice scores: the int32 sum (wrapping) of
    ``prod`` (int32 per word) over a slice's W // S chunks, converted
    once."""
    out = [torch.zeros((0, LANES), dtype=torch.float32, device=words.device)]
    for tiles in _tiles(words, W, S):
        s = prod(tiles).sum(dim=(1, 2), dtype=torch.int64) & 0xFFFFFFFF
        out.append(torch.where(s >= 2**31, s - 2**32, s).to(torch.float32))
    return torch.cat(out)


def fold_plain(scores: torch.Tensor, fold: str, lane_k: int = LANE_K):
    """The per-lane buffers a lab's sequential fold leaves after slices
    0 .. n-1 of (n, 128) ``scores`` (slice t's tag t): (tv, tt), each
    (lane_k, 128), values sorted descending.

    ``exact`` (first minimum slot replaced when score >= minimum) keeps
    the top lane_k of the scores and lane_k initial -inf (tag 0); ``fast``
    (every minimum slot replaced) keeps lane_k copies of the maximum, each
    tagged with the last slice holding it; ``top1g4`` folds, exactly, the
    strict maximum of each group of GROUP slices (the first among ties; a
    group whose first score is NaN has maximum NaN). A NaN score never
    enters: score >= minimum is false."""
    dev = scores.device
    n = scores.shape[0]
    tags = torch.arange(n, dtype=torch.int32, device=dev).view(-1, 1).expand(
        n, LANES)
    if fold == "top1g4":
        g = scores.reshape(-1, GROUP, LANES)
        gt = tags.reshape(-1, GROUP, LANES)
        scores, tags = g[:, 0], gt[:, 0]
        for jj in range(1, GROUP):
            take = g[:, jj] > scores
            scores = torch.where(take, g[:, jj], scores)
            tags = torch.where(take, gt[:, jj], tags)
        fold = "exact"
    live = torch.where(torch.isnan(scores), NEG_INF, scores)
    if fold == "fast":
        top = torch.cat([live, live.new_full((1, LANES), NEG_INF)]).amax(0)
        last = torch.where(scores == top, tags, -1).amax(0, keepdim=True) \
            if n else torch.full((1, LANES), -1, dtype=torch.int32,
                                 device=dev)
        tag = torch.where(last >= 0, last, 0).to(torch.int32)
        return (top.expand(lane_k, LANES).contiguous(),
                tag.expand(lane_k, LANES).contiguous())
    if fold != "exact":
        raise ValueError(f"unknown fold {fold!r}")
    v = torch.cat([live, live.new_full((lane_k, LANES), NEG_INF)])
    t = torch.cat([tags, tags.new_zeros((lane_k, LANES))])
    tv, idx = torch.topk(v, lane_k, dim=0)
    return tv, torch.gather(t, 0, idx)


def wrap_int(x: torch.Tensor, dtype) -> torch.Tensor:
    """int64 ``x`` reduced to the two's complement of int32 or int16
    ``dtype`` (what sums in that type wrap to)."""
    bits = torch.iinfo(dtype).bits
    x = x & ((1 << bits) - 1)
    return torch.where(x >= 1 << (bits - 1), x - (1 << bits), x).to(dtype)


def fast_fold_seq(values: torch.Tensor, tags: torch.Tensor):
    """The fast fold (every minimum slot replaced when score >= minimum,
    from LANE_K slots of -inf) of (P, ...) ``values`` with their ``tags``
    in fold order: its LANE_K slots stay equal, each the maximum, tagged
    with the last candidate holding it (tag 0 where there is none).
    Returns (value, tag), each (...); values are not NaN."""
    top = torch.cat([values, values.new_full((1, *values.shape[1:]),
                                             NEG_INF)]).amax(0)
    pos = torch.arange(values.shape[0], device=values.device).view(
        -1, *([1] * (values.dim() - 1)))
    last = torch.where(values == top, pos, -1).amax(0)
    tag = torch.gather(tags, 0, last.clamp(min=0)[None])[0]
    return top, torch.where(last >= 0, tag, 0).to(torch.int32)


def merge_fast(out_v, out_t):
    """Per-CUDA-block fast-fold buffers (nblk, ..., 128) merged as the
    sequential fold leaves them: each slot the maximum over the blocks,
    tagged with the largest tag holding it (a CUDA block folds its lab
    blocks in order, and a later lab block's tags are larger)."""
    top = out_v.amax(0)
    return top, torch.where(out_v == top, out_t, -1).amax(0)


def as_words32(words: torch.Tensor) -> torch.Tensor:
    """The same bytes as (rows, 128) int32 words (K3's input)."""
    return words.contiguous().view(torch.int32).reshape(-1, LANES)


# ---------------------------------------------------------------- kernels

def check_words(words: torch.Tensor, block_rows: int) -> int:
    """Raise unless ``words`` is a contiguous (NB * block_rows, 128) int32
    tensor with NB >= 1; returns NB."""
    if words.ndim != 2 or words.shape[1] != LANES or \
            words.dtype != torch.int32 or not words.is_contiguous() or \
            words.shape[0] < block_rows or words.shape[0] % block_rows:
        raise ValueError(f"words must be contiguous int32 (NB * "
                         f"{block_rows}, {LANES}), got {words.dtype} "
                         f"{tuple(words.shape)}")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"words on {words.device}")
    return words.shape[0] // block_rows


def check_table(table: torch.Tensor, rows: int, dtype, dev) -> None:
    if table.device != dev or table.dtype != dtype or \
            tuple(table.shape) != (rows, LANES) or not table.is_contiguous():
        raise ValueError(f"table: need contiguous {dtype} ({rows}, {LANES}) "
                         f"on {dev}, got {table.dtype} {tuple(table.shape)} "
                         f"on {table.device}")


def cuda_blocks(dev, nb: int, blocks=None) -> int:
    """A lab kernel's CUDA block count: ``blocks``, or BLOCKS_PER_SM a
    multiprocessor (the SM count read once per device), at most ``nb``
    (its grid-stride units)."""
    if blocks is None:
        blocks = min(nb, _device_info(dev)[0] * BLOCKS_PER_SM)
    return max(1, int(blocks))


def check_tables(tables: torch.Tensor, dev) -> int:
    """Raise unless ``tables`` is a contiguous int32 (Q, 128) tensor on
    ``dev`` with Q >= 1 (a query's int4x8 row each); returns Q."""
    if tables.device != dev or tables.dtype != torch.int32 or \
            tables.ndim != 2 or tables.shape[1] != LANES or \
            tables.shape[0] < 1 or not tables.is_contiguous():
        raise ValueError(f"tables: need contiguous int32 (Q, {LANES}) on "
                         f"{dev}, got {tables.dtype} {tuple(tables.shape)} "
                         f"on {tables.device}")
    return tables.shape[0]


def run_kernel(entry: str, words: torch.Tensor, nb: int, *args,
               blocks=None):
    """Launch lab kernel ``entry`` of the kernel library: C arguments
    ``args``, then the CUDA block count and the (blocks, LANE_K, 128)
    buffers it writes, one per CUDA block (grid-striding over the NB lab
    blocks). ``blocks``: the CUDA block count (default BLOCKS_PER_SM a
    multiprocessor, at most NB; fewer make each CUDA block fold more lab
    blocks). Returns the buffers (values, tags)."""
    dev = words.device
    nblk = cuda_blocks(dev, nb, blocks)
    out_v = torch.empty((nblk, LANE_K, LANES), dtype=torch.float32,
                        device=dev)
    out_t = torch.empty((nblk, LANE_K, LANES), dtype=torch.int32, device=dev)
    _launch(dev, entry, *args, nblk, out_v.data_ptr(), out_t.data_ptr())
    return out_v, out_t


def merge(out_v, out_t):
    """The per-CUDA-block buffers merged per lane: (LANE_K, 128) each."""
    return merge_lane_topk(out_v, out_t, LANE_K)


def finish(out_v, out_t, unmerged: bool):
    """A lab wrapper's result from its kernel's per-CUDA-block buffers:
    merged per lane, or with ``unmerged`` the buffers as they are (the
    kernel alone, for timing it without the merge)."""
    return (out_v, out_t) if unmerged else merge(out_v, out_t)


def one_buffer(result, unmerged: bool):
    """A plain version's (LANE_K, 128) pair as a wrapper returns it on the
    CPU: with ``unmerged``, as the single buffer (1, LANE_K, 128)."""
    return tuple(x[None] for x in result) if unmerged else result


# ----------------------------------------------------------------- timing

def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Milliseconds per fn() over ``reps`` back-to-back calls between two
    CUDA events, the card first sleeping (HOLD_CYCLES) while the host
    enqueues the calls: a call whose host work outlasts its kernel is
    timed by the card, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sweep_ms(fn, runs: int = 5, reps: int = 10) -> float:
    """The median of ``runs`` runs of ``cuda_ms(fn, reps)``."""
    return statistics.median(cuda_ms(fn, reps, warmup=int(r == 0))
                             for r in range(runs))


def stream_ms(words: torch.Tensor, **kw) -> float:
    """K3 (ops/streamprobe.py::stream_words_device) on the same words."""
    salt = torch.arange(LANES, dtype=torch.int32,
                        device=words.device).reshape(1, LANES) * 7919
    return sweep_ms(lambda: stream_words_device(words, salt), **kw)


def variant_dir(out_dir: str, sources, parts) -> str:
    """Write an ablation variant's copies of ``sources`` (file names in
    the package's csrc/) into ``out_dir``, each (old, new) of ``parts``
    replaced in the one source that holds ``old``; return ``out_dir``.
    A unit built there with ``-I out_dir -I csrc`` includes the copies
    (a source's own directory comes first) and csrc's other headers."""
    from ..ops import _build

    os.makedirs(out_dir, exist_ok=True)
    texts = {name: open(os.path.join(_build.CSRC_DIR, name)).read()
             for name in sources}
    for old, new in parts:
        holders = [name for name, text in texts.items() if old in text]
        if len(holders) != 1:
            raise RuntimeError(f"{len(holders)} of {list(sources)} hold "
                               f"{old!r}: the kernel's source changed")
        texts[holders[0]] = texts[holders[0]].replace(old, new)
    for name, text in texts.items():
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(text)
    return out_dir


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def report(lab: str, variant: str, *, nb: int, words: torch.Tensor,
           nnz_per_word: int, ms, k3_ms, merged_ms=None, queries=None,
           **extra) -> dict:
    """One report line: the sweep's ms (CUDA events; None where not
    measured, on the CPU) and its wrapper's with the per-lane merge
    (``merged_ms``), ns per 4 KiB chunk (an (8, 128) int32 chunk),
    Gnnz/s (nnz: elements times ``nnz_per_word``), GB/s of words, K3's
    ms and GB/s on the same words and the sweep's share of K3's; with
    ``queries``, ns per chunk per query and Gnnz/s per query (each
    query's nnz counted)."""
    nbytes = words.numel() * words.element_size()
    chunks = nbytes // (CHUNK * LANES * 4)
    nnz = words.numel() * nnz_per_word
    line = dict(lab=lab, variant=variant, nb=nb, words_bytes=nbytes, ms=ms,
                merged_ms=merged_ms, ns_per_chunk=None, gnnz_per_s=None,
                gb_per_s=None, k3_ms=k3_ms, k3_gb_per_s=None,
                share_of_k3=None)
    if queries:
        line.update(queries=queries, ns_per_chunk_per_query=None,
                    gnnz_per_s_per_query=None)
    if ms:
        line.update(ns_per_chunk=ms * 1e6 / chunks,
                    gnnz_per_s=nnz / ms / 1e6, gb_per_s=nbytes / ms / 1e6)
        if queries:
            line.update(ns_per_chunk_per_query=ms * 1e6 / chunks / queries,
                        gnnz_per_s_per_query=nnz * queries / ms / 1e6)
    if k3_ms:
        line["k3_gb_per_s"] = nbytes / k3_ms / 1e6
    if ms and k3_ms:
        line["share_of_k3"] = k3_ms / ms
    line.update(extra)
    return line


def parse_args(argv, variants, default, doc: str):
    """(variant names, torch.device) from a lab's command line: variant
    names (``default`` when none), ``--device cuda`` (the default; raises
    without a card) or ``--device cpu`` (the plain versions, untimed)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(variants)}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    bad = [v for v in args.variants if v not in variants]
    if bad:
        ap.error(f"unknown variants {bad}: choose from {', '.join(variants)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False); --device cpu runs the plain versions")
    dev = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    return args.variants or list(default), dev


def measure(lab: str, variant: str, words: torch.Tensor, nb: int,
            nnz_per_word: int, call, kernel=None, *, k3_ms,
            queries=None) -> dict:
    """The report line of one variant timed on the card (``sweep_ms``,
    the stream held while the host enqueues: device time) beside K3's
    ``k3_ms`` on the same words: ``ms`` the kernel alone (``kernel()``, its
    launch without the merge; where None, ``call()``), ``merged_ms`` the
    wrapper with its per-lane merge (``call()``)."""
    merged = sweep_ms(call)
    ms = sweep_ms(kernel) if kernel is not None else merged
    return report(lab, variant, nb=nb, words=words, nnz_per_word=nnz_per_word,
                  ms=ms, merged_ms=merged, k3_ms=k3_ms, queries=queries,
                  device=torch.cuda.get_device_name(words.device))


def drive(lab: str, names, words, nb: int, nnz_per_word: int,
          call, kernel, queries=None) -> list:
    """Run each variant ``call(name)``; on the card time it and its kernel
    alone, ``kernel(name)`` (``measure``; None where the call is one
    launch with its merge in it), beside K3 on the same words.
    ``words``: the words, or name -> the variant's words (K3 on each
    variant's own bytes). Print and return one report line per variant,
    with its largest finite result (on the CPU: untimed)."""
    of = words if isinstance(words, dict) else dict.fromkeys(names, words)
    cuda = next(iter(of.values())).device.type == "cuda"
    if cuda:
        print(smi_line(), flush=True)
    k3 = {}
    lines = []
    for name in names:
        w = of[name]
        if cuda:
            if w.data_ptr() not in k3:
                k3[w.data_ptr()] = stream_ms(as_words32(w))
            line = measure(lab, name, w, nb, nnz_per_word,
                           lambda: call(name),
                           None if kernel is None else lambda: kernel(name),
                           k3_ms=k3[w.data_ptr()], queries=queries)
        else:
            line = report(lab, name, nb=nb, words=w,
                          nnz_per_word=nnz_per_word, ms=None, k3_ms=None,
                          queries=queries, device="cpu")
        out = call(name)
        tv = (out[0] if isinstance(out, tuple) else out).float()
        best = tv[torch.isfinite(tv)]
        line["max_kept"] = float(best.max()) if best.numel() else None
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines
