"""DMA lab (L2) on the H100: whether the block size moves a plain sweep's
rate (experiments/dma_lab.py), each (BS, T) case timed beside the stream
probe K3 on the same words.

The sum over every word of bf16(its low half) + table[lane], into one
(8, 128) f32 sum: the words are NB = TOTAL_SUB / BS lab blocks of BS rows,
each walked in T sub-steps of BS / T rows; within a sub-step, row r of
chunk u adds into accumulator u % 2 of sublane r (both from 0), and the
sub-step ends with sum = (sum + acc0) + acc1 (dma_lab.py:41-64). f32
adds, float denormals flushed to zero (the TPU's and the kernel's
arithmetic). On the TPU the lab asks whether larger VMEM blocks beat the
stream ceiling; on this card a lab block is the work of one CUDA block's
grid-stride step (csrc/lab_dma.cu says what that mapping measures).

Order. The kernel's CUDA blocks each sum their lab blocks (lab block i in
CUDA block i % blocks, in order) from 0, and the partial sums are added
in block order; ``dma_lab_plain(..., blocks=n)`` repeats that order bit
for bit, and with ``blocks=1`` it is the TPU's order.

TOTAL_SUB (LAB_SUB, 2**21 here: 1 GiB of words, the JAX lab's 2**18
times 8) rows of the lab's words, random 31-bit integers (their low
halves include bf16 infinities and NaN, so every lane's sum is NaN: the
timing runs on them, the checks on ``check_data``'s values).
``dma_lab_device`` launches ``csrc/lab_dma.cu`` on a CUDA tensor and
``dma_lab_plain`` runs on a CPU tensor.

    python -m spmv_topk_tpu_torch.experiments.dma_lab [BS T] [BS T] ...
        [--device cpu]      (env LAB_SUB)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._common import (CHUNK, LANES, bf16, check_table, check_words,
                      cuda_blocks, dma_lab_data, drive, env_int, ftz,
                      _STEP_WORDS)

CASES = ((1024, 1), (2048, 2), (4096, 4), (8192, 8))   # dma_lab.py:100
TOTAL_SUB = 1 << 21


def name(bs: int, t: int) -> str:
    return f"{bs}x{t}"


def _check(words, table, bs, t):
    if t < 1 or bs < CHUNK * t or bs % (CHUNK * t):
        raise ValueError(f"BS={bs}, T={t}: BS must be a multiple of "
                         f"{CHUNK} * T")
    nb = check_words(words, bs)
    check_table(table, 1, torch.float32, words.device)
    return nb


def step_sums(words, table, bs: int, t: int) -> torch.Tensor:
    """(nb * t, 2, 8, 128) f32: each sub-step's two accumulators, in step
    order (lab block, then sub-step)."""
    half = bs // t
    chunks = half // CHUNK
    tab = ftz(table.reshape(1, 1, LANES))
    out = []
    per = max(1, _STEP_WORDS // (half * LANES))
    steps = words.shape[0] // half
    for s0 in range(0, steps, per):
        m = min(per, steps - s0)
        tiles = words[s0 * half:(s0 + m) * half].reshape(m, chunks, CHUNK,
                                                         LANES)
        acc = [torch.zeros((m, CHUNK, LANES), device=words.device)
               for _ in range(2)]
        for u in range(chunks):
            acc[u % 2] = ftz(acc[u % 2] + ftz(bf16(tiles[:, u]) + tab))
        out.append(torch.stack(acc, 1))
    return torch.cat(out)


def dma_lab_plain(words, table, *, bs: int, t: int, blocks: int = 1):
    """Plain PyTorch version: the (8, 128) f32 sum, in the order of a
    kernel on ``blocks`` CUDA blocks (1: the TPU's order). words:
    (NB * BS, 128) int32; table: (1, 128) f32."""
    return reduce_plain(dma_partials_plain(words, table, bs=bs, t=t,
                                           blocks=blocks))


def dma_partials_plain(words, table, *, bs: int, t: int, blocks: int = 1):
    """The kernel's per-CUDA-block partial sums, (blocks, 8, 128) f32:
    block b adds the sub-steps of lab blocks b, b + blocks, ... in order,
    (sum + acc0) + acc1 from 0."""
    nb = _check(words, table, bs, t)
    steps = step_sums(words, table, bs, t).reshape(nb, t, 2, CHUNK, LANES)
    rounds = -(-nb // blocks)
    part = torch.zeros((blocks, CHUNK, LANES), device=words.device)
    for k in range(rounds):
        lo, hi = k * blocks, min(nb, (k + 1) * blocks)
        for j in range(t):
            a = steps[lo:hi, j]
            part[:hi - lo] = ftz(ftz(part[:hi - lo] + a[:, 0]) + a[:, 1])
    return part


def reduce_plain(partials):
    """csrc/lab_dma.cu::lab_dma_reduce: the partials added in block order
    from the first one."""
    out = partials[0].clone()
    for b in range(1, partials.shape[0]):
        out = ftz(out + partials[b])
    return out


def dma_lab_device(words, table, *, bs: int, t: int, blocks=None,
                   unmerged: bool = False):
    """The lab kernel (csrc/lab_dma.cu) on a CUDA tensor: the (8, 128)
    sum, equal bit for bit to ``dma_lab_plain`` with the same ``blocks``
    (default ``_common.cuda_blocks``); a CPU tensor runs the plain version
    (``blocks`` default 1). ``unmerged``: the per-CUDA-block partial sums
    (blocks, 8, 128), the kernel alone."""
    nb = _check(words, table, bs, t)
    if words.device.type == "cpu":
        part = dma_partials_plain(words, table, bs=bs, t=t,
                                  blocks=blocks or 1)
        return part if unmerged else reduce_plain(part)
    from ..ops.kernel import _launch

    nblk = cuda_blocks(words.device, nb, blocks)
    part = torch.empty((nblk, CHUNK, LANES), dtype=torch.float32,
                       device=words.device)
    _launch(words.device, "lab_dma", words.data_ptr(), table.data_ptr(), nb,
            bs, t, nblk, part.data_ptr())
    dma_lab_device.launches += 1
    if unmerged:
        return part
    out = torch.empty((CHUNK, LANES), dtype=torch.float32,
                      device=words.device)
    _launch(words.device, "lab_dma_reduce", part.data_ptr(), nblk,
            out.data_ptr())
    return out


dma_lab_device.launches = 0


def check_data(kind: str, words: np.ndarray, seed: int = 0):
    """(words, table) with sums that can fail a wrong kernel: the words'
    low halves replaced by the bf16 of small integers (``integer``: every
    sum exact, the table small integers too), of N(0, 1) draws (``real``,
    the table N(0, 1)) or of positive values near the smallest normal
    (``tiny``, the table 0: the flush of denormals decides the sums)."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        vals = rng.integers(-8, 9, words.shape).astype(np.float32)
        table = rng.integers(-4, 5, (1, LANES)).astype(np.float32)
    elif kind == "real":
        vals = rng.standard_normal(words.shape).astype(np.float32)
        table = rng.standard_normal((1, LANES)).astype(np.float32)
    elif kind == "tiny":
        vals = (np.abs(rng.standard_normal(words.shape)) * 2.0 ** -126
                ).astype(np.float32)
        table = np.zeros((1, LANES), np.float32)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    w = (words.view(np.uint32) & np.uint32(0xFFFF0000)) | (
        vals.view(np.uint32) >> 16)
    return w.view(np.int32), table


def parse_cases(argv, doc: str):
    """((BS, T) cases, device) from the lab's command line: pairs of
    integers (the lab's four cases when none) and ``--device``."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("pairs", nargs="*", type=int, metavar="BS T")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if len(args.pairs) % 2:
        ap.error("give BS and T in pairs")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False); --device cpu runs the plain versions")
    cases = tuple(zip(args.pairs[::2], args.pairs[1::2])) or CASES
    dev = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    return cases, dev


def main(argv=None):
    cases, dev = parse_cases(argv, __doc__)
    total = env_int("LAB_SUB", TOTAL_SUB)
    words, table = (torch.from_numpy(a).to(dev) for a in dma_lab_data(total))
    by_name = {name(bs, t): (bs, t) for bs, t in cases}
    for bs, t in cases:
        _check(words, table, bs, t)

    def call(n, unmerged=False):
        bs, t = by_name[n]
        return dma_lab_device(words, table, bs=bs, t=t, unmerged=unmerged)

    return drive("dma_lab", list(by_name), words, total, 1, call,
                 lambda n: call(n, unmerged=True))


if __name__ == "__main__":
    main()
