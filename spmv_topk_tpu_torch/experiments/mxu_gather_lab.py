"""MXU-gather lab (L8) on the H100: whether a matrix product can serve the
batched query gather (experiments/mxu_gather_lab.py), its two arms timed
side by side.

  vpu     the production batch decode of REPS chunks (8 rows x 128 lanes)
          of h16 words for Q queries: out[q][lane] = float(int32 sum over
          every row of h16_apply(row q, h16_shared(w))) (mxu_gather_lab.py:
          65-76, spmv_topk_tpu/ops/kernel.py::_h16_shared / _h16_apply)
  onehot  the lab's matrix-product formulation (:79-97): each word's low
          half as one nnz (column w & 0x3FF, value the 6-bit field
          (w << 16) >> 26), a one-hot (N, C) f32 row per word and one
          ``torch.matmul`` with a (C, Q) f32 table: (N, Q) f32

The two arms are not one function: the one-hot arm encodes one half of a
word against another (f32) table; the lab compares their costs. The vpu
arm's kernel is ``csrc/lab_mxu.cu``; the one-hot arm is plain torch on
either device (the JAX lab leaves it to XLA), in float32 with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` False, as ``chip_smoke.py``
sets it).

REPS (LAB_REPS, 32: the lab's shape, launch-bound on the card as on the
TPU), Q (LAB_Q, 16), C = 1024. The words are random 31-bit integers and
the tables random int32 (mxu_gather_lab.py:101-106); a gather index is
the field's low 7 bits, as the TPU's lane gather reads the lab's raw
words. ``mxu_vpu_device`` launches the kernel on a CUDA tensor (one
launch, its merge on the card) and ``mxu_vpu_plain`` runs on a CPU
tensor.

    python -m spmv_topk_tpu_torch.experiments.mxu_gather_lab [arm ...]
        [--device cpu]      (env LAB_REPS, LAB_Q)
"""

from __future__ import annotations

import torch

from ._common import (CHUNK, LANES, check_tables, check_words, drive,
                      env_int, mxu_lab_data, parse_args, wrap_int)
from .batch_lab import KERNEL_QUERIES
from .h16_lab import decode_nsh

ARMS = ("vpu", "onehot")
REPS = 32
COLUMNS = 1024
# the kernel's grid (csrc/lab_mxu.cu: kMxuBlocksPerSm blocks of 4 x 128
# threads an SM): one wave, at least MXU_MIN_ROWS rows a block (one row
# a thread)
MXU_BLOCKS_PER_SM = 1
MXU_MIN_ROWS = 4
_WORKSPACE = {}


def _check(words, tables):
    chunks = check_words(words, CHUNK)
    check_tables(tables, words.device)
    return chunks


def mxu_vpu_sums(words, tables) -> torch.Tensor:
    """(Q, 128) int64: each query's unwrapped sum over every row."""
    return torch.stack([decode_nsh(words, tables[q:q + 1]).long().sum(0)
                        for q in range(tables.shape[0])])


def mxu_vpu_plain(words, tables) -> torch.Tensor:
    """Plain PyTorch version of the vpu arm: (Q, 128) f32. words:
    (REPS * 8, 128) int32; tables: (Q, 128) int32."""
    _check(words, tables)
    return wrap_int(mxu_vpu_sums(words, tables), torch.int32).float()


def mxu_blocks(dev, chunks: int, blocks=None) -> int:
    """The kernel's CUDA grid: ``blocks``, or one wave of MXU_BLOCKS_PER_SM
    blocks an SM (the SM count read once per device) with at least
    MXU_MIN_ROWS of the chunks' rows a block; at most MXU_BLOCKS_PER_SM an
    SM either way."""
    from ..ops.kernel import _device_info

    wave = _device_info(dev)[0] * MXU_BLOCKS_PER_SM
    if blocks is None:
        blocks = min(wave, -(-chunks * CHUNK // MXU_MIN_ROWS))
    return max(1, min(int(blocks), wave))


def block_rows(rows: int, blocks: int, b: int) -> range:
    """The rows of block ``b`` of ``blocks``: [b R / B, (b + 1) R / B), as
    the kernel takes them."""
    return range(rows * b // blocks, rows * (b + 1) // blocks)


def _workspace(dev, stream: int, Q: int):
    """The kernel's accumulator, (Q, 128) 64-bit counters, zeros (each
    launch leaves them 0), allocated once per device, stream and Q."""
    key = (dev.index, stream, Q)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = _WORKSPACE[key] = torch.zeros((Q, LANES), dtype=torch.int64,
                                           device=dev)
    return ws


def mxu_vpu_device(words, tables, *, blocks=None):
    """The vpu arm's kernel (csrc/lab_mxu.cu) on a CUDA tensor: as
    ``mxu_vpu_plain``, which a CPU tensor runs. One launch, its merge on
    the card, returns the (Q, 128) float32 result. ``blocks``: the CUDA
    block count (default ``mxu_blocks``' over the chunks)."""
    chunks = _check(words, tables)
    Q = tables.shape[0]
    if words.device.type == "cpu":
        return mxu_vpu_plain(words, tables)
    if Q not in KERNEL_QUERIES:
        raise ValueError(f"Q={Q}: the kernel is built for {KERNEL_QUERIES} "
                         f"queries")
    from ..ops.kernel import _launch

    dev = words.device
    nblk = mxu_blocks(dev, chunks, blocks)
    out = torch.empty((Q, LANES), dtype=torch.float32, device=dev)
    _launch(dev, "lab_mxu", words.data_ptr(), tables.data_ptr(), chunks, Q,
            nblk, _workspace(dev, torch.cuda.current_stream(dev).cuda_stream,
                             Q).data_ptr(), out.data_ptr())
    mxu_vpu_device.launches += 1
    return out


mxu_vpu_device.launches = 0


def mxu_onehot(words, tabq, columns: int = COLUMNS) -> torch.Tensor:
    """The one-hot arm (mxu_gather_lab.py:79-97) in torch: (N, Q) f32,
    row n = value_n * tabq[column_n] (one nonzero product a row)."""
    col = (words & 0x3FF).reshape(-1)
    val = ((words << 16) >> 26).to(torch.float32).reshape(-1)
    iota = torch.arange(columns, dtype=torch.int32, device=words.device)
    oh = torch.where(col[:, None] == iota[None, :], val[:, None], 0.0)
    return torch.matmul(oh, tabq)


def main(argv=None):
    names, dev = parse_args(argv, ARMS, ARMS, __doc__)
    reps, Q = env_int("LAB_REPS", REPS), env_int("LAB_Q", 16)
    words, tables, tabq = (torch.from_numpy(a).to(dev)
                           for a in mxu_lab_data(reps, Q, COLUMNS))

    def call(name):
        if name == "onehot":
            return mxu_onehot(words, tabq)
        return mxu_vpu_device(words, tables)

    return drive("mxu_gather_lab", names, words, reps, 2, call, None,
                 queries=Q)


if __name__ == "__main__":
    main()
