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
words. ``mxu_vpu_device`` launches the kernel on a CUDA tensor and
``mxu_vpu_plain`` runs on a CPU tensor.

    python -m spmv_topk_tpu_torch.experiments.mxu_gather_lab [arm ...]
        [--device cpu]      (env LAB_REPS, LAB_Q)
"""

from __future__ import annotations

import torch

from ._common import (CHUNK, LANES, check_tables, check_words, cuda_blocks,
                      drive, env_int, mxu_lab_data, parse_args, wrap_int)
from .batch_lab import KERNEL_QUERIES
from .h16_lab import decode_nsh

ARMS = ("vpu", "onehot")
REPS = 32
COLUMNS = 1024


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


def mxu_vpu_device(words, tables, *, blocks=None, unmerged: bool = False):
    """The vpu arm's kernel (csrc/lab_mxu.cu) on a CUDA tensor: as
    ``mxu_vpu_plain``, which a CPU tensor runs. ``blocks``: the CUDA block
    count (default ``_common.cuda_blocks`` over the chunks); ``unmerged``:
    the per-CUDA-block int32 sums (blocks, Q, 128), the kernel alone (on
    the CPU, the plain sums as one block)."""
    chunks = _check(words, tables)
    Q = tables.shape[0]
    if words.device.type == "cpu":
        if unmerged:
            return wrap_int(mxu_vpu_sums(words, tables), torch.int32)[None]
        return mxu_vpu_plain(words, tables)
    if Q not in KERNEL_QUERIES:
        raise ValueError(f"Q={Q}: the kernel is built for {KERNEL_QUERIES} "
                         f"queries")
    from ..ops.kernel import _launch

    nblk = cuda_blocks(words.device, chunks, blocks)
    part = torch.empty((nblk, Q, LANES), dtype=torch.int32,
                       device=words.device)
    _launch(words.device, "lab_mxu", words.data_ptr(), tables.data_ptr(),
            chunks, Q, nblk, part.data_ptr())
    mxu_vpu_device.launches += 1
    if unmerged:
        return part
    return wrap_int(part.long().sum(0), torch.int32).float()


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

    def call(name, unmerged=False):
        if name == "onehot":
            return mxu_onehot(words, tabq)
        return mxu_vpu_device(words, tables, unmerged=unmerged)

    return drive("mxu_gather_lab", names, words, reps, 2, call,
                 lambda name: call(name, unmerged=True), queries=Q)


if __name__ == "__main__":
    main()
