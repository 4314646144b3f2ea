"""Fold lab (L3) on the H100: the cost of the per-slice Top-K fold at a
production width (experiments/fold_lab.py), each variant timed beside the
stream probe K3 on the same words.

Every slice's score is the h16 decode of the production chain (h16_lab's
nsh_int_raw: int32 sums, one f32 convert a slice); slices t >= ``limit``
are not real. Variants:

  base    the production fold: score -inf at t >= limit, then the fast
          fold (every minimum slot)
  tguard  a scalar guard t < limit in place of the mask
  vguard  tguard + a vote of the lanes: the fold is skipped unless some
          lane's score - worst >= 0 (worst: the lane's buffer minimum)
  nofold  no Top-K: slot 0 takes each real slice's score (the last one
          stays)

W (LAB_W, 16) rows per slice, SPB (LAB_SPB, 32) slices per block, NB
(LAB_NB, 4096 here: 1 GiB of words); ``limit`` NB * SPB in ``main``.
``fold_lab_device`` launches ``csrc/lab_fold.cu`` on a CUDA tensor and
``fold_lab_plain`` runs on a CPU tensor.

vguard's vote spans the TPU kernel's 128 lanes; here it spans a warp's 32
(``__any_sync``). A lane whose score is below its minimum folds nothing,
so the vote only skips folds that change nothing, over 128 lanes or 32:
vguard leaves what tguard leaves (scores are finite int32 sums). nofold
returns the buffer of the CUDA block that holds slice limit - 1 (the last
block the sequential TPU grid writes), unsorted; the others merge their
blocks' buffers per lane.

    python -m spmv_topk_tpu_torch.experiments.fold_lab [variant ...]
        [--device cpu]
"""

from __future__ import annotations

import torch

from ._common import (CHUNK, DEFAULT_NB, LANE_K, LANES, NEG_INF,
                      check_table, check_words, drive, env_int, finish,
                      fold_plain, h16_lab_data, int_scores, one_buffer,
                      parse_args, run_kernel)
from .h16_lab import decode_nsh

VARIANTS = ("base", "tguard", "vguard", "nofold")   # csrc/lab_fold.cu's enum


def _check(words, table, variant, W, SPB, S):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if S != CHUNK:
        raise ValueError(f"the lab reads chunks of {CHUNK} rows, got S={S}")
    nb = check_words(words, W * SPB)
    check_table(table, 1, torch.int32, words.device)
    return nb


def last_real(limit: int, num_slices: int) -> int:
    """The last slice a fold sees: min(limit, num_slices) - 1 (-1: none)."""
    return min(limit, num_slices) - 1


def fold_lab_plain(words, table, limit: int, *, variant: str, W: int = 16,
                   SPB: int = 32, S: int = CHUNK):
    """Plain PyTorch version of the lab: (tv, tt), each (8, 128); sorted
    descending per lane but for nofold (slot 0 the score of the last real
    slice, the others -inf, tags 0). words: (NB * W * SPB, 128) int32;
    table: (1, 128) int32."""
    _check(words, table, variant, W, SPB, S)
    scores = int_scores(words, lambda t: decode_nsh(t, table), W=W, S=S)
    n = scores.shape[0]
    if variant == "nofold":
        tv = torch.full((LANE_K, LANES), NEG_INF, device=words.device)
        last = last_real(limit, n)
        if last >= 0:
            tv[0] = scores[last]
        return tv, torch.zeros((LANE_K, LANES), dtype=torch.int32,
                               device=words.device)
    if variant == "base":
        t = torch.arange(n, device=words.device).view(-1, 1)
        return fold_plain(torch.where(t < limit, scores, NEG_INF), "fast")
    return fold_plain(scores[:last_real(limit, n) + 1], "fast")


def fold_lab_device(words, table, limit: int, *, variant: str, W: int = 16,
                    SPB: int = 32, S: int = CHUNK, blocks=None,
                    unmerged: bool = False):
    """The lab kernel (csrc/lab_fold.cu) on a CUDA tensor: (tv, tt) as
    ``fold_lab_plain``, which a CPU tensor runs. ``blocks`` and
    ``unmerged`` as for kernel_lab's wrapper (nofold: every CUDA block's
    buffer)."""
    nb = _check(words, table, variant, W, SPB, S)
    if words.device.type == "cpu":
        return one_buffer(fold_lab_plain(words, table, limit,
                                         variant=variant, W=W, SPB=SPB,
                                         S=S), unmerged)
    limit = max(-2**31, min(int(limit), 2**31 - 1))
    out_v, out_t = run_kernel("lab_fold", words, nb, words.data_ptr(),
                              table.data_ptr(), nb, W, SPB, limit,
                              VARIANTS.index(variant), blocks=blocks)
    fold_lab_device.launches += 1
    if variant == "nofold" and not unmerged:
        b = max(0, last_real(limit, nb * SPB)) // SPB % out_v.shape[0]
        return out_v[b], out_t[b]
    return finish(out_v, out_t, unmerged)


fold_lab_device.launches = 0


def main(argv=None):
    names, dev = parse_args(argv, VARIANTS, VARIANTS, __doc__)
    W, SPB = env_int("LAB_W", 16), env_int("LAB_SPB", 32)
    nb = env_int("LAB_NB", DEFAULT_NB)
    words, table = (torch.from_numpy(a).to(dev)
                    for a in h16_lab_data(nb, W * SPB))
    def call(name, unmerged=False):
        return fold_lab_device(words, table, nb * SPB, variant=name, W=W,
                               SPB=SPB, unmerged=unmerged)

    return drive("fold_lab", names, words, nb, 2, call,
                 lambda name: call(name, unmerged=True))


if __name__ == "__main__":
    main()
