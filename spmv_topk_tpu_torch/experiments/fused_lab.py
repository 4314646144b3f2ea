"""Fused lab (L4) on the H100: the production sweep's features added one
at a time to the bare int8 lab kernel (experiments/fused_lab.py), timed
beside the stream probe K3 on the same words.

  v_bare    kernel_lab's int8 body and fold (no mask, no branches)
  v_smem    + the real-slice count nreal[0] (the TPU kernel's SMEM input):
            a slice t >= nreal[0] scores -inf
  v_branch  + three segments of lab blocks (the TPU kernel's three
            pl.when branches on block-index ranges), each with its own
            slice base and count nreal[b], chosen per lab block
  v_prod    the port's own production sweep K7
            (ops/kernel.py::topk_spmv_fused_device, codec int8x4) on the
            same words, planned as three buckets of width W

W = 32 rows, SPB = 16 slices per block, three segments, as the JAX lab;
NB from LAB_NB (4096 here: 1 GiB of words); the fold is kernel_lab's
LAB_FOLD (``fast``, else ``exact``: the JAX lab takes kernel_lab's
``_topk_update``, whose only branch is ``fast``). ``fused_lab_device``
launches ``csrc/lab_fused.cu`` (v_prod: K7) on a CUDA tensor and
``fused_lab_plain`` runs on a CPU tensor.

    python -m spmv_topk_tpu_torch.experiments.fused_lab [variant ...]
        [--device cpu]
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..config import TopKSpMVConfig
from ..formats.sell_buckets import FusedBucket
from ..ops.kernel import slice_plan_rows, slice_topk_plain, topk_spmv_fused_device
from ._common import (CHUNK, DEFAULT_NB, LANE_K, NEG_INF, check_table,
                      check_words, drive, env_int, finish, float_scores,
                      fold_plain, fused_lab_data, one_buffer, parse_args,
                      run_kernel)
from .kernel_lab import body_int8

W = 32
SPB = 16
NSEG = 3            # segments of v_branch
VARIANTS = ("v_bare", "v_smem", "v_branch", "v_prod")
MODES = VARIANTS[:3]                      # csrc/lab_fused.cu's enum Mode
FOLDS = ("exact", "fast")                 # enum Fold
# v_prod's engine configuration (fused_lab.py:143-144): fold_tile 1,
# buffers not tie-safe
PROD_CONFIG = TopKSpMVConfig(k=100, lane_k=LANE_K, max_cols=1024,
                             query_codec="int8x4")


def lab_fold() -> str:
    return "fast" if os.environ.get("LAB_FOLD", "exact") == "fast" else "exact"


@functools.lru_cache(maxsize=8)
def prod_plan(nb: int, width: int, spb: int, dev: torch.device):
    """(plan_rows (3, 6), nreal (3, 1)) on ``dev`` of v_prod's three
    buckets (fused_lab.py:145-151). The JAX lab gives each bucket a real
    count of nb * spb, which its kernel meets on every slice of the
    bucket's blocks; the port's plan table refuses a count its bucket
    cannot hold, so each bucket counts its own slices: the same
    candidates."""
    per = nb // NSEG
    plan = tuple(
        FusedBucket(width=width, slices_per_block=spb, blocks_per_slice=1,
                    slice_base=b * per * spb, blk_start=b * per,
                    num_blocks=(nb - 2 * per) if b == NSEG - 1 else per)
        for b in range(NSEG))
    nreal = np.array([[p.num_blocks * spb] for p in plan], np.int32)
    rows = slice_plan_rows(plan, nb, nreal, width * spb)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(nreal).to(dev)


def _check(words, table, nreal, variant, fold, W, SPB, S):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}")
    if S != CHUNK:
        raise ValueError(f"the lab reads chunks of {CHUNK} rows, got S={S}")
    nb = check_words(words, W * SPB)
    check_table(table, 2, torch.int32, words.device)
    if nreal.device != words.device or nreal.dtype != torch.int32 or \
            nreal.numel() != NSEG or not nreal.is_contiguous():
        raise ValueError(f"nreal: need {NSEG} contiguous int32 on "
                         f"{words.device}, got {nreal.dtype} "
                         f"{tuple(nreal.shape)} on {nreal.device}")
    return nb


def fused_lab_plain(words, table, nreal, *, variant: str, fold: str = "exact",
                    W: int = W, SPB: int = SPB, S: int = CHUNK):
    """Plain PyTorch version of the lab: (tv, tt), each (8, 128), sorted
    descending per lane (``_common.fold_plain``); v_prod: K7's plain
    version (ops/kernel.py::slice_topk_plain). words: (NB * W * SPB, 128)
    int32; table: (2, 128) int32; nreal: (3, 1) int32."""
    nb = _check(words, table, nreal, variant, fold, W, SPB, S)
    if variant == "v_prod":
        rows, nr = prod_plan(nb, W, SPB, words.device)
        cfg = PROD_CONFIG
        return slice_topk_plain(words, table, nr, rows, lane_k=cfg.lane_k,
                                fold_tile=cfg.fold_tile,
                                tie_safe=bool(cfg.tie_safe_topk),
                                block_sublanes=W * SPB, codec=cfg.query_codec)
    tab = table.view(torch.int32)
    scores = float_scores(words, lambda t: body_int8(t, tab), W=W, S=S,
                          flush=True)
    if variant != "v_bare":
        counts = nreal.reshape(-1).tolist()
        t = torch.arange(scores.shape[0], device=words.device)
        if variant == "v_smem":
            limit = torch.full_like(t, counts[0])
        else:
            per = nb // NSEG
            seg = (torch.clamp(t // SPB // per, max=NSEG - 1) if per
                   else torch.full_like(t, NSEG - 1))
            limit = seg * per * SPB + torch.tensor(counts, device=t.device)[seg]
        scores = torch.where((t < limit).view(-1, 1), scores, NEG_INF)
    return fold_plain(scores, fold)


def fused_lab_device(words, table, nreal, *, variant: str,
                     fold: str = "exact", W: int = W, SPB: int = SPB,
                     S: int = CHUNK, blocks=None, unmerged: bool = False):
    """The lab kernel (csrc/lab_fused.cu; v_prod: K7) on a CUDA tensor,
    merged per lane: (tv, tt) as ``fused_lab_plain``, which a CPU tensor
    runs. ``blocks`` and ``unmerged`` as for kernel_lab's wrapper; K7
    (v_prod) takes neither: it plans its own blocks and merges inside its
    wrapper."""
    nb = _check(words, table, nreal, variant, fold, W, SPB, S)
    if variant == "v_prod" and (blocks is not None or unmerged):
        raise ValueError("v_prod (K7) takes no blocks and always merges")
    if words.device.type == "cpu":
        return one_buffer(fused_lab_plain(words, table, nreal,
                                          variant=variant, fold=fold, W=W,
                                          SPB=SPB, S=S), unmerged)
    if variant == "v_prod":
        rows, nr = prod_plan(nb, W, SPB, words.device)
        return topk_spmv_fused_device(words, table, nr, rows,
                                      cfg=PROD_CONFIG, block_sublanes=W * SPB)
    out = run_kernel("lab_fused", words, nb, words.data_ptr(),
                     table.data_ptr(), nreal.data_ptr(), nb, W, SPB,
                     MODES.index(variant), FOLDS.index(fold), blocks=blocks)
    fused_lab_device.launches += 1
    return finish(*out, unmerged)


fused_lab_device.launches = 0


def main(argv=None):
    names, dev = parse_args(argv, VARIANTS, VARIANTS, __doc__)
    nb = env_int("LAB_NB", DEFAULT_NB)
    fold = lab_fold()
    words, table, nreal = (torch.from_numpy(a).to(dev) for a in
                           fused_lab_data(nb, W * SPB, SPB, NSEG))
    def call(name, unmerged=False):
        return fused_lab_device(words, table, nreal, variant=name, fold=fold,
                                unmerged=unmerged)

    # v_prod's kernel is timed with its merge (K7's wrapper)
    return drive(f"fused_lab/{fold}", names, words, nb, 1, call,
                 lambda name: call(name, unmerged=name != "v_prod"))


if __name__ == "__main__":
    main()
