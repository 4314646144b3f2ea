"""The batch sweeps' precision on data with ties (the parity contract's
third clause, ROADMAP): K8 (slice layout) and K6 (octet layout), every
codec, with production buffers (not tie-safe), on the CPU.

The corpus is tie-heavy: matrix values of +-1 and queries in {-1, 0, 1}
(every codec quantizes them to one level each, so every score is a small
integer multiple of one step, exact in any summation order), lane_k 4
and k 400 of the 700 rows, near a pool's 512 entries, so that lanes hold
more rows at or above the k-th score than their buffers and the
non-tie-safe argmin replacement (every minimum slot replaced) drops
candidates. The port's sweeps as their kernels compute them
(``slice_topk_batch_slots_plain`` on ``k8_launch``'s slots,
``octet_topk_batch_slots_plain`` on ``k6_launch``'s, the card's 132 SMs
monkeypatched in) and the JAX package's batch kernels in interpret mode
(one program of every block in order, the same buffers) each give their
per-lane pools, taken to each query's top k by ``finalize_topk_batch``.
A returned row is a hit when its exact score (the layout's scores plain,
exact here) is at least the exact k-th score, so which of several equal
scores a side returns is not a miss. The port's precision@k must be at
least the reference's, averaged over the queries and in total.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_topk_tpu.config as jcfg
from spmv_topk_tpu.formats import CooMatrix as JCoo
from spmv_topk_tpu.formats import create_sparse_matrix as jax_matrix
from spmv_topk_tpu.formats.sell_buckets import (fuse_buckets as jfuse,
                                                fuse_buckets_octet as jfuse8,
                                                pack_sell_buckets as jpack)
from spmv_topk_tpu.ops import kernel as jkernel
from spmv_topk_tpu.ops.quantized_query import pack_query_tables

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.ops import kernel as pkernel

ROWS, COLS, QUERIES, K = 700, 1024, 3, 400
BASE = dict(k=K, lane_k=4, max_cols=COLS, tie_safe_topk=False,
            block_sublanes=64)
# each codec at its engine's width quantum; the octet layout's fold of
# the top 3 of 8
CODECS = {"h16": dict(query_codec="h16", width_quantum=2),
          "f32": dict(query_codec="f32"),
          "int8x4": dict(query_codec="int8x4", width_quantum=4),
          "i8s": dict(query_codec="i8s", width_quantum=4),
          "i4s": dict(query_codec="i4s", width_quantum=4)}
LAYOUTS = {"slice": dict(fused_layout="slice", fused_block_sublanes=64),
           "octet": dict(fused_layout="octet", fused_block_sublanes=64,
                         fold_tile=8, octet_multicall=False)}
SMEM = 232448   # an H100's opt-in shared memory a block
SMS = 132


def _cfg(layout, codec):
    return {**BASE, **CODECS[codec], **LAYOUTS[layout]}


@pytest.fixture(scope="module")
def tie_corpus():
    """(the JAX corpus with values of +-1, the queries)."""
    base = jax_matrix(ROWS, COLS, 20, "gamma", seed=21)
    vals = np.random.default_rng(22).choice([-1.0, 1.0], base.nnz).astype(
        np.float32)
    qs = np.random.default_rng(23).integers(-1, 2, (QUERIES, COLS)).astype(
        np.float32)
    return JCoo(base.rows, base.cols, vals, base.num_rows, base.num_cols), qs


@pytest.fixture(scope="module")
def sweeps(tie_corpus):
    """Each (layout, codec): the JAX batch kernel's pools in interpret mode
    and what the port needs beside them: (fused matrix, tables, plan rows,
    JAX values, JAX tags)."""
    coo, qs = tie_corpus
    out = {}
    for layout in LAYOUTS:
        for codec in CODECS:
            cfg = jcfg.TopKSpMVConfig(**_cfg(layout, codec))
            octet = layout == "octet"
            f = (jfuse8 if octet else jfuse)(
                jpack(coo, cfg), block_sublanes=cfg.fused_block_sublanes)
            tabs, _ = pack_query_tables(qs, codec)
            run = (jkernel.topk_spmv_fused_batch_octet_device if octet
                   else jkernel.topk_spmv_fused_batch_device)
            tv, tt = run(jnp.asarray(f.words), jnp.asarray(tabs),
                         jnp.asarray(f.nreal), cfg=cfg, plan=f.plan,
                         block_sublanes=f.block_sublanes,
                         num_blocks=f.num_blocks, interpret=True,
                         codec=codec)
            rows = (pkernel.octet_plan_rows(f.plan, f.num_blocks) if octet
                    else pkernel.slice_plan_rows(f.plan, f.num_blocks,
                                                 f.nreal, f.block_sublanes))
            out[layout, codec] = (f, tabs, rows, np.asarray(tv),
                                  np.asarray(tt))
    return out


def _port_pools(layout, codec, f, tabs, rows):
    """The port's production sweep as its kernel computes it, on its
    launch's slots."""
    cfg = pt.TopKSpMVConfig(**_cfg(layout, codec))
    dev = torch.device("cuda", 0)
    args = (torch.from_numpy(f.words), torch.from_numpy(tabs),
            torch.from_numpy(f.nreal), torch.from_numpy(rows))
    kw = dict(lane_k=cfg.lane_k, tie_safe=False,
              block_sublanes=f.block_sublanes, codec=codec)
    if layout == "octet":
        *_, slots = pkernel.k6_launch(dev, cfg, QUERIES, 1)
        return pkernel.octet_topk_batch_slots_plain(
            *args, num_slots=slots, fold_tile=cfg.fold_tile, **kw)
    *_, slots = pkernel.k8_launch(dev, cfg, QUERIES, 1)
    return pkernel.slice_topk_batch_slots_plain(*args, num_slots=slots, **kw)


def _exact_scores(layout, codec, f, tabs, rows):
    """(Q, rows) each row's exact score (the layout's scores plain: exact
    integers here, in any order)."""
    scores_plain = (pkernel.octet_scores_plain if layout == "octet"
                    else pkernel.slice_scores_plain)
    row_ids = torch.from_numpy(f.row_ids).reshape(-1).long()
    out = torch.full((QUERIES, ROWS), float("-inf"))
    for q in range(QUERIES):
        s = scores_plain(torch.from_numpy(f.words), torch.from_numpy(tabs[q]),
                         torch.from_numpy(f.nreal), torch.from_numpy(rows),
                         num_slices=f.row_ids.shape[0],
                         block_sublanes=f.block_sublanes, codec=codec)
        s = s.reshape(-1)[:row_ids.numel()]
        ok = row_ids >= 0
        out[q, row_ids[ok]] = s[ok]
    return out


def _hits(pools, f, exact):
    """Each query's hits among its finalized top k: the distinct rows (a
    buffer of the non-tie-safe replacement can hold one candidate several
    times) whose exact score is at least the exact k-th."""
    idx, _ = pkernel.finalize_topk_batch(
        torch.as_tensor(np.array(pools[0])),
        torch.as_tensor(np.array(pools[1])), torch.from_numpy(f.row_ids), K)
    kth = exact.topk(K, dim=1).values[:, -1]
    return np.array([len({r for r in idx[q].tolist()
                          if r >= 0 and exact[q, r] >= kth[q]})
                     for q in range(QUERIES)])


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batch_precision_on_ties_at_least_the_references(
        sweeps, layout, codec, monkeypatch):
    """K8 and K6 with production buffers keep at least as many of each
    query's exact top k as the JAX batch kernel does on tied scores."""
    monkeypatch.setattr(pkernel, "_device_info", lambda dev: (SMS, SMEM))
    f, tabs, rows, jv, jt = sweeps[layout, codec]
    exact = _exact_scores(layout, codec, f, tabs, rows)
    kth = exact.topk(K, dim=1).values[:, -1:]
    # ties at the k-th score, and lanes holding more rows at or above it
    # than a buffer's lane_k entries
    assert ((exact == kth).sum(dim=1) > 1).all()
    row_ids = torch.from_numpy(f.row_ids)
    lane_of = torch.full((ROWS,), -1, dtype=torch.long)
    ok = row_ids >= 0
    lane_of[row_ids[ok].long()] = torch.arange(128).expand_as(row_ids)[ok]
    for q in range(QUERIES):
        per_lane = torch.bincount(lane_of[exact[q] >= kth[q]], minlength=128)
        assert per_lane.max() > BASE["lane_k"]
    port = _hits(_port_pools(layout, codec, f, tabs, rows), f, exact)
    ref = _hits((jv, jt), f, exact)
    assert port.mean() >= ref.mean() and port.sum() >= ref.sum(), (
        port, ref)
