"""Row-sharded dense batch engine.

The counterpart of ``spmv_topk_tpu.parallel.sharded_dense``: each mesh
position holds a contiguous row block of the dense corpus (bf16, or int8
with per-row scales) on its device, runs ``ops.dense.dense_topk_batch``
there, and the shards' (Q, k) candidate pairs are gathered onto the
first device and merged with one top-k, as the JAX engine's
``all_gather`` and ``lax.top_k`` merge them. One process.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, TopKSpMVConfig
from ..formats.coo import CooMatrix
from ..ops.dense import (_unique_entries, _upload, dense_topk_batch,
                         densify_bf16, densify_device, densify_int8)
from .mesh import make_mesh


class ShardedDenseTopKSpMV:
    """Multi-device dense Top-K engine (bf16, or int8 with per-row scales:
    half the bytes per shard)."""

    def __init__(self, matrix: CooMatrix,
                 config: TopKSpMVConfig = DEFAULT_CONFIG, mesh=None,
                 block_rows: int = 1 << 17, recall_target: float = 0.98,
                 dtype: str = "bf16"):
        if dtype not in ("bf16", "int8"):
            raise ValueError(f"dtype must be 'bf16' or 'int8', got {dtype!r}")
        self.mesh = mesh if mesh is not None else make_mesh()
        D = len(self.mesh)
        self.config = config
        self.dtype = dtype
        self.num_rows = matrix.num_rows
        self.num_cols = matrix.num_cols
        self.num_nnz = matrix.nnz
        self.recall_target = recall_target
        self.device = torch.device(self.mesh[0])

        if not matrix.is_sorted_row_major():
            matrix = matrix.sort_row_major()
        # repeated entries summed once for the whole corpus (as scipy sums
        # them), not per shard
        dense_src = _unique_entries(matrix)
        self._scipy_csr = (matrix.to_scipy_csr() if config.rescore_pool
                           else None)

        rows_per_shard = -(-matrix.num_rows // D)
        # block_rows must tile the shard exactly (zero rows pad the tail)
        self.block_rows = min(block_rows, rows_per_shard)
        pad_shard = -(-rows_per_shard // self.block_rows) * self.block_rows

        int8_mode = dtype == "int8"
        self._A, self._scales, self._row0, self._nrows = [], [], [], []
        for d in range(D):
            dev = torch.device(self.mesh[d])
            lo = d * rows_per_shard
            hi = min(lo + rows_per_shard, matrix.num_rows)
            local = dense_src.row_slice(lo, max(lo, hi))
            if dev.type == "cpu":
                if int8_mode:
                    bits, scales = (densify_int8(local) if hi > lo else
                                    (np.zeros((0, matrix.num_cols), np.int8),
                                     np.ones(0, np.float32)))
                else:
                    bits = (densify_bf16(local) if hi > lo else
                            np.zeros((0, matrix.num_cols), np.uint16))
                    scales = None
                A, sc = _upload(bits, scales, pad_shard, dev)
            else:
                A, sc = densify_device(local, dtype, dev, pad_shard)
            self._A.append(A)
            self._scales.append(sc)
            self._row0.append(lo)
            self._nrows.append(max(0, hi - lo))

    def _local(self, d: int, queries: np.ndarray, k: int):
        """Shard d's (rows, values), each (Q, k), global rows on its
        device; pad rows (past the shard's real rows) go to the sentinel
        row num_rows with -inf."""
        A = self._A[d]
        dev = A.device
        q = torch.from_numpy(queries).to(dev)
        nreal = self._nrows[d]
        if self.dtype == "int8":
            # quantized per query on the device, every shard alike; the
            # query scale only scales the returned values (true divisions:
            # torch divides by a scalar as a reciprocal multiply)
            m = q.abs().amax(dim=1)
            qs = torch.where(m > 0, m / torch.full_like(m, 127.0),
                             torch.ones_like(m))
            qi = torch.round(q / qs[:, None]).to(torch.int8)
            li, lv = dense_topk_batch(A, qi, nreal, self._scales[d], qs,
                                      k=k, block_rows=self.block_rows,
                                      recall_target=self.recall_target)
        else:
            li, lv = dense_topk_batch(A, q, nreal, k=k,
                                      block_rows=self.block_rows,
                                      recall_target=self.recall_target)
        valid = li < nreal
        gi = torch.where(valid, li + self._row0[d],
                         torch.full_like(li, self.num_rows))
        lv = torch.where(valid, lv, torch.full_like(lv, float("-inf")))
        return gi, lv

    def query_batch(self, queries, k: Optional[int] = None):
        """(Q, C) queries -> (rows int32, values f32), each (Q, k), on the
        mesh's first device."""
        user_k = k or self.config.k
        pool = self.config.rescore_pool
        k = max(user_k, pool) if pool else user_k
        queries = np.asarray(queries, np.float32)
        outs = [self._local(d, queries, k) for d in range(len(self.mesh))]
        gr = torch.cat([r.to(self.device) for r, _ in outs], dim=1)
        gv = torch.cat([v.to(self.device) for _, v in outs], dim=1)
        fv, fp = torch.topk(gv, min(k, gv.shape[1]), dim=1)
        fr = torch.gather(gr, 1, fp)
        fr = torch.where(fr < self.num_rows, fr, torch.full_like(fr, -1))
        if pool:
            from ..api import exact_rescore

            host = fr.cpu().numpy()
            res = [exact_rescore(self._scipy_csr, host[q], queries[q],
                                 user_k) for q in range(len(queries))]
            return (torch.from_numpy(np.stack([o[0] for o in res]))
                    .to(self.device),
                    torch.from_numpy(np.stack([o[1] for o in res]))
                    .to(self.device))
        return fr, fv

    def query(self, vec, k: Optional[int] = None):
        idx, vals = self.query_batch(np.asarray(vec)[None, :], k)
        return idx[0], vals[0]

    @property
    def hbm_bytes(self) -> int:
        """The dense shards' bytes on the cards (bf16 2 a value, int8 1)."""
        return sum(int(np.prod(a.shape)) for a in self._A) * (
            1 if self.dtype == "int8" else 2)
