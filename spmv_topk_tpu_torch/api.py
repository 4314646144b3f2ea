"""User-facing engine: matrix-resident Top-K SpMV on one device.

The PyTorch counterpart of ``spmv_topk_tpu.api.TopKSpMV`` for the
single-query path: the h16 codec on the octet stream, one partition.
``TopKSpMV`` is an ``nn.Module`` whose buffers hold the packed stream
(``words``), the real slices per bucket (``nreal``), the slice -> row map
(``row_ids``) and the kernel's bucket plan (``plan_rows``) on the device
it was built for. A query runs

  1. the query table (``ops/quantized_query.pack_query_table``),
  2. the octet sweep (``ops/kernel.topk_spmv_fused_octet_device``,
     a CUDA kernel on the card),
  3. ``finalize_topk`` on the device,
  4. with ``rescore_pool``, the exact host rescore of the pool
     (``exact_rescore``, native ``csr_rescore``).

Snapshots use the JAX package's ``.npz`` format v2, so one file serves
both packages.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

import numpy as np
import torch

from .config import LANES, TopKSpMVConfig, ValueFormat, DEFAULT_CONFIG
from .formats.coo import CooMatrix, from_scipy
from .formats.sell_buckets import (FusedSellMatrix, fuse_buckets_octet,
                                   octet_plan_array, octet_plan_from_array,
                                   pack_sell_buckets)
from .ops.kernel import (finalize_topk, octet_plan_rows,
                         topk_spmv_fused_octet_device)
from .ops.quantized_query import pack_query_table


def exact_rescore(csr, idx, vec, k):
    """Exact top-k among candidate rows `idx` by f32 CSR dot products.

    csr: scipy CSR of the full matrix; idx: candidate rows (-1 = padding);
    returns (indices, values) of length k, sorted descending, padded with
    (-1, -inf) if fewer than k valid candidates."""
    idx = np.asarray(idx)
    # dedupe: when the pool exceeds the valid candidates, masked (-inf)
    # slots surface row ids that alias real candidates
    rows = np.unique(idx[idx >= 0]).astype(np.int64)
    vec = np.ascontiguousarray(vec, np.float32)
    out_i = np.full(k, -1, np.int32)
    out_v = np.full(k, -np.inf, np.float32)
    if len(rows) == 0:
        return out_i, out_v
    # normalize the CSR arrays once per matrix; cached on the csr object
    cache = getattr(csr, "_spmv_tpu_norm", None)
    if cache is None:
        cache = (np.ascontiguousarray(csr.indptr, np.int64),
                 np.ascontiguousarray(csr.indices, np.int32),
                 np.ascontiguousarray(csr.data, np.float32))
        csr._spmv_tpu_norm = cache
    indptr, indices, data = cache

    from .utils import native

    exact = native.csr_rescore(indptr, indices, data, vec, rows)
    if exact is None:  # NumPy path when the native runtime is not built
        starts = indptr[rows]
        lens = indptr[rows + 1] - starts
        offs = np.concatenate(([0], np.cumsum(lens[:-1])))
        total = int(offs[-1] + lens[-1])
        gather = (np.arange(total, dtype=np.int64)
                  - np.repeat(offs, lens) + np.repeat(starts, lens))
        prod = data[gather] * vec[indices[gather]]
        csum = np.concatenate(([0.0], np.cumsum(prod, dtype=np.float64)))
        exact = (csum[offs + lens] - csum[offs]).astype(np.float32)
    order = np.argsort(-exact, kind="stable")[:k]
    out_i[: len(order)] = rows[order]
    out_v[: len(order)] = exact[order]
    return out_i, out_v


def _check_slice(config: TopKSpMVConfig) -> None:
    """Raise for configurations the port does not run yet."""
    if config.fused_layout != "octet":
        raise NotImplementedError(
            "fused_layout='slice' is not ported yet (ROADMAP.md Queue 1 "
            "item 7, slice layout): use fused_layout='octet'")
    if config.query_codec != "h16":
        raise NotImplementedError(
            f"query_codec={config.query_codec!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 5, other query codecs): use 'h16'")
    if config.num_partitions > 1:
        raise NotImplementedError(
            "num_partitions > 1 is not ported yet (ROADMAP.md Queue 1 "
            "item 8, partitioned engines)")


class TopKSpMV(torch.nn.Module):
    """Matrix-resident approximate Top-K SpMV engine (single device).

    ``device`` is required: the packed stream is uploaded there, and the
    sweep runs the CUDA kernel on a CUDA device and its plain PyTorch
    version on the CPU.
    """

    def __init__(self, matrix, config: TopKSpMVConfig = DEFAULT_CONFIG, *,
                 device):
        super().__init__()
        if not isinstance(matrix, CooMatrix):
            matrix = from_scipy(matrix)
        if config.max_cols < matrix.num_cols:
            config = dataclasses.replace(
                config, max_cols=-(-matrix.num_cols // LANES) * LANES)
        _check_slice(config)
        # exact rescoring keeps the host CSR; the sorted COO's arrays back
        # it without a copy
        csr = matrix.to_scipy_csr() if config.rescore_pool else None
        fused = fuse_buckets_octet(pack_sell_buckets(matrix, config),
                                   block_sublanes=config.fused_block_sublanes)
        self._init_state(config, fused, device, csr)

    def _init_state(self, config, fused: FusedSellMatrix, device, csr):
        self.config = config
        self.fused = fused
        self.num_rows = fused.num_rows
        self.num_cols = fused.num_cols
        self.num_nnz = fused.num_nnz
        self._value_scale = fused.value_scale
        self._scipy_csr = csr
        self._last_scale = 1.0
        device = torch.device(device)
        plan_rows = octet_plan_rows(fused.plan, fused.num_blocks)
        if fused.words.shape[0] != fused.num_blocks * fused.block_sublanes:
            raise ValueError("words rows do not match num_blocks * "
                             "block_sublanes")
        for name, arr in (("words", fused.words), ("nreal", fused.nreal),
                          ("row_ids", fused.row_ids),
                          ("plan_rows", plan_rows)):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(arr, np.int32)).to(device))

    @property
    def device(self) -> torch.device:
        return self.words.device

    @classmethod
    def from_reference_arrays(cls, words, nreal, row_ids, plan_rows, meta,
                              device, matrix=None):
        """Engine from the JAX engine's packed arrays.

        words/nreal/row_ids: ``eng.fused.words`` etc. of a
        ``spmv_topk_tpu.TopKSpMV``; plan_rows: its plan as the (B, 7)
        snapshot array; meta: the snapshot's meta dict (config as
        ``dataclasses.asdict``, geometry, value_scale). Exact rescoring
        needs the source matrix: without ``matrix`` it is disabled."""
        cfg_d = dict(meta["config"])
        cfg_d["value_format"] = ValueFormat(**cfg_d["value_format"])
        if cfg_d.get("rescore_pool") and matrix is None:
            # the packed stream alone cannot rescore: serve un-rescored
            warnings.warn(
                "engine has no host CSR: rescore_pool disabled (pass "
                "matrix= to restore exact rescoring)", stacklevel=2)
            cfg_d["rescore_pool"] = None
        config = TopKSpMVConfig(**cfg_d)
        _check_slice(config)
        if meta.get("num_partitions", 1) > 1:
            raise NotImplementedError(
                "partitioned snapshots are not ported yet (ROADMAP.md "
                "Queue 1 item 8, partitioned engines)")
        fused = FusedSellMatrix(
            words=np.asarray(words, np.int32),
            plan=octet_plan_from_array(plan_rows),
            nreal=np.asarray(nreal, np.int32).reshape(-1, 1),
            block_sublanes=int(meta["block_sublanes"]),
            num_blocks=int(meta["num_blocks"]),
            row_ids=np.asarray(row_ids, np.int32),
            num_rows=int(meta["num_rows"]), num_cols=int(meta["num_cols"]),
            num_nnz=int(meta["num_nnz"]),
            value_scale=float(meta.get("value_scale", 1.0)))
        csr = None
        if matrix is not None and config.rescore_pool:
            if not isinstance(matrix, CooMatrix):
                matrix = from_scipy(matrix)
            csr = matrix.to_scipy_csr()
        self = cls.__new__(cls)
        torch.nn.Module.__init__(self)
        self._init_state(config, fused, device, csr)
        return self

    def save(self, path: str) -> None:
        """Persist the packed engine (.npz format v2 of the JAX package)."""
        f = self.fused
        meta = dict(config=dataclasses.asdict(self.config),
                    block_sublanes=f.block_sublanes,
                    num_blocks=f.num_blocks, num_rows=f.num_rows,
                    num_cols=f.num_cols, num_nnz=f.num_nnz,
                    value_scale=f.value_scale, format_version=2)
        # explicit file handle: np.savez(str) appends '.npz' when the
        # suffix is missing, but load() opens the literal path
        with open(path, "wb") as fh:
            np.savez(fh, words=f.words, nreal=f.nreal, row_ids=f.row_ids,
                     plan=octet_plan_array(f.plan), meta=np.frombuffer(
                         json.dumps(meta).encode(), np.uint8))

    @classmethod
    def load(cls, path: str, *, device, matrix=None):
        """Engine from a snapshot written by save() in either package.
        Pass the source matrix as ``matrix=`` to keep exact rescoring."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            return cls.from_reference_arrays(
                z["words"], z["nreal"], z["row_ids"], z["plan"], meta,
                device, matrix=matrix)

    # -- query path ---------------------------------------------------------

    def _table(self, vec):
        """Device query table and its score scale."""
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != (self.num_cols,):
            raise ValueError(
                f"query must have shape ({self.num_cols},), got {vec.shape}")
        padded = np.zeros(self.config.max_cols, np.float32)
        padded[: self.num_cols] = vec
        tab, scale = pack_query_table(padded, self.config.query_codec)
        return torch.from_numpy(np.ascontiguousarray(tab)).to(self.device), \
            scale

    def candidates(self, vec):
        """Per-lane Top-K candidates (topv, topt), each (lane_k, 128),
        before the global merge; values are unscaled integer sums."""
        table, self._last_scale = self._table(vec)
        return topk_spmv_fused_octet_device(
            self.words, table, self.nreal, self.plan_rows, cfg=self.config,
            block_sublanes=self.fused.block_sublanes)

    def _rescore(self, idx, vec, k):
        if self._scipy_csr is None:
            raise NotImplementedError(
                "exact rescoring needs the host CSR: build the engine from "
                "the matrix with config.rescore_pool set, or pass matrix= "
                "to load()")
        return exact_rescore(self._scipy_csr, idx, vec, k)

    def query(self, vec, k: Optional[int] = None,
              rescore_pool: Optional[int] = None):
        """Top-K rows by A @ vec: (indices int32, values f32) tensors on
        the engine's device, sorted descending.

        rescore_pool (default config.rescore_pool; 0 disables): widen the
        device candidates to max(k, rescore_pool) and re-rank them exactly
        on the host CSR."""
        k = k or self.config.k
        if rescore_pool is None:
            rescore_pool = self.config.rescore_pool
        topv, topt = self.candidates(vec)
        pool = max(k, rescore_pool) if rescore_pool else k
        idx, vals = finalize_topk(topv, topt, self.row_ids, k=pool)
        if rescore_pool:
            ri, rv = self._rescore(idx.cpu().numpy(), vec, k)
            return (torch.from_numpy(ri).to(self.device),
                    torch.from_numpy(rv).to(self.device))
        scale = self._last_scale * self._value_scale
        if scale != 1.0:
            vals = vals * scale
        return idx, vals

    def forward(self, vec):
        return self.query(vec)

    def query_batch(self, queries, k=None, group_size=8, rescore_pool=None):
        raise NotImplementedError(
            "query_batch is not ported yet (ROADMAP.md Queue 1 item 6, "
            "multi-query sweep): call query() per query")

    def scores(self, vec):
        raise NotImplementedError(
            "scores() is not ported yet (ROADMAP.md Queue 1 item 4, "
            "plain SpMV over the octet stream)")

    # -- accounting ---------------------------------------------------------

    @property
    def hbm_bytes(self) -> int:
        """Bytes of packed words one query sweep reads."""
        return self.fused.hbm_bytes

    @property
    def bytes_per_nnz(self) -> float:
        return self.hbm_bytes / max(self.num_nnz, 1)
