"""User-facing engine: matrix-resident Top-K SpMV on one device.

The PyTorch counterpart of ``spmv_topk_tpu.api.TopKSpMV``, for every
valid ``TopKSpMVConfig``: the slice stream (``fused_layout="slice"``, the
default) or the octet stream (``fused_layout="octet"``), with any query
codec (``f32``, the default; ``h16``; ``int8x4``; ``i8s``; ``i4s``), on one
partition or, with ``num_partitions`` P > 1, on P row partitions that
share one plan and keep a Top-K pool each (``pack_fused_partitions``). ``TopKSpMV`` is an
``nn.Module`` whose buffers hold the packed stream (``words``), the real
slices per bucket (``nreal``), the slice -> row map (``row_ids``) and the
kernels' bucket plan (``plan_rows``) on the device it was built for. A
query runs

  1. the query table (``ops/quantized_query.pack_query_table``),
  2. the sweep (``ops/kernel.topk_spmv_fused_device`` on the slice
     stream, ``topk_spmv_fused_octet_device`` on the octet stream; CUDA
     kernels on the card),
  3. ``finalize_topk`` on the device,
  4. with ``rescore_pool``, the exact host rescore of the pool
     (``exact_rescore``, native ``csr_rescore``).

``query_batch`` runs the same steps per query group, with the group's
tables (``pack_query_tables``), the multi-query sweep
(``topk_spmv_fused_batch_device`` / ``topk_spmv_fused_batch_octet_device``),
``finalize_topk_batch`` and the rescore on a thread pool. ``scores`` is
plain SpMV over the same stream (``spmv_fused_scores_device`` /
``spmv_fused_scores_octet_device``): a zero fill and one launch that
stores each score, scaled, at its row.

Snapshots use the JAX package's ``.npz`` format v2, so one file serves
both packages.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .config import LANES, TopKSpMVConfig, ValueFormat, DEFAULT_CONFIG
from .formats.coo import CooMatrix, from_scipy
from .formats.sell_buckets import (FusedSellMatrix, PartitionedFusedMatrix,
                                   fuse_buckets, fuse_buckets_octet,
                                   octet_plan_array, octet_plan_from_array,
                                   pack_fused_partitions, pack_sell_buckets,
                                   slice_plan_array, slice_plan_from_array)
from .ops.kernel import (finalize_topk, finalize_topk_batch,
                         octet_plan_rows, slice_plan_rows,
                         spmv_fused_scores_device,
                         spmv_fused_scores_octet_device,
                         topk_spmv_fused_batch_device,
                         topk_spmv_fused_batch_octet_device,
                         topk_spmv_fused_device,
                         topk_spmv_fused_octet_device)
from .ops.quantized_query import pack_query_table, pack_query_tables

class _Layout(NamedTuple):
    """What differs between the two fused streams."""

    fuse: Callable            # BucketedSellMatrix -> FusedSellMatrix
    plan_array: Callable      # plan -> snapshot array
    plan_from_array: Callable
    plan_rows: Callable       # FusedSellMatrix -> the kernels' plan table
    sweep: Callable           # single-query Top-K sweep
    batch_sweep: Callable     # multi-query Top-K sweep
    scores: Callable          # SpMV


_LAYOUTS = {
    "slice": _Layout(
        fuse_buckets, slice_plan_array, slice_plan_from_array,
        lambda f: slice_plan_rows(f.plan, f.num_blocks, f.nreal,
                                  f.block_sublanes),
        topk_spmv_fused_device, topk_spmv_fused_batch_device,
        spmv_fused_scores_device),
    "octet": _Layout(
        fuse_buckets_octet, octet_plan_array, octet_plan_from_array,
        lambda f: octet_plan_rows(f.plan, f.num_blocks),
        topk_spmv_fused_octet_device, topk_spmv_fused_batch_octet_device,
        spmv_fused_scores_octet_device),
}


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
        # exact rescoring keeps the host CSR; the sorted COO's arrays back
        # it without a copy
        csr = matrix.to_scipy_csr() if config.rescore_pool else None
        if config.num_partitions > 1:
            fused = pack_fused_partitions(
                matrix, config, config.num_partitions,
                octet=config.fused_layout == "octet")
        else:
            fused = _LAYOUTS[config.fused_layout].fuse(
                pack_sell_buckets(matrix, config),
                block_sublanes=config.fused_block_sublanes)
        self._init_state(config, fused, device, csr)

    def _init_state(self, config, fused, device, csr):
        """fused: a FusedSellMatrix, or a PartitionedFusedMatrix when
        config.num_partitions > 1."""
        self.config = config
        self.fused = fused
        self.num_rows = fused.num_rows
        self.num_cols = fused.num_cols
        self.num_nnz = fused.num_nnz
        self._value_scale = fused.value_scale
        self._scipy_csr = csr
        self._last_scale = 1.0
        self._layout = _LAYOUTS[config.fused_layout]
        device = torch.device(device)
        P = config.num_partitions
        if getattr(fused, "num_partitions", 1) != P or \
                isinstance(fused, PartitionedFusedMatrix) != (P > 1):
            raise ValueError(f"config.num_partitions={P} does not match "
                             f"the packed stream ({type(fused).__name__})")
        # partition p's slice tags are offset by p * part_slices
        part_slices = fused.part_slices if P > 1 else fused.row_ids.shape[0]
        self._parts = (dict(num_partitions=P, part_slices=part_slices)
                       if P > 1 else {})
        plan_rows = self._layout.plan_rows(fused)
        if fused.words.shape[0] != \
                P * fused.num_blocks * fused.block_sublanes:
            raise ValueError("words rows do not match num_partitions * "
                             "num_blocks * block_sublanes")
        if fused.row_ids.shape[0] != P * part_slices:
            raise ValueError("row_ids rows do not match num_partitions * "
                             "part_slices")
        nreal = np.asarray(fused.nreal).reshape(P, len(fused.plan))
        ends = [p.slice_base + int(n) for nr in nreal
                for p, n in zip(fused.plan, nr)]
        if max(ends, default=0) > part_slices - 1:
            raise ValueError("plan slices run past row_ids")
        # scores() stores each slice lane's score at its row id on the card
        if fused.row_ids.size and int(np.max(fused.row_ids)) >= self.num_rows:
            raise ValueError("row_ids hold rows past num_rows")
        for name, arr in (("words", fused.words), ("nreal", fused.nreal),
                          ("row_ids", fused.row_ids),
                          ("plan_rows", plan_rows)):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(arr, np.int32)).to(device))

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def partition_kw(self) -> dict:
        """The Top-K sweeps' partition keywords for this engine's stream
        (num_partitions, part_slices), or none on one partition."""
        return dict(self._parts)

    @classmethod
    def from_reference_arrays(cls, words, nreal, row_ids, plan_rows, meta,
                              device, matrix=None):
        """Engine from the JAX engine's packed arrays.

        words/nreal/row_ids: ``eng.fused.words`` etc. of a
        ``spmv_topk_tpu.TopKSpMV``; plan_rows: its plan as the snapshot
        array, (B, 6) for the slice layout and (B, 7) for the octet
        layout; meta: the snapshot's meta dict (config as
        ``dataclasses.asdict``, geometry, value_scale; num_partitions and
        part_slices for a partitioned engine). Exact rescoring needs the
        source matrix: without ``matrix`` it is disabled."""
        cfg_d = dict(meta["config"])
        cfg_d["value_format"] = ValueFormat(**cfg_d["value_format"])
        if cfg_d.get("rescore_pool") and matrix is None:
            # the packed stream alone cannot rescore: serve un-rescored
            warnings.warn(
                "engine has no host CSR: rescore_pool disabled (pass "
                "matrix= to restore exact rescoring)", stacklevel=2)
            cfg_d["rescore_pool"] = None
        config = TopKSpMVConfig(**cfg_d)
        plan_rows = np.asarray(plan_rows)
        cols = 6 if config.fused_layout == "slice" else 7
        if plan_rows.ndim != 2 or plan_rows.shape[1] != cols:
            raise ValueError(f"a {config.fused_layout} plan has {cols} "
                             f"columns, got shape {plan_rows.shape}")
        P = int(meta.get("num_partitions", 1))
        geometry = dict(
            words=np.asarray(words, np.int32),
            plan=_LAYOUTS[config.fused_layout].plan_from_array(plan_rows),
            block_sublanes=int(meta["block_sublanes"]),
            num_blocks=int(meta["num_blocks"]),
            row_ids=np.asarray(row_ids, np.int32),
            num_rows=int(meta["num_rows"]), num_cols=int(meta["num_cols"]),
            num_nnz=int(meta["num_nnz"]),
            value_scale=float(meta.get("value_scale", 1.0)))
        if P > 1:
            fused = PartitionedFusedMatrix(
                nreal=np.asarray(nreal, np.int32).reshape(P, -1, 1),
                num_partitions=P, part_slices=int(meta["part_slices"]),
                **geometry)
        else:
            fused = FusedSellMatrix(
                nreal=np.asarray(nreal, np.int32).reshape(-1, 1), **geometry)
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
        # a partitioned stream's geometry, as the JAX package writes it
        meta.update(self._parts)
        # explicit file handle: np.savez(str) appends '.npz' when the
        # suffix is missing, but load() opens the literal path
        with open(path, "wb") as fh:
            np.savez(fh, words=f.words, nreal=f.nreal, row_ids=f.row_ids,
                     plan=self._layout.plan_array(f.plan),
                     meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))

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
        """Per-lane Top-K candidates (topv, topt), each (lane_k, 128), or
        (P, lane_k, 128) on P > 1 partitions (a pool per partition),
        before the global merge; values are unscaled (h16: integer sums;
        the quantized codecs: sums against the integer query table)."""
        table, self._last_scale = self._table(vec)
        return self._layout.sweep(
            self.words, table, self.nreal, self.plan_rows, cfg=self.config,
            block_sublanes=self.fused.block_sublanes, **self._parts)

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

    def batch_candidates(self, tables):
        """Per-lane candidates of a query group: (topv, topt), each
        (Q, lane_k, 128), or (Q, P, lane_k, 128) on P > 1 partitions,
        values unscaled. tables: the group's (Q, rows, 128) tables
        (``pack_query_tables``: float32 for f32, int32 for the other
        codecs) on the engine's device."""
        return self._layout.batch_sweep(
            self.words, tables, self.nreal, self.plan_rows, cfg=self.config,
            block_sublanes=self.fused.block_sublanes, **self._parts)

    def query_batch(self, queries, k: Optional[int] = None,
                    group_size: int = 8,
                    rescore_pool: Optional[int] = None):
        """Batched queries (Q, C) -> (Q, k) indices int32 and values f32,
        tensors on the engine's device, each row sorted descending.

        Each group of ``group_size`` queries is one multi-query sweep (the
        last group runs at its real size). rescore_pool: see query(); a
        group's pool goes to the host, and its queries to a thread pool
        (the native rescore releases the GIL), only once the next group's
        sweep has been enqueued, so the rescore overlaps the sweep.

        Quantization follows the JAX package's batch path: float32 query
        scales (``pack_query_tables``), applied as ``scales *
        value_scale`` in float32. query() uses a float64 scale, so an
        un-rescored value can differ from query()'s in the last bit."""
        user_k = k or self.config.k
        if rescore_pool is None:  # 0 disables explicitly
            rescore_pool = self.config.rescore_pool
        k = max(user_k, rescore_pool) if rescore_pool else user_k
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.num_cols or \
                not len(queries):
            raise ValueError(f"queries must have shape (Q >= 1, "
                             f"{self.num_cols}), got {queries.shape}")
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        idx_all, val_all, futs = [], [], []
        pending = None  # previous group's pool on its way to the host

        def submit(host_idx, copied, q0, n):
            if copied is not None:
                copied.synchronize()
            arr = host_idx.numpy()
            ex = rescore_executor(self)
            for j in range(n):
                futs.append(ex.submit(
                    self._rescore, arr[j], queries[q0 + j], user_k))

        for start in range(0, len(queries), group_size):
            chunk = queries[start:start + group_size]
            padded = np.zeros((len(chunk), self.config.max_cols), np.float32)
            padded[:, : self.num_cols] = chunk
            tabs, scales = pack_query_tables(padded, self.config.query_codec)
            tv, tt = self.batch_candidates(
                torch.from_numpy(tabs).to(self.device))
            idx, vals = finalize_topk_batch(tv, tt, self.row_ids, k=k)
            if rescore_pool:
                if pending is not None:
                    submit(*pending)
                pending = (*_to_host(idx), start, len(chunk))
                continue
            scale = torch.from_numpy(scales).to(self.device)[:, None] * \
                self._value_scale
            idx_all.append(idx)
            val_all.append(vals * scale)
        if rescore_pool:
            submit(*pending)
            outs = [f.result() for f in futs]
            return (torch.from_numpy(np.stack([o[0] for o in outs]))
                    .to(self.device),
                    torch.from_numpy(np.stack([o[1] for o in outs]))
                    .to(self.device))
        return torch.cat(idx_all), torch.cat(val_all)

    def scores(self, vec):
        """Full result A @ vec in row order (no Top-K): a (num_rows,) f32
        tensor on the engine's device.

        Plain SpMV over the stream the sweeps read, so it serves
        load()ed and from_reference_arrays engines too. The scores are
        the sweep's: for h16, 6-bit matrix values times the 4-bit query,
        scaled by the query scale times value_scale; for f32, bf16 matrix
        values times the f32 query; for int8x4, i8s and i4s, bf16 matrix
        values times the 8- or 4-bit query, scaled by the query scale.
        Rows absent from the stream are 0.
        Materializes num_rows floats; prefer query() for similarity
        lookup."""
        table, scale = self._table(vec)
        # one launch stores each score, scaled, straight to its row
        # (padding lanes, row -1, store nothing)
        out = torch.zeros(self.num_rows, dtype=torch.float32,
                          device=self.device)
        return self._layout.scores(
            self.words, table, self.nreal, self.plan_rows, cfg=self.config,
            block_sublanes=self.fused.block_sublanes,
            num_slices=self.row_ids.shape[0],
            num_partitions=self.config.num_partitions, row_ids=self.row_ids,
            scale=scale * self._value_scale, out=out)

    # -- accounting ---------------------------------------------------------

    @property
    def hbm_bytes(self) -> int:
        """Bytes of packed words one query sweep reads."""
        return self.fused.hbm_bytes

    @property
    def bytes_per_nnz(self) -> float:
        return self.hbm_bytes / max(self.num_nnz, 1)


def _to_host(t):
    """Start copying ``t`` to the host: (host tensor, CUDA event recorded
    after the copy, or None when ``t`` is already on the CPU)."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(t.device))
    return host, copied


def rescore_executor(holder):
    """Lazily created thread pool for batched host rescoring, cached on
    ``holder`` (an engine)."""
    ex = getattr(holder, "_rescore_ex", None)
    if ex is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(
            max_workers=min(16, os.cpu_count() or 8),
            thread_name_prefix="rescore")
        holder._rescore_ex = ex
    return ex
