"""Dense batch engine: bf16 / int8 block products and a per-block top-k.

The counterpart of ``spmv_topk_tpu.ops.dense``: for corpora whose dense
form fits the device (N * C * 2 bytes at bf16; N * C at int8 with
per-row scales), each query batch sweeps the dense corpus one row block
at a time, keeps each block's top-k per query and merges the blocks'
candidates with one exact top-k.

No kernel of its own: the JAX engine reaches no ``pallas_call`` (an XLA
``dot``, ``approx_max_k`` per block, ``lax.top_k``), and here the block
product is cuBLAS through torch and the selection ``torch.topk``:

  - bf16: ``torch.mm(queries, block.T, out_dtype=torch.float32)`` on the
    card, bf16 operands summed and returned in float32, as the JAX engine
    asks (``preferred_element_type=jnp.float32``); on the CPU the corpus
    is widened to float32 as the JAX engine widens it off the TPU;
  - int8: ``torch._int_mm`` (int8 x int8 -> int32) on the card, the query
    batch padded to a multiple of 8 rows as it needs; on the CPU the same
    exact integer sums in float64. Dequantized with one float32 multiply
    by the row scale (and the query scale at the end), as the JAX engine
    does, so int8 scores match it bit for bit;
  - ``approx_max_k`` becomes an exact per-block ``torch.topk`` (off the
    TPU JAX's ``approx_max_k`` is an exact sort and slice too);
    ``recall_target`` is kept, with the JAX engine's rule for its
    default, and selects nothing here. ``torch.topk`` does not promise
    which of two tied rows it keeps, where ``lax.top_k`` keeps the lower
    row.

On a CUDA device the engine densifies on the card (``densify_device``,
bit for bit ``densify_bf16`` / ``densify_int8`` from the sorted COO), so
the host never holds the dense form; on the CPU it runs the NumPy
functions, copied from the JAX package.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, TopKSpMVConfig
from ..formats.coo import CooMatrix, from_scipy


def densify_bf16(coo: CooMatrix, row_block: int = 1 << 17) -> np.ndarray:
    """COO -> dense bf16-bit uint16 array (each float32 value's top 16
    bits: truncation), built block-wise so the host never materializes
    the f32 dense form at once."""
    out = np.zeros((coo.num_rows, coo.num_cols), np.uint16)
    csr = coo.to_scipy().tocsr()
    for lo in range(0, coo.num_rows, row_block):
        hi = min(lo + row_block, coo.num_rows)
        d = csr[lo:hi].toarray().astype(np.float32)
        out[lo:hi] = (d.view(np.uint32) >> 16).astype(np.uint16)
    return out


def densify_int8(coo: CooMatrix, row_block: int = 1 << 17):
    """COO -> (dense int8 array, per-row f32 scales), built block-wise.

    Per-row symmetric quantization: row r is stored as
    round(A[r] / scale[r]) with scale[r] = max|A[r]| / 127 (1 for an empty
    row), so the int32 product times scale[r] recovers the dot product.
    """
    out = np.zeros((coo.num_rows, coo.num_cols), np.int8)
    scales = np.ones(coo.num_rows, np.float32)
    csr = coo.to_scipy().tocsr()
    for lo in range(0, coo.num_rows, row_block):
        hi = min(lo + row_block, coo.num_rows)
        d = csr[lo:hi].toarray().astype(np.float32)
        m = np.abs(d).max(axis=1)
        s = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
        out[lo:hi] = np.rint(d / s[:, None]).astype(np.int8)
        scales[lo:hi] = s
    return out, scales


def _unique_entries(coo: CooMatrix) -> CooMatrix:
    """Row-major sorted COO with each (row, col) once, the entries of a
    repeated position summed in float32 in their order, ((a + b) + c):
    what ``to_scipy()`` stores for the NumPy densify (scipy's CSR of a
    sorted COO keeps the entries' order and sums duplicates in turn). An
    unsorted COO is summed by ``to_scipy()`` itself. Cached on ``coo``
    (as its sortedness is), so several engines over one corpus sum it
    once."""
    cached = getattr(coo, "_unique", None)
    if cached is not None:
        return cached
    coo._unique = _sum_duplicates(coo)
    return coo._unique


def _sum_duplicates(coo: CooMatrix) -> CooMatrix:
    if not coo.is_sorted_row_major():
        m = from_scipy(coo.to_scipy())
        return m if m.is_sorted_row_major() else m.sort_row_major()
    n = coo.nnz
    if n < 2:
        return coo
    new = np.empty(n, bool)
    new[0] = True
    np.not_equal(coo.rows[1:], coo.rows[:-1], out=new[1:])
    new[1:] |= coo.cols[1:] != coo.cols[:-1]
    starts = np.flatnonzero(new)
    if len(starts) == n:
        return coo
    runs = np.diff(np.append(starts, n))
    vals = coo.vals[starts].copy()
    for j in range(1, int(runs.max())):
        more = runs > j
        vals[more] += coo.vals[starts[more] + j]
    m = CooMatrix(coo.rows[starts], coo.cols[starts], vals, coo.num_rows,
                  coo.num_cols)
    m._sorted = True
    return m


def densify_device(coo: CooMatrix, dtype: str, device, padded_rows=None,
                   row_block: int = 1 << 17):
    """``densify_bf16`` (dtype "bf16": a (padded_rows, C) bfloat16
    tensor, scales None) or ``densify_int8`` ("int8": int8 tensor and
    (padded_rows,) float32 scales) computed on ``device`` from the COO,
    bit for bit the NumPy functions: a block's float32 rows scattered
    from its entries (``_unique_entries``), then the same bit truncation,
    or the same float32 max, division by 127 and by the scale, and round
    half to even (every division by a tensor: torch divides by a scalar
    as a reciprocal multiply). Rows past num_rows are zero (scale 1)."""
    if dtype not in ("bf16", "int8"):
        raise ValueError(f"dtype must be 'bf16' or 'int8', got {dtype!r}")
    dev = torch.device(device)
    m = _unique_entries(coo)
    n, C = m.num_rows, m.num_cols
    padded_rows = n if padded_rows is None else int(padded_rows)
    int8 = dtype == "int8"
    out = torch.zeros((padded_rows, C), dtype=torch.int8 if int8
                      else torch.int16, device=dev)
    scales = (torch.ones(padded_rows, dtype=torch.float32, device=dev)
              if int8 else None)
    # each block's entries; the row bounds in the rows' own type (int64
    # bounds would make searchsorted copy every row index as int64)
    edges = np.searchsorted(m.rows, np.append(
        np.arange(0, n, row_block), n).astype(m.rows.dtype), side="left")
    for i, lo in enumerate(range(0, n, row_block)):
        hi = min(lo + row_block, n)
        s, e = edges[i], edges[i + 1]
        d = torch.zeros((hi - lo, C), dtype=torch.float32, device=dev)
        r = torch.from_numpy(m.rows[s:e] - lo).to(dev).long()
        c = torch.from_numpy(m.cols[s:e]).to(dev).long()
        d.index_put_((r, c), torch.from_numpy(m.vals[s:e]).to(dev))
        if int8:
            mx = d.abs().amax(dim=1)
            sc = torch.where(mx > 0, mx / torch.full_like(mx, 127.0),
                             torch.ones_like(mx))
            out[lo:hi] = torch.round(d / sc[:, None]).to(torch.int8)
            scales[lo:hi] = sc
        else:
            out[lo:hi] = (d.view(torch.int32) >> 16).to(torch.int16)
    return (out, scales) if int8 else (out.view(torch.bfloat16), None)


def _int8_product(blk, q, plain=False):
    """(B, Q) int32 sums of int8 rows ``blk`` (B, C) against int8 queries
    ``q`` (Q, C): ``torch._int_mm`` on the card (the query rows padded to
    a multiple of 8, as it needs); exact float64 sums on the CPU, or
    anywhere with ``plain``."""
    if plain or blk.device.type == "cpu":
        return (blk.double() @ q.double().T).to(torch.int32)
    Q = q.shape[0]
    pad = -Q % 8
    if pad:
        q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    return torch._int_mm(blk, q.T)[:, :Q]


def _float_product(blk, q, plain=False):
    """(Q, B) float32 dot products of rows ``blk`` (B, C) with queries
    ``q`` (Q, C) of the same type: bf16 operands on the card summed and
    returned in float32 (``torch.mm`` with ``out_dtype``); float32 (the
    CPU's widened corpus) by torch.mm; with ``plain``, bf16 operands
    widened to float32 first (every product exact; torch's float32
    products leave TF32 off unless a caller turns it on)."""
    if blk.dtype == torch.bfloat16:
        if plain:
            return torch.mm(q.float(), blk.float().T)
        return torch.mm(q, blk.T, out_dtype=torch.float32)
    return torch.mm(q, blk.T)


def dense_topk_batch(A, queries, num_real=None, row_scales=None,
                     query_scales=None, *, k: int, block_rows: int,
                     recall_target: float = 0.98, plain: bool = False):
    """Top-k rows of A @ queries.T for a (Q, C) query batch.

    A: (N, C) bfloat16 (or float32, the CPU's widened bf16), or int8, in
    which case ``row_scales`` is the (N,) f32 per-row scale of
    densify_int8, ``queries`` the already-quantized (Q, C) int8 batch and
    ``query_scales`` the (Q,) f32 per-query scales (applied to the
    returned values at the end). N a multiple of block_rows. num_real:
    real-row count; pad rows past it score -inf. recall_target: kept for
    the JAX signature; the per-block top-k is exact. plain: the products
    in float64 (int8: exact integer sums) or in float32 from the widened
    bf16 values, on any device: the reference the card's cuBLAS products
    are held to. Returns (indices int32, values f32), each (Q, k).
    """
    Q = queries.shape[0]
    if A.shape[0] % block_rows:
        raise ValueError(f"A has {A.shape[0]} rows, not a multiple of "
                         f"block_rows={block_rows}")
    num_blocks = A.shape[0] // block_rows
    int8_mode = A.dtype == torch.int8
    q = queries if int8_mode else queries.to(A.dtype)
    kb = min(k, block_rows)
    vs, isx = [], []
    for b in range(num_blocks):
        lo = b * block_rows
        blk = A[lo:lo + block_rows]
        if int8_mode:
            s = _int8_product(blk, q, plain).T.float() \
                * row_scales[lo:lo + block_rows][None, :]
        else:
            s = _float_product(blk, q, plain)
        if num_real is not None and lo + block_rows > num_real:
            rows = lo + torch.arange(block_rows, device=s.device)
            s = torch.where(rows[None, :] < num_real, s,
                            torch.full_like(s, float("-inf")))
        v, i = torch.topk(s, kb, dim=1)
        vs.append(v)
        isx.append(i + lo)
    vs = torch.cat(vs, dim=1)                       # (Q, NB * kb)
    isx = torch.cat(isx, dim=1)
    fv, fp = torch.topk(vs, min(k, vs.shape[1]), dim=1)
    if query_scales is not None:
        fv = fv * query_scales[:, None]
    return torch.gather(isx, 1, fp).to(torch.int32), fv


def quantize_queries_int8(queries: np.ndarray, device="cuda"):
    """(Q, C) f32 -> (int8 (Q, C) tensor, (Q,) f32 per-query scales) on
    ``device`` (the card unless the caller asks for the CPU, as the JAX
    function puts its arrays on the default device), quantized on the
    host as the JAX engine does."""
    queries = np.asarray(queries, np.float32)
    m = np.abs(queries).max(axis=1)
    qscales = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
    qi = np.rint(queries / qscales[:, None]).astype(np.int8)
    return (torch.from_numpy(qi).to(device),
            torch.from_numpy(qscales).to(device))


def device_budget(device) -> Optional[int]:
    """~60% of the device's memory (None on the CPU, as JAX's CPU device
    reports no limit)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1] * 0.6)


class DenseTopKSpMV:
    """Matrix-resident dense Top-K engine (single device).

    For batched serving when N * C * 2 bytes (bf16) or N * C (int8) fits
    the device; use TopKSpMV for single-query latency or corpora too
    large to densify. ``device`` is required, as for TopKSpMV.
    """

    def __init__(self, matrix, config: TopKSpMVConfig = DEFAULT_CONFIG, *,
                 device, block_rows: int = 1 << 17,
                 recall_target: Optional[float] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 dtype: str = "bf16"):
        if dtype not in ("bf16", "int8"):
            raise ValueError(f"dtype must be 'bf16' or 'int8', got {dtype!r}")
        if not isinstance(matrix, CooMatrix):
            matrix = from_scipy(matrix)
        device = torch.device(device)
        # cap the block to the (1024-aligned) corpus height so small
        # corpora aren't zero-padded up to a full 131072-row block
        block_rows = min(block_rows, 1 << 20,
                         -(-matrix.num_rows // 1024) * 1024)
        if recall_target is None:
            # the JAX engine's default: 0.95 from 4 row blocks on
            recall_target = (0.95 if -(-matrix.num_rows // block_rows) >= 4
                             else 0.98)
        padded_rows = -(-matrix.num_rows // block_rows) * block_rows
        elt = 1 if dtype == "int8" else 2
        dense_bytes = elt * padded_rows * matrix.num_cols
        budget = hbm_budget_bytes
        if budget is None:
            budget = device_budget(device)
        if budget is not None and dense_bytes > budget:
            raise ValueError(
                f"dense form needs {dense_bytes/1e9:.1f} GB > budget "
                f"{budget/1e9:.1f} GB — use the sparse TopKSpMV engine")
        t0 = time.perf_counter()
        if device.type == "cpu":
            if dtype == "int8":
                bits, scales = densify_int8(matrix)
            else:
                bits, scales = densify_bf16(matrix), None
            A, scales = _upload(bits, scales, padded_rows, device)
        else:
            A, scales = densify_device(matrix, dtype, device, padded_rows)
            torch.cuda.synchronize(device)
        self.densify_seconds = time.perf_counter() - t0
        csr = matrix.to_scipy_csr() if config.rescore_pool else None
        self._init_state(config, dtype, A, scales, matrix.num_rows,
                         matrix.num_cols, matrix.nnz, block_rows,
                         recall_target, csr)

    def _init_state(self, config, dtype, A, scales, num_rows, num_cols,
                    num_nnz, block_rows, recall_target, csr):
        self.config = config
        self.dtype = dtype
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_nnz = num_nnz
        self.block_rows = block_rows
        self.recall_target = recall_target
        self._elt_bytes = 1 if dtype == "int8" else 2
        self._A = A
        self._scales = scales
        # exact rescoring keeps the host CSR and re-ranks the top
        # max(k, pool) candidates with exact f32 dot products
        self._scipy_csr = csr

    @classmethod
    def from_reference_arrays(cls, bits, scales=None, *, num_rows: int,
                              config: TopKSpMVConfig = DEFAULT_CONFIG,
                              device, block_rows: int,
                              recall_target: float, matrix=None):
        """Engine from the JAX engine's dense arrays (``eng._A`` and
        ``eng._scales`` as numpy; ``block_rows``, ``recall_target`` and
        ``num_rows`` its attributes). bits: int8 (with its (N,) f32
        scales), the bf16 bits as uint16, or float32 holding bf16 values
        (the JAX engine's form off the TPU); N, the padded rows, a
        multiple of block_rows. Exact rescoring needs ``matrix``."""
        bits = np.array(bits)      # a writable copy for torch
        if bits.dtype == np.int8:
            dtype = "int8"
            if scales is None or np.shape(scales) != (bits.shape[0],):
                raise ValueError("int8 bits need (N,) scales")
            scales = np.array(scales, np.float32)
        else:
            dtype = "bf16"
            if bits.dtype == np.float32:
                u = bits.view(np.uint32)
                if np.any(u & 0xFFFF):
                    raise ValueError("float32 bits hold values that are "
                                     "not bf16")
                bits = (u >> 16).astype(np.uint16)
            elif bits.dtype != np.uint16:
                raise ValueError(f"bits of {bits.dtype}: need int8, uint16 "
                                 "(bf16 bits) or float32")
            scales = None
        if bits.ndim != 2 or bits.shape[0] % block_rows or \
                not 0 < num_rows <= bits.shape[0]:
            raise ValueError(f"bits {bits.shape}: need (N, C), N a multiple "
                             f"of block_rows={block_rows} and >= num_rows")
        if matrix is not None and not isinstance(matrix, CooMatrix):
            matrix = from_scipy(matrix)
        device = torch.device(device)
        A, sc = _upload(bits, scales, bits.shape[0], device)
        self = cls.__new__(cls)
        self.densify_seconds = 0.0
        csr = (matrix.to_scipy_csr()
               if matrix is not None and config.rescore_pool else None)
        self._init_state(config, dtype, A, sc, num_rows, bits.shape[1],
                         matrix.nnz if matrix is not None else 0,
                         block_rows, recall_target, csr)
        return self

    @property
    def device(self) -> torch.device:
        return self._A.device

    def query_batch(self, queries, k: Optional[int] = None):
        """(Q, C) queries -> (indices int32, values f32), each (Q, k),
        tensors on the engine's device; indices past the real rows -1."""
        user_k = k or self.config.k
        pool = self.config.rescore_pool
        k = max(user_k, pool) if pool else user_k
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.num_cols:
            raise ValueError(f"queries must have shape (Q, {self.num_cols}),"
                             f" got {queries.shape}")
        num_real = (self.num_rows if self._A.shape[0] > self.num_rows
                    else None)
        if self.dtype == "int8":
            qdev, qscales = quantize_queries_int8(queries, self.device)
            idx, vals = dense_topk_batch(
                self._A, qdev, num_real, self._scales, qscales, k=k,
                block_rows=self.block_rows,
                recall_target=self.recall_target)
        else:
            idx, vals = dense_topk_batch(
                self._A, torch.from_numpy(queries).to(self.device),
                num_real, k=k, block_rows=self.block_rows,
                recall_target=self.recall_target)
        # only when k exceeds the number of real rows can pad entries
        # surface; mark them
        idx = torch.where(idx < self.num_rows, idx, torch.full_like(idx, -1))
        if pool:
            if self._scipy_csr is None:
                raise NotImplementedError(
                    "exact rescoring needs the host CSR: pass matrix= to "
                    "from_reference_arrays")
            from ..api import exact_rescore

            host = idx.cpu().numpy()
            outs = [exact_rescore(self._scipy_csr, host[q], queries[q],
                                  user_k) for q in range(len(queries))]
            return (torch.from_numpy(np.stack([o[0] for o in outs]))
                    .to(self.device),
                    torch.from_numpy(np.stack([o[1] for o in outs]))
                    .to(self.device))
        return idx, vals

    def query(self, vec, k: Optional[int] = None):
        """Single query, for API parity: the sweep's cost is per batch, so
        prefer query_batch for throughput."""
        idx, vals = self.query_batch(np.asarray(vec)[None, :], k)
        return idx[0], vals[0]

    @property
    def hbm_bytes(self) -> int:
        """The dense form's bytes on the card (the CPU widens bf16 to
        float32 and holds twice that)."""
        return int(np.prod(self._A.shape)) * self._elt_bytes


def _upload(bits, scales, padded_rows, device):
    """(A, scales) tensors on ``device`` from the NumPy densify's arrays,
    zero rows (scale 1) padded up to ``padded_rows``: int8 as it is,
    bf16 as bfloat16 on the card and widened to float32 on the CPU."""
    pad = padded_rows - bits.shape[0]
    if pad:
        bits = np.concatenate([bits, np.zeros((pad, bits.shape[1]),
                                              bits.dtype)])
        if scales is not None:
            scales = np.concatenate([scales, np.ones(pad, np.float32)])
    if bits.dtype == np.int8:
        return (torch.from_numpy(bits).to(device),
                torch.from_numpy(np.ascontiguousarray(scales)).to(device))
    A = torch.from_numpy(bits.view(np.int16)).to(device).view(torch.bfloat16)
    if device.type == "cpu":
        A = A.float()          # the CPU has no bf16 x bf16 -> f32 product
    return A, None
