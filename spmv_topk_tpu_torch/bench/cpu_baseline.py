"""CPU Top-K SpMV baseline (host only: no torch, no card).

Port of the reference's CPU benchmark (test_cpu.py): load or synthesize
the matrix, build a scipy CSR, run Top-K against random L2-normalized
queries, print the mean time. The reference uses sparse_dot_topn's
awesome_cossim_topn (test_cpu.py:104); this uses it when installed, else
the native runtime's threaded fused loop (``utils.native.cpu_topk_spmv``),
else scipy matvec + argpartition (the same O(nnz + N) work without the
fused loop).

  python -m spmv_topk_tpu_torch.bench.cpu_baseline --rows 100000 -k 100 -t 10
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..formats.synthetic import create_sparse_matrix, create_sample_vector
from ..formats.mtx import read_mtx


def _sparse_dot_topn_fn():
    """Top-K via sparse_dot_topn when installed (reference's CPU anchor,
    test_cpu.py:104), handling both the legacy awesome_cossim_topn and the
    >=1.0 sp_matmul_topn APIs. Returns None when unavailable."""
    try:
        import scipy.sparse as sp
        import sparse_dot_topn as sdt
    except ImportError:
        return None

    def run(csr_t, query, k):
        # top-k rows of A @ q == top_n entries of the single row q @ A^T
        q_csr = sp.csr_matrix(query.reshape(1, -1))
        if hasattr(sdt, "sp_matmul_topn"):           # >= 1.0 API
            res = sdt.sp_matmul_topn(q_csr, csr_t, top_n=k, sort=True)
        else:
            res = sdt.awesome_cossim_topn(q_csr, csr_t, k, 0.0)
        return res.indices[:k], res.data[:k]

    return run


def _native_fn(csr):
    """Fused threaded Top-K SpMV from the native runtime — the stand-in
    for sparse_dot_topn's fused C++ loop when that library is missing
    (runtime/spmv_runtime.cpp::cpu_topk_spmv). Returns None when the .so
    is unavailable."""
    from ..utils import native

    if not native.available():
        return None
    indptr = np.ascontiguousarray(csr.indptr, np.int64)
    indices = np.ascontiguousarray(csr.indices, np.int32)
    data = np.ascontiguousarray(csr.data, np.float32)

    # symbol-availability probe on an empty matrix (stale .so guard)
    probe = native.cpu_topk_spmv(np.zeros(1, np.int64),
                                 np.zeros(0, np.int32),
                                 np.zeros(0, np.float32),
                                 np.zeros(csr.shape[1], np.float32), 1)
    if probe is None:
        return None

    def run(query, k):
        return native.cpu_topk_spmv(
            indptr, indices, data,
            np.ascontiguousarray(query, np.float32), k)

    return run


def topk_cpu(csr, query: np.ndarray, k: int, sdt_fn=None, csr_t=None,
             native_fn=None):
    if sdt_fn is not None:
        return sdt_fn(csr_t, query, k)
    if native_fn is not None:
        return native_fn(query, k)
    scores = csr @ query
    idx = np.argpartition(-scores, min(k, len(scores) - 1))[:k]
    idx = idx[np.argsort(-scores[idx], kind="stable")]
    return idx.astype(np.int32), scores[idx].astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--matrix")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--deg", type=int, default=20)
    ap.add_argument("--dist", default="gamma")
    ap.add_argument("-k", type=int, default=100)
    ap.add_argument("-t", "--num-tests", type=int, default=10)
    args = ap.parse_args(argv)

    coo = (read_mtx(args.matrix) if args.matrix else
           create_sparse_matrix(args.rows, args.cols, args.deg, args.dist, seed=1))
    csr = coo.to_scipy()
    sdt_fn = _sparse_dot_topn_fn()
    # the transpose is part of the resident index, not the per-query cost
    csr_t = csr.T.tocsr() if sdt_fn is not None else None
    native_fn = _native_fn(csr) if sdt_fn is None else None

    times = []
    for it in range(args.num_tests):
        q = create_sample_vector(coo.num_cols, seed=it)
        t0 = time.perf_counter()
        topk_cpu(csr, q, args.k, sdt_fn=sdt_fn, csr_t=csr_t,
                 native_fn=native_fn)
        times.append(time.perf_counter() - t0)
    mean_s = float(np.mean(times[min(2, len(times) - 1):]))
    print(json.dumps(dict(
        metric="cpu_topk_spmv", mean_ms=round(mean_s * 1e3, 3),
        gnnz_per_sec=round(coo.nnz / mean_s / 1e9, 3), nnz=coo.nnz, k=args.k,
        backend=("sparse_dot_topn" if sdt_fn is not None else
                 "native_threaded" if native_fn is not None else
                 "scipy_fallback"),
        sparse_dot_topn_available=sdt_fn is not None,
    )))


if __name__ == "__main__":
    main()
