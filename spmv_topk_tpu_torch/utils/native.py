"""ctypes bindings to the native host runtime (``runtime/spmv_runtime.cpp``).

The O(nnz) host loops of the packer (plan, scatter) and the exact rescore
run in the repository's C++ runtime. This module builds it from the
``runtime/`` sources with its Makefile, into ``build/spmv_topk_tpu_torch/``
under a name that carries a hash of the sources, and loads it. When the
build fails the callers take their NumPy paths (``available()`` says
which); at full scale those paths need several times the packed size in
temporaries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..ops._build import BUILD_DIR

_RUNTIME_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "runtime",
)

_LIB = None
_TRIED = False
load_error = None   # why the library is unavailable (None when loaded)


def _lib_path() -> str:
    h = hashlib.sha256()
    for name in ("Makefile", "spmv_runtime.cpp"):
        with open(os.path.join(_RUNTIME_DIR, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libspmv_runtime-{h.hexdigest()[:16]}.so")


def _load():
    global _LIB, _TRIED, load_error
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _lib_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(["make", "-s", "-C", _RUNTIME_DIR, f"TARGET={tmp}"],
                           capture_output=True, timeout=300, check=True)
            os.replace(tmp, path)   # atomic: concurrent builds agree
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError) as e:
        load_error = repr(e)
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mtx_parse.argtypes = [
        ctypes.c_char_p, i64p, i64p, i64p, i32p, i32p, f32p]
    lib.mtx_parse.restype = ctypes.c_int
    lib.coo_sort_perm.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.coo_sort_perm.restype = None
    lib.sell_plan.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i64p, i64p, i64p]
    lib.sell_plan.restype = None
    lib.sell_scatter.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, i64p, i64p, i64p, i32p,
        ctypes.c_int32]
    lib.sell_scatter.restype = None
    lib.h16_scatter.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, i64p, i64p, i64p,
        ctypes.c_float, i32p, ctypes.c_int32]
    lib.h16_scatter.restype = None
    lib.coo_is_sorted.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32]
    lib.coo_is_sorted.restype = ctypes.c_int32
    lib.csr_rescore.argtypes = [
        i64p, i32p, f32p, f32p, i64p, ctypes.c_int64, f32p]
    lib.csr_rescore.restype = None
    lib.cpu_topk_spmv.argtypes = [
        i64p, i32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i32p, f32p]
    lib.cpu_topk_spmv.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mtx_parse(path: str):
    """(rows, cols, vals, num_rows, num_cols) of an MTX file, or None if
    the native library is unavailable or the file needs the NumPy path
    (symmetric matrices)."""
    lib = _load()
    if lib is None:
        return None
    nr = ctypes.c_int64()
    nc = ctypes.c_int64()
    nnz = ctypes.c_int64()
    rc = lib.mtx_parse(path.encode(), ctypes.byref(nr), ctypes.byref(nc),
                       ctypes.byref(nnz), None, None, None)
    if rc != 0:
        return None
    rows = np.empty(nnz.value, np.int32)
    cols = np.empty(nnz.value, np.int32)
    vals = np.empty(nnz.value, np.float32)
    rc = lib.mtx_parse(path.encode(), ctypes.byref(nr), ctypes.byref(nc),
                       ctypes.byref(nnz), _ptr(rows, ctypes.c_int32),
                       _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_float))
    if rc != 0:
        return None
    return rows, cols, vals, int(nr.value), int(nc.value)


def coo_sort_perm(rows: np.ndarray, cols: np.ndarray, num_cols: int):
    """int64 permutation sorting the entries by (row, col), or None if
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    perm = np.empty(len(rows), np.int64)
    lib.coo_sort_perm(_ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
                      len(rows), num_cols, _ptr(perm, ctypes.c_int64))
    return perm


def sell_plan(degrees: np.ndarray, chunk_sublanes: int, sigma_sort: bool):
    """(perm, rank, slice widths) of the SELL plan, or None if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    degrees = np.ascontiguousarray(degrees, np.int32)
    n = len(degrees)
    num_slices = -(-n // 128)
    perm = np.empty(n, np.int64)
    rank = np.empty(n, np.int64)
    slice_w = np.empty(num_slices, np.int64)
    lib.sell_plan(_ptr(degrees, ctypes.c_int32), n, chunk_sublanes,
                  int(sigma_sort), _ptr(perm, ctypes.c_int64),
                  _ptr(rank, ctypes.c_int64), _ptr(slice_w, ctypes.c_int64))
    return perm, rank, slice_w


def sell_scatter(rows, cols, vals, row_start, rank, slice_off, total_sub,
                 n_threads: int = 0):
    """Threaded (col << 16 | bf16) scatter, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    words = np.zeros((total_sub, 128), np.int32)
    lib.sell_scatter(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), len(rows),
        _ptr(row_start, ctypes.c_int64), _ptr(rank, ctypes.c_int64),
        _ptr(slice_off, ctypes.c_int64), _ptr(words, ctypes.c_int32),
        n_threads)
    return words


def coo_is_sorted(rows: np.ndarray, cols: np.ndarray):
    """Row-major sortedness (duplicates allowed), or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    return bool(lib.coo_is_sorted(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        len(rows), 0))


def h16_scatter(rows, cols, vals, row_start, rank, slice_off, total_sub,
                value_scale: float, n_threads: int = 0):
    """Threaded h16 pair-scatter (2 nnz per int32 word), or None if
    unavailable (NumPy path in formats.sell_buckets._scatter_h16).
    slice_off is in WORD units (pair degrees)."""
    lib = _load()
    if lib is None:
        return None
    words = np.zeros((total_sub, 128), np.int32)
    lib.h16_scatter(
        _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), len(rows),
        _ptr(row_start, ctypes.c_int64), _ptr(rank, ctypes.c_int64),
        _ptr(slice_off, ctypes.c_int64), ctypes.c_float(1.0 / value_scale),
        _ptr(words, ctypes.c_int32), n_threads)
    return words


def cpu_topk_spmv(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                  vec: np.ndarray, k: int, n_threads: int = 0):
    """Threaded fused CPU Top-K SpMV over a CSR (SpMV and a running top-k,
    no score vector). Returns (idx, val) sorted by value desc (ties:
    index asc), or None if the native library is unavailable. indptr
    must be int64, indices int32, data/vec f32."""
    lib = _load()
    if lib is None:
        return None
    num_rows = len(indptr) - 1
    out_idx = np.empty(k, np.int32)
    out_val = np.empty(k, np.float32)
    lib.cpu_topk_spmv(_ptr(indptr, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int32),
                      _ptr(data, ctypes.c_float), _ptr(vec, ctypes.c_float),
                      num_rows, k, n_threads,
                      _ptr(out_idx, ctypes.c_int32),
                      _ptr(out_val, ctypes.c_float))
    return out_idx, out_val


def csr_rescore(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                vec: np.ndarray, sel: np.ndarray):
    """Exact f32 scores of selected CSR rows against a dense query, or
    None if unavailable (NumPy path in api.exact_rescore). indptr must be
    int64, indices int32, data/vec f32, sel int64."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(sel), np.float32)
    lib.csr_rescore(_ptr(indptr, ctypes.c_int64),
                    _ptr(indices, ctypes.c_int32),
                    _ptr(data, ctypes.c_float), _ptr(vec, ctypes.c_float),
                    _ptr(sel, ctypes.c_int64), len(sel),
                    _ptr(out, ctypes.c_float))
    return out
