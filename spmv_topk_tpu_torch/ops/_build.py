"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

``csrc/*.cu`` compile with nvcc into one shared library with a plain C
interface under ``build/spmv_topk_tpu_torch/`` beside the package, at the
first launch of any kernel. The file name carries a hash of the sources
and flags, so an edited source builds anew. Nothing here runs at import:
a host without nvcc or a card imports every module of the package, and
only a launch on a CUDA tensor needs the library.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``; ``check`` raises when
that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "spmv_topk_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None
build_seconds = None   # wall seconds of the nvcc build in this process
                       # (0.0 when a built library was reused)

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64
# name -> argtypes of each C entry point (all return int: cudaError_t)
_SIGNATURES = {
    "octet_topk_h16": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
                       _i32, _vp, _vp, _vp],
    "stream_words": [_vp, _i64, _vp, _i32, _vp],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))):
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libspmv_topk_kernels-{h.hexdigest()[:16]}.so")


def nvcc_version() -> str:
    """The 'release' line of `nvcc --version`."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip().splitlines()[-1]


def lib():
    """The loaded kernel library, built first if needed."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    path = library_path()
    t0 = time.perf_counter()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, path)   # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    so = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = so
    return so


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
