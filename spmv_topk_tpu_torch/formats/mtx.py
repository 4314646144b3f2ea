"""Matrix Market (MTX) I/O.

The reader and writer of ``spmv_topk_tpu.formats.mtx``, carried over:
banner parsing, 1-based -> 0-based indices, pattern matrices (values 1),
symmetric matrices mirrored off the diagonal, row-major sorting. General
files go through the native C++ parser (``runtime/spmv_runtime.cpp``,
``utils/native.py``) when it is built; symmetric and gzipped files take
the NumPy path here.
"""

from __future__ import annotations

import gzip
import io

import numpy as np

from .coo import CooMatrix


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_mtx(path: str, read_values: bool = True) -> CooMatrix:
    """Parse an MTX file into a sorted CooMatrix: ``pattern`` (no values,
    val=1), ``symmetric`` (off-diagonal entries mirrored), general
    real/integer. ``read_values=False`` reads every value as 1."""
    if read_values and not str(path).endswith(".gz"):
        from ..utils import native

        parsed = native.mtx_parse(str(path))
        if parsed is not None:
            rows, cols, vals, num_rows, num_cols = parsed
            return CooMatrix(rows, cols, vals, num_rows, num_cols).sort_row_major()

    with _open(path, "rb") as f:
        header = f.readline().decode()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        tokens = header.strip().split()
        fmt = tokens[2] if len(tokens) > 2 else "coordinate"
        field = tokens[3] if len(tokens) > 3 else "real"
        symmetry = tokens[4] if len(tokens) > 4 else "general"
        if fmt != "coordinate":
            raise ValueError(f"{path}: only coordinate MTX supported")

        line = f.readline()
        while line.startswith(b"%"):
            line = f.readline()
        num_rows, num_cols, nnz = (int(t) for t in line.split())

        pattern = field == "pattern"
        body = f.read()

    data = np.loadtxt(
        io.BytesIO(body), dtype=np.float64,
        usecols=(0, 1) if pattern else (0, 1, 2), ndmin=2, max_rows=nnz,
    )
    rows = data[:, 0].astype(np.int32) - 1
    cols = data[:, 1].astype(np.int32) - 1
    if pattern or not read_values:
        vals = np.ones(len(rows), dtype=np.float32)
    else:
        vals = data[:, 2].astype(np.float32)

    if symmetry == "symmetric":
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, rows[: len(off)][off]])
        vals = np.concatenate([vals, vals[off]])

    return CooMatrix(rows, cols, vals, num_rows, num_cols).sort_row_major()


def write_mtx(path: str, coo: CooMatrix, precision: int = 10) -> None:
    """Write a CooMatrix as a general real coordinate MTX file (gzipped
    when ``path`` ends in ``.gz``)."""
    with _open(path, "wt") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n%\n")
        f.write(f"{coo.num_rows} {coo.num_cols} {coo.nnz}\n")
        chunk = 1 << 20
        for start in range(0, coo.nnz, chunk):
            sl = slice(start, min(start + chunk, coo.nnz))
            lines = [
                f"{r + 1} {c + 1} {v:.{precision}}"
                for r, c, v in zip(coo.rows[sl], coo.cols[sl], coo.vals[sl])
            ]
            f.write("\n".join(lines))
            f.write("\n")
