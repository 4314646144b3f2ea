"""The least time a request's work needs on one NVIDIA H100, counted from
the problem and never from the program's packed stream.

A Top-K SpMV of Q queries against a matrix of nnz entries and C columns
reads each nnz once at its codec's unpadded width, each query's values
once, and writes each answer (an int32 row and a float32 value) once;
it multiplies and adds once per nnz and query. The least time is the
larger of the bytes at the card's memory bandwidth and the operations at
its float32 rate outside the tensor cores.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12          # float32, CUDA cores

# bytes of one nnz at the codec's unpadded width: a bf16 value and a
# 16-bit column; h16 packs a 6-bit value and a 10-bit column
NNZ_BYTES = {"f32": 4, "int8x4": 4, "i8s": 4, "i4s": 4, "h16": 2}
# bytes of one query value as the codec reads it
QUERY_BYTES = {"f32": 4.0, "int8x4": 1.0, "i8s": 1.0, "i4s": 0.5,
               "h16": 0.5}
ANSWER_BYTES = 8             # int32 row + float32 value


def work(nnz: int, num_cols: int, queries: int, k: int,
         codec: str) -> tuple[float, float]:
    """(bytes, operations) of one request of ``queries`` queries."""
    nbytes = (nnz * NNZ_BYTES[codec] + queries * num_cols * QUERY_BYTES[codec]
              + queries * k * ANSWER_BYTES)
    return float(nbytes), 2.0 * nnz * queries


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)


def bound_by(nbytes: float, flops: float) -> str:
    return ("bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_FLOPS
            else "operations")
