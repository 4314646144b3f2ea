"""Seeded corpus and queries, made on the device.

The distribution of the port's synthetic generator
(``spmv_topk_tpu_torch/formats/synthetic.py``), frozen here so that a
change to the program cannot move the benchmark's data: per-row degree
Gamma(k=3, theta=d/3) truncated to an integer and clipped to [1,
num_cols], column indices uniform and sorted within each row (a
repeated column adds), values uniform [0, 1) and L2-normalised per row;
queries uniform [0, 1) and L2-normalised.

Drawn with a ``torch.Generator`` on the device in a few large calls, so
one seed on one kind of device gives the same arrays every time. The
bits differ from the NumPy generator's for the same seed; the
distribution is the same.
"""

from __future__ import annotations

import hashlib

import torch

GAMMA_K = 3.0
FIXED = float(2 ** 31)    # squares in fixed point: sums exact to 4.7e-10


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws under ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _generator(device, seed: int, stream: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def degrees(spec: dict, seed: int, device) -> torch.Tensor:
    """(num_rows,) int64 nnz per row."""
    n, c, d = spec["num_rows"], spec["num_cols"], spec["average_degree"]
    if spec["distribution"] != "gamma":
        raise ValueError(f"unknown distribution {spec['distribution']!r}")
    g = _generator(device, seed, "degrees")
    shape = torch.full((n,), GAMMA_K, dtype=torch.float32, device=device)
    deg = (torch._standard_gamma(shape, generator=g) * (d / GAMMA_K)).long()
    return deg.clamp_(min=1, max=c)


def make_corpus(spec: dict, seed: int, device) -> dict:
    """The corpus as row-major sorted COO arrays on ``device``: ``rows``
    and ``cols`` int32, ``vals`` float32, ``indptr`` int64 (num_rows + 1),
    with ``num_rows`` and ``num_cols``."""
    n, c = spec["num_rows"], spec["num_cols"]
    deg = degrees(spec, seed, device)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=indptr[1:])
    nnz = int(indptr[-1])
    rows = torch.repeat_interleave(torch.arange(n, device=device), deg,
                                   output_size=nnz)
    del deg
    g = _generator(device, seed, "cols")
    cols = torch.randint(0, c, (nnz,), generator=g, device=device)
    bits = max(int(c - 1).bit_length(), 1)
    # rows are grouped already: one sort of (row << bits | col) sorts each
    # row's columns
    keys = torch.sort((rows << bits) | cols).values
    del cols
    cols = (keys & ((1 << bits) - 1)).to(torch.int32)
    del keys
    g = _generator(device, seed, "vals")
    vals = torch.rand(nnz, generator=g, device=device)
    if spec.get("l2_norm", True):
        # per-row sums of squares from one scan of the squares in 2^-31
        # fixed point: integer sums are exact in any order, where a float
        # scan on the device is not bitwise the same run to run
        sq = (vals.double().square_() * FIXED).long()
        csum = torch.zeros(nnz + 1, dtype=torch.int64, device=device)
        torch.cumsum(sq, 0, out=csum[1:])
        del sq
        sq = (csum[indptr[1:]] - csum[indptr[:-1]]).double() / FIXED
        del csum
        inv = torch.where(sq > 0, sq.rsqrt(), torch.ones_like(sq)).float()
        vals.mul_(inv[rows])
        del inv, sq
    return dict(rows=rows.to(torch.int32), cols=cols, vals=vals,
                indptr=indptr, num_rows=n, num_cols=c)


def make_queries(num_queries: int, num_cols: int, seed: int, device,
                 stream: str = "queries") -> torch.Tensor:
    """(num_queries, num_cols) float32, each row L2-normalised."""
    g = _generator(device, seed, stream)
    q = torch.rand((num_queries, num_cols), generator=g, device=device)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def checksum(corpus: dict) -> tuple:
    """A fingerprint of the corpus's arrays, for the reference to confirm
    that it regenerated the arrays the program was given."""
    return (int(corpus["vals"].numel()),
            int(corpus["vals"].view(torch.int32).long().sum()),
            int(corpus["cols"].long().sum()),
            int(corpus["indptr"][-1]))
