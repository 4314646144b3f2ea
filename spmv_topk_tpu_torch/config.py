"""Runtime configuration of the Top-K SpMV engine (PyTorch/CUDA port).

Field for field the same dataclasses as ``spmv_topk_tpu.config``, with the
same defaults and validation, so that ``dataclasses.asdict`` of one config
is the ``meta["config"]`` of a snapshot that loads in either package (see
``spmv_topk_tpu/config.py`` for what each knob means).

Two fields keep their names and values only for that snapshot format:
``interpret`` (the port picks a kernel or its plain version from the
device of the tensors it is given) and ``octet_multicall`` (the port
sweeps every bucket in one launch; both values give the same candidates).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# a slice is 128 rows, one per lane of the packed stream
LANES = 128


@dataclasses.dataclass(frozen=True)
class ValueFormat:
    """Reduced-precision storage format of matrix values."""

    kind: str = "bf16"          # "f32" | "bf16" | "fixed"
    fixed_width: int = 32       # total bits of the emulated ap_ufixed
    fixed_integer_part: int = 1  # integer bits


F32 = ValueFormat("f32")
BF16 = ValueFormat("bf16")
FIXED32 = ValueFormat("fixed", fixed_width=32)
FIXED8 = ValueFormat("fixed", fixed_width=8)


@dataclasses.dataclass(frozen=True)
class TopKSpMVConfig:
    """All design knobs of the Top-K SpMV engine (same fields as
    ``spmv_topk_tpu.config.TopKSpMVConfig``)."""

    k: int = 100
    lane_k: int = 8
    num_partitions: int = 1
    value_format: ValueFormat = BF16
    max_cols: int = 1024
    slice_height: int = LANES
    chunk_sublanes: int = 8
    block_sublanes: int = 512
    sigma_sort: bool = True
    layout: str = "bucketed"
    fused_block_sublanes: int = 1024
    width_quantum: int = 8
    query_codec: str = "f32"
    tie_safe_topk: Optional[bool] = None
    rescore_pool: Optional[int] = None
    fused_layout: str = "slice"
    octet_multicall: bool = True
    fold_tile: int = 1
    batch_subgroup: int = 0
    interpret: Optional[bool] = None

    def __post_init__(self):
        if self.tie_safe_topk is None:
            # tie-heavy score domain (h16 small-integer scores) with no
            # exact re-ranking behind it -> keep first-of-ties
            object.__setattr__(
                self, "tie_safe_topk",
                self.query_codec == "h16" and not self.rescore_pool)
        if self.layout != "bucketed":
            raise ValueError(
                f"unknown layout {self.layout!r}: 'bucketed' is the one "
                "production format")
        if self.max_cols % LANES != 0:
            raise ValueError(f"max_cols must be a multiple of {LANES}")
        if self.block_sublanes % self.chunk_sublanes != 0:
            raise ValueError("block_sublanes must be a multiple of chunk_sublanes")
        if self.slice_height != LANES:
            raise ValueError("slice_height must equal the lane count (128)")
        if self.query_codec == "i8s" and self.max_cols > 1024:
            raise ValueError("i8s codec supports max_cols <= 1024 "
                             "(table-row select is a single sign bit)")
        if self.query_codec == "i4s" and self.max_cols > 2048:
            raise ValueError("i4s codec supports max_cols <= 2048")
        if self.query_codec == "h16" and self.max_cols > 1024:
            raise ValueError("h16 codec supports max_cols <= 1024 "
                             "(10-bit column field)")
        if self.query_codec not in ("f32", "int8x4", "i8s", "i4s", "h16"):
            raise ValueError(f"unknown query codec {self.query_codec!r}")
        if self.width_quantum not in (1, 2, 4, 8):
            raise ValueError("width_quantum must be 1, 2, 4 or 8")
        if self.fold_tile not in (1, 2, 4, 8):
            raise ValueError("fold_tile must be 1, 2, 4 or 8")
        if self.fused_layout not in ("slice", "octet"):
            raise ValueError("fused_layout must be 'slice' or 'octet'")
        if (self.fused_layout == "octet" and self.num_partitions > 1
                and not self.sigma_sort):
            raise ValueError(
                "fused_layout='octet' with num_partitions>1 requires "
                "sigma_sort=True: the shared partition skeleton cannot "
                "hold duplicate bucket widths in the transposed stream "
                "(unsorted rows produce positional same-width buckets)")
        if self.fused_layout == "octet" and self.fold_tile in (2, 4):
            raise ValueError(
                "the octet layout's fold is intrinsically top-3-of-8 "
                "(fold_tile=8) or exact (fold_tile=1); 2/4 are not "
                "expressible in the transposed stream")
        if self.batch_subgroup < 0:
            raise ValueError("batch_subgroup must be >= 0")


DEFAULT_CONFIG = TopKSpMVConfig()
