"""spmv-topk-tpu-torch: the PyTorch/CUDA port of spmv_topk_tpu.

The JAX package's engine (``TopKSpMV``) for every valid
``TopKSpMVConfig``: both fused layouts (slice, the default, and octet),
every query codec (f32, h16, int8x4, i8s, i4s), one partition or several
(``num_partitions``); single queries, batched queries and plain SpMV. Its
device sweeps, and the per-bucket ops over ``pack_sell_buckets``'
buckets (``ops.kernel.topk_spmv_bucket_device`` and its two siblings),
are CUDA kernels written for Hopper (``csrc/``). Beside them the host
modules of the JAX package: the formats (``formats``: SELL, BS-CSR, MTX),
the oracles (``ops.gold``, ``ops.xla_ref``), the host merge (``topk``)
and the metrics (``eval``). Imports torch, numpy and scipy only; corpora
and queries come from numpy generators seeded as in the JAX package, so
both packages see the same data.

Beside it the dense engine (``DenseTopKSpMV``, ``ops.dense``: bf16 or
int8 block products and a per-block top-k) and the sharded engines
(``parallel``: ``ShardedTopKSpMV`` over a list of devices and, across
processes, ``torch.distributed``; ``ShardedDenseTopKSpMV``).

Around them the JAX package's tools: the command line (``python -m
spmv_topk_tpu_torch``, ``cli``), the autotuner (``autotune``), the
benchmark tools (``bench``: the CSV benchmark loop, sweep, serving loop,
CPU baseline and capacity planner), ``utils.profiling`` and the examples
(``examples``).
"""

from .config import (
    TopKSpMVConfig, ValueFormat, DEFAULT_CONFIG, F32, BF16, FIXED32, FIXED8,
    LANES,
)
from .api import TopKSpMV
from .ops.dense import DenseTopKSpMV
from .tune import autotune
from .formats import (CooMatrix, create_query_batch, create_sample_vector,
                      create_sparse_matrix, from_scipy)

__version__ = "0.1.0"
