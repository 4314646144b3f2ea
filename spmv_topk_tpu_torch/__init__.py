"""spmv-topk-tpu-torch: the PyTorch/CUDA port of spmv_topk_tpu.

The JAX package's engines on one partition, the slice layout (codecs
f32 and h16; the default ``TopKSpMVConfig()``) and the h16 octet layout:
single queries, batched queries and plain SpMV, with their device sweeps
written as CUDA kernels for Hopper (``csrc/``). Imports torch, numpy and
scipy only; corpora and queries come from numpy generators seeded as in
the JAX package, so both packages see the same data.
"""

from .config import (
    TopKSpMVConfig, ValueFormat, DEFAULT_CONFIG, F32, BF16, FIXED32, FIXED8,
    LANES,
)
from .api import TopKSpMV
from .formats import (CooMatrix, create_query_batch, create_sample_vector,
                      create_sparse_matrix, from_scipy)

__version__ = "0.1.0"
