"""spmv-topk-tpu-torch: the PyTorch/CUDA port of spmv_topk_tpu.

The single-query Top-K SpMV path of the JAX package (h16 codec, octet
stream, one partition), with its device sweep written as CUDA kernels
for Hopper (``csrc/``). Imports torch, numpy and scipy only; corpora and
queries come from numpy generators seeded as in the JAX package, so both
packages see the same data.
"""

from .config import (
    TopKSpMVConfig, ValueFormat, DEFAULT_CONFIG, F32, BF16, FIXED32, FIXED8,
    LANES,
)
from .api import TopKSpMV
from .formats import (CooMatrix, create_query_batch, create_sample_vector,
                      create_sparse_matrix, from_scipy)

__version__ = "0.1.0"
