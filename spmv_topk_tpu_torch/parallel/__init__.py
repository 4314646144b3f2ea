"""Row-sharded engines over a list of devices (``mesh``) and, across
processes, ``torch.distributed`` (``distributed``): the counterpart of
``spmv_topk_tpu.parallel``."""

from .mesh import AXIS, Mesh, make_mesh
from .sharded_buckets import ShardedBucketedTopKSpMV
from .sharded_dense import ShardedDenseTopKSpMV
from .distributed import initialize_multihost, global_mesh, local_shard_rows

# Public multi-device engine = the fused bucketed layout, as in the JAX
# package (spmv_topk_tpu/parallel/__init__.py:9).
ShardedTopKSpMV = ShardedBucketedTopKSpMV
