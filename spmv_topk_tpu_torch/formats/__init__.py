from .coo import CooMatrix, from_scipy
from .synthetic import create_sparse_matrix, create_sample_vector, create_query_batch
from .sell_buckets import pack_sell_buckets, fuse_buckets, fuse_buckets_octet
