from .coo import CooMatrix, from_scipy, from_dense
from .mtx import read_mtx, write_mtx
from .synthetic import create_sparse_matrix, create_sample_vector, create_query_batch
from .bscsr import pack_bscsr, pack_bscsr_partition, unpack_bscsr_partition, BscsrPartition
from .sell import pack_sell, unpack_sell, SellMatrix
from .sell_buckets import pack_sell_buckets, fuse_buckets, fuse_buckets_octet
