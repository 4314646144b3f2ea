"""The yardstick's bytes, operations and least time, worked out by hand."""

import pytest

from benchmark import roofline


def test_bytes_and_operations_of_a_small_problem():
    # 1,000 nnz, 128 columns, 2 queries, top 10, f32 queries:
    # 1,000 x 4 B of matrix + 2 x 128 x 4 B of queries + 2 x 10 x 8 B of
    # answers; 2 x 1,000 x 2 multiply-adds
    assert roofline.work(1000, 128, 2, 10, "f32") == (5184.0, 4000.0)
    # i8s reads a byte a query value; h16 two bytes an nnz, half a byte a
    # query value
    assert roofline.work(1000, 128, 2, 10, "i8s") == (4416.0, 4000.0)
    assert roofline.work(1000, 128, 1, 10, "h16") == (2144.0, 2000.0)


def test_least_time_is_the_larger_bound():
    nbytes, flops = 3.35e12, 67e12 / 2       # 1 s of bytes, 0.5 s of work
    assert roofline.least_seconds(nbytes, flops) == pytest.approx(1.0)
    assert roofline.bound_by(nbytes, flops) == "bytes"
    assert roofline.least_seconds(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_by(1.0, 67e12) == "operations"


def test_the_cells_bounds():
    # a 64-query request on 195M nnz is bound by its operations, a single
    # query by its bytes
    b, f = roofline.work(195_000_000, 1024, 64, 100, "i8s")
    assert roofline.bound_by(b, f) == "operations"
    assert roofline.least_seconds(b, f) == pytest.approx(
        2 * 195e6 * 64 / 67e12)
    b, f = roofline.work(195_000_000, 1024, 1, 100, "f32")
    assert roofline.bound_by(b, f) == "bytes"
    assert roofline.least_seconds(b, f) == pytest.approx(
        (195e6 * 4 + 4096 + 800) / 3.35e12)
