"""The Top-K sweep kernels' share of their roofline, in %: the least time
the traced requests' work needs (``benchmark/roofline.py``: each nnz read
once a request at its codec's width, the query tables and the answers;
2 x nnz x queries operations) over the device time of the program's sweep
kernels (K7 ``slice_topk_kernel``, K8 ``slice_topk_batch_kernel``, and the
octet and per-bucket sweeps) in the traced window."""

SWEEPS = ("slice_topk_kernel", "slice_topk_batch_kernel", "octet_topk_kernel",
          "octet_topk_batch", "bucket_topk")


def is_sweep(name):
    return any(s in name for s in SWEEPS) and "at::" not in name


def read(ctx):
    t = ctx.trace
    if t is None or not t.requests:
        return None
    busy = t.seconds(t.kernels(is_sweep))
    if busy <= 0:
        return None
    least = ctx.roofline.least_seconds(*ctx.request_work()) * t.requests
    return 100.0 * least / busy
