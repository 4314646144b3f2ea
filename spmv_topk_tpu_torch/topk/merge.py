"""Top-K candidate merging.

The device merge is ``ops.kernel.finalize_topk`` (re-exported here);
``merge_candidates_host`` is the host NumPy merge of
``spmv_topk_tpu.topk.merge``, carried over: the reference design's
read_result (offset, dedupe, sort by value; host_spmv_bscsr.cpp:399-448),
used by the golds and as an oracle of the device merge (for example of
per-bucket candidate lists).
"""

from __future__ import annotations

import numpy as np

from ..ops.kernel import finalize_topk  # noqa: F401 (re-export)


def merge_candidates_host(idx_lists, val_lists, k: int):
    """Merge per-partition candidate lists into a global Top-K.

    Deduplicates by row id keeping the max value, drops ids < 0, then
    sorts by value descending with ascending-index tie-break.
    """
    idx = np.concatenate([np.asarray(i) for i in idx_lists])
    val = np.concatenate([np.asarray(v) for v in val_lists])
    keep = idx >= 0
    idx, val = idx[keep], val[keep]
    # dedupe keeping max value per row
    order = np.lexsort((-val, idx))
    idx, val = idx[order], val[order]
    first = np.ones(len(idx), dtype=bool)
    first[1:] = idx[1:] != idx[:-1]
    idx, val = idx[first], val[first]
    top = np.lexsort((idx, -val))[:k]
    return idx[top].astype(np.int32), val[top].astype(np.float32)
