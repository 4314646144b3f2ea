#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spmv_topk_tpu_torch) on one GPU.

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py bucket_small bucket_path # those and their needs

Builds the CUDA kernels from ``spmv_topk_tpu_torch/csrc`` and the native
host runtime from ``runtime/``, then prints one JSON object per phase.
Phase names on the command line (``PHASES``) run those phases and what
they need (``PHASE_NEEDS``; the 10M corpus, its queries and gold sets
come with any full-size phase), then the launch counts, the kernels line
of the kernels those phases measured, and the ``ok`` line; with none,
every phase runs:

  1. environment: card, power limit, torch / CUDA / nvcc versions, whether
     the native runtime loaded, kernel build seconds, each kernel's
     registers and spill bytes;
  2. kernels vs their plain PyTorch versions on a 50k-row h16 octet
     corpus (tie-safe buffers, so per-lane values must agree bit for bit;
     K4's scores bit for bit in slice order and in row order, and
     ``scores()`` bit for bit against the path before the row-order
     store, the kernel's slice order and a torch scatter), once more with
     blocks small enough
     to force wide octets; K6 on 5 queries in uneven subgroups (h16
     ignores them), and K6 h16 with production buffers against its slot
     plain on the kernel's grid, tags included;
     then the slice-layout kernels K7, K8 (5 queries in uneven subgroups)
     and K9 the same way: h16 at quantum 2 with fold 8 and fold 1, f32 at
     quantum 8 on integer-valued data (exact in any summation order)
     and on real values (the plain version sums in the kernels' order),
     wide slices, and blocks past the unroll threshold (K9 in both store
     forms; no K9 or K4 instantiation may spill);
  2b. ``k1_small``: K1 and K10b (P = 3) with their lane merge on the
     card against their slot plain (``octet_topk_slots_plain`` on the
     kernel's grid) at 50k rows, tie-safe and production buffers, tags
     included, every codec (f32 at 65,536 columns too), fold 1 and 8,
     lane_k 4, 8 and 16, wide octets, the unmerged launch's slots too;
     every K1 instantiation's registers (none may spill);
  2c. ``k7_small``: K7 and K10a (P = 3) the same way against
     ``slice_topk_slots_plain`` (every codec, fold 1, 2 and 8, lane_k 4,
     8 and 16, wide slices, f32 at 65,536 columns); every K7
     instantiation's registers and K3's (none may spill). The other small
     slice phases hold K7 to its slot plain too (``_slice_agree``), tie-safe
     and not;
  2d. ``k6_small``: K6 and K10d (P = 2) for f32, int8x4, i8s and i4s
     the same way against ``octet_topk_batch_slots_plain`` on the
     kernel's grid (fold 1 and 8, lane_k 4, 8 and 16, wide octets of 8-
     and 3-chunk spans, 1, 5 and 33 queries, f32 and int8x4 at 65,536
     columns: every (kernel codec, pass) of ``k6_pass``), the unmerged
     launch's slots too; every K6 instantiation's registers (none may
     spill);
  3. the main path at full size: the 10M x 1024 gamma corpus (seed 1) in
     the headline config, 32 queries through ``TopKSpMV.query()`` held
     against the exact scipy top-100, sweep and end-to-end times, and the
     stream floor of the same words;
  4. K1 and K3 timed against their plain versions at the main-path
     shapes, and checked against them there; K1 alone on the card with
     and without its lane merge, the ``torch.topk`` merge of its slots
     (the route before the merge moved onto the card), its production
     buffers against its slot plain; K3's library yardstick (one
     ``torch`` int32 sum of the words' chunks, equal to K3's checksum)
     and K3 alone on the card;
  5. the batch path on the same engine: ``query_batch`` of the 32 queries
     in one group against the same gold sets and against ``query()``,
     K6 against its plain version, and the ``batch32_*`` numbers of
     ``bench.py`` (256 queries in groups of 32, with and without the
     rescore); K6 h16 alone on the card with and without its lane merge
     (and the ``torch.topk`` merge of its slots), at 32 and 64 queries,
     the registers and spills of its instantiations (none may spill),
     its stream reads per group and slots;
  6. the scores path: ``scores()`` of one query (a zero fill and one K4
     launch that stores to row order) on the host clock and between CUDA
     events, against the exact f32 product and bit for bit against the
     path before the row-order store (timed too); K4 against its plain
     version in both store forms, each timed beside its bound (the slice
     engines do the same with K9);
  7. partitioned engines (``num_partitions`` > 1) at 50k rows, P = 3 and
     4: K10a-d (K1, K6, K7, K8 with a partition axis; the batch ones on
     5 queries) and the partitioned K4/K9 against
     their plain versions, tie-safe, bit-equal: octet h16 at fold 8 and
     fold 1, slice h16 at quantum 2, slice f32 on integer-valued and on
     real data, wide octets and wide slices, and at least one partition
     holding a bucket with no real slice; then f32 K7, K8, K9 at 65,536
     columns (tables read from global memory) on one and two partitions;
  8. the query codecs at 50k rows: K7, K8 (5 queries), K9 for int8x4, i8s
     and i4s, and K1, K6, K4 for f32, int8x4, i8s and i4s at fold 8 and,
     with wide octets, fold 1, wide slices, int8x4 at 1536 columns and
     i4s at 2048 (tables of several rows) and P = 3 partitions of each
     stream, all against their plain versions, tie-safe, bit-equal;
  9. the library yardsticks on the 10M corpus: one ``torch.sparse.mm`` of
     its CSR (the SpMV kernels' counterpart), and that plus
     ``torch.topk`` (the Top-K sweeps'), for 1, 8 and 32 queries; timed
     only, used nowhere in the port;
 10. the slice-layout engines on the 10M corpus, each built from its
     config and driven alike (``phase_slice_engine``): ``bench.py``'s
     batch engine (h16, quantum 2, fold 8, pool 400); the default engine
     ``TopKSpMVConfig(k=100, max_cols=1024)`` (f32, no rescore), and the
     same on 2 partitions (K10a, K10c, the partitioned K9); the c3 and
     c8 deployments of ``spmv_topk_tpu/bench/full_eval.py`` (i8s and i4s
     at quantum 4; c8 with pool 400, its 50M rows cut to this corpus);
     c3's geometry with the int8x4 codec (``bench/sweep.py``'s codec
     flag). Each: 32 ``query()`` against the exact and the bf16-matrix
     top-100, ``query_batch`` in groups of 32 (rescored engines, with the
     ``batch32_*`` numbers) or 8, one ``scores()``, K7, K8 (on the path's
     group) and K9 held to and timed against their plain versions, K3 on
     the words; K7 and K8 alone on the card with and without their lane
     merge, the ``torch.topk`` merge of their slots, their production
     buffers against their slot plains, their slots' balance (``k7_deal``
     against the old round-robin), K8's grid, passes, registers and spills;
     on 2 partitions the same config with the int8x4 codec too (its words
     the f32 engine's), its 32 ``query()`` and its ``query_batch`` in
     groups of 8 a path of its own (K10a, K10c), both held and timed on it
     as K7 and K8 are; an engine without a rescore is held to its plain
     path bit for bit, and its ``query_batch`` to its ``query()``;
 11. the octet-layout engines on the 10M corpus, each built from its
     config and driven alike (``phase_octet_engine``): the headline
     config on 2 partitions (K10b, K10d, the partitioned K4), the same
     with the f32 codec (``partitioned_octet_f32_path``), and with each
     other codec (f32, int8x4, i8s, i4s). Each: 32 ``query()`` against
     the exact top-100, ``query_batch`` of the 32 in one group and the
     ``batch32_*`` numbers, one ``scores()``, the three kernels held to
     and timed against their plain versions on the path's shapes (K6 on
     its group of 32), K1 (K10b) and K6 (K10d) alone on the card with and
     without their merge and against their slot plains (K6's first 4
     queries of the group), K6's pass, slots and registers, K3 and its
     library yardstick on the words;
 12. the per-bucket ops K11, K13, K12 over every bucket of
     ``pack_sell_buckets``: at 50k rows every codec against their plain
     versions, tie-safe, bit for bit (lane_k 4, 8, 16; a bucket of one
     slice per block; quantum 2, widths below 8 scoring 0; 2-3-row
     tables; f32 and int8x4 at 65,536 columns), K13 and K12 tie-safe or
     not against their plain versions on the kernels' slots
     (``bucket_topk_slots_plain``, ``bucket_topk_batch_slots_plain``),
     tags included, K12 on 5 queries and on 1 and 33 (every (kernel
     codec, pass) of ``k12_pass``), its unmerged launch's slots too, and
     every K12 and K11 instantiation's registers (none may spill); on the
     10M corpus the default config (32 queries through K13, stacked and
     finalized once, against ``merge_candidates_host``, the bf16 top 100
     and the default engine; K12 on a group of 8 against K13 and against
     its slot plain; K11 against K9) and h16 at quantum 8 (K13, the exact
     rescore of a pool of 400; K12 on a group of 8 against its slot
     plain), each op timed summed over its buckets; K13, K12 and K11 also
     alone on the card (K13 whole, per bucket, with num_real 0; K12 with
     and without its lane merge, and the ``torch.topk`` merge of its
     slots), beside K3 per bucket, with K13's host enqueue time and the
     registers and spill bytes of the kernels' instantiations;
 13. the measurement labs (``spmv_topk_tpu_torch/experiments``: kernel_lab
     L7, fused_lab L4, h16_lab L5, fold_lab L3, batch_lab L1, dma_lab L2,
     i16_probe L6, mxu_gather_lab L8): ``labs_small`` holds every
     variant (and every fold of kernel_lab and fused_lab) against its plain
     version at 8 lab blocks, on the default CUDA blocks and on 3 (the
     grid stride folding several lab blocks into one buffer), on the
     labs' own words and on them with integer, real and tiny
     (near-denormal) values, fold_lab with a limit that cuts the last
     block, and fused_lab's v_prod (K7) on finite words; batch_lab at 16
     and 4 queries, dma_lab's four (BS, T) cases (its plain version in
     the kernel's order of CUDA blocks), i16_probe's five variants and
     mxu_gather_lab's VPU arm at 32 and 64 chunks, bit for bit; ``sass``
     counts the instructions nvcc made of batch_lab's and i16_probe's
     variants (does ``cur`` share ``shared``'s decode; is ``g16x``
     ``g16``) and of K6 h16's decode of one word for 32 queries;
     ``labs`` times each lab's variants on 1 GiB of its words
     (4096 lab blocks for L7, L4, L5, L3; 2048 for L1 and L6; 2**21 rows
     for L2; L8 at 32 and 512 chunks with its one-hot arm, and at 65536
     without it) beside K3 and its library yardstick on
     the same words, each kernel alone and with its wrapper's merge, and
     checks each against its plain version at that size (kernel_lab,
     fused_lab and dma_lab on the words with real values);
 14. the dense engine (``DenseTopKSpMV``; ``dense``): at 50k rows each
     dtype's densify on the card against the NumPy densify and its
     query_batch against its plain products (int8 bit for bit, bf16 to
     rtol 1e-5); on the 10M corpus int8 under ``bench.py``'s 12 GiB
     budget (which refuses bf16) and bf16 under the card's own, raw
     batches of 64 and 256, ms a query and precision@100;
 15. the sharded engines on positions of the one card (``sharded_*``):
     the octet h16 headline at D = 1 (held to ``TopKSpMV``'s answers) and
     D = 4 (held to D = 1's; saved, loaded, held to itself), the default
     slice f32 engine at D = 1 (held to ``TopKSpMV``) and D = 4, c3's
     i8s and the headline with i4s at num_partitions = 2 (K10a-d held to
     and timed against their plain versions; c3 over an NCCL group of one
     process with ``exchange_skeleton=True``); ``sharded_dense``: int8 at
     D = 1 and 4, held to ``DenseTopKSpMV``;
 16. ``pack16_lab``: L9's six cases bit for bit against their plain
     versions, then the lab's own timing run; ``sass`` holds each case's
     512 rounds of every chain;
 17. the launch counts of each path's run (counts set to 0 just before
     a path is driven, read just after).

Then the kernel summary (each kernel's time, its plain version's, the
least time the card could take for the same work and what bounds it, and
the library yardstick's time; each codec's numbers nested under its
kernel's h16 entry), the ``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed check raises, so
the run exits non-zero with no ``ok`` line; so does a host without CUDA.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(k=100, lane_k=8, num_partitions=1, max_cols=1024,
                query_codec="h16", fused_layout="octet", width_quantum=2,
                fused_block_sublanes=1024, fold_tile=8, rescore_pool=400)
FULL_ROWS, NUM_COLS, AVG_DEG, CORPUS_SEED = 10_000_000, 1024, 20, 1
NUM_QUERIES, QUERY_SEED = 32, 3
MIN_PRECISION = 0.98
BATCH_GROUP, BATCH_GROUPS, BATCH_SEED = 32, 8, 6
# bench.py's batch engine (bench.py:295-303): the slice layout
SLICE_BATCH = dict(k=100, lane_k=8, num_partitions=1, max_cols=1024,
                   query_codec="h16", fused_layout="slice",
                   width_quantum=2, fused_block_sublanes=1024, fold_tile=8,
                   rescore_pool=400)
# the default engine ranks by bf16 matrix values: its floor is against
# the top-100 of the bf16-rounded matrix
MIN_PRECISION_BF16 = 0.95
DEFAULT_GROUP = 8      # query_batch's default group size
# the default engine: TopKSpMVConfig(k=100, max_cols=1024), nothing else
# set (slice layout, f32 codec, quantum 8, fold 1, no rescore)
DEFAULT = dict(k=100, max_cols=NUM_COLS)
PARTITIONS = 2         # the partitioned paths (tests/test_tpu_smoke.py:107)
# the quantized-codec deployments of spmv_topk_tpu/bench/full_eval.py: c3
# (:174-191, on this very corpus) and c8 (:263-275, 50M rows there, cut to
# this corpus's 10M to keep the run's time)
C3 = dict(k=100, max_cols=1024, query_codec="i8s", width_quantum=4)
C8 = dict(k=100, max_cols=1024, query_codec="i4s", width_quantum=4,
          rescore_pool=400)
# the int8x4 codec of bench/sweep.py (:79) at c3's geometry
INT8X4 = dict(C3, query_codec="int8x4")
# the f32 column field's width: the widest f32 table (256 KB), and the
# widest int8x4 table (128 rows, 64 KB)
F32_MAX_COLS = 65536
# the kernel codecs of the single-query sweeps (int8x4_global is the batch
# sweeps' only)
SINGLE_QUERY_CODECS = {"h16", "f32", "f32_global", "int8x4", "i8s", "i4s"}
# NVIDIA's data sheet for the H100 SXM (at its 700 W limit): HBM3 bytes
# per second, and float32 operations per second outside the tensor cores
# (the rate used for the sweeps' multiply-adds of either codec)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# integer instructions a second: 64 INT32 lanes an SM a clock (the Hopper
# white paper's INT32 33.5 TOPS, SXM5, counts a multiply-add as two)
INT32_INSTR_PER_S = 16.75e12
# integer instructions of the h16 batch decode a word and query beside its
# two shared-memory gathers (csrc/lab_batch.cu's bound: the nibble shifts,
# the products and their sum), for the labs L1 and L8
H16_BATCH_INT_OPS = 10


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    """Milliseconds per fn() over a run of `reps` back-to-back calls
    between two CUDA events (the host enqueues ahead of the card, so
    launch overhead hides unless it exceeds the device time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_lanes(kv, kt, pv, pt):
    """Max |kernel - plain| over the per-lane sorted values, after
    requiring bit-equal values and equal (value, tag) pairs above each
    lane's smallest kept value (the tie that decides that last slot may
    keep a different tag)."""
    kv, kt, pv, pt = (x.cpu().numpy() for x in (kv, kt, pv, pt))
    require(np.array_equal(kv, pv, equal_nan=True),
            "kernel per-lane sorted values equal the plain version's")
    for lane in range(kv.shape[1]):
        floor = pv[:, lane].min()
        a = sorted(zip(kv[:, lane][kv[:, lane] > floor].tolist(),
                       kt[:, lane][kv[:, lane] > floor].tolist()))
        b = sorted(zip(pv[:, lane][pv[:, lane] > floor].tolist(),
                       pt[:, lane][pv[:, lane] > floor].tolist()))
        require(a == b, f"lane {lane} (value, tag) pairs above its floor")
    fin = np.isfinite(pv)
    return float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0


def compare_pools(kv, kt, pv, pt):
    """``compare_lanes`` for each (lane_k, 128) pool of (..., lane_k, 128)
    buffers (queries, partitions: a pool per partition, never merged
    across them); the largest error."""
    require(kv.shape == pv.shape, f"kernel pools {tuple(kv.shape)} match "
            f"the plain version's {tuple(pv.shape)}")
    shape = (-1, *kv.shape[-2:])
    return max(compare_lanes(*bufs) for bufs in
               zip(*(x.reshape(shape) for x in (kv, kt, pv, pt))))


def bound(nbytes, ops, int_ops=0):
    """The least time, ms, the card could take to move ``nbytes`` once,
    do ``ops`` float operations and issue ``int_ops`` integer
    instructions, and which bounds it (bytes, or operations)."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = max(ops / F32_OPS_PER_S, int_ops / INT32_INSTR_PER_S) * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def sweep_bound(eng, queries, out_bytes):
    """``bound`` of a sweep over ``eng``'s words for ``queries`` queries:
    the words and the queries' tables (``_table_spec``) read once,
    ``out_bytes`` written, a multiply and an add per nnz per query."""
    from spmv_topk_tpu_torch.ops.kernel import _table_spec

    table = _table_spec(eng.config)[0] * 128 * 4
    return bound(eng.hbm_bytes + queries * table + out_bytes,
                 2 * eng.num_nnz * queries)


def topk_out_bytes(eng, queries):
    """(value, tag) pairs of the merged per-lane pools."""
    return queries * eng.config.num_partitions * eng.config.lane_k * 128 * 8


def _e2e_ms_per_query(eng, many, group, **kw):
    """Best of 3 host-clock runs of ``query_batch`` over ``many`` in
    groups of ``group``, per query."""
    import torch

    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, v = eng.query_batch(many, group_size=group, **kw)
        v.cpu()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / len(many)


def phase_environment():
    import torch

    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.utils import native

    _build.lib()
    env = dict(phase="environment", nvidia_smi=smi_line(),
               torch=torch.__version__, cuda=torch.version.cuda,
               nvcc=_build.nvcc_version(),
               device=torch.cuda.get_device_name(0),
               native_runtime=native.available(),
               native_error=native.load_error,
               kernel_build_seconds=_build.build_seconds,
               kernel_source_seconds=_build.source_seconds,
               registers_and_spill_bytes=_build.ptxas_report())
    emit(env)
    return env


def _plain_and_kernel(eng, table, cfg):
    from spmv_topk_tpu_torch.ops.kernel import (octet_topk_plain,
                                                topk_spmv_fused_octet_device)

    args = (eng.words, table, eng.nreal, eng.plan_rows)
    kern = topk_spmv_fused_octet_device(
        *args, cfg=cfg, block_sublanes=eng.fused.block_sublanes,
        **eng.partition_kw)
    plain = octet_topk_plain(
        *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=eng.fused.block_sublanes, codec=cfg.query_codec,
        **eng.partition_kw)
    return kern, plain


def _tables(qs, dev, codec="h16"):
    import torch

    from spmv_topk_tpu_torch.ops.quantized_query import pack_query_tables

    tabs, _ = pack_query_tables(qs, codec)
    return torch.from_numpy(tabs).to(dev)


def _batch_plain_and_kernel(eng, tables, cfg):
    from spmv_topk_tpu_torch.ops.kernel import (
        octet_topk_batch_plain, topk_spmv_fused_batch_octet_device)

    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    kern = topk_spmv_fused_batch_octet_device(
        *args, cfg=cfg, block_sublanes=eng.fused.block_sublanes,
        **eng.partition_kw)
    plain = octet_topk_batch_plain(
        *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=eng.fused.block_sublanes, codec=cfg.query_codec,
        **eng.partition_kw)
    return kern, plain


def _k6_slots_equal(eng, tables, cfg):
    """Whether K6 (merged on the card) gives ``octet_topk_batch_slots_
    plain``'s pairs on the kernel's grid bit for bit, tags included."""
    import torch

    (pv, pt), _ = _batch_slots_plain(eng, tables, cfg, tables.shape[0])
    kv, kt = _batch_launch(eng, tables, cfg)
    torch.cuda.synchronize()
    return bool(torch.equal(kv, pv) and torch.equal(kt, pt))


def _same_bits(a, b):
    """Whether two float32 tensors hold the same bits."""
    import torch

    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def _scores_agree(eng, q):
    """K4 (octet layout) or K9 (slice layout) of an engine, or of a
    shard's view, on query q against its plain version on the same
    inputs, bit for bit, in both store forms: slice order, and row order
    (each slice lane's score times the query's scale at its row id, into
    a zero fill). Returns the larger max abs difference (0)."""
    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    octet = eng.config.fused_layout == "octet"
    wrapper, plain, name = (
        (K.spmv_fused_scores_octet_device, K.octet_scores_plain, "K4")
        if octet else
        (K.spmv_fused_scores_device, K.slice_scores_plain, "K9"))
    table, scale = eng._table(q)
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    kw = dict(block_sublanes=eng.fused.block_sublanes,
              num_slices=eng.row_ids.shape[0],
              num_partitions=eng.config.num_partitions)
    pkw = dict(kw, codec=eng.config.query_codec)
    rows = int(eng.row_ids.max()) + 1

    def store():
        return dict(row_ids=eng.row_ids, scale=scale,
                    out=torch.zeros(rows, dtype=torch.float32,
                                    device=eng.words.device))

    ks = wrapper(*args, cfg=eng.config, **kw)
    ps = plain(*args, **pkw)
    kr = wrapper(*args, cfg=eng.config, **kw, **store())
    pr = plain(*args, **pkw, **store())
    torch.cuda.synchronize()
    require(_same_bits(ks, ps), f"{name} slice-order scores equal the plain "
            "version's bit for bit")
    require(_same_bits(kr, pr), f"{name} row-order scores equal the plain "
            "version's bit for bit")
    return max(float((ks - ps).abs().max()), float((kr - pr).abs().max()))


def _scores_before(eng, table, scale):
    """scores() as the port ran it before the row-order store: the
    kernel's slice order, then an int64 copy of row_ids, torch.where
    sending padding lanes to one extra slot, the multiply by the scale and
    scatter_ into a zero fill."""
    from spmv_topk_tpu_torch.experiments.k9_ablation import epilogue

    sc = eng._layout.scores(
        eng.words, table, eng.nreal, eng.plan_rows, cfg=eng.config,
        block_sublanes=eng.fused.block_sublanes,
        num_slices=eng.row_ids.shape[0],
        num_partitions=eng.config.num_partitions)
    return epilogue(eng, sc, scale * eng._value_scale)


def _scores_path(eng, q):
    """scores() of an engine (a zero fill and one K4 or K9 launch in row
    order) held bit for bit to the path before the row-order store
    (``_scores_before``), then timed: the whole call between CUDA events
    (device ms) and to its synchronize on the host clock, each the median
    of 10, and the path before between CUDA events."""
    import torch

    table, scale = eng._table(q)
    got = eng.scores(q)
    want = _scores_before(eng, table, scale)
    torch.cuda.synchronize()
    require(_same_bits(got, want), "scores() equals the path before the "
            "row-order store bit for bit")
    host, device, before = [], [], []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        eng.scores(q)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
        before.append(cuda_ms(lambda: _scores_before(eng, table, scale),
                              reps=1, warmup=0))
    return dict(scores_device_ms_median=statistics.median(device),
                scores_host_ms_median=statistics.median(host),
                scores_before_row_store_device_ms_median=statistics.median(
                    before))


def _scores_times(eng, q, kn):
    """K4 or K9 (``kn``, the engine's layout) through its wrapper, in row
    order (scores()'s launch, into a zero fill made once) and in slice
    order, each beside its plain version and its bound: the words and the
    table read once, and the scores written once (row order: the row ids
    read besides, a float a row written)."""
    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    octet = eng.config.fused_layout == "octet"
    wrapper, plain = ((K.spmv_fused_scores_octet_device, K.octet_scores_plain)
                      if octet else
                      (K.spmv_fused_scores_device, K.slice_scores_plain))
    table, scale = eng._table(q)
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    kw = dict(block_sublanes=eng.fused.block_sublanes,
              num_slices=eng.row_ids.shape[0],
              num_partitions=eng.config.num_partitions)
    pkw = dict(kw, codec=eng.config.query_codec)
    out = torch.zeros(eng.num_rows, dtype=torch.float32, device=eng.device)
    rows = dict(row_ids=eng.row_ids, scale=scale * eng._value_scale, out=out)
    slice_bytes = eng.row_ids.numel() * 4
    bounds = {kn: sweep_bound(eng, 1, slice_bytes + eng.num_rows * 4),
              f"{kn}_slice_order": sweep_bound(eng, 1, slice_bytes)}
    return {
        f"{kn}_ms": cuda_ms(lambda: wrapper(*args, cfg=eng.config, **kw,
                                            **rows), reps=20, warmup=2),
        f"{kn}_plain_ms": cuda_ms(lambda: plain(*args, **pkw, **rows),
                                  reps=2),
        f"{kn}_slice_order_ms": cuda_ms(lambda: wrapper(
            *args, cfg=eng.config, **kw), reps=20, warmup=2),
        f"{kn}_slice_order_plain_ms": cuda_ms(lambda: plain(*args, **pkw),
                                              reps=2),
        **{f"{k}_bound_ms": b[0] for k, b in bounds.items()},
        **{f"{k}_bound_by": b[1] for k, b in bounds.items()}}


def phase_small(dev):
    """Kernels vs plain versions on a 50k-row corpus."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops.streamprobe import (stream_words_device,
                                                     stream_words_plain)

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    q = create_query_batch(1, NUM_COLS, seed=8)[0]
    qs5 = create_query_batch(5, NUM_COLS, seed=9)
    cases = []
    for fbs, fold in ((1024, 8), (1024, 1), (64, 8)):
        cfg = TopKSpMVConfig(**dict(HEADLINE, fused_block_sublanes=fbs,
                                    fold_tile=fold, tie_safe_topk=True,
                                    rescore_pool=None))
        eng = TopKSpMV(coo, cfg, device=dev)
        wide = sum(p.blocks_per_octet > 1 for p in eng.fused.plan)
        if fbs == 64:
            require(wide > 0, "small blocks force wide octets")
        table, _ = eng._table(q)
        (kv, kt), (pv, pt) = _plain_and_kernel(eng, table, cfg)
        torch.cuda.synchronize()
        err = compare_lanes(kv, kt, pv, pt)
        # K6: 5 queries in subgroups of 2 (the last subgroup holds one)
        bcfg = dataclasses.replace(cfg, batch_subgroup=2)
        tables = _tables(qs5, dev)
        (bv, bt), (bpv, bpt) = _batch_plain_and_kernel(eng, tables, bcfg)
        torch.cuda.synchronize()
        k6_err = max(compare_lanes(bv[j], bt[j], bpv[j], bpt[j])
                     for j in range(len(qs5)))
        # K6 h16's production buffers merged on the card: its slot plain
        # on the kernel's grid, values and tags bit for bit
        require(_k6_slots_equal(eng, tables,
                                dataclasses.replace(cfg, tie_safe_topk=False)),
                "K6 h16 (production buffers) equals its slot plain")
        k4_err = _scores_agree(eng, q)
        _scores_path(eng, q)
        cases.append(dict(fused_block_sublanes=fbs, fold_tile=fold,
                          buckets=len(eng.fused.plan), wide_buckets=wide,
                          k1_max_abs_err=err, k6_max_abs_err=k6_err,
                          k6_slots_plain_equal=True, k4_max_abs_err=k4_err))
    salt = torch.arange(128, dtype=torch.int32, device=dev).reshape(1, 128) * 7919
    ks = stream_words_device(eng.words, salt)
    ps = stream_words_plain(eng.words, salt)
    torch.cuda.synchronize()
    require(torch.equal(ks, ps), "stream probe checksum equals plain")
    out = dict(phase="kernels_vs_plain_small", rows=coo.num_rows,
               nnz=coo.nnz, cases=cases, k3_equal=True, k4_equal=True)
    emit(out)
    return out


# K1's translation unit of each codec (csrc/octet_topk.cuh's instantiations)
K1_UNITS = dict(h16="octet_topk.cu", f32="octet_topk_f32.cu",
                int8x4="octet_topk_q.cu", i8s="octet_topk_q.cu",
                i4s="octet_topk_q.cu")
# K1's small cases: (lane_k, fold_tile, fused block sublanes); 64 makes
# wide octets
K1_GEOMS = ((8, 8, 1024), (4, 1, 1024), (16, 8, 64))
K1_CODECS = ("h16", "f32", "int8x4", "i8s", "i4s")


def phase_k1_small(dev):
    """K1 and K10b (P = 3) against their slot plain
    (``octet_topk_slots_plain`` on the kernel's grid) at 50k rows, bit for
    bit, tags included: tie-safe and production buffers, every codec, fold
    1 and 8, lane_k 4, 8 and 16, wide octets, and f32 at 65,536 columns
    (tables in global memory); the unmerged launch's slots against the
    plain's; then the registers and spills of every K1 instantiation, of
    which none may spill."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops import kernel as K

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    q = create_query_batch(1, NUM_COLS, seed=8)[0]
    wcoo = create_sparse_matrix(20_000, F32_MAX_COLS, AVG_DEG, "gamma",
                                seed=19)
    wq = create_query_batch(1, F32_MAX_COLS, seed=20)[0]
    base = dict(HEADLINE, rescore_pool=None)
    cases = [(coo, q, dict(base, query_codec=c, lane_k=k, fold_tile=f,
                           fused_block_sublanes=b, num_partitions=P))
             for c in K1_CODECS for k, f, b in K1_GEOMS for P in (1, 3)]
    cases += [(wcoo, wq, dict(base, query_codec="f32", max_cols=F32_MAX_COLS,
                              num_partitions=P)) for P in (1, 2)]
    out = []
    for corpus, query, kw in cases:
        cfg = TopKSpMVConfig(**kw)
        eng = TopKSpMV(corpus, cfg, device=dev)
        table, _ = eng._table(query)
        P = cfg.num_partitions
        arg, _ = K._kernel_codec(dev, cfg.query_codec, table.shape[0])
        for tie_safe in (False, True):
            tcfg = dataclasses.replace(cfg, tie_safe_topk=tie_safe)
            require(_k1_slots_equal(eng, table, tcfg),
                    f"K1 {kw} tie_safe={tie_safe} equals its slot plain")
            uv, ut = K._octet_topk_cuda(
                eng.words, table, eng.nreal, eng.plan_rows, P,
                eng.partition_kw.get("part_slices", 0), tcfg,
                cfg.fused_block_sublanes, unmerged=True)
            blocks, slots = K.octet_topk_grid(dev, tcfg,
                                              eng.words.shape[0] // P, P)
            sv, st = K.octet_topk_slots_plain(
                eng.words, table, eng.nreal, eng.plan_rows, num_slots=slots,
                lane_k=cfg.lane_k, fold_tile=cfg.fold_tile, tie_safe=tie_safe,
                block_sublanes=cfg.fused_block_sublanes,
                codec=cfg.query_codec, merged=False, **eng.partition_kw)
            torch.cuda.synchronize()
            require(torch.equal(uv, sv) and torch.equal(ut, st),
                    f"K1 {kw} tie_safe={tie_safe}: unmerged slots equal "
                    "the plain's")
            if tie_safe:
                (kv, kt), (pv, pt) = _plain_and_kernel(eng, table, tcfg)
                torch.cuda.synchronize()
                compare_pools(kv, kt, pv, pt)
        out.append(dict(codec=K.KERNEL_CODECS[arg], lane_k=cfg.lane_k,
                        fold_tile=cfg.fold_tile,
                        fused_block_sublanes=cfg.fused_block_sublanes,
                        partitions=P, blocks=blocks, slots=slots,
                        wide_buckets=sum(p.blocks_per_octet > 1
                                         for p in eng.fused.plan),
                        zero_real_buckets=int((eng.nreal == 0).sum()),
                        slots_plain_equal=True, unmerged_equal=True))
        del eng
    require(any(c["wide_buckets"] for c in out), "wide octets ran")
    require(any(c["zero_real_buckets"] for c in out if c["partitions"] > 1),
            "a partition holds a bucket with no real slice")
    require({c["codec"] for c in out} == SINGLE_QUERY_CODECS,
            "every codec ran, f32 in shared and in global memory")
    regs = {k: dict(registers=r, spill_bytes=sp)
            for k, (r, sp) in _build.ptxas_report().items()
            if k.startswith("octet_topk_kernel<")}
    require(len(regs) == 5 * 3 * 4,
            f"every K1 instantiation reported ({len(regs)} of 60)")
    require(all(v["spill_bytes"] == 0 for v in regs.values()),
            "no K1 instantiation spills")
    res = dict(phase="k1_vs_slots_plain_small", rows=coo.num_rows,
               cases=out, registers=regs, nvidia_smi=smi_line())
    emit(res)
    return res


# K7's small cases: (lane_k, fold_tile, fused block sublanes): tiled
# sub-tiles at fold 8 and 2, runs at fold 1, wide slices at 32
K7_GEOMS = ((8, 8, 1024), (4, 1, 1024), (16, 2, 32))
# each codec's width quantum (bench.py's slice engine, the default, c3)
K7_QUANTUM = dict(h16=2, f32=8, int8x4=4, i8s=4, i4s=4)
# K7's translation unit of each codec (csrc/slice_topk.cuh's instantiations)
K7_UNITS = dict(h16="slice_topk.cu", f32="slice_topk_f32.cu",
                int8x4="slice_topk_q.cu", i8s="slice_topk_q.cu",
                i4s="slice_topk_q.cu")


def phase_k7_small(dev):
    """K7 and K10a (P = 3) against their slot plain
    (``slice_topk_slots_plain`` on the kernel's grid) at 50k rows, bit for
    bit, tags included: tie-safe and production buffers, every codec,
    fold 1, 2 and 8, lane_k 4, 8 and 16, wide slices, and f32 at 65,536
    columns (tables in global memory); the unmerged launch's slots against
    the plain's; then the registers and spills of every K7 and K3
    instantiation, of which none may spill."""
    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops import kernel as K

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    q = create_query_batch(1, NUM_COLS, seed=8)[0]
    wcoo = create_sparse_matrix(20_000, F32_MAX_COLS, AVG_DEG, "gamma",
                                seed=19)
    wq = create_query_batch(1, F32_MAX_COLS, seed=20)[0]
    cases = [(coo, q, dict(k=100, max_cols=NUM_COLS, query_codec=c,
                           width_quantum=K7_QUANTUM[c], lane_k=k,
                           fold_tile=f, fused_block_sublanes=b,
                           num_partitions=P))
             for c in K7_QUANTUM for k, f, b in K7_GEOMS for P in (1, 3)]
    cases += [(wcoo, wq, dict(k=100, max_cols=F32_MAX_COLS,
                              num_partitions=P)) for P in (1, 2)]
    out = []
    for corpus, query, kw in cases:
        cfg = TopKSpMVConfig(**kw)
        eng = TopKSpMV(corpus, cfg, device=dev)
        table, _ = eng._table(query)
        P = cfg.num_partitions
        arg, _ = K._kernel_codec(dev, cfg.query_codec, table.shape[0])
        _k7_agree(eng, table, cfg, f"K7 {kw}")
        blocks, slots = K.slice_topk_grid(dev, cfg, eng.words.shape[0] // P,
                                          P)
        out.append(dict(codec=K.KERNEL_CODECS[arg], lane_k=cfg.lane_k,
                        fold_tile=cfg.fold_tile,
                        fused_block_sublanes=cfg.fused_block_sublanes,
                        partitions=P, blocks=blocks, slots=slots,
                        modes=sorted({K.slice_work(r, cfg.fold_tile)[0]
                                      for r in eng.plan_rows.tolist()}),
                        zero_real_buckets=int((eng.nreal == 0).sum()),
                        slots_plain_equal=True, unmerged_equal=True))
        del eng
    require(any(K.WIDE in c["modes"] for c in out), "wide slices ran")
    require(any(K.TILED in c["modes"] for c in out), "sub-tiles ran")
    require(any(c["zero_real_buckets"] for c in out if c["partitions"] > 1),
            "a partition holds a bucket with no real slice")
    require({c["codec"] for c in out} == SINGLE_QUERY_CODECS,
            "every codec ran, f32 in shared and in global memory")
    regs = {k: dict(registers=r, spill_bytes=sp)
            for k, (r, sp) in _build.ptxas_report().items()
            if k.startswith(("slice_topk_kernel<", "stream_words_kernel"))}
    require(len(regs) == 5 * 3 * 2 + 1,
            f"every K7 instantiation and K3 reported ({len(regs)} of 31)")
    require(all(v["spill_bytes"] == 0 for v in regs.values()),
            "no K7 or K3 instantiation spills")
    res = dict(phase="k7_vs_slots_plain_small", rows=coo.num_rows,
               cases=out, registers=regs, nvidia_smi=smi_line())
    emit(res)
    return res


# K8's cases at 50k rows: (lane_k, fused block sublanes); 32-row blocks
# make wide slices
K8_GEOMS = ((8, 1024), (4, 1024), (16, 32))
# K8's translation unit of each codec (csrc/slice_topk_batch.cuh's
# instantiations)
K8_UNITS = dict(h16="slice_topk_batch.cu", f32="slice_topk_batch_f32.cu",
                int8x4="slice_topk_batch_q.cu", i8s="slice_topk_batch_q.cu",
                i4s="slice_topk_batch_q.cu")
# K8's instantiations: h16 passes of 8, 16, 32; f32 in shared memory,
# int8x4 and Sign (i8s, i4s) passes of 8 and 16, f32 and int8x4 in global
# memory 8; lane_k 4, 8, 16; tie-safe and not
K8_INSTANTIATIONS = (3 + 3 * 2 + 2) * 3 * 2
# the queries of a full-size group whose K8 pairs are held to the slot
# plain (the kernel runs the whole group, on the group's grid)
K8_HELD = 4


def phase_k8_small(dev):
    """K8 and K10c (P = 2) against their slot plain
    (``slice_topk_batch_slots_plain`` on the kernel's grid) at 50k rows,
    bit for bit, tags included, merged on the card and the unmerged
    launch's slots: tie-safe and production buffers, every codec at its
    width quantum, lane_k 4, 8 and 16, wide slices, 5 queries (a short
    pass), 1 and 33 (passes split, the last of one query), and f32 and
    int8x4 at 65,536 columns (tables in global memory); then the registers
    and spills of every K8 instantiation, of which none may spill."""
    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops import kernel as K

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    qs = create_query_batch(33, NUM_COLS, seed=9)
    wcoo = create_sparse_matrix(20_000, F32_MAX_COLS, AVG_DEG, "gamma",
                                seed=19)
    wqs = create_query_batch(5, F32_MAX_COLS, seed=20)
    base = dict(k=100, max_cols=NUM_COLS)
    cases = [(coo, qs[:5], dict(base, query_codec=c,
                                width_quantum=K7_QUANTUM[c], lane_k=k,
                                fused_block_sublanes=b, num_partitions=P))
             for c in K7_QUANTUM for k, b in K8_GEOMS for P in (1, 2)]
    cases += [(coo, qs[:n], dict(base, query_codec=c,
                                 width_quantum=K7_QUANTUM[c]))
              for c in K7_QUANTUM for n in (1, 33)]
    cases += [(wcoo, wqs, dict(k=100, max_cols=F32_MAX_COLS, query_codec=c,
                               width_quantum=K7_QUANTUM[c], num_partitions=P))
              for c in ("f32", "int8x4") for P in (1, 2)]
    out = []
    for corpus, queries, kw in cases:
        cfg = TopKSpMVConfig(**kw)
        eng = TopKSpMV(corpus, cfg, device=dev)
        P = cfg.num_partitions
        tables = _tables(queries, dev, cfg.query_codec)
        _batch_agree(eng, tables, cfg, f"K8 {len(queries)} queries {kw}")
        codec, qp, passes, slots = K.k8_launch(dev, cfg, len(queries), P)
        out.append(dict(codec=codec, lane_k=cfg.lane_k,
                        fused_block_sublanes=cfg.fused_block_sublanes,
                        partitions=P, queries=len(queries),
                        pass_queries=qp, passes=passes, slots=slots,
                        modes=sorted({K.slice_work(r, 1)[0]
                                      for r in eng.plan_rows.tolist()}),
                        zero_real_buckets=int((eng.nreal == 0).sum()),
                        slots_plain_equal=True, unmerged_equal=True))
        del eng
    require(any(K.WIDE in c["modes"] for c in out), "wide slices ran")
    require(any(c["passes"] > 1 and c["queries"] % c["pass_queries"] == 1
                for c in out), "a pass of one query after full ones ran")
    require({c["codec"] for c in out} == set(K.KERNEL_CODECS),
            "every codec ran, f32 and int8x4 in shared and in global memory")
    regs = _k8_registers(_build.ptxas_report())
    require(len(regs) == K8_INSTANTIATIONS,
            f"every K8 instantiation reported ({len(regs)} of "
            f"{K8_INSTANTIATIONS})")
    require(all(v["spill_bytes"] == 0 for v in regs.values()),
            "no K8 instantiation spills")
    res = dict(phase="k8_vs_slots_plain_small", rows=coo.num_rows,
               cases=out, registers=regs, nvidia_smi=smi_line())
    emit(res)
    return res


def _k8_registers(report):
    """{K8 instantiation: registers, spill bytes} of a ptxas report."""
    return {k: dict(registers=r, spill_bytes=sp)
            for k, (r, sp) in report.items()
            if k.startswith("slice_topk_batch_kernel<")}


# K6's cases at 50k rows: (lane_k, fold_tile, fused block sublanes); 64
# makes wide octets of 8-chunk spans, 24 of 3-chunk spans (a load batch
# ends at each span's end)
K6_GEOMS = ((8, 8, 1024), (4, 1, 1024), (16, 8, 64), (8, 1, 24))
K6_CODECS = ("f32", "int8x4", "i8s", "i4s")
# K12's translation unit of each codec (csrc/bucket_topk_batch.cuh's
# instantiations)
K12_UNITS = {c: f"bucket_topk_batch_{c}.cu"
             for c in ("f32", "int8x4", "i8s", "i4s")}
K12_UNITS["h16"] = "bucket_topk_batch.cu"
# K6's translation unit of each codec but h16 (csrc/octet_topk_batch.cuh's
# instantiations; h16's kernel is octet_topk_batch_h16.cu)
K6_UNITS = dict(f32="octet_topk_batch_f32.cu",
                int8x4="octet_topk_batch_int8x4.cu",
                i8s="octet_topk_batch_i8s.cu", i4s="octet_topk_batch_i4s.cu")
# K6's instantiations but h16's: f32, int8x4, i8s and i4s passes of 8
# and 16, f32 and int8x4 in global memory 8; lane_k 4, 8, 16; tie-safe
# and not; fold 1 and 8
K6_INSTANTIATIONS = (4 * 2 + 2) * 3 * 2 * 2


def phase_k6_small(dev):
    """K6 and K10d (P = 2) for f32, int8x4, i8s and i4s against their slot
    plain (``octet_topk_batch_slots_plain`` on the kernel's grid) at 50k
    rows, bit for bit, tags included, merged on the card and the unmerged
    launch's slots: tie-safe and production buffers, every codec at its
    width quantum, fold 1 and 8, lane_k 4, 8 and 16, wide octets (spans of
    8 and of 3 chunks), 5 queries (a short pass), 1 and 33 (passes split,
    the last of one query), and f32 and int8x4 at 65,536 columns (tables
    in global memory), so that every (kernel codec, pass) ``k6_pass`` can
    give runs; then the registers and spills of every K6 instantiation, of
    which none may spill."""
    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops import kernel as K

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    qs = create_query_batch(33, NUM_COLS, seed=9)
    wcoo = create_sparse_matrix(20_000, F32_MAX_COLS, AVG_DEG, "gamma",
                                seed=19)
    wqs = create_query_batch(5, F32_MAX_COLS, seed=20)
    base = dict(HEADLINE, rescore_pool=None)
    cases = [(coo, qs[:5], dict(base, query_codec=c,
                                width_quantum=K7_QUANTUM[c], lane_k=k,
                                fold_tile=f, fused_block_sublanes=b,
                                num_partitions=P))
             for c in K6_CODECS for k, f, b in K6_GEOMS for P in (1, 2)]
    cases += [(coo, qs[:n], dict(base, query_codec=c,
                                 width_quantum=K7_QUANTUM[c]))
              for c in K6_CODECS for n in (1, 33)]
    cases += [(wcoo, wqs, dict(base, query_codec=c,
                               width_quantum=K7_QUANTUM[c],
                               max_cols=F32_MAX_COLS, num_partitions=P))
              for c in ("f32", "int8x4") for P in (1, 2)]
    out = []
    for corpus, queries, kw in cases:
        cfg = TopKSpMVConfig(**kw)
        eng = TopKSpMV(corpus, cfg, device=dev)
        P = cfg.num_partitions
        tables = _tables(queries, dev, cfg.query_codec)
        _batch_agree(eng, tables, cfg, f"K6 {len(queries)} queries {kw}")
        codec, qp, passes, slots = K.k6_launch(dev, cfg, len(queries), P)
        out.append(dict(codec=codec, lane_k=cfg.lane_k,
                        fold_tile=cfg.fold_tile,
                        fused_block_sublanes=cfg.fused_block_sublanes,
                        partitions=P, queries=len(queries),
                        pass_queries=qp, passes=passes, slots=slots,
                        wide_buckets=sum(p.blocks_per_octet > 1
                                         for p in eng.fused.plan),
                        zero_real_buckets=int((eng.nreal == 0).sum()),
                        slots_plain_equal=True, unmerged_equal=True))
        del eng
    require(any(c["wide_buckets"] and c["fused_block_sublanes"] == 24
                for c in out), "wide octets of 3-chunk spans ran")
    require(any(c["passes"] > 1 and c["queries"] % c["pass_queries"] == 1
                for c in out), "a pass of one query after full ones ran")
    require({(c["codec"], c["pass_queries"]) for c in out} ==
            {(c, q) for c, qs in K.K6_PASS_QUERIES.items() for q in qs},
            "every (kernel codec, pass) ran, f32 and int8x4 in shared and "
            "in global memory")
    regs = _k6_registers(_build.ptxas_report())
    require(len(regs) == K6_INSTANTIATIONS,
            f"every K6 instantiation reported ({len(regs)} of "
            f"{K6_INSTANTIATIONS})")
    require(all(v["spill_bytes"] == 0 for v in regs.values()),
            "no K6 instantiation spills")
    res = dict(phase="k6_vs_slots_plain_small", rows=coo.num_rows,
               cases=out, registers=regs, nvidia_smi=smi_line())
    emit(res)
    return res


def _k6_registers(report):
    """{K6 instantiation but h16's: registers, spill bytes} of a ptxas
    report."""
    return {k: dict(registers=r, spill_bytes=sp)
            for k, (r, sp) in report.items()
            if k.startswith("octet_topk_batch_kernel<")}


def _k6_instantiation(codec, pass_queries, lane_k, tie_safe, exact,
                      queries):
    """The name ``_build.ptxas_report`` gives K6's kernel for a kernel
    codec (KERNEL_CODECS), pass, lane_k, buffers, fold and a launch of
    ``queries`` queries (h16 sizes its sums for the first pass's queries
    rounded up to 8, 16 or 32)."""
    flags = f"{lane_k},{int(tie_safe)},{int(exact)}>"
    if codec == "h16":
        live = min(queries, pass_queries)
        nr = 1 if live <= 8 else 2 if live <= 16 else 4
        return f"octet_topk_batch_h16_kernel<{nr},{flags}"
    return (f"octet_topk_batch_kernel<{_pass_codec(codec, pass_queries)},"
            f"{flags}")


def _pass_codec(codec, pass_queries):
    """The name ``_build.ptxas_report`` gives the pass codec
    (csrc/codecs.cuh) of a kernel codec (KERNEL_CODECS) and pass of the
    batch sweeps K6 and K12 (K8 takes FloatPass for every float codec)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    q = pass_queries
    if codec == "h16":
        return f"H16Pass<{q}>"
    if codec.startswith("f32") or codec == "int8x4_global":
        c = dict(f32="F32T<1>", f32_global="F32T<0>",
                 int8x4_global="Int8x4T<0>")[codec]
        return f"FloatPass<{c},{q}>"
    c = "Int8x4T<1>" if codec == "int8x4" else "Sign"
    return f"Bf16Pass<{c},{q},{K.TABLE_FIELDS[codec]}>"


def _k6_times(eng, tables, cfg, key="k6"):
    """K6's numbers at an octet engine's shapes beyond its wrapper's time:
    alone on the card with and without its merge and the ``torch.topk``
    merge of its unmerged slots (``_k6_alone_ms``), its pass, passes and
    slots, and the registers and spill bytes of the instantiation it
    launches."""
    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops import kernel as K

    P = cfg.num_partitions
    codec, qp, passes, slots = K.k6_launch(eng.words.device, cfg,
                                           tables.shape[0], P)
    alone, unmerged, topk_merge = _k6_alone_ms(eng, tables, cfg)
    name = _k6_instantiation(codec, qp, cfg.lane_k, bool(cfg.tie_safe_topk),
                             cfg.fold_tile == 1, tables.shape[0])
    regs, spill = _build.ptxas_report()[name]
    groups = 128 // K.batch_block_lanes(qp, cfg.lane_k, codec)
    return {f"{key}_alone_ms": alone, f"{key}_unmerged_ms": unmerged,
            f"{key}_card_merge_ms": alone - unmerged,
            f"{key}_topk_merge_of_the_slots_ms": topk_merge,
            f"{key}_kernel_codec": codec, f"{key}_pass_queries": qp,
            f"{key}_passes": passes, f"{key}_slots": slots,
            f"{key}_cuda_blocks": slots * groups * P * passes,
            f"{key}_instantiation": name, f"{key}_registers": regs,
            f"{key}_spill_bytes": spill}


def phase_main(dev):
    """The main path at full size; returns (engine, queries, results,
    gold top-100 sets, query() indices)."""
    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops.kernel import topk_spmv_fused_octet_device
    from spmv_topk_tpu_torch.ops.streamprobe import stream_words_device
    from spmv_topk_tpu_torch.utils import native

    require(native.available(),
            f"native runtime loaded for the full-size pack ({native.load_error})")
    t0 = time.perf_counter()
    coo = create_sparse_matrix(FULL_ROWS, NUM_COLS, AVG_DEG, "gamma",
                               seed=CORPUS_SEED)
    gen_s = time.perf_counter() - t0
    cfg = TopKSpMVConfig(**HEADLINE)
    t0 = time.perf_counter()
    eng = TopKSpMV(coo, cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.from_numpy(eng.fused.words).to(dev)    # upload alone, for its time
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    qs = create_query_batch(NUM_QUERIES, NUM_COLS, seed=QUERY_SEED)
    t0 = time.perf_counter()
    gold_scores = np.asarray(eng._scipy_csr @ qs.T)       # (rows, Q)
    gold = []
    for j in range(NUM_QUERIES):
        g = gold_scores[:, j]
        part = np.argpartition(-g, cfg.k - 1)[:cfg.k]
        gold.append(set(part.tolist()))
    del gold_scores
    gold_s = time.perf_counter() - t0

    eng.query(qs[0])                                      # warm
    torch.cuda.synchronize()
    topk_spmv_fused_octet_device.launches = 0
    stream_words_device.launches = 0
    prec, prec_raw, e2e_ms, sweep_ms, single = [], [], [], [], []
    svals = []
    for j in range(NUM_QUERIES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, vals = eng.query(qs[j])
        torch.cuda.synchronize()
        e2e_ms.append((time.perf_counter() - t0) * 1e3)
        idx = idx.cpu().numpy()
        single.append(idx)
        svals.append(vals.cpu().numpy())
        require(idx.shape == (cfg.k,) and (idx >= 0).all()
                and np.isfinite(vals.cpu().numpy()).all(),
                "query returns k valid rows with finite scores")
        prec.append(len(gold[j] & set(idx.tolist())) / cfg.k)
        raw_idx, _ = eng.query(qs[j], rescore_pool=0)
        prec_raw.append(len(gold[j] & set(raw_idx.cpu().numpy().tolist()))
                        / cfg.k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.candidates(qs[j])
        end.record()
        end.synchronize()
        sweep_ms.append(start.elapsed_time(end))
    salts = [torch.full((1, 128), i, dtype=torch.int32, device=dev)
             for i in range(11)]
    floor_ms = cuda_ms(lambda it=iter(salts): stream_words_device(
        eng.words, next(it)), reps=10)
    torch.cuda.synchronize()
    launches = dict(octet_topk_h16=topk_spmv_fused_octet_device.launches,
                    stream_words=stream_words_device.launches)

    sweep = statistics.median(sweep_ms)
    res = dict(
        phase="main_path", rows=coo.num_rows, cols=coo.num_cols,
        nnz=coo.nnz, config=HEADLINE, buckets=len(eng.fused.plan),
        generate_s=gen_s, pack_and_upload_s=build_s, upload_s=upload_s,
        gold_s=gold_s, words_bytes_on_device=eng.words.numel() * 4,
        padding_words_per_nnz=eng.fused.padding_ratio,
        queries=NUM_QUERIES, precision_at_100_mean=float(np.mean(prec)),
        precision_at_100_min=float(np.min(prec)),
        precision_raw_mean=float(np.mean(prec_raw)),
        sweep_ms_median=sweep, e2e_ms_median=statistics.median(e2e_ms),
        gnnz_per_s=coo.nnz / (sweep * 1e-3) / 1e9,
        words_gb_per_s=eng.hbm_bytes / (sweep * 1e-3) / 1e9,
        stream_floor_ms=floor_ms,
        stream_floor_gb_per_s=eng.hbm_bytes / (floor_ms * 1e-3) / 1e9,
        launches=launches,
        nvidia_smi=smi_line())
    emit(res)
    require(res["precision_at_100_mean"] >= MIN_PRECISION,
            f"mean precision@100 >= {MIN_PRECISION}")
    res["_answers"] = (single, svals)     # the sharded phase's reference
    return coo, eng, qs, res, gold, single


def phase_kernels_full(eng, qs, dev):
    """Kernel vs plain at the main-path shapes: times and agreement. K1
    through its wrapper, alone on the card (``_k1_alone_ms``: with its
    lane merge, without it, and the ``torch.topk`` merge of its slots that
    the route ran before the merge moved onto the card), its production
    buffers against its slot plain bit for bit, tags included; K3 and its
    library yardstick (``_k3_library_ms``)."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch.ops import kernel as K
    from spmv_topk_tpu_torch.ops.streamprobe import (stream_words_device,
                                                     stream_words_plain)

    cfg = eng.config
    table, _ = eng._table(qs[0])
    bs = eng.fused.block_sublanes
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    # agreement needs tie-safe buffers: h16 scores tie often at this size
    safe = dataclasses.replace(cfg, tie_safe_topk=True)
    (kv, kt), (pv, pt) = _plain_and_kernel(eng, table, safe)
    torch.cuda.synchronize()
    k1_err = compare_lanes(kv, kt, pv, pt)
    # the production buffers, ties and tags included, on the kernel's slots
    blocks, slots = K.octet_topk_grid(dev, cfg, eng.words.shape[0])
    require(_k1_slots_equal(eng, table, cfg),
            "K1 (production buffers) equals its slot plain at full size")

    plain_kw = dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                    tie_safe=bool(cfg.tie_safe_topk), block_sublanes=bs)
    k1_ms = cuda_ms(lambda: K.topk_spmv_fused_octet_device(
        *args, cfg=cfg, block_sublanes=bs), reps=20, warmup=2)
    k1_alone_ms, k1_unmerged_ms, k1_topk_merge_ms = _k1_alone_ms(
        eng, table, cfg)
    k1_plain_ms = cuda_ms(lambda: K.octet_topk_plain(*args, **plain_kw),
                          reps=3)
    k1_slots_plain_ms = cuda_ms(lambda: K.octet_topk_slots_plain(
        *args, num_slots=slots, codec=cfg.query_codec, **plain_kw), reps=1)
    salt = torch.arange(128, dtype=torch.int32, device=dev).reshape(1, 128)
    ks = stream_words_device(eng.words, salt)
    ps = stream_words_plain(eng.words, salt)
    torch.cuda.synchronize()
    require(torch.equal(ks, ps), "full-size stream checksum equals plain")
    k3_ms = cuda_ms(lambda: stream_words_device(eng.words, salt), reps=20,
                    warmup=2)
    k3_plain_ms = cuda_ms(lambda: stream_words_plain(eng.words, salt),
                          reps=3)
    k3_library_ms = _k3_library_ms(eng.words, salt, ks)
    k3_alone_ms = _device_ms([lambda: stream_words_device(eng.words, salt)],
                             10)[0][0]
    k1_bound = sweep_bound(eng, 1, topk_out_bytes(eng, 1))
    # K3: the words read once, an add per word
    k3_bound = bound(eng.hbm_bytes + 2 * 8 * 128 * 4, eng.words.numel())
    res = dict(phase="kernels_vs_plain_full", words_bytes=eng.hbm_bytes,
               k1_ms=k1_ms, k1_alone_ms=k1_alone_ms,
               k1_unmerged_ms=k1_unmerged_ms,
               k1_card_merge_ms=k1_alone_ms - k1_unmerged_ms,
               k1_topk_merge_of_the_slots_ms=k1_topk_merge_ms,
               k1_blocks=blocks, k1_slots=slots,
               **{f"k1_{k}": v for k, v in _k1_deal_balance(eng,
                                                            slots).items()},
               k1_plain_ms=k1_plain_ms, k1_slots_plain_ms=k1_slots_plain_ms,
               k1_max_abs_err=k1_err, k1_slots_plain_equal=True,
               k1_words_gb_per_s=eng.hbm_bytes / (k1_ms * 1e-3) / 1e9,
               k1_alone_words_gb_per_s=(eng.hbm_bytes / (k1_alone_ms * 1e-3)
                                        / 1e9),
               k1_bound_ms=k1_bound[0], k1_bound_by=k1_bound[1],
               k3_ms=k3_ms, k3_plain_ms=k3_plain_ms, k3_max_abs_err=0,
               k3_library_ms=k3_library_ms, k3_alone_ms=k3_alone_ms,
               k3_gb_per_s=eng.hbm_bytes / (k3_ms * 1e-3) / 1e9,
               k3_library_gb_per_s=eng.hbm_bytes / (k3_library_ms * 1e-3)
               / 1e9,
               k3_bound_ms=k3_bound[0], k3_bound_by=k3_bound[1],
               nvidia_smi=smi_line())
    emit(res)
    return res


def _k1_deal_balance(eng, slots):
    """What each of K1's ``slots`` slots sweeps under its deal
    (``ops/kernel.py::k1_deal``) and, for comparison, under dealing the
    octets one a slot in turn, from the engine's plan (first partition):
    the largest slot's chunks and work over the mean, and its octets (a
    count, no device time)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    nreal = eng.nreal.reshape(eng.config.num_partitions, -1)[0]
    chunks = K.octet_real_chunks(eng.plan_rows, nreal).numpy()
    real = chunks > 0
    work = (chunks + K.K1_OCTET_COST) * real
    deals = dict(runs=K.k1_deal(eng.plan_rows, nreal, slots).numpy(),
                 one_a_slot_in_turn=np.arange(len(work)) % slots)
    out = {}
    for name, slot in deals.items():
        for what, x in (("chunks", chunks), ("work", work)):
            per_slot = np.bincount(slot, weights=x, minlength=slots)
            out[f"slot_{what}_max_over_mean_{name}"] = float(
                per_slot.max() / per_slot.mean())
        out[f"slot_octets_max_{name}"] = int(np.bincount(
            slot, weights=real, minlength=slots).max())
    return out


def _k1_slots_equal(eng, table, cfg):
    """Whether K1 (merged on the card) gives ``octet_topk_slots_plain``'s
    pairs on the kernel's grid bit for bit, tags included, under cfg (its
    buffers tie-safe or not), on the engine's partitions."""
    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    P = eng.config.num_partitions
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bs = eng.fused.block_sublanes
    kv, kt = K.topk_spmv_fused_octet_device(*args, cfg=cfg, block_sublanes=bs,
                                            **eng.partition_kw)
    _, slots = K.octet_topk_grid(eng.words.device, cfg,
                                 eng.words.shape[0] // P, P)
    pv, pt = K.octet_topk_slots_plain(
        *args, num_slots=slots, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk), block_sublanes=bs,
        codec=cfg.query_codec, **eng.partition_kw)
    torch.cuda.synchronize()
    return bool(torch.equal(kv, pv) and torch.equal(kt, pt))


def _k1_alone_ms(eng, table, cfg, reps=10):
    """K1 alone on the card, device time (``_device_ms``) on the engine's
    stream: (the launch, its lane merge included; the launch with the
    merge left out, ``unmerged``; one per-lane ``torch.topk`` over those
    unmerged slots, the merge of the route before K1's card merge)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    P = eng.config.num_partitions
    ps = eng.partition_kw.get("part_slices", 0)
    args = (eng.words, table, eng.nreal, eng.plan_rows, P, ps, cfg,
            eng.fused.block_sublanes)
    slots = K._octet_topk_cuda(*args, unmerged=True)
    fns = [lambda: K._octet_topk_cuda(*args),
           lambda: K._octet_topk_cuda(*args, unmerged=True),
           lambda: K.merge_lane_topk(*slots, cfg.lane_k, lead=1)]
    for fn in fns:
        fn()
    return tuple(_device_ms([fn], reps)[0][0] for fn in fns)


def _k7_slots_plain(eng, table, cfg, merged=True):
    """``slice_topk_slots_plain`` on K7's grid for cfg (its buffers
    tie-safe or not), on the engine's partitions."""
    from spmv_topk_tpu_torch.ops import kernel as K

    P = cfg.num_partitions
    _, slots = K.slice_topk_grid(eng.words.device, cfg,
                                 eng.words.shape[0] // P, P)
    return K.slice_topk_slots_plain(
        eng.words, table, eng.nreal, eng.plan_rows, num_slots=slots,
        lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk),
        block_sublanes=eng.fused.block_sublanes, codec=cfg.query_codec,
        merged=merged, **eng.partition_kw)


def _k7_agree(eng, table, cfg, what):
    """Require K7 (K10a) under cfg, tie-safe and with production buffers,
    to give ``slice_topk_slots_plain``'s pairs on its grid bit for bit,
    tags included, merged on the card and (the unmerged launch) slot by
    slot; tie-safe, its values those of ``slice_topk_plain`` too. Returns
    the tie-safe pools' max abs error against ``slice_topk_plain``."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bs = eng.fused.block_sublanes
    P = cfg.num_partitions
    err = None
    for tie_safe in (True, False):
        tcfg = dataclasses.replace(cfg, tie_safe_topk=tie_safe)
        kv, kt = K.topk_spmv_fused_device(*args, cfg=tcfg, block_sublanes=bs,
                                          **eng.partition_kw)
        pv, pt = _k7_slots_plain(eng, table, tcfg)
        uv, ut = K._slice_topk_cuda(*args, P,
                                    eng.partition_kw.get("part_slices", 0),
                                    tcfg, bs, unmerged=True)
        sv, st = _k7_slots_plain(eng, table, tcfg, merged=False)
        torch.cuda.synchronize()
        require(torch.equal(kv, pv) and torch.equal(kt, pt),
                f"{what} tie_safe={tie_safe}: K7 equals its slot plain")
        require(torch.equal(uv, sv) and torch.equal(ut, st),
                f"{what} tie_safe={tie_safe}: unmerged slots equal the "
                "plain's")
        if tie_safe:
            err = compare_pools(kv, kt, *K.slice_topk_plain(
                *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                tie_safe=True, block_sublanes=bs, codec=cfg.query_codec,
                **eng.partition_kw))
    return err


def _k7_alone_ms(eng, table, cfg, reps=10):
    """K7 alone on the card, device time (``_device_ms``) on the engine's
    stream: (the launch, its lane merge included; the launch with the
    merge left out, ``unmerged``; one per-lane ``torch.topk`` over those
    unmerged slots, the merge of the route before K7's card merge)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    P = eng.config.num_partitions
    ps = eng.partition_kw.get("part_slices", 0)
    args = (eng.words, table, eng.nreal, eng.plan_rows, P, ps, cfg,
            eng.fused.block_sublanes)
    slots = K._slice_topk_cuda(*args, unmerged=True)
    fns = [lambda: K._slice_topk_cuda(*args),
           lambda: K._slice_topk_cuda(*args, unmerged=True),
           lambda: K.merge_lane_topk(*slots, cfg.lane_k, lead=1)]
    for fn in fns:
        fn()
    return tuple(_device_ms([fn], reps)[0][0] for fn in fns)


def _k7_deal_balance(eng, slots, fold_tile=None, old=None):
    """What each of ``slots`` slots sweeps under K7's deal
    (``ops/kernel.py::k7_deal``, at cfg's fold_tile or ``fold_tile``; K8
    deals at 1) and, for comparison, under the kernel before it (work item
    g to slot g mod ``old``, round-robin; K7's before it: sms x 8 CUDA
    blocks), from the engine's plan (first partition): the largest slot's
    (block's) rows and work over the mean, and its items (a count, no
    device time)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    cfg = eng.config
    fold = cfg.fold_tile if fold_tile is None else fold_tile
    nreal = eng.nreal.reshape(cfg.num_partitions, -1)[0]
    rows, work = K.k7_item_work(eng.plan_rows, nreal, fold)
    if old is None:
        old = _device_info_sms(eng.words.device) * 8
    deals = dict(runs=(K.k7_deal(eng.plan_rows, nreal, slots,
                                 fold).numpy(), slots),
                 round_robin_before=(np.arange(len(work)) % old, old))
    out = {}
    for name, (slot, n) in deals.items():
        for what, x in (("rows", rows), ("work", work)):
            per_slot = np.bincount(slot, weights=x, minlength=n)
            out[f"slot_{what}_max_over_mean_{name}"] = float(
                per_slot.max() / per_slot.mean())
        out[f"slot_items_max_{name}"] = int(np.bincount(
            slot, weights=rows > 0, minlength=n).max())
    return out


def _batch_slots_plain(eng, tables, cfg, held):
    """The slot plain of the engine's batch sweep (K8,
    ``slice_topk_batch_slots_plain``, on the slice layout; K6,
    ``octet_topk_batch_slots_plain``, on the octet layout) on its grid for
    cfg (its buffers tie-safe or not) and a launch of the tables' queries,
    for the first ``held`` of them, on the engine's partitions: (the
    merged pairs, each slot's sorted buffers), the merge taken over those
    buffers (``lane_merge_plain``: its order is total, so sorting first
    changes nothing)."""
    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    P = cfg.num_partitions
    octet = cfg.fused_layout == "octet"
    launch = K.k6_launch if octet else K.k8_launch
    *_, slots = launch(eng.words.device, cfg, tables.shape[0], P)
    tables = tables[:held]
    kw = dict(num_slots=slots, lane_k=cfg.lane_k,
              tie_safe=bool(cfg.tie_safe_topk),
              block_sublanes=eng.fused.block_sublanes, codec=cfg.query_codec,
              merged=False, **eng.partition_kw)
    plain = K.octet_topk_batch_slots_plain if octet else \
        K.slice_topk_batch_slots_plain
    if octet:
        kw["fold_tile"] = cfg.fold_tile
    sv, st = plain(eng.words, tables, eng.nreal, eng.plan_rows, **kw)
    pairs = [K.lane_merge_plain(v, t, cfg.lane_k)
             for v, t in zip(sv.flatten(0, 1), st.flatten(0, 1))]
    shape = (tables.shape[0], *(() if P == 1 else (P,)), cfg.lane_k, 128)
    return ((torch.stack([v for v, _ in pairs]).view(shape),
             torch.stack([t for _, t in pairs]).view(shape)), (sv, st))


def _batch_launch(eng, tables, cfg, unmerged=False):
    """The engine's batch sweep (K6 on the octet layout, K8 on the slice
    layout) under cfg on the tables' queries, through its launch."""
    from spmv_topk_tpu_torch.ops import kernel as K

    args = (eng.words, tables, eng.nreal, eng.plan_rows,
            cfg.num_partitions, eng.partition_kw.get("part_slices", 0), cfg)
    bs = eng.fused.block_sublanes
    if cfg.fused_layout == "octet":
        return K.octet_topk_batch_cuda(*args, **K._sweep_kw(cfg, bs),
                                       unmerged=unmerged)
    return K._slice_topk_batch_cuda(*args, bs, unmerged=unmerged)


def _batch_agree(eng, tables, cfg, what, held=None, plain=True):
    """Require the engine's batch sweep (K8 / K10c on the slice layout, K6
    / K10d on the octet layout) under cfg on the tables' queries,
    tie-safe and with production buffers, to give its slot plain's pairs
    on its grid bit for bit, tags included, merged on the card and (the
    unmerged launch) slot by slot, for the first ``held`` queries (by
    default all: the slot plain takes a second or two a query at full
    size); tie-safe, every query's values those of the layout's batch
    plain (``slice_topk_batch_plain``, ``octet_topk_batch_plain``) too
    unless not ``plain``. Returns the tie-safe pools' max abs error
    against that plain (None without it)."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    octet = cfg.fused_layout == "octet"
    name = "K6" if octet else "K8"
    err = None
    for tie_safe in (True, False):
        tcfg = dataclasses.replace(cfg, tie_safe_topk=tie_safe)
        kv, kt = _batch_launch(eng, tables, tcfg)
        uv, ut = _batch_launch(eng, tables, tcfg, unmerged=True)
        n = held or tables.shape[0]
        (pv, pt), (sv, st) = _batch_slots_plain(eng, tables, tcfg, n)
        torch.cuda.synchronize()
        require(torch.equal(kv[:n], pv) and torch.equal(kt[:n], pt),
                f"{what} tie_safe={tie_safe}: {name} equals its slot plain")
        require(torch.equal(uv[:n], sv) and torch.equal(ut[:n], st),
                f"{what} tie_safe={tie_safe}: unmerged slots equal the "
                "plain's")
        if tie_safe and plain:
            ref = (K.octet_topk_batch_plain(
                *args, **K._sweep_kw(tcfg, eng.fused.block_sublanes),
                **eng.partition_kw) if octet else K.slice_topk_batch_plain(
                *args, **_slice_plain_kw(tcfg), **eng.partition_kw))
            err = compare_pools(kv, kt, *ref)
    return err


def _k8_alone_ms(eng, tables, cfg, reps=10):
    """K8 alone on the card, device time (``_device_ms``): (the launch,
    its lane merge included; the launch with the merge left out,
    ``unmerged``; one per-lane ``torch.topk`` over those unmerged slots,
    the merge of the kernel before this one)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    P = eng.config.num_partitions
    ps = eng.partition_kw.get("part_slices", 0)
    args = (eng.words, tables, eng.nreal, eng.plan_rows, P, ps, cfg,
            eng.fused.block_sublanes)
    slots = K._slice_topk_batch_cuda(*args, unmerged=True)
    fns = [lambda: K._slice_topk_batch_cuda(*args),
           lambda: K._slice_topk_batch_cuda(*args, unmerged=True),
           lambda: K.merge_lane_topk(*slots, cfg.lane_k,
                                     lead=1 + int(P > 1))]
    for fn in fns:
        fn()
    return tuple(_device_ms([fn], reps)[0][0] for fn in fns)


def _k8_instantiation(codec, pass_queries, lane_k, tie_safe):
    """The name ``_build.ptxas_report`` gives K8's kernel for a kernel
    codec (KERNEL_CODECS), pass, lane_k and buffers."""
    pc = {"h16": f"H16Pass<{pass_queries}>",
          "f32": f"FloatPass<F32T<1>,{pass_queries}>",
          "f32_global": f"FloatPass<F32T<0>,{pass_queries}>",
          "int8x4": f"FloatPass<Int8x4T<1>,{pass_queries}>",
          "int8x4_global": f"FloatPass<Int8x4T<0>,{pass_queries}>",
          "i8s": f"FloatPass<Sign,{pass_queries}>",
          "i4s": f"FloatPass<Sign,{pass_queries}>"}[codec]
    return f"slice_topk_batch_kernel<{pc},{lane_k},{int(tie_safe)}>"


def _k8_times(eng, tables, cfg, key="k8"):
    """K8's numbers at an engine's shapes beyond its wrapper's time: alone
    on the card with and without its merge and the ``torch.topk`` merge
    of its unmerged slots (``_k8_alone_ms``), its grid, passes and slots,
    its slots' balance (``_k7_deal_balance`` at fold_tile 1 against the
    kernel before it: item g to slot g mod its slots), and the registers
    and spill bytes of the instantiation it launches."""
    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops import kernel as K

    dev = eng.words.device
    P = cfg.num_partitions
    Q = tables.shape[0]
    codec, qp, passes, slots = K.k8_launch(dev, cfg, Q, P)
    alone, unmerged, topk_merge = _k8_alone_ms(eng, tables, cfg)
    sms = _device_info_sms(dev)
    *_, old = K.batch_grid(Q, K.BATCH_SUBGROUP, sms,
                                 eng.words.shape[0] // P // 8, P)
    name = _k8_instantiation(codec, qp, cfg.lane_k,
                             bool(cfg.tie_safe_topk))
    regs, spill = _build.ptxas_report()[name]
    groups = 128 // K.batch_block_lanes(qp, cfg.lane_k, codec)
    return {f"{key}_alone_ms": alone, f"{key}_unmerged_ms": unmerged,
            f"{key}_card_merge_ms": alone - unmerged,
            f"{key}_topk_merge_of_the_slots_ms": topk_merge,
            f"{key}_kernel_codec": codec, f"{key}_pass_queries": qp,
            f"{key}_passes": passes, f"{key}_slots": slots,
            f"{key}_cuda_blocks": slots * groups * P * passes,
            f"{key}_instantiation": name, f"{key}_registers": regs,
            f"{key}_spill_bytes": spill, f"{key}_slots_plain_equal": True,
            **{f"{key}_{k}": v for k, v in _k7_deal_balance(
                eng, slots, fold_tile=1, old=old).items()}}


def _device_info_sms(dev):
    import torch

    return torch.cuda.get_device_properties(dev).multi_processor_count


def _k3_library_ms(words, salt, k3_sum):
    """K3's library yardstick: one PyTorch reduction of the words' (8,
    128) chunks in int32 plus the salt (int32 wraparound), required equal
    to K3's checksum ``k3_sum``, then timed (CUDA events)."""
    import torch

    def lib():
        return words.view(-1, 8, 128).sum(0, dtype=torch.int32) + salt

    require(torch.equal(lib(), k3_sum),
            "torch's int32 chunk sum plus the salt equals K3's checksum")
    return cuda_ms(lib, reps=20, warmup=2)


def _k6_alone_ms(eng, tables, cfg, reps=10):
    """K6 alone on the card, device time (``_device_ms``) on the engine's
    stream: (the launch, its lane merge included; the launch with the
    merge left out, ``unmerged``; one per-lane ``torch.topk`` over those
    unmerged slots, the merge of the kernels before K6's card merges)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    P = eng.config.num_partitions
    kw = K._sweep_kw(cfg, eng.fused.block_sublanes)
    ps = eng.partition_kw.get("part_slices", 0)
    args = (eng.words, tables, eng.nreal, eng.plan_rows, P, ps, cfg)
    slots = K.octet_topk_batch_cuda(*args, **kw, unmerged=True)
    fns = [lambda: K.octet_topk_batch_cuda(*args, **kw),
           lambda: K.octet_topk_batch_cuda(*args, **kw, unmerged=True),
           lambda: K.merge_lane_topk(*slots, cfg.lane_k, lead=1 + int(P > 1))]
    for fn in fns:
        fn()
    return tuple(_device_ms([fn], reps)[0][0] for fn in fns)


def phase_batch(eng, qs, gold, single, k1_ms, dev):
    """The batch path on the main-path engine: query_batch through K6."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch.formats import create_query_batch
    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops.kernel import (
        octet_h16_grid, octet_topk_batch_plain,
        topk_spmv_fused_batch_octet_device)

    cfg = eng.config
    k = cfg.k
    many = create_query_batch(BATCH_GROUP * BATCH_GROUPS, NUM_COLS,
                              seed=BATCH_SEED)
    eng.query_batch(many[:BATCH_GROUP], group_size=BATCH_GROUP)     # warm
    eng.query_batch(many[:BATCH_GROUP], group_size=BATCH_GROUP,
                    rescore_pool=0)
    torch.cuda.synchronize()

    topk_spmv_fused_batch_octet_device.launches = 0
    t0 = time.perf_counter()
    idx, vals = eng.query_batch(qs, group_size=BATCH_GROUP)
    torch.cuda.synchronize()
    group_ms = (time.perf_counter() - t0) * 1e3
    e2e = _e2e_ms_per_query(eng, many, BATCH_GROUP)
    e2e_raw = _e2e_ms_per_query(eng, many, BATCH_GROUP, rescore_pool=0)
    launches = topk_spmv_fused_batch_octet_device.launches

    idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
    require(idx.shape == (NUM_QUERIES, k) and (idx >= 0).all()
            and np.isfinite(vals).all(),
            "query_batch returns k valid rows with finite scores per query")
    prec = [len(gold[j] & set(idx[j].tolist())) / k
            for j in range(NUM_QUERIES)]
    same = [len(set(single[j].tolist()) & set(idx[j].tolist())) / k
            for j in range(NUM_QUERIES)]

    # K6 against its plain version with tie-safe buffers, all 32 queries
    tables = _tables(qs, dev)
    safe = dataclasses.replace(cfg, tie_safe_topk=True)
    (kv, kt), (pv, pt) = _batch_plain_and_kernel(eng, tables, safe)
    torch.cuda.synchronize()
    k6_err = max(compare_lanes(kv[j], kt[j], pv[j], pt[j])
                 for j in range(NUM_QUERIES))

    bs = eng.fused.block_sublanes
    args = (eng.words, tables, eng.nreal, eng.plan_rows)
    k6_ms = cuda_ms(lambda: topk_spmv_fused_batch_octet_device(
        *args, cfg=cfg, block_sublanes=bs), reps=10, warmup=2)
    k6_plain_ms = cuda_ms(lambda: octet_topk_batch_plain(
        *args, lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
        tie_safe=bool(cfg.tie_safe_topk), block_sublanes=bs), reps=1,
        warmup=0)
    # the kernel alone on the card, with and without its lane merge, and
    # the torch.topk merge of its slots, for the 32 and for 64 queries
    # (two passes over the stream)
    k6_alone_ms, k6_sweep_ms, k6_topk_merge_ms = _k6_alone_ms(eng, tables,
                                                             cfg)
    k6_alone_ms_64q = _k6_alone_ms(eng, _tables(many[:64], dev), cfg)[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    passes, slots = octet_h16_grid(NUM_QUERIES, sms, lane_k=cfg.lane_k)
    regs = {k: dict(registers=r, spill_bytes=sp)
            for k, (r, sp) in _build.ptxas_report().items()
            if k.startswith("octet_topk_batch_h16_kernel<")}
    require(regs and all(v["spill_bytes"] == 0 for v in regs.values()),
            "no K6 h16 instantiation spills")
    per_query = k6_ms / NUM_QUERIES
    k6_bound = sweep_bound(eng, NUM_QUERIES, topk_out_bytes(eng, NUM_QUERIES))
    res = dict(
        phase="batch_path", queries=NUM_QUERIES, group_size=BATCH_GROUP,
        k6_bound_ms=k6_bound[0], k6_bound_by=k6_bound[1],
        precision_at_100_mean=float(np.mean(prec)),
        precision_at_100_min=float(np.min(prec)),
        agreement_with_query_mean=float(np.mean(same)),
        agreement_with_query_min=float(np.min(same)),
        group_of_32_e2e_ms=group_ms,
        k6_ms=k6_ms, k6_plain_ms=k6_plain_ms, k6_max_abs_err=k6_err,
        k6_alone_ms=k6_alone_ms, k6_alone_ms_64_queries=k6_alone_ms_64q,
        k6_sweep_alone_ms=k6_sweep_ms,
        k6_merge_share=1 - k6_sweep_ms / k6_alone_ms,
        stream_reads_per_group=passes, octet_slots=slots,
        block_buffer_bytes_per_group=NUM_QUERIES * slots * cfg.lane_k * 128 * 8,
        words_bytes=eng.hbm_bytes,
        batch32_ms_per_query=per_query,
        batch32_gnnz_per_query=eng.num_nnz / (per_query * 1e-3) / 1e9,
        batch32_e2e_ms_per_query=e2e,
        batch32_e2e_raw_ms_per_query=e2e_raw,
        batch32_rescore_overhead_pct=(e2e / e2e_raw - 1) * 100,
        single_query_k1_ms=k1_ms, launches=launches,
        nvidia_smi=smi_line())
    emit(res)
    emit(dict(phase="batch_k6_h16_registers", instantiations=regs))
    emit(dict(phase="batch_k6_h16_split", queries=NUM_QUERIES,
              k6_ms=k6_ms, k6_alone_ms=k6_alone_ms,
              k6_sweep_alone_ms=k6_sweep_ms,
              card_merge_ms=k6_alone_ms - k6_sweep_ms,
              merge_share=res["k6_merge_share"],
              torch_topk_merge_of_the_slots_ms=k6_topk_merge_ms,
              stream_reads_per_group=passes, octet_slots=slots,
              # the subgroup kernel this one replaced, on the same corpus
              # and card (PERF.md section 6)
              k6_ms_subgroup_kernel=2.431))
    require(res["precision_at_100_mean"] >= MIN_PRECISION,
            f"batch mean precision@100 >= {MIN_PRECISION}")
    require(launches > 0, "query_batch launched K6")
    return res


def phase_scores(eng, qs, dev):
    """The scores path on the main-path engine: scores() through K4 (a
    zero fill and one launch in row order), its host-clock and device
    times and the path before the row-order store's (``_scores_path``);
    K4 held to its plain version in both store forms and timed in both,
    with their bounds (``_scores_times``)."""
    import torch

    from spmv_topk_tpu_torch.ops.kernel import spmv_fused_scores_octet_device

    q = qs[0]
    eng.scores(q)                                            # warm
    torch.cuda.synchronize()
    spmv_fused_scores_octet_device.launches = 0
    e2e = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = eng.scores(q)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
    launches = spmv_fused_scores_octet_device.launches
    s = s.cpu().numpy()
    require(s.shape == (eng.num_rows,) and np.isfinite(s).all(),
            "scores() returns a finite score per row")
    exact = np.asarray(eng._scipy_csr @ q, np.float32)

    k4_err = _scores_agree(eng, q)
    times = _scores_times(eng, q, "k4")
    res = dict(phase="scores_path", rows=eng.num_rows,
               scores_e2e_ms_median=statistics.median(e2e),
               **_scores_path(eng, q), **times, k4_max_abs_err=k4_err,
               k4_words_gb_per_s=eng.hbm_bytes / (times["k4_ms"] * 1e-3)
               / 1e9,
               max_abs_diff_vs_exact_f32=float(np.abs(s - exact).max()),
               max_abs_exact=float(np.abs(exact).max()),
               launches=launches, nvidia_smi=smi_line())
    emit(res)
    require(launches == 5, "each scores() launched K4 once")
    return res


# ------------------------------------------------------------ slice layout

def _integer_valued(coo, seed):
    """The corpus with integer values in [-8, 8]: exact in bf16, and every
    partial sum of the f32 codec an exact f32, so any summation order
    gives the same bits."""
    from spmv_topk_tpu_torch.formats import CooMatrix

    vals = np.random.default_rng(seed).integers(-8, 9, coo.nnz).astype(
        np.float32)
    return CooMatrix(coo.rows, coo.cols, vals, coo.num_rows, coo.num_cols)


def _slice_plain_kw(cfg):
    return dict(lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk),
                block_sublanes=cfg.fused_block_sublanes,
                codec=cfg.query_codec)


def _slice_agree(eng, cfg, q, qs, dev, held=None):
    """K7 (query q), K8 (queries qs in one group) and K9 (query q) of one
    engine under cfg (tie-safe buffers) against their plain versions,
    which sum in the kernels' order for both codecs: per-lane values and
    K9's scores bit-equal in both store forms (``_scores_agree``), and
    (value, tag) pairs equal above each lane's floor; K7 and K8, tie-safe
    and with production buffers, bit for bit against their slot plains
    too (``_k7_agree``, ``_batch_agree``, K8's for its first ``held``
    queries). Returns the three max abs errors."""
    table, _ = eng._table(q)
    k7 = _k7_agree(eng, table, cfg, "K7")
    k8 = _batch_agree(eng, _tables(qs, dev, cfg.query_codec), cfg,
                      f"K8 {len(qs)} queries", held)
    return k7, k8, _scores_agree(eng, q)


def _scores_registers():
    """The registers and spills of every instantiation of K9 and K4 (five
    codec types, two store forms each), from the build's ptxas report;
    requires that none spills."""
    from spmv_topk_tpu_torch.ops import _build

    report = _build.ptxas_report()
    out = {}
    for kernel in ("slice_scores_kernel<", "octet_scores_kernel<"):
        regs = {k: dict(registers=r, spill_bytes=sp)
                for k, (r, sp) in report.items() if k.startswith(kernel)}
        require(len(regs) == 10, f"{kernel}...>: 10 instantiations, got "
                f"{len(regs)}")
        require(all(v["spill_bytes"] == 0 for v in regs.values()),
                f"no {kernel}...> instantiation spills: {regs}")
        out[f"{kernel[:-1]}_registers"] = regs
    return out


def phase_slice_small(dev):
    """K7, K8, K9 vs their plain versions on a 50k-row corpus: h16 at
    quantum 2 with fold 8 and fold 1, f32 at quantum 8 (integer-valued
    data, then the real values: the plain version sums in the kernels'
    order), blocks small enough for wide slices, and blocks past the
    JAX kernel's unroll threshold (every slice folded despite fold 8).
    K8 runs 5 queries in subgroups of 2 (the last holds one)."""
    import dataclasses

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops import kernel as K

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    icoo = _integer_valued(coo, 17)
    rng = np.random.default_rng(18)
    iq = rng.integers(-8, 9, (6, NUM_COLS)).astype(np.float32)
    q = create_query_batch(1, NUM_COLS, seed=8)[0]
    qs5 = create_query_batch(5, NUM_COLS, seed=9)
    h16 = dict(SLICE_BATCH, tie_safe_topk=True, rescore_pool=None)
    f32 = dict(k=100, max_cols=NUM_COLS, tie_safe_topk=True)
    cases = []
    for name, kw, integer, want in (
            ("h16_q2_fold8", h16, False, {K.TILED}),
            ("h16_q2_fold1", dict(h16, fold_tile=1), False, {K.RUNS}),
            ("f32_q8_fold1", f32, True, {K.RUNS}),
            ("f32_q8_fold1_real", f32, False, {K.RUNS}),
            ("h16_q2_fold8_wide", dict(h16, fused_block_sublanes=32), False,
             {K.WIDE, K.TILED}),
            ("f32_q8_fold1_wide", dict(f32, fused_block_sublanes=32), True,
             {K.WIDE, K.RUNS}),
            ("h16_q2_fold8_unroll", dict(h16, fused_block_sublanes=2048),
             False, {K.RUNS})):
        cfg = TopKSpMVConfig(**kw)
        eng = TopKSpMV(icoo if integer else coo, cfg, device=dev)
        modes = {K.slice_work(r, cfg.fold_tile)[0]
                 for r in eng.plan_rows.tolist()}
        require(want <= modes and modes <= want | {K.RUNS},
                f"{name}: work-item modes {sorted(modes)} cover {want}")
        k7, k8, k9 = _slice_agree(
            eng, dataclasses.replace(cfg, batch_subgroup=2),
            iq[0] if integer else q, iq[1:] if integer else qs5, dev)
        cases.append(dict(case=name, buckets=len(eng.fused.plan),
                          wide_buckets=sum(p.blocks_per_slice > 1
                                           for p in eng.fused.plan),
                          work_items=K.slice_work_items(eng.plan_rows,
                                                        cfg.fold_tile),
                          k7_max_abs_err=k7, k8_max_abs_err=k8,
                          k9_max_abs_err=k9))
    out = dict(phase="slice_kernels_vs_plain_small", rows=coo.num_rows,
               nnz=coo.nnz, cases=cases, **_scores_registers())
    emit(out)
    return out


def _same_top(idx, vals, ref_idx, ref_vals, what, rtol=0.0):
    """Require two top-k lists of one query to hold the same values (bit
    for bit, or within ``rtol``) and the same rows, but where a row ties
    the k-th value, or lies within ``rtol`` of it (either list may keep
    another of the tied rows)."""
    if rtol:
        require(np.allclose(vals, ref_vals, rtol=rtol, atol=0),
                f"{what}: top-k values equal to rtol {rtol}")
    else:
        require(np.array_equal(vals, ref_vals), f"{what}: top-k values "
                "equal bit for bit")
    kth = ref_vals[-1] + rtol * abs(ref_vals[-1])
    require(set(idx[vals > kth].tolist()) == set(ref_idx[ref_vals > kth]
                                                 .tolist()),
            f"{what}: the same rows above the k-th value")


def _precision(gold, idx, k):
    return [len(g & set(i.tolist())) / k for g, i in zip(gold, idx)]


def _gold_sets(csr, qs, k):
    scores = np.asarray(csr @ qs.T)                       # (rows, Q)
    return [set(np.argpartition(-scores[:, j], k - 1)[:k].tolist())
            for j in range(scores.shape[1])]


def _drive(eng, qs, k, group):
    """query() of each query (host-clock ms, indices, values), then
    query_batch of all of them in groups of ``group``, then one scores().
    Returns (single indices, single values, query ms, batch indices,
    batch values, batch ms, scores, scores ms)."""
    import torch

    single, svals, q_ms = [], [], []
    for q in qs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, vals = eng.query(q)
        torch.cuda.synchronize()
        q_ms.append((time.perf_counter() - t0) * 1e3)
        idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
        require(idx.shape == (eng.config.k,) and (idx >= 0).all()
                and np.isfinite(vals).all(),
                "query returns k valid rows with finite scores")
        single.append(idx)
        svals.append(vals)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bidx, bvals = eng.query_batch(qs, group_size=group)
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t0) * 1e3
    bidx, bvals = bidx.cpu().numpy(), bvals.cpu().numpy()
    require(bidx.shape == (len(qs), eng.config.k) and (bidx >= 0).all()
            and np.isfinite(bvals).all(),
            "query_batch returns k valid rows with finite scores per query")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = eng.scores(qs[0])
    torch.cuda.synchronize()
    s_ms = (time.perf_counter() - t0) * 1e3
    s = s.cpu().numpy()
    require(s.shape == (eng.num_rows,) and np.isfinite(s).all(),
            "scores() returns a finite score per row")
    return single, svals, q_ms, bidx, bvals, b_ms, s, s_ms


def _reset_slice_counts():
    from spmv_topk_tpu_torch.ops import kernel as K

    for w in (K.topk_spmv_fused_device, K.topk_spmv_fused_batch_device,
              K.spmv_fused_scores_device):
        w.launches = 0


def _slice_counts():
    from spmv_topk_tpu_torch.ops import kernel as K

    return dict(slice_topk=K.topk_spmv_fused_device.launches,
                slice_topk_batch=K.topk_spmv_fused_batch_device.launches,
                slice_scores=K.spmv_fused_scores_device.launches)


def _slice_kernel_times(eng, qs, dev, group):
    """K7, K8 (one group of the first ``group`` queries of qs, the
    path's group size) and K9 held to their plain versions at this
    engine's shapes (``_slice_agree``, tie-safe buffers: bit-equal; K7's
    and K8's production buffers bit for bit against their slot plains),
    then each timed against its plain version (K9 in both store forms,
    ``_scores_times``; scores() on the host clock and between CUDA
    events, ``_scores_path``); K7 and K8 alone on the card with and
    without their lane merge (``_k7_alone_ms``, ``_k8_times``: K8's grid,
    passes, registers and spills too), their grids and their slots'
    balance (``_k7_deal_balance``)."""
    import dataclasses

    from spmv_topk_tpu_torch.ops import kernel as K

    cfg = eng.config
    qs = qs[:group]
    k7, k8, k9 = _slice_agree(
        eng, dataclasses.replace(cfg, tie_safe_topk=True), qs[0], qs, dev,
        held=K8_HELD)
    bs = cfg.fused_block_sublanes
    parts = eng.partition_kw
    table, _ = eng._table(qs[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bargs = (eng.words, _tables(qs, dev, cfg.query_codec), eng.nreal,
             eng.plan_rows)
    P = cfg.num_partitions
    plain_kw = dict(_slice_plain_kw(cfg), **parts)
    bounds = dict(k7=sweep_bound(eng, 1, topk_out_bytes(eng, 1)),
                  k8=sweep_bound(eng, len(qs), topk_out_bytes(eng, len(qs))))
    alone, unmerged, topk_merge = _k7_alone_ms(eng, table, cfg)
    blocks, slots = K.slice_topk_grid(dev, cfg, eng.words.shape[0] // P, P)
    return dict(**_k8_times(eng, bargs[1], cfg),
        k7_alone_ms=alone, k7_unmerged_ms=unmerged,
        k7_card_merge_ms=alone - unmerged,
        k7_topk_merge_of_the_slots_ms=topk_merge, k7_blocks=blocks,
        k7_slots=slots, k7_slots_plain_equal=True,
        **{f"k7_{k}": v for k, v in _k7_deal_balance(eng, slots).items()},
        k7_ms=cuda_ms(lambda: K.topk_spmv_fused_device(
            *args, cfg=cfg, block_sublanes=bs, **parts), reps=20, warmup=2),
        k7_plain_ms=cuda_ms(lambda: K.slice_topk_plain(
            *args, fold_tile=cfg.fold_tile, **plain_kw), reps=2),
        k7_max_abs_err=k7,
        k8_ms=cuda_ms(lambda: K.topk_spmv_fused_batch_device(
            *bargs, cfg=cfg, block_sublanes=bs, **parts), reps=10, warmup=2),
        k8_plain_ms=cuda_ms(lambda: K.slice_topk_batch_plain(
            *bargs, **plain_kw), reps=1, warmup=0),
        k8_max_abs_err=k8, k8_queries=len(qs),
        **_scores_times(eng, qs[0], "k9"), **_scores_path(eng, qs[0]),
        k9_max_abs_err=k9,
        **{f"{k}_bound_ms": b[0] for k, b in bounds.items()},
        **{f"{k}_bound_by": b[1] for k, b in bounds.items()})


def _bf16_gold_sets(csr, qs, k):
    """The top-k sets of the bf16-rounded matrix, what the engines without
    a rescore rank by."""
    import scipy.sparse

    from spmv_topk_tpu_torch.ops.fixedpoint import quantize_bf16

    bf16 = scipy.sparse.csr_matrix(
        (quantize_bf16(csr.data), csr.indices, csr.indptr), shape=csr.shape)
    return _gold_sets(bf16, qs, k)


def _unrescored_agree(eng, qs, group, single, svals, bidx, bvals, dev):
    """An engine without a rescore against its plain path and its two
    entry points against each other: each query()'s top-k bit-equal to
    the plain sweep's, finalized and scaled as query() does; K8's
    candidates (tie-safe, the path's first group) bit-equal to K7's for
    each query, since both fold every slice and sum alike; and
    query_batch's top-k the same as query()'s, bit for bit for f32 and to
    rtol 1e-6 for the scaled codecs (query_batch scales in float32,
    query() in float64)."""
    import dataclasses

    from spmv_topk_tpu_torch.ops import kernel as K

    cfg = eng.config
    bs = cfg.fused_block_sublanes
    parts = eng.partition_kw
    safe = dataclasses.replace(cfg, tie_safe_topk=True)
    tables = _tables(qs[:group], dev, cfg.query_codec)
    bv, bt = K.topk_spmv_fused_batch_device(
        eng.words, tables, eng.nreal, eng.plan_rows, cfg=safe,
        block_sublanes=bs, **parts)
    for j in range(len(tables)):
        sv, st = K.topk_spmv_fused_device(
            eng.words, tables[j], eng.nreal, eng.plan_rows, cfg=safe,
            block_sublanes=bs, **parts)
        compare_pools(bv[j], bt[j], sv, st)
    rtol = 0.0 if cfg.query_codec == "f32" else 1e-6
    for j, q in enumerate(qs):
        table, scale = eng._table(q)
        pv, pt = K.slice_topk_plain(eng.words, table, eng.nreal,
                                    eng.plan_rows, fold_tile=cfg.fold_tile,
                                    **_slice_plain_kw(cfg), **parts)
        pidx, pvals = K.finalize_topk(pv, pt, eng.row_ids, k=cfg.k)
        scale *= eng._value_scale
        if scale != 1.0:
            pvals = pvals * scale
        _same_top(single[j], svals[j], pidx.cpu().numpy(),
                  pvals.cpu().numpy(), "query() against the plain path")
        _same_top(bidx[j], bvals[j], single[j], svals[j],
                  "query_batch against query()", rtol=rtol)


def _k10a_int8x4(coo, eng, qs, gold, gold_bf16, dev):
    """The partitioned default engine with the int8x4 query codec, built
    through ``TopKSpMV`` (its words are the f32 engine's ``eng``'s,
    required equal: formats/sell_buckets.py re-encodes only i8s and i4s,
    and ``prod_int8x4`` reads the same col | bf16 word): its query() path
    over every query, the slice counts zeroed just before (its K10a
    launches) and its answers held to the precision floor of ``eng``'s
    path, then its query_batch in groups of 8 the same way (its K10c
    launches); then K10a on its words and table held to its slot plain,
    tie-safe and not, and to ``slice_topk_plain`` (``_k7_agree``), K10c
    on the first group's tables the same way (``_batch_agree``), each timed
    through its wrapper, alone, unmerged and against its plain version."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch import TopKSpMV
    from spmv_topk_tpu_torch.ops import kernel as K

    cfg = dataclasses.replace(eng.config, query_codec="int8x4")
    e8 = TopKSpMV(coo, cfg, device=dev)
    require(torch.equal(e8.words, eng.words),
            "the int8x4 engine's words are the f32 engine's")
    e8.query(qs[0])                                       # warm
    torch.cuda.synchronize()
    _reset_slice_counts()
    idx, q_ms = [], []
    for q in qs:
        t0 = time.perf_counter()
        i, v = e8.query(q)
        torch.cuda.synchronize()
        q_ms.append((time.perf_counter() - t0) * 1e3)
        require(i.shape == (cfg.k,) and bool((i >= 0).all())
                and bool(torch.isfinite(v).all()),
                "int8x4 query returns k valid rows with finite scores")
        idx.append(i.cpu().numpy())
    launches = _slice_counts()["slice_topk"]
    floor, ref = ((MIN_PRECISION, gold) if cfg.rescore_pool else
                  (MIN_PRECISION_BF16, gold_bf16))
    prec = float(np.mean(_precision(ref, idx, cfg.k)))
    require(prec >= floor, f"the partitioned int8x4 path's precision@100 "
            f"{prec} >= {floor}")
    # the path's query_batch in groups of 8: its K10c launches
    _reset_slice_counts()
    bidx, _ = e8.query_batch(qs, group_size=DEFAULT_GROUP)
    torch.cuda.synchronize()
    batch_launches = _slice_counts()["slice_topk_batch"]
    bprec = float(np.mean(_precision(ref, bidx.cpu().numpy(), cfg.k)))
    require(bprec >= floor, f"the partitioned int8x4 path's batch "
            f"precision@100 {bprec} >= {floor}")
    tables = _tables(qs[:DEFAULT_GROUP], dev, cfg.query_codec)
    err10c = _batch_agree(e8, tables, cfg, "K10c int8x4", held=K8_HELD)
    table, _ = e8._table(qs[0])
    err = _k7_agree(e8, table, cfg, "K10a int8x4")
    bs = e8.fused.block_sublanes
    args = (e8.words, table, e8.nreal, e8.plan_rows)
    ms = cuda_ms(lambda: K.topk_spmv_fused_device(
        *args, cfg=cfg, block_sublanes=bs, **e8.partition_kw), reps=20,
        warmup=2)
    alone, unmerged, _ = _k7_alone_ms(e8, table, cfg)
    plain_ms = cuda_ms(lambda: K.slice_topk_plain(
        *args, fold_tile=cfg.fold_tile, **_slice_plain_kw(cfg),
        **e8.partition_kw), reps=2)
    b = bound(e8.hbm_bytes + table.numel() * 4 + topk_out_bytes(e8, 1),
              2 * e8.num_nnz)
    bargs = (e8.words, tables, e8.nreal, e8.plan_rows)
    b10c = sweep_bound(e8, DEFAULT_GROUP, topk_out_bytes(e8, DEFAULT_GROUP))
    k10c = dict(
        k10c_int8x4_ms=cuda_ms(lambda: K.topk_spmv_fused_batch_device(
            *bargs, cfg=cfg, block_sublanes=bs, **e8.partition_kw), reps=10,
            warmup=2),
        k10c_int8x4_plain_ms=cuda_ms(lambda: K.slice_topk_batch_plain(
            *bargs, **_slice_plain_kw(cfg), **e8.partition_kw), reps=1,
            warmup=0),
        k10c_int8x4_launches=batch_launches,
        k10c_int8x4_batch_precision_mean=bprec,
        k10c_int8x4_max_abs_err=err10c, k10c_int8x4_queries=DEFAULT_GROUP,
        k10c_int8x4_bound_ms=b10c[0], k10c_int8x4_bound_by=b10c[1],
        **_k8_times(e8, tables, cfg, key="k10c_int8x4"))
    del e8
    torch.cuda.empty_cache()
    return dict(**k10c, k10a_int8x4_ms=ms, k10a_int8x4_launches=launches,
                k10a_int8x4_precision_mean=prec,
                k10a_int8x4_query_e2e_ms_median=statistics.median(q_ms),
                k10a_int8x4_alone_ms=alone, k10a_int8x4_unmerged_ms=unmerged,
                k10a_int8x4_plain_ms=plain_ms, k10a_int8x4_max_abs_err=err,
                k10a_int8x4_bound_ms=b[0], k10a_int8x4_bound_by=b[1],
                k10a_int8x4_slots_plain_equal=True)


def phase_slice_engine(coo, csr, qs, gold, gold_bf16, dev, name, config,
                       group):
    """One slice-layout engine built from ``config`` on the full corpus
    (kernels K7, K8, K9; with num_partitions > 1, K10a, K10c and the
    partitioned K9): 32 query() against the exact and the bf16-matrix
    top-100 (and, rescored, the raw pool's), query_batch in groups of
    ``group``, one scores() against the exact f32 product, K7, K8 (the
    path's group) and K9 held to (tie-safe) and timed against their plain
    versions, K3 on the words; with ``group`` 32, the batch32_* numbers.

    A rescored engine is held to MIN_PRECISION against the exact top-100
    in query(), query_batch and their agreement; one without a rescore
    ranks by bf16 matrix values and is held to MIN_PRECISION_BF16 against
    the bf16 matrix's top-100, and to its plain path
    (``_unrescored_agree``)."""
    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import create_query_batch
    from spmv_topk_tpu_torch.ops import kernel as K
    from spmv_topk_tpu_torch.ops.streamprobe import stream_words_device

    cfg = TopKSpMVConfig(**config)
    t0 = time.perf_counter()
    eng = TopKSpMV(coo, cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k = cfg.k
    eng.query(qs[0])                                      # warm
    eng.query_batch(qs[:2], group_size=2)
    eng.scores(qs[0])
    torch.cuda.synchronize()
    _reset_slice_counts()
    single, svals, q_ms, bidx, bvals, b_ms, s, s_ms = _drive(eng, qs, k,
                                                             group)
    torch.cuda.synchronize()
    launches = _slice_counts()
    raw = ([eng.query(q, rescore_pool=0)[0].cpu().numpy() for q in qs]
           if cfg.rescore_pool else single)
    same = [len(set(a.tolist()) & set(b.tolist())) / k
            for a, b in zip(single, bidx)]
    if not cfg.rescore_pool:
        _unrescored_agree(eng, qs, group, single, svals, bidx, bvals, dev)
    prec = _precision(gold, single, k)
    bprec = _precision(gold, bidx, k)
    res = dict(
        phase=f"{name}_path", config=config, rows=eng.num_rows,
        buckets=len(eng.fused.plan),
        widths=[p.width for p in eng.fused.plan],
        work_items=K.slice_work_items(eng.plan_rows, cfg.fold_tile),
        words_bytes=eng.hbm_bytes,
        padding_words_per_nnz=eng.fused.padding_ratio,
        pack_and_upload_s=build_s, queries=len(qs),
        precision_at_100_mean=float(np.mean(prec)),
        precision_at_100_min=float(np.min(prec)),
        precision_bf16_matrix_mean=float(np.mean(
            _precision(gold_bf16, single, k))),
        precision_bf16_matrix_min=float(np.min(
            _precision(gold_bf16, single, k))),
        precision_raw_mean=float(np.mean(_precision(gold, raw, k))),
        precision_raw_bf16_matrix_mean=float(np.mean(
            _precision(gold_bf16, raw, k))),
        query_e2e_ms_median=statistics.median(q_ms),
        batch_precision_at_100_mean=float(np.mean(bprec)),
        batch_precision_at_100_min=float(np.min(bprec)),
        batch_precision_bf16_matrix_mean=float(np.mean(
            _precision(gold_bf16, bidx, k))),
        agreement_with_query_mean=float(np.mean(same)),
        agreement_with_query_min=float(np.min(same)),
        batch_group_size=group, batch_e2e_ms_per_query=b_ms / len(qs),
        scores_e2e_ms=s_ms)
    times = _slice_kernel_times(eng, qs, dev, group)
    if cfg.num_partitions > 1 and cfg.query_codec == "f32":
        times.update(_k10a_int8x4(coo, eng, qs, gold, gold_bf16, dev))
    if group == BATCH_GROUP:
        many = create_query_batch(BATCH_GROUP * BATCH_GROUPS, NUM_COLS,
                                  seed=BATCH_SEED)
        per_query = times["k8_ms"] / group
        res.update(
            batch32_ms_per_query=per_query,
            batch32_gnnz_per_query=eng.num_nnz / (per_query * 1e-3) / 1e9,
            batch32_e2e_ms_per_query=_e2e_ms_per_query(eng, many, group),
            batch32_e2e_raw_ms_per_query=_e2e_ms_per_query(
                eng, many, group, rescore_pool=0))
    exact = np.asarray(csr @ qs[0], np.float32)
    salt = torch.arange(128, dtype=torch.int32, device=dev).reshape(1, 128)
    k3_ms = cuda_ms(lambda: stream_words_device(eng.words, salt), reps=20,
                    warmup=2)
    res.update(
        scores_max_abs_diff_vs_exact_f32=float(np.abs(s - exact).max()),
        max_abs_exact=float(np.abs(exact).max()), **times,
        k7_words_gb_per_s=eng.hbm_bytes / (times["k7_ms"] * 1e-3) / 1e9,
        k3_ms=k3_ms, k3_gb_per_s=eng.hbm_bytes / (k3_ms * 1e-3) / 1e9,
        k3_library_ms=_k3_library_ms(eng.words, salt,
                                     stream_words_device(eng.words, salt)),
        launches=launches, nvidia_smi=smi_line())
    emit(res)
    if cfg.rescore_pool:
        floor, keys = MIN_PRECISION, ("precision_at_100_mean",
                                      "batch_precision_at_100_mean",
                                      "agreement_with_query_mean")
    else:
        floor, keys = MIN_PRECISION_BF16, ("precision_bf16_matrix_mean",
                                           "batch_precision_bf16_matrix_mean")
    for key in keys:
        require(res[key] >= floor, f"{name} path {key} >= {floor}")
    for kname, n in launches.items():
        require(n > 0, f"the {name} path launched {kname}")
    res["_answers"] = (single, svals)     # the sharded phase's reference
    del eng
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ partitions

def phase_partition_small(dev):
    """K10a-d and the partitioned K4/K9 against their plain versions on
    a 50k-row corpus at P = 3 and 4 (tie-safe buffers: bit-equal values,
    (value, tag) pairs above each lane's floor, scores bit-equal; the
    batch sweeps on 5 queries in subgroups of 2); then f32 K7, K8, K9 at
    65,536 columns, their tables read from global memory, on one and on
    two partitions."""
    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops import kernel as K

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    icoo = _integer_valued(coo, 17)
    rng = np.random.default_rng(18)
    iq = rng.integers(-8, 9, (6, NUM_COLS)).astype(np.float32)
    q = create_query_batch(1, NUM_COLS, seed=8)[0]
    qs5 = create_query_batch(5, NUM_COLS, seed=9)
    octet = dict(HEADLINE, tie_safe_topk=True, rescore_pool=None,
                 batch_subgroup=2)
    h16 = dict(SLICE_BATCH, tie_safe_topk=True, rescore_pool=None,
               batch_subgroup=2)
    f32 = dict(k=100, max_cols=NUM_COLS, tie_safe_topk=True,
               batch_subgroup=2)
    cases = []
    for name, kw, integer, P in (
            ("octet_h16_fold8", octet, False, 3),
            ("octet_h16_fold1", dict(octet, fold_tile=1), False, 4),
            ("octet_h16_wide", dict(octet, fused_block_sublanes=64), False,
             3),
            ("slice_h16_q2_fold8", h16, False, 3),
            ("slice_h16_q2_fold8_wide", dict(h16, fused_block_sublanes=32),
             False, 4),
            ("slice_f32_q8_int", f32, True, 4),
            ("slice_f32_q8_real", f32, False, 3),
            ("slice_f32_q8_wide_int", dict(f32, fused_block_sublanes=32),
             True, 3)):
        cfg = TopKSpMVConfig(**dict(kw, num_partitions=P))
        eng = TopKSpMV(icoo if integer else coo, cfg, device=dev)
        plan = eng.fused.plan
        wide = sum((p.blocks_per_octet if cfg.fused_layout == "octet"
                    else p.blocks_per_slice) > 1 for p in plan)
        if "wide" in name:
            require(wide > 0, f"{name}: small blocks force wide buckets")
        zero_real = int((eng.nreal == 0).sum())
        query, queries = (iq[0], iq[1:]) if integer else (q, qs5)
        if cfg.fused_layout == "octet":
            table, _ = eng._table(query)
            (kv, kt), (pv, pt) = _plain_and_kernel(eng, table, cfg)
            (bv, bt), (bpv, bpt) = _batch_plain_and_kernel(
                eng, _tables(queries, dev), cfg)
            torch.cuda.synchronize()
            errs = (compare_pools(kv, kt, pv, pt),
                    compare_pools(bv, bt, bpv, bpt),
                    _scores_agree(eng, query))
            require(kv.shape == (P, cfg.lane_k, 128) and bv.shape ==
                    (len(queries), P, cfg.lane_k, 128),
                    f"{name}: a pool per partition")
            kinds = ("k10b", "k10d", "k4")
        else:
            errs = _slice_agree(eng, cfg, query, queries, dev)
            kinds = ("k10a", "k10c", "k9")
        cases.append(dict(case=name, partitions=P, buckets=len(plan),
                          wide_buckets=wide, zero_real_buckets=zero_real,
                          **{f"{k}_max_abs_err": e
                             for k, e in zip(kinds, errs)}))
        del eng
    require(any(c["zero_real_buckets"] for c in cases),
            "a partition holds a bucket with no real slice")

    # f32 tables past shared memory: 65,536 columns, 256 KB a table
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    require(K.tables_in_smem(4 * F32_MAX_COLS, limit) == 0,
            "a 65,536-column f32 table exceeds a CUDA block's shared memory")
    wcoo = create_sparse_matrix(20_000, F32_MAX_COLS, AVG_DEG, "gamma",
                                seed=19)
    wqs = create_query_batch(5, F32_MAX_COLS, seed=20)
    wide_cols = []
    for P in (1, 2):
        cfg = TopKSpMVConfig(k=100, max_cols=F32_MAX_COLS,
                             tie_safe_topk=True, num_partitions=P)
        eng = TopKSpMV(wcoo, cfg, device=dev)
        k7, k8, k9 = _slice_agree(eng, cfg, wqs[0], wqs, dev)
        wide_cols.append(dict(partitions=P, k7_max_abs_err=k7,
                              k8_max_abs_err=k8, k9_max_abs_err=k9))
        del eng
    out = dict(phase="partition_kernels_vs_plain_small", rows=coo.num_rows,
               nnz=coo.nnz, cases=cases, f32_65536_cols=wide_cols,
               shared_memory_per_block_optin=limit)
    emit(out)
    return out


# ------------------------------------------------------------ query codecs

def _octet_agree(eng, cfg, q, qs, dev):
    """K1 (query q), K6 (queries qs in one group) and K4 (query q) of one
    octet engine under cfg (tie-safe buffers) against their plain versions,
    which add in the kernels' order: per-lane values and K4's scores
    bit-equal in both store forms (``_scores_agree``), (value, tag) pairs
    equal above each lane's floor. Returns the three max abs errors."""
    import torch

    table, _ = eng._table(q)
    (kv, kt), (pv, pt) = _plain_and_kernel(eng, table, cfg)
    (bv, bt), (bpv, bpt) = _batch_plain_and_kernel(
        eng, _tables(qs, dev, cfg.query_codec), cfg)
    torch.cuda.synchronize()
    return (compare_pools(kv, kt, pv, pt), compare_pools(bv, bt, bpv, bpt),
            _scores_agree(eng, q))


def phase_codecs_small(dev):
    """The query codecs against their plain versions on a 50k-row corpus,
    tie-safe, bit for bit: K7, K8 (5 queries in subgroups of 2) and K9 on
    the slice stream for int8x4, i8s and i4s; K1, K6 and K4 on the octet
    stream for f32, int8x4, i8s and i4s at fold 8 and, with wide octets
    (small blocks), fold 1; wide slices; int8x4 at 1536 columns (3 table
    rows) and i4s at 2048 (2 rows, the sign select) on both streams; P = 3
    partitions of each stream, with a partition holding a bucket with no
    real slice."""
    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    slice_q4 = dict(k=100, max_cols=NUM_COLS, width_quantum=4,
                    tie_safe_topk=True, batch_subgroup=2)
    octet = dict(HEADLINE, tie_safe_topk=True, rescore_pool=None,
                 batch_subgroup=2)
    cases = [(f"slice_{c}", dict(slice_q4, query_codec=c), 1)
             for c in ("i8s", "i4s", "int8x4")]
    cases += [("slice_i4s_fold8", dict(slice_q4, query_codec="i4s",
                                       fold_tile=8), 1),
              ("slice_int8x4_wide", dict(slice_q4, query_codec="int8x4",
                                         fused_block_sublanes=32), 1)]
    for c in ("f32", "int8x4", "i8s", "i4s"):
        cases += [(f"octet_{c}_fold8", dict(octet, query_codec=c), 1),
                  (f"octet_{c}_fold1_wide", dict(
                      octet, query_codec=c, fold_tile=1,
                      fused_block_sublanes=64), 1)]
    cases += [("slice_i8s_p3", dict(slice_q4, query_codec="i8s"), 3),
              ("slice_int8x4_wide_p3", dict(slice_q4, query_codec="int8x4",
                                            fused_block_sublanes=32), 3),
              ("octet_i4s_p3", dict(octet, query_codec="i4s"), 3),
              ("octet_f32_wide_p3", dict(octet, query_codec="f32",
                                         fused_block_sublanes=64), 3)]
    q = create_query_batch(1, NUM_COLS, seed=8)[0]
    qs5 = create_query_batch(5, NUM_COLS, seed=9)
    out = []
    for name, kw, P in cases:
        cfg = TopKSpMVConfig(**dict(kw, num_partitions=P))
        eng = TopKSpMV(coo, cfg, device=dev)
        out.append(_codec_case(name, eng, cfg, q, qs5, dev))
        del eng
    require(all(c["wide_buckets"] for c in out if "wide" in c["case"]),
            "small blocks force wide octets and slices")
    require(all(c["zero_real_buckets"] for c in out
                if c["partitions"] > 1),
            "a partition holds a bucket with no real slice")
    # tables of several rows: int8x4 at 1536 columns, i4s at 2048
    for codec, cols, rows in (("int8x4", 1536, 3), ("i4s", 2048, 2)):
        wcoo = create_sparse_matrix(20_000, cols, AVG_DEG, "gamma", seed=10)
        wq = create_query_batch(6, cols, seed=11)
        for layout, base in (("slice", slice_q4), ("octet", octet)):
            cfg = TopKSpMVConfig(**dict(base, query_codec=codec,
                                        max_cols=cols))
            eng = TopKSpMV(wcoo, cfg, device=dev)
            require(eng._table(wq[0])[0].shape[0] == rows,
                    f"{codec} at {cols} columns: {rows} table rows")
            out.append(_codec_case(f"{layout}_{codec}_{cols}_cols", eng,
                                   cfg, wq[0], wq[1:], dev))
            del eng
    res = dict(phase="codec_kernels_vs_plain_small", rows=coo.num_rows,
               nnz=coo.nnz, cases=out)
    emit(res)
    return res


def _codec_case(name, eng, cfg, q, qs, dev):
    """One engine of phase_codecs_small, its three sweeps held to their
    plain versions."""
    from spmv_topk_tpu_torch.ops import kernel as K

    octet = cfg.fused_layout == "octet"
    plan = eng.fused.plan
    if octet:
        errs = _octet_agree(eng, cfg, q, qs, dev)
        kinds = ("k1", "k6", "k4")
    else:
        errs = _slice_agree(eng, cfg, q, qs, dev)
        kinds = ("k7", "k8", "k9")
    return dict(case=name, codec=cfg.query_codec,
                partitions=cfg.num_partitions, buckets=len(plan),
                wide_buckets=sum((p.blocks_per_octet if octet
                                  else p.blocks_per_slice) > 1 for p in plan),
                zero_real_buckets=int((eng.nreal == 0).sum()),
                table_rows=K._table_spec(cfg)[0],
                **{f"{k}_max_abs_err": e for k, e in zip(kinds, errs)})


def phase_octet_engine(coo, csr, qs, gold, dev, name, config,
                       p1_words_bytes):
    """One octet-layout engine built from ``config`` on the full corpus:
    the headline config with another query codec (kernels K1, K6, K4), or
    with num_partitions > 1 (K10b, K10d and the partitioned K4). 32
    query() against the exact top-100, query_batch of the 32 in one group
    and the batch32_* numbers, one scores() against the exact f32
    product, the three kernels held to (tie-safe) and timed against their
    plain versions at the path's shapes (K6 on its group of 32), K3 on the
    words, and the words against the one-partition h16 engine's."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch import TopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import create_query_batch
    from spmv_topk_tpu_torch.ops import kernel as K
    from spmv_topk_tpu_torch.ops.streamprobe import stream_words_device

    cfg = TopKSpMVConfig(**config)
    P, codec = cfg.num_partitions, cfg.query_codec
    t0 = time.perf_counter()
    eng = TopKSpMV(coo, cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k = cfg.k
    eng.query(qs[0])                                      # warm
    eng.query_batch(qs[:2], group_size=2)
    eng.scores(qs[0])
    torch.cuda.synchronize()
    _reset_octet_counts()
    single, _, q_ms, bidx, _, b_ms, s, s_ms = _drive(eng, qs, k, BATCH_GROUP)
    torch.cuda.synchronize()
    launches = _octet_counts(codec)
    prec = _precision(gold, single, k)
    bprec = _precision(gold, bidx, k)
    same = [len(set(a.tolist()) & set(b.tolist())) / k
            for a, b in zip(single, bidx)]
    raw = [eng.query(q, rescore_pool=0)[0].cpu().numpy() for q in qs]
    many = create_query_batch(BATCH_GROUP * BATCH_GROUPS, NUM_COLS,
                              seed=BATCH_SEED)
    e2e = _e2e_ms_per_query(eng, many, BATCH_GROUP)
    e2e_raw = _e2e_ms_per_query(eng, many, BATCH_GROUP, rescore_pool=0)

    # the kernels against their plain versions (tie-safe), then timed
    group = qs[:BATCH_GROUP]
    kinds = ("k10b", "k10d", "k4") if P > 1 else ("k1", "k6", "k4")
    errs = _octet_agree(eng, dataclasses.replace(cfg, tie_safe_topk=True),
                        qs[0], group, dev)
    bs = eng.fused.block_sublanes
    parts = eng.partition_kw
    table, _ = eng._table(qs[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    bargs = (eng.words, _tables(group, dev, codec), eng.nreal, eng.plan_rows)
    plain_kw = dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                    tie_safe=bool(cfg.tie_safe_topk), block_sublanes=bs,
                    codec=codec, **parts)
    salt = torch.arange(128, dtype=torch.int32, device=dev).reshape(1, 128)
    k1, k6, k4 = kinds
    times = {
        f"{k1}_ms": cuda_ms(lambda: K.topk_spmv_fused_octet_device(
            *args, cfg=cfg, block_sublanes=bs, **parts), reps=20, warmup=2),
        f"{k1}_plain_ms": cuda_ms(lambda: K.octet_topk_plain(*args,
                                                             **plain_kw),
                                  reps=2),
        f"{k6}_ms": cuda_ms(lambda: K.topk_spmv_fused_batch_octet_device(
            *bargs, cfg=cfg, block_sublanes=bs, **parts), reps=10, warmup=2),
        f"{k6}_plain_ms": cuda_ms(lambda: K.octet_topk_batch_plain(
            *bargs, **plain_kw), reps=1, warmup=0),
        **_scores_times(eng, qs[0], k4), **_scores_path(eng, qs[0]),
        "k3_ms": cuda_ms(lambda: stream_words_device(eng.words, salt),
                         reps=20, warmup=2),
        "k3_library_ms": _k3_library_ms(
            eng.words, salt, stream_words_device(eng.words, salt))}
    # K1 (K10b) alone on the card, with and without its lane merge, and
    # its production buffers against its slot plain, tags included; K6
    # (K10d) the same, its pass and registers, its first K8_HELD queries'
    # production buffers held to its slot plain
    times[f"{k1}_alone_ms"], times[f"{k1}_unmerged_ms"], _ = _k1_alone_ms(
        eng, table, cfg)
    require(_k1_slots_equal(eng, table, cfg),
            f"{name}: {k1} (production buffers) equals its slot plain")
    times.update(_k6_times(eng, bargs[1], cfg, key=k6))
    _batch_agree(eng, bargs[1], cfg, f"{name}: {k6}", held=K8_HELD,
                 plain=False)
    bounds = {k1: sweep_bound(eng, 1, topk_out_bytes(eng, 1)),
              k6: sweep_bound(eng, len(group),
                              topk_out_bytes(eng, len(group)))}
    exact = np.asarray(csr @ qs[0], np.float32)
    per_query = times[f"{k6}_ms"] / len(group)
    res = dict(
        phase=f"{name}_path", config=config, rows=eng.num_rows,
        buckets=len(eng.fused.plan),
        zero_real_buckets=int((eng.nreal == 0).sum()),
        table_rows=K._table_spec(cfg)[0],
        words_bytes=eng.hbm_bytes, words_bytes_one_partition=p1_words_bytes,
        words_bytes_added=eng.hbm_bytes - p1_words_bytes,
        padding_words_per_nnz=eng.fused.padding_ratio,
        pack_and_upload_s=build_s, queries=len(qs),
        precision_at_100_mean=float(np.mean(prec)),
        precision_at_100_min=float(np.min(prec)),
        precision_raw_mean=float(np.mean(_precision(gold, raw, k))),
        query_e2e_ms_median=statistics.median(q_ms),
        batch_precision_at_100_mean=float(np.mean(bprec)),
        batch_precision_at_100_min=float(np.min(bprec)),
        agreement_with_query_mean=float(np.mean(same)),
        group_of_32_e2e_ms=b_ms,
        batch32_ms_per_query=per_query,
        batch32_gnnz_per_query=eng.num_nnz / (per_query * 1e-3) / 1e9,
        batch32_e2e_ms_per_query=e2e,
        batch32_e2e_raw_ms_per_query=e2e_raw,
        scores_e2e_ms=s_ms,
        scores_max_abs_diff_vs_exact_f32=float(np.abs(s - exact).max()),
        max_abs_exact=float(np.abs(exact).max()),
        **{f"{kn}_max_abs_err": e for kn, e in zip(kinds, errs)},
        **{f"{k6}_queries": len(group)}, **times,
        **{f"{kn}_bound_ms": b[0] for kn, b in bounds.items()},
        **{f"{kn}_bound_by": b[1] for kn, b in bounds.items()},
        **{f"{k1}_words_gb_per_s": eng.hbm_bytes / (times[f"{k1}_ms"] * 1e-3)
           / 1e9},
        k3_gb_per_s=eng.hbm_bytes / (times["k3_ms"] * 1e-3) / 1e9,
        launches=launches, nvidia_smi=smi_line())
    emit(res)
    for key in ("precision_at_100_mean", "batch_precision_at_100_mean"):
        require(res[key] >= MIN_PRECISION,
                f"{name} path {key} >= {MIN_PRECISION}")
    for kname, n in launches.items():
        require(n > 0, f"the {name} path launched {kname}")
    del eng
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ per-bucket ops

def _with_dense_rows(coo, degrees, seed):
    """coo with one row more per degree, each of that many nnz: a bucket
    of one slice per block, wider than the 512-row block target for the
    one-nnz codecs."""
    from spmv_topk_tpu_torch.formats import CooMatrix

    rng = np.random.default_rng(seed)
    rows, cols, vals = [coo.rows], [coo.cols], [coo.vals]
    for i, d in enumerate(degrees):
        rows.append(np.full(d, coo.num_rows + i, np.int32))
        cols.append(np.sort(rng.choice(coo.num_cols, d, replace=False)))
        vals.append(rng.standard_normal(d).astype(np.float32) * 0.1)
    return CooMatrix(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals), coo.num_rows + len(degrees),
                     coo.num_cols)


def _bucket_tensors(m, dev):
    """Every bucket of ``m`` in one device tensor: (words, [(the bucket's
    rows of words, num_real (1, 1), geometry keywords with slice_base)])."""
    import torch

    words = torch.empty((sum(b.words.shape[0] for b in m.buckets), 128),
                        dtype=torch.int32, device=dev)
    out, r0 = [], 0
    for b in m.buckets:
        n = b.words.shape[0]
        words[r0:r0 + n].copy_(torch.from_numpy(b.words))
        out.append((words[r0:r0 + n],
                    torch.tensor([[b.num_slices]], dtype=torch.int32,
                                 device=dev),
                    dict(width=b.width,
                         slices_per_block=b.block_sublanes // b.width,
                         num_blocks=b.num_blocks, slice_base=b.slice_base)))
        r0 += n
    return words, out


def _table1(q, dev, codec):
    import torch

    from spmv_topk_tpu_torch.ops.quantized_query import pack_query_table

    tab, scale = pack_query_table(q, codec)
    return torch.from_numpy(np.ascontiguousarray(tab)).to(dev), scale


def _bucket_topk(bks, table, cfg, codec, plain=False):
    """K13 (or its plain version) over every bucket: (B, lane_k, 128)
    values and global slice tags."""
    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    outs = []
    for w, nr, geo in bks:
        if plain:
            outs.append(K.bucket_topk_plain(
                w, table, nr, lane_k=cfg.lane_k,
                tie_safe=bool(cfg.tie_safe_topk), codec=codec, **geo))
        else:
            outs.append(K.topk_spmv_bucket_device(
                w, table, nr, cfg=cfg, num_groups=table.shape[0],
                codec=codec, **geo))
    return torch.stack([v for v, _ in outs]), torch.stack([t for _, t in outs])


def _k13_slots_plain(w, table, nr, geo, cfg, codec):
    """K13's plain version on the slots its kernel runs on this bucket."""
    from spmv_topk_tpu_torch.ops import kernel as K

    n = geo["num_blocks"] * geo["slices_per_block"]
    arg, _ = K._kernel_codec(w.device, codec, table.shape[0])
    slots = K._bucket_topk_slots(w.device, arg, cfg.lane_k, table.shape[0],
                                 n)
    return K.bucket_topk_slots_plain(w, table, nr, lane_k=cfg.lane_k,
                                     tie_safe=bool(cfg.tie_safe_topk),
                                     codec=codec, num_slots=slots, **geo)


def _bucket_topk_batch(bks, tables, cfg, codec, plain=False):
    """K12 (or its plain version) over every bucket: (Q, B, lane_k, 128)."""
    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    outs = []
    for w, nr, geo in bks:
        if plain:
            outs.append(K.bucket_topk_batch_plain(
                w, tables, nr, lane_k=cfg.lane_k,
                tie_safe=bool(cfg.tie_safe_topk), codec=codec, **geo))
        else:
            outs.append(K.topk_spmv_bucket_batch_device(
                w, tables, nr, cfg=cfg, codec=codec, **geo))
    return (torch.stack([v for v, _ in outs], dim=1),
            torch.stack([t for _, t in outs], dim=1))


def _k12_launch(w, tables, geo, cfg, codec):
    """K12's (kernel codec, pass, passes, slots) on this bucket."""
    from spmv_topk_tpu_torch.ops import kernel as K

    return K.k12_launch(w.device, codec, tables.shape[0], cfg.lane_k,
                        tables.shape[1],
                        geo["num_blocks"] * geo["slices_per_block"])


def _k12_unmerged(w, nr, geo, tables, cfg, codec):
    """K12's unmerged launch on one bucket: each slot's sorted buffers."""
    from spmv_topk_tpu_torch.ops import kernel as K

    return K._bucket_topk_batch_cuda(
        w, tables, nr, lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk),
        codec=codec, unmerged=True, **geo)


def _k12_agree(bks, tables, cfg, codec, unmerged=False):
    """K12 over every bucket equal to its plain version on the kernel's
    slots (``bucket_topk_batch_slots_plain``), bit for bit, tags included,
    and with ``unmerged`` its unmerged launch's slots too. Returns the
    (kernel codec, pass) pairs it ran."""
    import torch

    from spmv_topk_tpu_torch.ops import kernel as K

    ran = set()
    for w, nr, geo in bks:
        codec_arg, qp, _, slots = _k12_launch(w, tables, geo, cfg, codec)
        ran.add((codec_arg, qp))
        v, t = K.topk_spmv_bucket_batch_device(w, tables, nr, cfg=cfg,
                                               codec=codec, **geo)
        kw = dict(lane_k=cfg.lane_k, tie_safe=bool(cfg.tie_safe_topk),
                  codec=codec, num_slots=slots, **geo)
        sv, st = K.bucket_topk_batch_slots_plain(w, tables, nr, **kw)
        torch.cuda.synchronize()
        require(torch.equal(v, sv) and torch.equal(t, st),
                "K12 equals its plain version on the kernel's slots bit for "
                "bit, tags included")
        if unmerged:
            uv, ut = _k12_unmerged(w, nr, geo, tables, cfg, codec)
            sv, st = K.bucket_topk_batch_slots_plain(w, tables, nr,
                                                     merged=False, **kw)
            torch.cuda.synchronize()
            require(torch.equal(uv, sv) and torch.equal(ut, st),
                    "K12's unmerged slots equal its slot plain's")
    return ran


def _bucket_scores(bks, table, cfg, codec, plain=False):
    """K11 (or its plain version) of every bucket: a list of (slices,
    128) f32 score rows."""
    from spmv_topk_tpu_torch.ops import kernel as K

    out = []
    for w, _, geo in bks:
        kw = {k: v for k, v in geo.items() if k != "slice_base"}
        out.append(K.bucket_scores_plain(w, table, codec=codec, **kw) if plain
                   else K.spmv_bucket_scores_device(w, table, cfg=cfg,
                                                    codec=codec, **kw))
    return out


def _bucket_agree(bks, table, tables, cfg, codec):
    """K11, K13 and K12 over every bucket against their plain versions
    (tie-safe buffers): scores and per-lane values bit-equal, (value, tag)
    pairs equal above each lane's floor; K13 and K12 against their plain
    versions on the kernels' slots, tie-safe and not, bit for bit, tags
    included. Returns the three max errors and the (kernel codec, pass)
    pairs K12 ran."""
    import dataclasses

    import torch

    safe = dataclasses.replace(cfg, tie_safe_topk=True)
    ks = _bucket_scores(bks, table, cfg, codec)
    kv, kt = _bucket_topk(bks, table, safe, codec)
    bv, bt = _bucket_topk_batch(bks, tables, safe, codec)
    torch.cuda.synchronize()
    for k, p in zip(ks, _bucket_scores(bks, table, cfg, codec, plain=True)):
        require(torch.equal(k, p), "K11 scores equal the plain version's "
                "bit for bit")
    ran = set()
    for c in (safe, dataclasses.replace(cfg, tie_safe_topk=False)):
        for j, (w, nr, geo) in enumerate(bks):
            v, t = _bucket_topk(bks[j:j + 1], table, c, codec)
            sv, st = _k13_slots_plain(w, table, nr, geo, c, codec)
            require(torch.equal(v[0], sv) and torch.equal(t[0], st),
                    "K13 equals its plain version on the kernel's slots "
                    "bit for bit, tags included")
        ran |= _k12_agree(bks, tables, c, codec)
    return (0.0, compare_pools(kv, kt, *_bucket_topk(bks, table, safe, codec,
                                                     plain=True)),
            compare_pools(bv, bt, *_bucket_topk_batch(bks, tables, safe,
                                                      codec, plain=True)),
            ran)


# K12's instantiations: h16 passes of 8 and 16, f32, int8x4, i8s and i4s
# passes of 8, f32 and int8x4 in global memory 8; lane_k 4, 8, 16;
# tie-safe and not. K11's: one a kernel codec but int8x4_global (i8s and
# i4s share one)
K12_INSTANTIATIONS = (2 + 6) * 3 * 2
K11_INSTANTIATIONS = 5


def _bucket_registers(report, kernel):
    """{instantiation of ``kernel``: registers, spill bytes} of a ptxas
    report."""
    return {k: dict(registers=r, spill_bytes=sp)
            for k, (r, sp) in report.items() if k.startswith(f"{kernel}<")}


def phase_bucket_small(dev):
    """K11, K13 and K12 over every bucket of pack_sell_buckets against
    their plain versions, tie-safe, bit for bit, and K13 and K12 against
    their plain versions on the kernels' slots, tie-safe and not, tags
    included: every codec on the 50k-row corpus with three dense rows (a
    bucket of one slice per block, wider than 512 rows for the one-nnz
    codecs) at lane_k 4, 8 and 16; f32 at width_quantum 2 (widths not
    multiples of 8: their last width % 8 rows are dropped, widths below 8
    score 0); int8x4 at 1536 columns and i4s at 2048 (tables of 3 and 2
    rows); f32 and int8x4 at 65,536 columns (tables read from global
    memory). K12 on 5 queries (a short pass of 8), and at lane_k 8 on 1
    and 33 (passes of 8, h16's of 16; the last of one query) with its
    unmerged launch's slots, so that every (kernel codec, pass) of
    ``k12_pass`` runs. Every K12 and K11 instantiation's registers: none
    may spill."""
    import dataclasses

    import torch

    from spmv_topk_tpu_torch.ops import _build

    from spmv_topk_tpu_torch import TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.formats.sell_buckets import pack_sell_buckets
    from spmv_topk_tpu_torch.ops import kernel as K

    coo = create_sparse_matrix(50_000, NUM_COLS, AVG_DEG, "gamma", seed=7)
    dense = _with_dense_rows(coo, (700, 900, 1000), 46)
    cases = [(c, c, dense, (4, 8, 16))
             for c in ("h16", "f32", "int8x4", "i8s", "i4s")]
    cases.append(("f32_quantum2", "f32", coo, (8,)))
    for name, codec, cols in (("int8x4_1536_cols", "int8x4", 1536),
                              ("i4s_2048_cols", "i4s", 2048),
                              ("f32_65536_cols", "f32", F32_MAX_COLS),
                              ("int8x4_65536_cols", "int8x4", F32_MAX_COLS)):
        cases.append((name, codec, create_sparse_matrix(
            20_000, cols, AVG_DEG, "gamma", seed=10), (8,)))
    out, ran = [], set()
    for name, codec, corpus, lane_ks in cases:
        cfg = TopKSpMVConfig(k=100, max_cols=corpus.num_cols,
                             query_codec=codec,
                             width_quantum=2 if "quantum2" in name else 8)
        m = pack_sell_buckets(corpus, cfg)
        qs = create_query_batch(34, corpus.num_cols, seed=11)
        words, bks = _bucket_tensors(m, dev)
        table, _ = _table1(qs[0], dev, codec)
        tables = _tables(qs[1:6], dev, codec)
        errs = [_bucket_agree(bks, table, tables,
                              dataclasses.replace(cfg, lane_k=lk), codec)
                for lk in lane_ks]
        ran |= set().union(*(e[3] for e in errs))
        # K12 on 1 and 33 queries, tie-safe and not, merged and unmerged
        for q in (1, 33):
            for safe in (True, False):
                ran |= _k12_agree(bks, _tables(qs[1:1 + q], dev, codec),
                                  dataclasses.replace(cfg,
                                                      tie_safe_topk=safe),
                                  codec, unmerged=True)
        widths = [b.width for b in m.buckets]
        short = [s for s, b in zip(_bucket_scores(bks, table, cfg, codec),
                                   m.buckets) if b.width < 8]
        out.append(dict(
            case=name, codec=codec, rows=corpus.num_rows,
            cols=corpus.num_cols, buckets=len(m.buckets), widths=widths,
            one_slice_per_block=sum(b.block_sublanes == b.width
                                    for b in m.buckets),
            padded_buckets=sum(b.num_slices < b.num_blocks * (
                b.block_sublanes // b.width) for b in m.buckets),
            table_rows=table.shape[0], lane_k=list(lane_ks),
            short_buckets_all_zero=all(not s.any() for s in short),
            k11_max_abs_err=max(e[0] for e in errs),
            k13_max_abs_err=max(e[1] for e in errs),
            k12_max_abs_err=max(e[2] for e in errs)))
        require(out[-1]["padded_buckets"] > 0,
                f"{name}: a last block holds padding slices")
        if corpus is dense:
            require(out[-1]["one_slice_per_block"] > 0 and
                    (codec == "h16" or max(widths) > 512),
                    f"{name}: a bucket of one slice per block, past 512 "
                    "rows for the one-nnz codecs")
        if "quantum2" in name:
            require(any(w % 8 for w in widths) and short and
                    out[-1]["short_buckets_all_zero"],
                    "quantum 2: widths past multiples of 8, and those "
                    "below 8 score 0")
        del words, bks
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    require(K.tables_in_smem(4 * F32_MAX_COLS, limit) == 0,
            "a 65,536-column f32 table is read from global memory")
    want = {(c, q) for c, qs in K.K12_PASS_QUERIES.items() for q in qs}
    require(ran == want, f"every (kernel codec, pass) of k12_pass ran: "
            f"{sorted(want - ran)} did not")
    report = _build.ptxas_report()
    k12_regs = _bucket_registers(report, "bucket_topk_batch_kernel")
    k11_regs = _bucket_registers(report, "bucket_scores_kernel")
    require(len(k12_regs) == K12_INSTANTIATIONS and
            len(k11_regs) == K11_INSTANTIATIONS,
            f"{K12_INSTANTIATIONS} K12 and {K11_INSTANTIATIONS} K11 "
            f"instantiations built ({len(k12_regs)}, {len(k11_regs)})")
    require(not any(r["spill_bytes"] for r in (*k12_regs.values(),
                                               *k11_regs.values())),
            "no K12 or K11 instantiation spills")
    res = dict(phase="bucket_kernels_vs_plain_small", cases=out,
               k12_kernel_codecs_and_passes=sorted(ran),
               k12_registers_and_spill_bytes=k12_regs,
               k11_registers_and_spill_bytes=k11_regs)
    emit(res)
    return res


def _reset_bucket_counts():
    from spmv_topk_tpu_torch.ops import kernel as K

    for w in (K.spmv_bucket_scores_device, K.topk_spmv_bucket_device,
              K.topk_spmv_bucket_batch_device):
        w.launches = 0


def _bucket_counts():
    from spmv_topk_tpu_torch.ops import kernel as K

    return dict(bucket_scores=K.spmv_bucket_scores_device.launches,
                bucket_topk=K.topk_spmv_bucket_device.launches,
                bucket_topk_batch=K.topk_spmv_bucket_batch_device.launches)


# cycles of the card's sleep that holds the stream while the host enqueues
# the launches of a device-timed run (``_device_ms``): about 5 ms, more
# than enqueueing a query's buckets takes
HOLD_CYCLES = 10_000_000


def _device_ms(fns, reps):
    """Device milliseconds of ``fns`` run back to back: the stream is held
    by a sleep on the card while the host enqueues them, so host time adds
    nothing. Returns (each fn's median over ``reps`` runs with an event
    between each two, the median over ``reps`` runs of all of them between
    two events: an event between two launches keeps the second from
    overlapping the first)."""
    import torch

    per, total = [], []
    for split in (True, False):
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(fns) + 1 if split else 2)]
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES)
            ev[0].record()
            for j, fn in enumerate(fns):
                fn()
                if split:
                    ev[j + 1].record()
            ev[-1].record()
            ev[-1].synchronize()
            if split:
                per.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
            else:
                total.append(ev[0].elapsed_time(ev[-1]))
    return ([statistics.median(col) for col in zip(*per)],
            statistics.median(total))


def _bucket_times(bks, words, table, cfg, codec, num_nnz, tables):
    """K13 and K11 per query and K12 per group of ``tables`` over every
    bucket, each summed over its bucket launches, between CUDA events,
    against their plain versions; alone on the card (no host time:
    ``_device_ms``): K13 whole and per bucket, and with num_real 0 (its
    fixed cost), beside K3 on the same words; K11; K12 with and without its
    lane merge, and the ``torch.topk`` merge of its unmerged slots (the
    kernel before's merge); K13's host clock per query (``_bucket_topk``
    enqueued, and to a synchronize; the bare launches enqueued); K12's
    pass, passes and slots; the kernels' registers and spill bytes; the
    bounds."""
    import torch

    from spmv_topk_tpu_torch.ops import _build
    from spmv_topk_tpu_torch.ops import kernel as K
    from spmv_topk_tpu_torch.ops.streamprobe import stream_words_device

    nb = len(bks)
    wbytes = words.numel() * 4
    tbytes = table.numel() * 4
    slices = sum(g["num_blocks"] * g["slices_per_block"] for _, _, g in bks)
    pairs = nb * cfg.lane_k * 128 * 8
    res = dict(buckets=nb, words_bytes=wbytes)
    kinds = [("k13", lambda: _bucket_topk(bks, table, cfg, codec),
              lambda: _bucket_topk(bks, table, cfg, codec, plain=True),
              bound(wbytes + nb * tbytes + pairs, 2 * num_nnz)),
             ("k11", lambda: _bucket_scores(bks, table, cfg, codec),
              lambda: _bucket_scores(bks, table, cfg, codec, plain=True),
              bound(wbytes + nb * tbytes + slices * 128 * 4, 2 * num_nnz))]
    Q = len(tables)
    kinds.append(("k12", lambda: _bucket_topk_batch(bks, tables, cfg, codec),
                  lambda: _bucket_topk_batch(bks, tables, cfg, codec,
                                             plain=True),
                  bound(wbytes + Q * nb * tbytes + Q * pairs,
                        2 * num_nnz * Q)))
    res["k12_queries"] = Q
    for kn, fn, plain, b in kinds:
        res[f"{kn}_ms"] = cuda_ms(fn, reps=10, warmup=2)
        res[f"{kn}_plain_ms"] = cuda_ms(plain, reps=1, warmup=0)
        res[f"{kn}_bound_ms"], res[f"{kn}_bound_by"] = b

    launches = [lambda w=w, nr=nr, geo=geo: K.topk_spmv_bucket_device(
        w, table, nr, cfg=cfg, num_groups=table.shape[0], codec=codec, **geo)
        for w, nr, geo in bks]
    salt = torch.arange(128, dtype=torch.int32, device=words.device).reshape(
        1, 128)
    per_bucket, alone = _device_ms(launches, reps=10)
    # num_real 0: no slice swept, so a launch's fixed cost (launch, table,
    # merge levels)
    zero = torch.zeros((1, 1), dtype=torch.int32, device=words.device)
    empty, empty_total = _device_ms(
        [lambda w=w, geo=geo: K.topk_spmv_bucket_device(
            w, table, zero, cfg=cfg, num_groups=table.shape[0], codec=codec,
            **geo) for w, _, geo in bks], reps=10)
    k3_per, k3_sum = _device_ms([lambda w=w: stream_words_device(w, salt)
                                 for w, _, _ in bks], reps=10)
    # K11 alone; K12 alone with and without its merge, and the torch.topk
    # merge of each bucket's unmerged slots
    _, k11_alone = _device_ms([lambda b=b: _bucket_scores([b], table, cfg,
                                                          codec)
                               for b in bks], reps=10)
    _, k12_alone = _device_ms([lambda w=w, nr=nr, geo=geo:
                               K.topk_spmv_bucket_batch_device(
                                   w, tables, nr, cfg=cfg, codec=codec, **geo)
                               for w, nr, geo in bks], reps=10)
    _, k12_unmerged = _device_ms([lambda w=w, nr=nr, geo=geo: _k12_unmerged(
        w, nr, geo, tables, cfg, codec) for w, nr, geo in bks], reps=10)
    slots = [_k12_unmerged(w, nr, geo, tables, cfg, codec)
             for w, nr, geo in bks]
    _, k12_topk_merge = _device_ms([lambda v=v, t=t: K.merge_lane_topk(
        v, t, cfg.lane_k, lead=1) for v, t in slots], reps=10)
    launch = [_k12_launch(w, tables, geo, cfg, codec) for w, _, geo in bks]
    names = {_k12_instantiation(c, qp, cfg.lane_k, bool(cfg.tie_safe_topk))
             for c, qp, _, _ in launch}
    report = _build.ptxas_report()
    # the host clock of one query: _bucket_topk, its launches and the two
    # stacks (to enqueue them, and to a synchronize: the card's time shows
    # when it is the longer); and the bare launches, enqueued
    def host(fn, out):
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out[0].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            out[1].append((time.perf_counter() - t0) * 1e3)

    enq, sync, bare = [], [], []
    host(lambda: _bucket_topk(bks, table, cfg, codec), (enq, sync))
    host(lambda: [fn() for fn in launches], (bare, []))
    k3 = cuda_ms(lambda: stream_words_device(words, salt), reps=20, warmup=2)
    bucket_bytes = [w.numel() * 4 for w, _, _ in bks]
    res.update(
        k13_alone_ms=alone, k13_alone_ms_by_bucket=per_bucket,
        k13_num_real_0_ms=empty_total, k13_num_real_0_ms_by_bucket=empty,
        k3_ms_by_bucket=k3_per, k3_ms_summed_over_buckets=k3_sum,
        bucket_words_bytes=bucket_bytes,
        k13_host_enqueue_ms_median=statistics.median(enq),
        k13_host_ms_median=statistics.median(sync),
        k13_host_launches_ms_median=statistics.median(bare),
        k13_host_launch_ms_per_bucket=statistics.median(bare) / nb,
        launches_per_query=nb, k3_ms=k3,
        k3_gb_per_s=wbytes / (k3 * 1e-3) / 1e9,
        k13_words_gb_per_s=wbytes / (res["k13_ms"] * 1e-3) / 1e9,
        k13_alone_words_gb_per_s=wbytes / (alone * 1e-3) / 1e9,
        k13_alone_share_of_k3=k3_sum / alone,
        k13_registers_and_spill_bytes=_bucket_registers(report,
                                                        "bucket_topk_kernel"),
        k11_alone_ms=k11_alone,
        k11_alone_words_gb_per_s=wbytes / (k11_alone * 1e-3) / 1e9,
        k11_registers_and_spill_bytes=_bucket_registers(
            report, "bucket_scores_kernel"),
        k12_alone_ms=k12_alone, k12_unmerged_ms=k12_unmerged,
        k12_card_merge_ms=k12_alone - k12_unmerged,
        k12_topk_merge_of_the_slots_ms=k12_topk_merge,
        k12_alone_words_gb_per_s=wbytes / (k12_alone * 1e-3) / 1e9,
        k12_kernel_codec_pass_passes_slots_by_bucket=launch,
        k12_registers_and_spill_bytes={n: report[n] for n in sorted(names)})
    require(not any(report[n][1] for n in names),
            "the K12 instantiations of the path do not spill")
    return res


def _k12_instantiation(codec, pass_queries, lane_k, tie_safe):
    """The name ``_build.ptxas_report`` gives K12's kernel for a kernel
    codec (KERNEL_CODECS), pass, lane_k and buffers."""
    return (f"bucket_topk_batch_kernel<{_pass_codec(codec, pass_queries)},"
            f"{lane_k},{int(tie_safe)}>")


def phase_bucket_path(coo, csr, qs, gold, gold_bf16, df, dev):
    """The per-bucket ops on the 10M corpus. Engine (a): pack_sell_buckets
    of the default config (f32, quantum 8): for each of the 32 queries K13
    over every bucket, the buffers stacked and finalized once (precision@100
    against the bf16 matrix's top 100 >= MIN_PRECISION_BF16, and not below
    the default engine's query() by more than 0.005 mean), and
    merge_candidates_host over each bucket's own top 100 giving the same
    rows; K12 on the default group of 8 (each query's sorted lane values
    equal K13's to rtol 1e-6: the two sum in different orders); K11 on
    one query against the default engine's K9 scores of the same slices
    (rtol 1e-6) and the bf16 matrix product. Engine (b): h16 at quantum 8
    with the headline's other settings: K13 over every bucket, the exact
    rescore of a pool of 400 (precision@100 >= MIN_PRECISION), K12 on a
    group of 8. Each: K12's group against its plain version on the
    kernel's slots, bit for bit; the three kernels against their plain
    versions (``_bucket_agree``); times, launches, K3."""
    import scipy.sparse
    import torch

    from spmv_topk_tpu_torch import TopKSpMVConfig
    from spmv_topk_tpu_torch.api import exact_rescore
    from spmv_topk_tpu_torch.formats.sell_buckets import (fuse_buckets,
                                                          pack_sell_buckets)
    from spmv_topk_tpu_torch.ops import kernel as K
    from spmv_topk_tpu_torch.ops.fixedpoint import quantize_bf16
    from spmv_topk_tpu_torch.topk import merge_candidates_host

    k = 100
    group = qs[:DEFAULT_GROUP]
    out = {}
    for name, config in (("bucket", DEFAULT),
                         ("bucket_h16", dict(HEADLINE, width_quantum=8))):
        cfg = TopKSpMVConfig(**config)
        codec = cfg.query_codec
        t0 = time.perf_counter()
        m = pack_sell_buckets(coo, cfg)
        words, bks = _bucket_tensors(m, dev)
        row_ids = torch.from_numpy(m.row_ids).to(dev)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        _bucket_topk(bks, _table1(qs[0], dev, codec)[0], cfg, codec)  # warm
        torch.cuda.synchronize()

        _reset_bucket_counts()
        pools, idx, raw, host_ms = [], [], [], []
        for q in qs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table, _ = _table1(q, dev, codec)
            tv, tt = _bucket_topk(bks, table, cfg, codec)
            pool = cfg.rescore_pool or k
            ri, _ = K.finalize_topk(tv, tt, row_ids, pool)
            ri = ri.cpu().numpy()
            if cfg.rescore_pool:
                ri = exact_rescore(csr, ri, q, k)[0]
            host_ms.append((time.perf_counter() - t0) * 1e3)
            idx.append(ri)
            raw.append(ri if not cfg.rescore_pool else
                       K.finalize_topk(tv, tt, row_ids, k)[0].cpu().numpy())
            pools.append((tv, tt))
        tables = _tables(group, dev, codec)
        bv, bt = _bucket_topk_batch(bks, tables, cfg, codec)
        ks = _bucket_scores(bks, _table1(qs[0], dev, codec)[0], cfg, codec)
        torch.cuda.synchronize()
        launches = _bucket_counts()
        # the group's pairs against K12's plain version on its slots
        for j, (w, nr, geo) in enumerate(bks):
            *_, slots = _k12_launch(w, tables, geo, cfg, codec)
            sv, st = K.bucket_topk_batch_slots_plain(
                w, tables, nr, lane_k=cfg.lane_k,
                tie_safe=bool(cfg.tie_safe_topk), codec=codec,
                num_slots=slots, **geo)
            require(torch.equal(bv[:, j], sv) and torch.equal(bt[:, j], st),
                    f"{name}: K12's group equals its plain version on the "
                    "kernel's slots bit for bit at full size")

        prec = _precision(gold, idx, k)
        res = dict(phase=f"{name}_path", config=config, rows=m.num_rows,
                   widths=[b.width for b in m.buckets],
                   pack_and_upload_s=pack_s, queries=len(qs),
                   precision_at_100_mean=float(np.mean(prec)),
                   precision_at_100_min=float(np.min(prec)),
                   precision_raw_mean=float(np.mean(_precision(gold, raw,
                                                               k))),
                   precision_bf16_matrix_mean=float(np.mean(_precision(
                       gold_bf16, raw, k))),
                   query_e2e_ms_median=statistics.median(host_ms))
        if codec == "f32":
            # the stacked finalize against the host merge of each
            # bucket's own top 100
            for (tv, tt), ri in zip(pools, idx):
                lists = [K.finalize_topk(v, t, row_ids, k)
                         for v, t in zip(tv, tt)]
                mi, _ = merge_candidates_host(
                    [i.cpu().numpy() for i, _ in lists],
                    [v.cpu().numpy() for _, v in lists], k)
                require(set(mi.tolist()) == set(ri.tolist()),
                        "merge_candidates_host over the per-bucket top 100 "
                        "gives the stacked finalize's rows")
            res["default_query_precision_bf16_mean"] = \
                df["precision_bf16_matrix_mean"]
            require(res["precision_bf16_matrix_mean"] >= MIN_PRECISION_BF16,
                    f"{name} precision@100 vs the bf16 matrix >= "
                    f"{MIN_PRECISION_BF16}")
            require(res["precision_bf16_matrix_mean"] >=
                    df["precision_bf16_matrix_mean"] - 0.005,
                    "the per-bucket pool ranks at least as well as the "
                    "default engine's query() (within 0.005)")
            # K12 against K13, each query's sorted lane values: rtol 1e-6
            # (the two sum in different orders), atol 1e-6 for sums that
            # cancel to near 0 (a bucket of few slices keeps them all)
            for j in range(len(group)):
                require(np.allclose(bv[j].cpu().numpy(),
                                    pools[j][0].cpu().numpy(), rtol=1e-6,
                                    atol=1e-6),
                        "K12's sorted lane values equal K13's to rtol 1e-6")
            res["k12_vs_k13_max_abs_diff"] = float(max(
                (bv[j] - pools[j][0]).abs().max() for j in range(len(group))))
            # K11 against the default engine's K9 over the same slices
            fused = fuse_buckets(m, block_sublanes=cfg.fused_block_sublanes)
            fwords = torch.from_numpy(fused.words).to(dev)
            plan = torch.from_numpy(K.slice_plan_rows(
                fused.plan, fused.num_blocks, fused.nreal,
                fused.block_sublanes)).to(dev)
            k9 = K.spmv_fused_scores_device(
                fwords, _table1(qs[0], dev, codec)[0],
                torch.from_numpy(fused.nreal).to(dev), plan, cfg=cfg,
                block_sublanes=fused.block_sublanes,
                num_slices=row_ids.shape[0])
            diff = 0.0
            rows = torch.zeros(m.num_rows + 1, dtype=torch.float32,
                               device=dev)
            for s, b in zip(ks, m.buckets):
                want = k9[b.slice_base:b.slice_base + b.num_slices]
                got = s[:b.num_slices]
                require(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
                        "K11 equals K9 on the same slices to rtol 1e-6")
                diff = max(diff, float((got - want).abs().max()))
                ids = row_ids[b.slice_base:b.slice_base + b.num_slices]
                ids = ids.reshape(-1).long()
                rows.scatter_(0, torch.where(ids >= 0, ids, m.num_rows),
                              got.reshape(-1))
            del fwords, k9
            rows = rows[:m.num_rows].cpu().numpy()
            bf16 = scipy.sparse.csr_matrix(
                (quantize_bf16(csr.data), csr.indices, csr.indptr),
                shape=csr.shape)
            exact_bf16 = np.asarray(bf16 @ qs[0].astype(np.float64))
            exact = np.asarray(csr @ qs[0], np.float32)
            require(np.allclose(rows, exact_bf16, rtol=1e-5, atol=1e-5),
                    "K11 scattered to rows equals the bf16 matrix product")
            res.update(k11_vs_k9_max_abs_diff=diff,
                       k11_max_abs_diff_vs_exact_f32=float(
                           np.abs(rows - exact).max()),
                       max_abs_exact=float(np.abs(exact).max()))
        else:
            require(res["precision_at_100_mean"] >= MIN_PRECISION,
                    f"{name} rescored precision@100 >= {MIN_PRECISION}")
        # the kernels against their plain versions, then timed
        table, _ = _table1(qs[0], dev, codec)
        errs = _bucket_agree(bks, table, _tables(qs[1:6], dev, codec), cfg,
                             codec)
        res.update(k11_max_abs_err=errs[0], k13_max_abs_err=errs[1],
                   k12_max_abs_err=errs[2],
                   **_bucket_times(bks, words, table, cfg, codec,
                                   coo.nnz, tables),
                   launches=launches, nvidia_smi=smi_line())
        emit(res)
        for kname, n in launches.items():
            require(n > 0, f"the {name} path launched {kname}")
        out[name] = res
        del words, bks, row_ids, pools, m
        torch.cuda.empty_cache()
    return out["bucket"], out["bucket_h16"]


def phase_library(csr, qs, dev):
    """The library yardsticks on the corpus, timed only: one
    ``torch.sparse.mm`` of its f32 CSR with 1 query (the SpMV kernels'
    counterpart), and that plus ``torch.topk`` of the top 100 for 1, 8
    and 32 queries (two calls: the Top-K sweeps' counterpart). The port
    calls neither."""
    import torch

    A = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int32)),
        torch.from_numpy(np.ascontiguousarray(csr.indices, np.int32)),
        torch.from_numpy(np.ascontiguousarray(csr.data, np.float32)),
        size=csr.shape).to(dev)
    dense = torch.from_numpy(np.ascontiguousarray(qs.T)).to(dev)  # (C, Q)
    one = dense[:, :1].contiguous()
    got = torch.sparse.mm(A, one)[:, 0].cpu().numpy()
    want = np.asarray(csr @ qs[0], np.float32)
    require(np.allclose(got, want, rtol=1e-4, atol=1e-4),
            "torch.sparse.mm computes the corpus's A @ q")
    res = dict(phase="library_yardsticks", nnz=int(csr.nnz),
               spmv_ms=cuda_ms(lambda: torch.sparse.mm(A, one), reps=20,
                               warmup=2))
    for n in (1, DEFAULT_GROUP, BATCH_GROUP):
        qn = dense[:, :n].contiguous()
        res[f"spmv_topk_{n}_ms"] = cuda_ms(
            lambda qn=qn: torch.topk(torch.sparse.mm(A, qn), 100, dim=0),
            reps=10, warmup=2)
    res["nvidia_smi"] = smi_line()
    del A, dense, one
    torch.cuda.empty_cache()
    emit(res)
    return res


# the measurement labs (spmv_topk_tpu_torch/experiments): lab blocks of the
# labs phase (4096 blocks of 512 rows: 1,073,741,824 bytes of words, 21x the
# L2, about 3.9 a CUDA block) and of the small phase, and the CUDA blocks of
# the small phase's strided case
LAB_NB, LAB_SMALL_NB, LAB_STRIDE_BLOCKS = 4096, 8, 3
LAB_NO_LIBRARY = ("none: no single PyTorch call computes a lab's decode "
                  "and fold, or its decode and sum, on its synthetic words")


def _real_values(words, seed):
    """``_common.with_values("real", ...)`` made on the card: the words'
    value bits [0:16) replaced by the bf16 of N(0, 1) draws (torch's
    generator), their other bits kept. On the labs' own words every lane
    keeps +inf and h16's products are NaN or flushed, so a fault shows
    only on values like these."""
    import torch

    g = torch.Generator(device=words.device).manual_seed(seed)
    vals = torch.randn(words.shape, generator=g, device=words.device)
    return (words & ~0xFFFF) | ((vals.view(torch.int32) >> 16) & 0xFFFF)


def _ragged_nreal(nb, spb):
    """fused_lab's three real-slice counts cut short: v_smem masks the
    last 7 slices, v_branch the last 3 of segment 0 and, past segment 1's
    own, 1 of segment 2's."""
    per = nb // 3
    return np.array([[nb * spb - 7], [per * spb - 3], [per * spb + 1]],
                    np.int32)


def phase_labs_small(dev):
    """Every lab variant (every fold) against its plain version at
    LAB_SMALL_NB lab blocks, on the default CUDA blocks (one lab block
    each) and on LAB_STRIDE_BLOCKS (each folding two or three lab blocks
    into one buffer, as at full size); kernel_lab and fused_lab on the
    lab's words and on them with integer, real and tiny values
    (``with_values``: tiny values make the flush of denormals decide the
    scores); bit-equal values (NaN where NaN), (value, tag) pairs above
    each lane's floor; fold_lab's nofold slot for slot."""
    import torch

    from spmv_topk_tpu_torch.experiments import _common as lc
    from spmv_topk_tpu_torch.experiments import (fold_lab, fused_lab,
                                                 h16_lab, kernel_lab)

    t0 = time.perf_counter()
    nb = LAB_SMALL_NB
    counts = dict(kernel_lab=0, fused_lab=0, h16_lab=0, fold_lab=0)
    err = 0.0

    def agree(lab, kern, plain):
        nonlocal err
        torch.cuda.synchronize()
        err = max(err, compare_lanes(*kern, *plain))
        counts[lab] += 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    strides = (None, LAB_STRIDE_BLOCKS)
    words, table, table_i = lc.kernel_lab_data(nb, 32 * 16)
    for kind in ("lab", *lc.CHECK_KINDS):
        w, ti, ft = ((words, table_i, table) if kind == "lab" else
                     lc.with_values(kind, words, table_i, table, seed=17))
        wd, tabs = t(w), kernel_lab.lab_tables(ft, ti, dev)
        for v in kernel_lab.VARIANTS:
            for fold in kernel_lab.FOLDS:
                kw = dict(variant=v, fold=fold, W=32, SPB=16)
                plain = kernel_lab.kernel_lab_plain(wd, tabs[v], **kw)
                for blocks in strides:
                    agree("kernel_lab", kernel_lab.kernel_lab_device(
                        wd, tabs[v], blocks=blocks, **kw), plain)
    words, table, _ = lc.fused_lab_data(nb, fused_lab.W * fused_lab.SPB,
                                        fused_lab.SPB, fused_lab.NSEG)
    nreal = t(_ragged_nreal(nb, fused_lab.SPB))
    for kind in ("lab", *lc.CHECK_KINDS):
        w, ti, _ = ((words, table, None) if kind == "lab" else
                    lc.with_values(kind, words, table, seed=18))
        wd, td = t(w), t(ti)
        # v_prod (K7, as the lab sets it: buffers not tie-safe, so its
        # slots depend on the order at tied scores) on finite words
        # without ties; it plans its own CUDA blocks
        for v in (fused_lab.VARIANTS if kind in ("real", "tiny")
                  else fused_lab.MODES):
            for fold in fused_lab.FOLDS:
                kw = dict(variant=v, fold=fold)
                plain = fused_lab.fused_lab_plain(wd, td, nreal, **kw)
                for blocks in (strides if v != "v_prod" else (None,)):
                    agree("fused_lab", fused_lab.fused_lab_device(
                        wd, td, nreal, blocks=blocks, **kw), plain)
    for seed in (0, 1):
        wd, td = (t(a) for a in lc.h16_lab_data(nb, 16 * 32, seed=seed))
        for v in h16_lab.VARIANTS:
            plain = h16_lab.h16_lab_plain(wd, td, variant=v)
            for blocks in strides:
                agree("h16_lab", h16_lab.h16_lab_device(
                    wd, td, variant=v, blocks=blocks), plain)
        for limit in (nb * 32, nb * 32 - 5):
            for v in fold_lab.VARIANTS:
                plain = fold_lab.fold_lab_plain(wd, td, limit, variant=v)
                for blocks in strides:
                    kern = fold_lab.fold_lab_device(wd, td, limit, variant=v,
                                                    blocks=blocks)
                    if v == "nofold":
                        torch.cuda.synchronize()
                        require(all(torch.equal(a, b) for a, b in
                                    zip(kern, plain)),
                                "fold_lab nofold equals plain slot for slot")
                        counts["fold_lab"] += 1
                    else:
                        agree("fold_lab", kern, plain)
    # L1, L2, L6, L8: bit-equal to their plain versions (integer sums;
    # dma_lab's float sum in the order of the kernel's CUDA blocks)
    from spmv_topk_tpu_torch.experiments import (batch_lab, dma_lab,
                                                 i16_probe, mxu_gather_lab)

    def exact(lab, kern, plain):
        torch.cuda.synchronize()
        _exact(lab, kern, plain)
        counts[lab] = counts.get(lab, 0) + 1

    for Q, W, SPB in ((16, 16, 64), (4, 8, 9)):
        wd, td = (t(a) for a in lc.batch_lab_data(nb, W * SPB, Q, seed=21))
        for v in batch_lab.VARIANTS:
            kw = dict(variant=v, W=W, SPB=SPB)
            plain = batch_lab.batch_lab_plain(wd, td, **kw)
            for blocks in strides:
                exact("batch_lab", batch_lab.batch_lab_device(
                    wd, td, blocks=blocks, **kw), plain)
    rows = nb * dma_lab.CASES[-1][0]
    words, table = lc.dma_lab_data(rows, seed=22)
    for kind in ("lab", *lc.CHECK_KINDS):
        w, tb = ((words, table) if kind == "lab" else
                 dma_lab.check_data(kind, words, seed=23))
        wd, td = t(w), t(tb)
        for bs, st in dma_lab.CASES:
            for blocks in strides:
                n = lc.cuda_blocks(dev, rows // bs, blocks)
                exact("dma_lab", dma_lab.dma_lab_device(
                    wd, td, bs=bs, t=st, blocks=blocks),
                    dma_lab.dma_lab_plain(wd, td, bs=bs, t=st, blocks=n))
    w32, w16, t32, t16 = (t(a) for a in lc.i16_probe_data(
        nb, i16_probe.SUB32, seed=24))
    for v in i16_probe.VARIANTS:
        wd, td = (w32, t32) if "32" in v else (w16, t16)
        salt = (torch.arange(128, device=dev) * 37 - 2000).to(
            wd.dtype).reshape(1, 128)
        plain = i16_probe.i16_probe_plain(wd, td, salt, variant=v)
        for blocks in strides:
            exact("i16_probe", i16_probe.i16_probe_device(
                wd, td, salt, variant=v, blocks=blocks), plain)
    for reps, Q in ((mxu_gather_lab.REPS, 16), (64, 4)):
        wd, td, _ = (t(a) for a in lc.mxu_lab_data(reps, Q, seed=25))
        plain = mxu_gather_lab.mxu_vpu_plain(wd, td)
        for blocks in strides:
            exact("mxu_gather_lab", mxu_gather_lab.mxu_vpu_device(
                wd, td, blocks=blocks), plain)
    out = dict(phase="labs_small", nb=nb, stride_blocks=LAB_STRIDE_BLOCKS,
               cases=counts, max_abs_err=err,
               seconds=time.perf_counter() - t0)
    emit(out)
    return out


def _lab_counters():
    """Launch counters of the lab kernels and of K7 (fused_lab's v_prod)."""
    from spmv_topk_tpu_torch.experiments import (fold_lab, fused_lab,
                                                 h16_lab, kernel_lab)
    from spmv_topk_tpu_torch.ops import kernel as K

    from spmv_topk_tpu_torch.experiments import (batch_lab, dma_lab,
                                                 i16_probe, mxu_gather_lab)

    return dict(lab_kernel=kernel_lab.kernel_lab_device,
                lab_fused=fused_lab.fused_lab_device,
                lab_h16=h16_lab.h16_lab_device,
                lab_fold=fold_lab.fold_lab_device,
                slice_topk=K.topk_spmv_fused_device,
                lab_batch=batch_lab.batch_lab_device,
                lab_dma=dma_lab.dma_lab_device,
                lab_i16=i16_probe.i16_probe_device,
                lab_mxu=mxu_gather_lab.mxu_vpu_device)


def _lab_agree(v, kern, ref):
    """The default check of a fold lab's variant: ``compare_lanes``, or
    slot for slot (fold_lab's nofold)."""
    import torch

    if v == "nofold":
        require(all(torch.equal(a, b) for a, b in zip(kern, ref)),
                "nofold equals plain slot for slot at full size")
        return 0.0
    return compare_lanes(*kern, *ref)


def _exact(v, kern, ref):
    """Kernel and plain results equal bit for bit (NaN where NaN): a
    tensor or a tuple of tensors; error 0."""
    kern, ref = ((x,) if not isinstance(x, tuple) else x
                 for x in (kern, ref))
    for a, b in zip(kern, ref, strict=True):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        require(a.shape == b.shape and a.dtype == b.dtype and
                np.array_equal(a, b, equal_nan=a.dtype.kind == "f"),
                f"{v}: kernel equals its plain version bit for bit")
    return 0.0


def _lab_time(name, lab, words, nb, nnz_per_word, table_bytes, variants,
              agree=_lab_agree, out_bytes=None, queries=1, ops_per=2,
              int_ops_per_word=0):
    """One lab at full size. variants: name -> (call, kernel, counter,
    check): the wrapper on ``words`` (a tensor, or name -> the variant's
    words), its kernel alone (unmerged; None where the wrapper merges
    inside, K7), the counter of ``_lab_counters`` they add to, and the
    (kernel, plain) calls on the check inputs. Each variant's kernel is
    held to its plain version on its check inputs by ``agree`` (the plain
    call timed once between CUDA events); then, counters at 0, each is
    timed by ``_common.measure`` beside K3 on its words (and K3's library
    yardstick there, ``_k3_library_ms``). Bound: the words,
    ``table_bytes`` and ``out_bytes`` (default the merged (value, tag)
    buffers) moved once, or ``ops_per`` float operations per nnz per
    query, or ``int_ops_per_word`` integer instructions per word per
    query, the largest."""
    import torch

    from spmv_topk_tpu_torch.experiments import _common as lc
    from spmv_topk_tpu_torch.ops.streamprobe import stream_words_device

    of = words if isinstance(words, dict) else dict.fromkeys(variants, words)
    out_bytes = lc.LANE_K * 128 * 8 if out_bytes is None else out_bytes
    res = {}
    for v, (_, _, _, (kcall, pcall)) in variants.items():
        kern = kcall()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        ref = pcall()
        end.record()
        end.synchronize()
        e = agree(v, kern, ref)
        res[v] = dict(max_abs_err=e, plain_ms=start.elapsed_time(end))
    k3, k3_library = {}, {}
    w0 = next(iter(of.values()))
    salt = torch.arange(128, dtype=torch.int32,
                        device=w0.device).reshape(1, 128) * 7919
    for w in of.values():
        if w.data_ptr() not in k3:
            w32 = lc.as_words32(w)
            k3[w.data_ptr()] = lc.stream_ms(w32)
            k3_library[w.data_ptr()] = _k3_library_ms(
                w32, salt, stream_words_device(w32, salt))
    counters = _lab_counters()
    for c in counters.values():
        c.launches = 0
    for v, (call, kernel, counter, _) in variants.items():
        w = of[v]
        before = counters[counter].launches
        rep = lc.measure(lab, v, w, nb, nnz_per_word, call, kernel,
                         k3_ms=k3[w.data_ptr()])
        nbytes = w.numel() * w.element_size()
        b_ms, b_by = bound(nbytes + table_bytes + out_bytes,
                           ops_per * w.numel() * nnz_per_word * queries,
                           int_ops_per_word * w.numel() * queries)
        res[v].update(bound_ms=b_ms, bound_by=b_by,
                      launches=counters[counter].launches - before,
                      merge_in_ms=kernel is None, k3_ms=rep["k3_ms"],
                      **{k: rep[k] for k in ("ms", "merged_ms",
                                             "ns_per_chunk", "gnnz_per_s",
                                             "gb_per_s", "share_of_k3")})
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    require(launches.get(name, 0) > 0, f"the {lab} path launched {name}")
    nbytes = w0.numel() * w0.element_size()
    return dict(nb=nb, words_bytes=nbytes, k3_ms=k3[w0.data_ptr()],
                k3_gb_per_s=nbytes / k3[w0.data_ptr()] / 1e6,
                k3_library_ms=k3_library[w0.data_ptr()],
                launches=launches, variants=res)


def phase_labs(dev):
    """The labs' variants at LAB_NB lab blocks (1 GiB of words), each
    timed, its kernel alone and its wrapper with the merge, beside K3 on
    the same words: kernel_lab every body under every fold, fused_lab
    v_bare, v_smem, v_branch and v_prod (K7), h16_lab every decode,
    fold_lab every fold at a limit of every slice. The checks against the
    plain versions run at the same size: kernel_lab and fused_lab on the
    words with real values (``_real_values``; fused_lab with ragged
    counts), fold_lab at a limit that cuts the last lab block."""
    import torch

    from spmv_topk_tpu_torch.experiments import _common as lc
    from spmv_topk_tpu_torch.experiments import (fold_lab, fused_lab,
                                                 h16_lab, kernel_lab)

    start = time.perf_counter()
    out = dict(phase="labs", nb=LAB_NB)

    def t(a):
        return torch.from_numpy(a).to(dev)

    nb = LAB_NB

    t0 = time.perf_counter()
    words, table, table_i = lc.kernel_lab_data(nb, 32 * 16)
    gen = time.perf_counter() - t0
    wd, tabs = t(words), kernel_lab.lab_tables(table, table_i, dev)
    del words
    rd = _real_values(wd, seed=19)

    def kl(w, v, fold, **kw):
        return kernel_lab.kernel_lab_device(w, tabs[v], variant=v, fold=fold,
                                            **kw)

    variants = {}
    for fold in kernel_lab.FOLDS:
        for v in kernel_lab.VARIANTS:
            variants[f"{v}/{fold}"] = (
                lambda v=v, fold=fold: kl(wd, v, fold),
                lambda v=v, fold=fold: kl(wd, v, fold, unmerged=True),
                "lab_kernel",
                (lambda v=v, fold=fold: kl(rd, v, fold),
                 lambda v=v, fold=fold: kernel_lab.kernel_lab_plain(
                     rd, tabs[v], variant=v, fold=fold)))
    out["kernel_lab"] = _lab_time("lab_kernel", "kernel_lab", wd, nb, 1,
                                  8 * 128 * 4, variants)
    out["kernel_lab"]["data_seconds"] = gen
    del wd, rd, tabs

    t0 = time.perf_counter()
    words, table, nreal = lc.fused_lab_data(
        nb, fused_lab.W * fused_lab.SPB, fused_lab.SPB, fused_lab.NSEG)
    gen = time.perf_counter() - t0
    wd, td, nd = t(words), t(table), t(nreal)
    del words
    rd, rn = _real_values(wd, seed=20), t(_ragged_nreal(nb, fused_lab.SPB))

    def fl(w, n, v, **kw):
        return fused_lab.fused_lab_device(w, td, n, variant=v, **kw)

    variants = {
        v: (lambda v=v: fl(wd, nd, v),
            (lambda v=v: fl(wd, nd, v, unmerged=True))
            if v != "v_prod" else None,
            "lab_fused" if v != "v_prod" else "slice_topk",
            (lambda v=v: fl(rd, rn, v),
             lambda v=v: fused_lab.fused_lab_plain(rd, td, rn, variant=v)))
        for v in fused_lab.VARIANTS}
    out["fused_lab"] = _lab_time("lab_fused", "fused_lab", wd, nb, 1,
                                 2 * 128 * 4, variants)
    out["fused_lab"]["data_seconds"] = gen
    del wd, td, nd, rd, rn

    t0 = time.perf_counter()
    words, table = (t(a) for a in lc.h16_lab_data(nb, 16 * 32))
    gen = time.perf_counter() - t0

    def hl(v, **kw):
        return h16_lab.h16_lab_device(words, table, variant=v, **kw)

    variants = {v: (lambda v=v: hl(v), lambda v=v: hl(v, unmerged=True),
                    "lab_h16",
                    (lambda v=v: hl(v),
                     lambda v=v: h16_lab.h16_lab_plain(words, table,
                                                       variant=v)))
                for v in h16_lab.VARIANTS}
    out["h16_lab"] = _lab_time("lab_h16", "h16_lab", words, nb, 2, 128 * 4,
                               variants)
    out["h16_lab"]["data_seconds"] = gen

    def fo(v, limit, **kw):
        return fold_lab.fold_lab_device(words, table, limit, variant=v, **kw)

    limit, cut = nb * 32, nb * 32 - 5
    variants = {v: (lambda v=v: fo(v, limit),
                    lambda v=v: fo(v, limit, unmerged=True), "lab_fold",
                    (lambda v=v: fo(v, cut),
                     lambda v=v: fold_lab.fold_lab_plain(words, table, cut,
                                                         variant=v)))
                for v in fold_lab.VARIANTS}
    out["fold_lab"] = _lab_time("lab_fold", "fold_lab", words, nb, 2,
                                128 * 4, variants)
    del words, table
    torch.cuda.empty_cache()
    out.update(_labs2(dev))
    out["seconds"] = time.perf_counter() - start
    out["nvidia_smi"] = smi_line()
    emit(out)
    return out


# L1 batch_lab at 2048 blocks of 64 slices of 16 rows (1 GiB) and 16
# queries; L2 dma_lab on 2**21 rows (1 GiB); L6 i16_probe at 2048 blocks
# (1 GiB of int32, and of int16); L8 mxu_gather_lab, 16 queries, at its
# 32 chunks and at 512 (its one-hot arm then 2 GiB), and its VPU arm alone
# at 65536 (256 MiB of words, past the L2; the one-hot would be 256 GiB)
BATCH_Q, DMA_ROWS, MXU_REPS = 16, 1 << 21, (32, 512, 65536)
ONEHOT_MAX_BYTES = 4 << 30


def _labs2(dev):
    """The labs L1, L2, L6, L8 at full size (``_lab_time``): each variant
    held to its plain version bit for bit (batch_lab and i16_probe on
    their own words, dma_lab on the words with real values, its plain
    version in the kernel's block order; mxu_gather_lab at each shape),
    then timed beside K3 on the same words; mxu_gather_lab's one-hot arm
    (``mxu_onehot``: a one-hot and ``torch.matmul``, TF32 off) timed
    beside its VPU arm."""
    import torch

    from spmv_topk_tpu_torch.experiments import _common as lc
    from spmv_topk_tpu_torch.experiments import (batch_lab, dma_lab,
                                                 i16_probe, mxu_gather_lab)

    def t(a):
        return torch.from_numpy(a).to(dev)

    out = {}
    nb, W, SPB = batch_lab.DEFAULT_NB, 16, 64
    t0 = time.perf_counter()
    words, tables = (t(a) for a in lc.batch_lab_data(nb, W * SPB, BATCH_Q))
    gen = time.perf_counter() - t0

    def bl(v, **kw):
        return batch_lab.batch_lab_device(words, tables, variant=v, W=W,
                                          SPB=SPB, **kw)

    variants = {v: (lambda v=v: bl(v), lambda v=v: bl(v, unmerged=True),
                    "lab_batch",
                    (lambda v=v: bl(v), lambda v=v: batch_lab.batch_lab_plain(
                        words, tables, variant=v, W=W, SPB=SPB)))
                for v in batch_lab.VARIANTS}
    out["batch_lab"] = _lab_time(
        "lab_batch", "batch_lab", words, nb, 2, BATCH_Q * 128 * 4, variants,
        agree=_exact, out_bytes=BATCH_Q * lc.LANE_K * 128 * 8,
        queries=BATCH_Q, int_ops_per_word=H16_BATCH_INT_OPS)
    out["batch_lab"].update(data_seconds=gen, queries=BATCH_Q)
    del words, tables

    t0 = time.perf_counter()
    words, table = (t(a) for a in lc.dma_lab_data(DMA_ROWS))
    gen = time.perf_counter() - t0
    rd = _real_values(words, seed=26)
    variants = {}
    for bs, st in dma_lab.CASES:
        n = lc.cuda_blocks(dev, DMA_ROWS // bs)
        variants[dma_lab.name(bs, st)] = (
            lambda bs=bs, st=st: dma_lab.dma_lab_device(words, table, bs=bs,
                                                        t=st),
            lambda bs=bs, st=st: dma_lab.dma_lab_device(
                words, table, bs=bs, t=st, unmerged=True),
            "lab_dma",
            (lambda bs=bs, st=st: dma_lab.dma_lab_device(rd, table, bs=bs,
                                                         t=st),
             lambda bs=bs, st=st, n=n: dma_lab.dma_lab_plain(
                 rd, table, bs=bs, t=st, blocks=n)))
    out["dma_lab"] = _lab_time("lab_dma", "dma_lab", words, DMA_ROWS, 1,
                               128 * 4, variants, agree=_exact,
                               out_bytes=8 * 128 * 4, ops_per=2)
    out["dma_lab"].update(data_seconds=gen, rows=DMA_ROWS,
                          lab_blocks={dma_lab.name(bs, st): DMA_ROWS // bs
                                      for bs, st in dma_lab.CASES},
                          cuda_blocks={dma_lab.name(bs, st): lc.cuda_blocks(
                              dev, DMA_ROWS // bs)
                              for bs, st in dma_lab.CASES})
    del words, table, rd

    nb = i16_probe.DEFAULT_NB
    t0 = time.perf_counter()
    w32, w16, t32, t16 = (t(a) for a in lc.i16_probe_data(
        nb, i16_probe.SUB32))
    gen = time.perf_counter() - t0
    salt = {w.dtype: torch.arange(128, device=dev).to(w.dtype).reshape(
        1, 128) for w in (w32, w16)}

    def il(v, **kw):
        w, tb = (w32, t32) if "32" in v else (w16, t16)
        return i16_probe.i16_probe_device(w, tb, salt[w.dtype], variant=v,
                                          **kw)

    def ip(v):
        w, tb = (w32, t32) if "32" in v else (w16, t16)
        return i16_probe.i16_probe_plain(w, tb, salt[w.dtype], variant=v)

    variants = {v: (lambda v=v: il(v), lambda v=v: il(v, unmerged=True),
                    "lab_i16", (lambda v=v: il(v), lambda v=v: ip(v)))
                for v in i16_probe.VARIANTS}
    out["i16_probe"] = _lab_time(
        "lab_i16", "i16_probe", {v: w32 if "32" in v else w16
                                 for v in i16_probe.VARIANTS},
        nb, 1, 16 * 128 * 2, variants, agree=_exact, out_bytes=8 * 128 * 4,
        ops_per=3)
    out["i16_probe"]["data_seconds"] = gen
    del w32, w16, t32, t16

    res = {}
    for reps in MXU_REPS:
        words, tables, tabq = (t(a) for a in lc.mxu_lab_data(reps, BATCH_Q))
        variants = {"vpu": (
            lambda: mxu_gather_lab.mxu_vpu_device(words, tables),
            lambda: mxu_gather_lab.mxu_vpu_device(words, tables,
                                                  unmerged=True),
            "lab_mxu",
            (lambda: mxu_gather_lab.mxu_vpu_device(words, tables),
             lambda: mxu_gather_lab.mxu_vpu_plain(words, tables)))}
        r = _lab_time("lab_mxu", "mxu_gather_lab", words, reps, 2,
                      BATCH_Q * 128 * 4, variants, agree=_exact,
                      out_bytes=BATCH_Q * 128 * 4, queries=BATCH_Q,
                      int_ops_per_word=H16_BATCH_INT_OPS)
        oh_bytes = words.numel() * 1024 * 4
        oh_ms = (lc.sweep_ms(lambda: mxu_gather_lab.mxu_onehot(words, tabq))
                 if oh_bytes <= ONEHOT_MAX_BYTES else None)
        r["variants"]["vpu"].update(onehot_ms=oh_ms, onehot_bytes=oh_bytes,
                                    reps=reps, words_bytes=r["words_bytes"])
        res[reps] = r
        del words, tables, tabq
        torch.cuda.empty_cache()
    launches = {}
    for r in res.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["mxu_gather_lab"] = dict(
        res[MXU_REPS[0]], reps=MXU_REPS[0], launches=launches,
        variants={("vpu" if reps == MXU_REPS[0] else f"vpu_reps{reps}"):
                  r["variants"]["vpu"] for reps, r in res.items()})
    return out


def phase_sass():
    """What nvcc made of L1's and L6's variants (``_build.sass_report``):
    each kernel's instruction count and most frequent opcodes, and whether
    batch_lab's cur (the decode per query) compiled to shared's code, and
    i16_probe's g16x to g16's; L9's chains and K6 h16's decode a word."""
    from spmv_topk_tpu_torch.ops import _build

    out = dict(phase="sass")
    for match in ("lab_batch_sweep", "lab_i16_sweep", "lab_mxu_sweep"):
        rep = _build.sass_report(match.replace("_sweep", ".cu"), match)
        out[match] = {k: dict(total=c["total"], top=sorted(
            ((op, n) for op, n in c.items() if op != "total"),
            key=lambda x: -x[1])[:12]) for k, c in rep.items()}
        out[match + "_opcodes"] = rep
    b, i = out["lab_batch_sweep_opcodes"], out["lab_i16_sweep_opcodes"]
    for q in (4, 16):
        # lab_batch_sweep<Q, MODE, QG>: cur is mode 0, shared mode 1
        cur, shr = ([c for k, c in b.items()
                     if k.startswith(f"lab_batch_sweep<{q},{mode},")]
                    for mode in (0, 1))
        out[f"cur_equals_shared_q{q}"] = bool(cur and shr
                                              and cur[0] == shr[0])
    # lab_i16_sweep<T, GATHER, WIDEN>: g16 is <short, 1, 0>, g16x <short,
    # 1, 1> (cu++filt may spell the flags true / false)
    flags = {k: k.split("<", 1)[1].rstrip(">").split(",") for k in i}
    g16 = [i[k] for k, a in flags.items()
           if a[0] == "short" and a[1] in ("1", "true")
           and a[2] in ("0", "false")]
    g16x = [i[k] for k, a in flags.items()
            if a[0] == "short" and a[1] in ("1", "true")
            and a[2] in ("1", "true")]
    out["g16x_equals_g16"] = bool(g16 and g16x and g16[0] == g16x[0])
    for k in ("lab_batch_sweep_opcodes", "lab_i16_sweep_opcodes",
              "lab_mxu_sweep_opcodes"):
        out.pop(k)
    out["lab_pack16"] = _pack16_sass()
    out["k6_h16"] = _k6_h16_sass()
    emit(out)
    return out


def _k6_h16_sass():
    """K6 h16's decode of one word for 32 queries (``codecs.cuh::H16x32``):
    the opcode counts of the straight-line probe of 2 words less those of
    the probe of 1; and the headline instantiation's (lane_k 8, fold 8,
    production buffers) instruction and IDP counts."""
    from spmv_topk_tpu_torch.ops import _build

    rep = _build.sass_report("octet_topk_batch_h16.cu")
    one, two = (next(c for k, c in rep.items()
                     if k.startswith(f"h16x32_words_probe<{n}>"))
                for n in (1, 2))
    per_word = {op: n - one.get(op, 0) for op, n in two.items()
                if n != one.get(op, 0)}
    main = next(c for k, c in rep.items()
                if k.split("<", 1)[0] == "octet_topk_batch_h16_kernel"
                and k.split("<", 1)[1].rstrip(">").split(",") in (
                    ["4", "8", "0", "0"], ["4", "8", "false", "false"]))
    return dict(per_word_instructions=per_word["total"],
                per_word_opcodes=per_word,
                idp_per_word=sum(n for op, n in per_word.items()
                                 if op.startswith("IDP")),
                headline_kernel_instructions=main["total"],
                headline_kernel_idp=sum(n for op, n in main.items()
                                        if op.startswith("IDP")))


# ------------------------------------------------------------ L9 pack16_lab

PACK16_DEFAULT = "f32_8"
PACK16_NO_LIBRARY = ("none: no PyTorch call runs the lab's chain as one "
                     "operation")


def _bits(t):
    """A tile's bit pattern (NaN-safe equality)."""
    import torch

    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


def phase_pack16(dev):
    """L9 (pack16_lab): each of the lab's six cases held to its plain
    version bit for bit, on the lab's tile and on x + 3 (the float chains
    run to inf and NaN, the integer ones wrap), then the lab's own run
    (``pack16_lab.main``: the slope of 12 against 2 chained calls on x +
    i, each case; the path, its launches counted from 0), each case's
    plain version timed beside it."""
    import torch

    from spmv_topk_tpu_torch.experiments import pack16_lab as L

    data = L.pack16_data()
    for name in L.NAMES:
        x = data[name].to(dev)
        for xi in (x, x + 3):
            got, want = L.pack16_device(xi), L.pack16_plain(xi)
            torch.cuda.synchronize()
            require(got.dtype == want.dtype and
                    torch.equal(_bits(got), _bits(want)),
                    f"L9 {name}: kernel equals its plain version bit for bit")
    L.pack16_device.launches = 0
    lines = L.main([])
    torch.cuda.synchronize()
    launches = L.pack16_device.launches
    cases = {}
    for line in lines:
        x = data[line["case"]].to(dev)
        cases[line["case"]] = dict(line, max_abs_err=0.0, plain_ms=cuda_ms(
            lambda x=x: L.pack16_plain(x), reps=3))
    res = dict(phase="pack16_lab", cases=cases,
               launches=dict(lab_pack16=launches), nvidia_smi=smi_line())
    emit(res)
    require(launches > 0, "the pack16_lab path launched lab_pack16")
    return res


def pack16_entry(p16):
    """L9's entry of the kernels line: the f32 (8,128) case's numbers,
    every case nested under ``variants``."""
    where = dict(route="cuda",
                 source="spmv_topk_tpu_torch/csrc/lab_pack16.cu",
                 replaces="experiments/pack16_lab.py:46")

    def keys(r):
        return dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None,
                    telem_op_per_s=r["telem_op_per_s"],
                    cyc_per_op=r["cyc_per_op"],
                    sm_clock_hz=r["sm_clock_hz"],
                    rate_source=r["rate_source"])

    cases = p16["cases"]
    return dict(name="lab_pack16", **where,
                launches=p16["launches"]["lab_pack16"],
                **keys(cases[PACK16_DEFAULT]),
                library_calls=PACK16_NO_LIBRARY,
                default_variant=PACK16_DEFAULT,
                variants={n: dict(name=f"lab_pack16/{n}", **where, **keys(r))
                          for n, r in cases.items()})


def _pack16_sass():
    """What nvcc made of L9: per kernel the chain's arithmetic
    instructions, required to hold the lab's 512 rounds of every chain
    (a float multiply and add each; an integer multiply-add may fuse into
    one IMAD)."""
    from spmv_topk_tpu_torch.ops import _build

    rep = _build.sass_report("lab_pack16.cu", "lab_pack16")
    out = {}
    for kern, c in rep.items():
        sub = int(kern.rsplit(",", 1)[-1].split("<")[-1].rstrip(">"))
        if "bf16" in kern:
            arith = sum(n for op, n in c.items()
                        if op.split(".")[0] in ("HMUL2", "HADD2", "HFMA2"))
            need = 2 * 512 * sub // 2        # bf16x2: two elements a chain
        elif "f32" in kern:
            arith = c.get("FMUL", 0) + c.get("FADD", 0)
            need = 2 * 512 * sub
        else:
            arith = sum(n for op, n in c.items()
                        if op.split(".")[0] in ("IMAD", "IADD3", "IMUL"))
            need = 512 * sub
        out[kern] = dict(total=c["total"], chain_ops=arith, need=need,
                         top=sorted(((op, n) for op, n in c.items()
                                     if op != "total"),
                                    key=lambda x: -x[1])[:6])
        require(arith >= need, f"{kern}: the SASS holds the lab's 512 "
                f"rounds ({arith} chain instructions, {need} needed)")
    require(len(out) == 6, f"six L9 kernels in the SASS, got {list(out)}")
    return out


# ------------------------------------------------------------ dense engine

DENSE_BUDGET = 12 << 30         # bench.py:405-409's hbm_budget_bytes
DENSE_QUERIES = (64, 256)       # bench.py's raw batches
DENSE_SEED = 9
DENSE_SMALL_ROWS = 50_000
# a sanity floor of the raw dense precision@100 against the exact top 100
# (int8 and bf16 values; the selection is exact)
MIN_PRECISION_DENSE = 0.8


def _dense_rows_agree(bi, bv, pi, pv, rtol, what):
    """Values equal (bit for bit, or to rtol with atol 1e-6) and the same
    rows above each query's k-th value (less the margin)."""
    bi, bv, pi, pv = (x.cpu().numpy() for x in (bi, bv, pi, pv))
    if rtol:
        require(np.allclose(bv, pv, rtol=rtol, atol=1e-6),
                f"{what}: values equal to rtol {rtol}")
    else:
        require(np.array_equal(bv, pv), f"{what}: values bit for bit")
    for j in range(len(bi)):
        kth = pv[j, -1] + rtol * abs(pv[j, -1]) + (1e-6 if rtol else 0)
        require(set(bi[j][bv[j] > kth].tolist()) ==
                set(pi[j][pv[j] > kth].tolist()),
                f"{what}: query {j}'s rows above the k-th value")
    return float(np.abs(bv - pv).max())


def _dense_small(dev):
    """The dense engine on a 50k-row corpus, each dtype: the card's
    densify bit for bit the NumPy densify's, and query_batch of 64 raw
    queries against its plain products (``dense_topk_batch(plain=True)``:
    exact float64 integer sums; float32 of the bf16 values, TF32 off):
    int8 bit for bit, bf16 to rtol 1e-5 (the same exact products, added in
    another order), rows above the k-th value equal."""
    import torch

    from spmv_topk_tpu_torch import DenseTopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)
    from spmv_topk_tpu_torch.ops import dense as D

    coo = create_sparse_matrix(DENSE_SMALL_ROWS, NUM_COLS, AVG_DEG, "gamma",
                               seed=CORPUS_SEED)
    qs = create_query_batch(DENSE_QUERIES[0], NUM_COLS, seed=DENSE_SEED)
    out = {}
    for dtype in ("int8", "bf16"):
        eng = DenseTopKSpMV(coo, TopKSpMVConfig(k=100, max_cols=NUM_COLS),
                            device=dev, dtype=dtype)
        n = coo.num_rows
        if dtype == "int8":
            bits, sc = D.densify_int8(coo)
            require(np.array_equal(eng._A[:n].cpu().numpy(), bits) and
                    np.array_equal(eng._scales[:n].cpu().numpy(), sc),
                    "int8 densify on the card equals the NumPy densify")
        else:
            bits = D.densify_bf16(coo)
            require(np.array_equal(eng._A[:n].to(torch.bfloat16)
                                   .view(torch.int16).cpu().numpy()
                                   .view(np.uint16), bits),
                    "bf16 densify on the card equals the NumPy densify")
        bi, bv = eng.query_batch(qs)
        if dtype == "int8":
            qi, qsc = D.quantize_queries_int8(qs, dev)
            pi, pv = D.dense_topk_batch(eng._A, qi, n, eng._scales, qsc,
                                        k=100, block_rows=eng.block_rows,
                                        plain=True)
        else:
            pi, pv = D.dense_topk_batch(eng._A, torch.from_numpy(qs).to(dev),
                                        n, k=100, block_rows=eng.block_rows,
                                        plain=True)
        out[f"{dtype}_max_abs_err"] = _dense_rows_agree(
            bi, bv, pi, pv, 1e-5 if dtype == "bf16" else 0.0,
            f"dense {dtype} at {n} rows against its plain products")
        del eng
    torch.cuda.empty_cache()
    return out


def _batch_ms(fn, runs=3):
    """Best host-clock ms of ``fn()`` over ``runs`` runs, each ending in a
    synchronize."""
    import torch

    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def phase_dense(coo, qs, gold, dev):
    """The dense engine on the 10M corpus (bench.py:390-415): int8 under
    bench.py's 12 GiB budget (which refuses the bf16 form), then bf16
    under the card's own budget; raw batches of 64 and 256 queries (the
    path's 32 queries first), ms a query (best of 3, host clock, ending in
    a synchronize) and precision@100 of the 32 against the exact top 100;
    each dtype held to its plain products at 50k rows (``_dense_small``).
    Returns the int8 answers of the 64 for the sharded dense engine."""
    import torch

    from spmv_topk_tpu_torch import DenseTopKSpMV, TopKSpMVConfig
    from spmv_topk_tpu_torch.formats import create_query_batch

    res = dict(phase="dense", rows=coo.num_rows, **_dense_small(dev))
    batches = {n: np.concatenate([qs, create_query_batch(
        n - len(qs), NUM_COLS, seed=DENSE_SEED)]) for n in DENSE_QUERIES}
    cfg = TopKSpMVConfig(k=100, max_cols=NUM_COLS)
    try:
        DenseTopKSpMV(coo, cfg, device=dev, hbm_budget_bytes=DENSE_BUDGET)
        refused = False
    except ValueError:
        refused = True
    require(refused, "the bf16 form is refused under a 12 GiB budget")
    answers = None
    for dtype, budget in (("int8", DENSE_BUDGET), ("bf16", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = DenseTopKSpMV(coo, cfg, device=dev, hbm_budget_bytes=budget,
                            dtype=dtype)
        build_s = time.perf_counter() - t0
        print(f"dense {dtype}: densify on the card {eng.densify_seconds:.3f}"
              f" s ({coo.num_rows} x {coo.num_cols}, {eng.hbm_bytes} bytes)",
              flush=True)
        r = dict(densify_s=eng.densify_seconds, build_s=build_s,
                 bytes_on_card=eng.hbm_bytes, block_rows=eng.block_rows,
                 recall_target=eng.recall_target,
                 budget=budget if budget is not None else
                 "card: 0.6 x torch.cuda.mem_get_info total")
        for n, Q in batches.items():
            eng.query_batch(Q)                          # warm
            idx, _ = eng.query_batch(Q)
            idx = idx.cpu().numpy()
            if n == DENSE_QUERIES[0] and dtype == "int8":
                answers = eng.query_batch(Q)
            prec = _precision(gold, idx[:len(qs)], 100)
            ms = _batch_ms(lambda Q=Q: eng.query_batch(Q))
            r[f"q{n}_ms_per_query"] = ms / n
            r[f"q{n}_batch_ms"] = ms
            r[f"q{n}_precision_at_100_mean"] = float(np.mean(prec))
            r[f"q{n}_precision_at_100_min"] = float(np.min(prec))
            require(np.mean(prec) >= MIN_PRECISION_DENSE,
                    f"dense {dtype} precision@100 >= {MIN_PRECISION_DENSE}")
        res[dtype] = r
        del eng
        torch.cuda.empty_cache()
    res["nvidia_smi"] = smi_line()
    emit(res)
    return res, answers, batches[DENSE_QUERIES[0]]


# --------------------------------------------------------- sharded engines

SHARDS = 4
SNAPSHOT_DIR = os.path.join("build", "chip_smoke_snapshot")


def _sharded_drive(eng, qs, group):
    """query() of each query (host-clock ms, numpy rows and values), then
    query_batch of all in groups of ``group`` (host-clock ms)."""
    import torch

    idx, vals, q_ms = [], [], []
    for q in qs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i, v = eng.query(q)
        torch.cuda.synchronize()
        q_ms.append((time.perf_counter() - t0) * 1e3)
        idx.append(i.cpu().numpy())
        vals.append(v.cpu().numpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bi, bv = eng.query_batch(qs, group_size=group)
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t0) * 1e3
    return idx, vals, q_ms, bi.cpu().numpy(), bv.cpu().numpy(), b_ms


def _same_answers(a, b, what):
    """Two runs' (rows, values) lists, query by query: values bit for bit,
    the same rows above the k-th value."""
    for j, (ai, av, bi, bv) in enumerate(zip(*a, *b)):
        _same_top(ai, av, bi, bv, f"{what}, query {j}")


def _sweep_counts(octet):
    from spmv_topk_tpu_torch.ops import kernel as K

    if octet:
        return dict(octet_topk=K.topk_spmv_fused_octet_device.launches,
                    octet_topk_batch=(
                        K.topk_spmv_fused_batch_octet_device.launches))
    return dict(slice_topk=K.topk_spmv_fused_device.launches,
                slice_topk_batch=K.topk_spmv_fused_batch_device.launches)


class _ShardView:
    """Shard ``pos`` of a sharded engine as the kernel helpers read an
    engine (words, nreal, plan_rows, row_ids, config, tables)."""

    def __init__(self, eng, pos, num_nnz):
        import types

        sh = eng._shards[pos]
        self.config = eng.config
        self.words, self.nreal = sh["words"], sh["nreal"]
        self.plan_rows, self.row_ids = sh["plan_rows"], sh["row_ids"]
        kw = eng._sweep_kw()
        self.partition_kw = {k: kw[k] for k in ("num_partitions",
                                                "part_slices") if k in kw}
        self.fused = types.SimpleNamespace(
            block_sublanes=eng.fused_block_sublanes)
        self.hbm_bytes = self.words.numel() * 4
        self.num_nnz = num_nnz
        self._eng = eng

    def _table(self, q):
        tab, scale = self._eng._table(q)
        return tab.to(self.words.device), scale


def _shard_kernel_times(view, qs, dev, group):
    """The sweeps of one shard of a partitioned sharded engine (K10a and
    K10c on the slice stream, K10b and K10d on the octet stream: a query,
    and one group of ``group``) held to their plain versions (tie-safe,
    bit for bit) and timed against them; K10b and K10c alone on the card
    too (K10c with its grid, slots and registers, ``_k8_times``)."""
    import dataclasses

    from spmv_topk_tpu_torch.ops import kernel as K

    cfg = view.config
    octet = cfg.fused_layout == "octet"
    safe = dataclasses.replace(cfg, tie_safe_topk=True)
    qs = qs[:group]
    e1, e2, _ = (_octet_agree(view, safe, qs[0], qs, dev) if octet else
                 _slice_agree(view, safe, qs[0], qs, dev, held=K8_HELD))
    bs = cfg.fused_block_sublanes
    parts = view.partition_kw
    table, _ = view._table(qs[0])
    args = (view.words, table, view.nreal, view.plan_rows)
    bargs = (view.words, _tables(qs, dev, cfg.query_codec), view.nreal,
             view.plan_rows)
    if octet:
        k1, k2 = "k10b", "k10d"
        one, batch = (K.topk_spmv_fused_octet_device,
                      K.topk_spmv_fused_batch_octet_device)
        kw = dict(lane_k=cfg.lane_k, fold_tile=cfg.fold_tile,
                  tie_safe=bool(cfg.tie_safe_topk), block_sublanes=bs,
                  codec=cfg.query_codec, **parts)
        plain1 = lambda: K.octet_topk_plain(*args, **kw)        # noqa: E731
        plain2 = lambda: K.octet_topk_batch_plain(*bargs, **kw)  # noqa: E731
    else:
        k1, k2 = "k10a", "k10c"
        one, batch = K.topk_spmv_fused_device, K.topk_spmv_fused_batch_device
        kw = dict(_slice_plain_kw(cfg), **parts)
        plain1 = lambda: K.slice_topk_plain(                    # noqa: E731
            *args, fold_tile=cfg.fold_tile, **kw)
        plain2 = lambda: K.slice_topk_batch_plain(*bargs, **kw)  # noqa: E731
    b1 = sweep_bound(view, 1, topk_out_bytes(view, 1))
    b2 = sweep_bound(view, len(qs), topk_out_bytes(view, len(qs)))
    alone = {}
    if octet:   # K10b alone on the card, with and without its lane merge
        alone[f"{k1}_alone_ms"], alone[f"{k1}_unmerged_ms"], _ = \
            _k1_alone_ms(view, table, cfg)
    else:       # K10c alone, its grid, slots and registers
        alone.update(_k8_times(view, bargs[1], cfg, key=k2))
    return {**alone,
        f"{k1}_ms": cuda_ms(lambda: one(*args, cfg=cfg, block_sublanes=bs,
                                        **parts), reps=20, warmup=2),
        f"{k1}_plain_ms": cuda_ms(plain1, reps=2),
        f"{k1}_max_abs_err": e1,
        f"{k2}_ms": cuda_ms(lambda: batch(*bargs, cfg=cfg, block_sublanes=bs,
                                          **parts), reps=10, warmup=2),
        f"{k2}_plain_ms": cuda_ms(plain2, reps=1, warmup=0),
        f"{k2}_max_abs_err": e2, f"{k2}_queries": len(qs),
        f"{k1}_bound_ms": b1[0], f"{k1}_bound_by": b1[1],
        f"{k2}_bound_ms": b2[0], f"{k2}_bound_by": b2[1]}


def _sharded_run(coo, qs, dev, name, config, shards, group, gold_sets,
                 floor, ref=None, ref_name=None, exchange=None):
    """One sharded engine on ``shards`` positions of the card: build, warm,
    then the path (counts from 0): 32 query() and query_batch in groups of
    ``group``; precision@100 of both against ``gold_sets`` (>= ``floor``),
    and, with ``ref`` ((rows, values) per query), query()'s answers held
    to ref's. Returns (engine, result line, the query() answers)."""
    import torch

    from spmv_topk_tpu_torch import TopKSpMVConfig
    from spmv_topk_tpu_torch.parallel import ShardedTopKSpMV, make_mesh

    cfg = TopKSpMVConfig(**config)
    octet = cfg.fused_layout == "octet"
    t0 = time.perf_counter()
    eng = ShardedTopKSpMV(coo, cfg, mesh=make_mesh([dev] * shards),
                          exchange_skeleton=exchange)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng.query(qs[0])
    eng.query_batch(qs[:2], group_size=2)
    torch.cuda.synchronize()
    _reset_octet_counts()
    _reset_slice_counts()
    idx, vals, q_ms, bi, bv, b_ms = _sharded_drive(eng, qs, group)
    launches = _sweep_counts(octet)
    prec = _precision(gold_sets, idx, cfg.k)
    bprec = _precision(gold_sets, bi, cfg.k)
    if ref is not None:
        _same_answers((idx, vals), ref, f"{name} against {ref_name}")
    same = [len(set(a.tolist()) & set(b.tolist())) / cfg.k
            for a, b in zip(idx, bi)]
    res = dict(phase=f"sharded_{name}", config=config, shards=shards,
               mesh=[str(dev)] * shards, exchange_skeleton=bool(exchange),
               pack_and_upload_s=build_s, words_bytes=eng.hbm_bytes,
               query_e2e_ms_median=statistics.median(q_ms),
               batch_group_size=group, batch_e2e_ms_per_query=b_ms / len(qs),
               precision_at_100_mean=float(np.mean(prec)),
               batch_precision_at_100_mean=float(np.mean(bprec)),
               agreement_with_query_mean=float(np.mean(same)),
               same_as=ref_name, launches=launches)
    require(min(res["precision_at_100_mean"],
                res["batch_precision_at_100_mean"]) >= floor,
            f"sharded {name} precision@100 >= {floor}")
    for kname, n in launches.items():
        require(n > 0, f"the sharded {name} path launched {kname}")
    return eng, res, (idx, vals)


def phase_sharded(coo, qs, gold, gold_bf16, dev, main_answers,
                  default_answers):
    """The sharded bucket engine on the 10M corpus, positions on one card:
    the octet h16 headline config (rescored) at D = 1 (held to the
    headline TopKSpMV's answers) and D = 4 (held to D = 1's; saved and
    loaded back, held to itself); the default slice f32 config at D = 1
    (held to the default TopKSpMV) and D = 4 (its agreement with D = 1:
    four pools against one); then num_partitions = 2 at D = 1 with the
    quantized codecs, c3's i8s on the slice stream under an NCCL group of
    one process with exchange_skeleton=True, and the headline with i4s: the
    partitioned kernels K10a-d at full size held to and timed against
    their plain versions."""
    import shutil

    import torch

    from spmv_topk_tpu_torch.parallel import (ShardedTopKSpMV, distributed,
                                              make_mesh)

    out = {}
    # octet h16 headline, rescored
    eng, r, a1 = _sharded_run(coo, qs, dev, "octet_h16_d1", HEADLINE, 1,
                              BATCH_GROUP, gold, MIN_PRECISION,
                              ref=main_answers, ref_name="TopKSpMV headline")
    out["octet_h16_d1"] = r
    del eng
    eng, r, a4 = _sharded_run(coo, qs, dev, "octet_h16_d4", HEADLINE, SHARDS,
                              BATCH_GROUP, gold, MIN_PRECISION, ref=a1,
                              ref_name="octet_h16_d1")
    os.makedirs(SNAPSHOT_DIR, exist_ok=True)
    path = os.path.join(SNAPSHOT_DIR, "octet_h16_d4")
    t0 = time.perf_counter()
    eng.save(path)
    r["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ShardedTopKSpMV.load(path, mesh=make_mesh([dev] * SHARDS),
                                matrix=coo)
    r["load_s"] = time.perf_counter() - t0
    shutil.rmtree(SNAPSHOT_DIR)
    for j, q in enumerate(qs[:8]):
        for x, y in zip(back.query(q), eng.query(q)):
            require(torch.equal(x, y), f"the loaded snapshot answers query "
                    f"{j} as the saved engine")
    out["octet_h16_d4"] = r
    del eng, back
    torch.cuda.empty_cache()
    # default slice f32, raw
    eng, r, d1 = _sharded_run(coo, qs, dev, "slice_f32_d1", DEFAULT, 1,
                              DEFAULT_GROUP, gold_bf16, MIN_PRECISION_BF16,
                              ref=default_answers,
                              ref_name="TopKSpMV default")
    out["slice_f32_d1"] = r
    del eng
    eng, r, d4 = _sharded_run(coo, qs, dev, "slice_f32_d4", DEFAULT, SHARDS,
                              DEFAULT_GROUP, gold_bf16, MIN_PRECISION_BF16)
    r["agreement_with_d1_mean"] = float(np.mean([
        len(set(a.tolist()) & set(b.tolist())) / DEFAULT["k"]
        for a, b in zip(d4[0], d1[0])]))
    out["slice_f32_d4"] = r
    del eng
    torch.cuda.empty_cache()
    # num_partitions = 2 with the quantized codecs: K10a-d at full size
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize_multihost(f"127.0.0.1:{port}", 1, 0,
                                     device_type="cuda")
    try:
        require(distributed.world_size() == 1, "an NCCL group of one")
        eng, r, _ = _sharded_run(coo, qs, dev, "slice_i8s_p2",
                                 dict(C3, num_partitions=PARTITIONS), 1,
                                 DEFAULT_GROUP, gold_bf16,
                                 MIN_PRECISION_BF16, exchange=True)
        r["process_group"] = "nccl, world size 1"
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    r.update(_shard_kernel_times(_ShardView(eng, 0, coo.nnz), qs, dev,
                                 DEFAULT_GROUP))
    out["slice_i8s_p2"] = r
    del eng
    torch.cuda.empty_cache()
    eng, r, _ = _sharded_run(coo, qs, dev, "octet_i4s_p2",
                             dict(HEADLINE, query_codec="i4s",
                                  num_partitions=PARTITIONS), 1,
                             BATCH_GROUP, gold, MIN_PRECISION)
    r.update(_shard_kernel_times(_ShardView(eng, 0, coo.nnz), qs, dev,
                                 BATCH_GROUP))
    out["octet_i4s_p2"] = r
    del eng
    torch.cuda.empty_cache()
    for r in out.values():
        r["nvidia_smi"] = smi_line()
        emit(r)
    return out


def phase_sharded_dense(coo, batch, gold, dev, dense_answers):
    """The sharded dense engine, int8, on the 10M corpus at D = 1 and D =
    4 positions of the card: a raw batch of 64 (the dense phase's), each
    held to the one-device DenseTopKSpMV's answers (exact integer sums:
    values bit for bit, rows above the k-th value), ms a query (best of 3)
    and precision@100 of its first 32."""
    import torch

    from spmv_topk_tpu_torch import TopKSpMVConfig
    from spmv_topk_tpu_torch.parallel import ShardedDenseTopKSpMV, make_mesh

    res = dict(phase="sharded_dense", dtype="int8", queries=len(batch))
    for shards in (1, SHARDS):
        t0 = time.perf_counter()
        eng = ShardedDenseTopKSpMV(coo, TopKSpMVConfig(k=100,
                                                       max_cols=NUM_COLS),
                                   mesh=make_mesh([dev] * shards),
                                   dtype="int8")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        bi, bv = eng.query_batch(batch)
        err = _dense_rows_agree(bi, bv, *dense_answers, 0.0,
                                f"sharded dense int8 D={shards} against "
                                "DenseTopKSpMV int8")
        prec = _precision(gold, bi.cpu().numpy()[:len(gold)], 100)
        ms = _batch_ms(lambda: eng.query_batch(batch))
        res[f"d{shards}"] = dict(build_s=build_s, bytes_on_card=eng.hbm_bytes,
                                 block_rows=eng.block_rows,
                                 ms_per_query=ms / len(batch), batch_ms=ms,
                                 precision_at_100_mean=float(np.mean(prec)),
                                 max_abs_err_vs_dense=err)
        del eng
        torch.cuda.empty_cache()
    res["nvidia_smi"] = smi_line()
    emit(res)
    return res


def lab_entry(name, source, replaces, res, default, variants_of=None,
              **extra_top):
    """A lab's entry of the kernels line: its default variant's numbers,
    every variant's nested under ``variants``. ``ms`` is the kernel alone
    (but where ``merge_in_ms``), ``merged_ms`` its wrapper with the
    per-lane merge (or the merge of its partial sums)."""
    def keys(r, **extra):
        return dict(launches=r["launches"], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], merged_ms=r["merged_ms"],
                    merge_in_ms=r["merge_in_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=None, gb_per_s=r["gb_per_s"],
                    share_of_k3=r["share_of_k3"], k3_ms=r["k3_ms"], **extra)

    where = dict(route="cuda", source=f"spmv_topk_tpu_torch/csrc/{source}",
                 replaces=replaces)
    variants = {v: dict(name=f"{name}/{v}", **where, **keys(r))
                for v, r in res["variants"].items()}
    for v, extra in (variants_of or {}).items():
        variants[v].update(extra)
    top = keys(res["variants"][default])
    top.update(extra_top)
    top["launches"] = res["launches"][name]
    return dict(name=name, **where, **top, library_calls=LAB_NO_LIBRARY,
                default_variant=default, nb=res["nb"],
                words_bytes=res["words_bytes"],
                k3_library_ms=res["k3_library_ms"], variants=variants)


def _reset_octet_counts():
    from spmv_topk_tpu_torch.ops import kernel as K

    for w in (K.topk_spmv_fused_octet_device,
              K.topk_spmv_fused_batch_octet_device,
              K.spmv_fused_scores_octet_device):
        w.launches = 0


def _octet_counts(codec):
    """The octet wrappers' counts, under the kernels line's names of the
    path's codec (octet_topk_<codec>, ...)."""
    from spmv_topk_tpu_torch.ops import kernel as K

    return {f"octet_topk_{codec}": K.topk_spmv_fused_octet_device.launches,
            f"octet_topk_batch_{codec}": (
                K.topk_spmv_fused_batch_octet_device.launches),
            f"octet_scores_{codec}": K.spmv_fused_scores_octet_device.launches}


def kernel_entry(name, source, replaces, launches, res, key, library_ms,
                 **extra):
    """One kernel of the summary line, from a phase's results ``res``
    whose keys for this kernel start with ``key``."""
    return dict(name=name, route="cuda",
                source=f"spmv_topk_tpu_torch/csrc/{source}",
                replaces=replaces, launches=launches,
                max_abs_err=res[f"{key}_max_abs_err"], ms=res[f"{key}_ms"],
                plain_ms=res[f"{key}_plain_ms"],
                bound_ms=res[f"{key}_bound_ms"],
                bound_by=res[f"{key}_bound_by"], library_ms=library_ms,
                **extra)


# The phases a run can name on the command line, in the order they run,
# and what each needs run before it (the 10M corpus, its queries and gold
# sets come with any of the full-size phases).
PHASES = ("small", "k1_small", "k7_small", "k8_small", "k6_small",
          "slice_small",
          "partition_small",
          "codecs_small", "bucket_small", "labs_small", "sass", "main",
          "library",
          "slice_engines", "default_config", "bucket_path", "octet_engines",
          "dense", "sharded", "labs", "pack16")
PHASE_NEEDS = {
    "slice_engines": ("default_config",),
    "bucket_path": ("default_config", "library"),
    "octet_engines": ("main", "library"),
    "sharded": ("main", "default_config", "dense"),
    "main": ("library",),
    "default_config": ("library",),
}
FULL_SIZE = set(PHASES[PHASES.index("main"):PHASES.index("labs")])


def selected_phases(names):
    """The phases to run for the command line's phase names, their needs
    added; every phase when none is named."""
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase(s) {unknown}; the "
                         f"phases are {list(PHASES)}")
    if not names:
        return set(PHASES)
    want, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in want:
            want.add(name)
            todo.extend(PHASE_NEEDS.get(name, ()))
    return want


def phase_corpus(dev):
    """The 10M x 1024 corpus, its CSR, the 32 queries and their exact
    top-100 sets, for a run whose main path does not build them."""
    from spmv_topk_tpu_torch.formats import (create_query_batch,
                                             create_sparse_matrix)

    t0 = time.perf_counter()
    coo = create_sparse_matrix(FULL_ROWS, NUM_COLS, AVG_DEG, "gamma",
                               seed=CORPUS_SEED)
    csr = coo.to_scipy_csr()
    qs = create_query_batch(NUM_QUERIES, NUM_COLS, seed=QUERY_SEED)
    gold = _gold_sets(csr, qs, 100)
    emit(dict(phase="corpus", rows=coo.num_rows, nnz=coo.nnz,
              seconds=time.perf_counter() - t0))
    return coo, csr, qs, gold


def main(argv=()):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    want = selected_phases(list(argv))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_environment()
    torch.cuda.synchronize()
    for name, fn in (("small", phase_small), ("k1_small", phase_k1_small),
                     ("k7_small", phase_k7_small),
                     ("k8_small", phase_k8_small),
                     ("k6_small", phase_k6_small),
                     ("slice_small", phase_slice_small),
                     ("partition_small", phase_partition_small),
                     ("codecs_small", phase_codecs_small),
                     ("bucket_small", phase_bucket_small),
                     ("labs_small", phase_labs_small)):
        if name in want:
            fn(dev)
            torch.cuda.synchronize()
    if "sass" in want:
        phase_sass()
    R = {}
    if want & FULL_SIZE:
        if "main" in want:
            coo, eng, qs, R["main_res"], gold, single = phase_main(dev)
            torch.cuda.synchronize()
            R["full"] = phase_kernels_full(eng, qs, dev)
            torch.cuda.synchronize()
            R["batch"] = phase_batch(eng, qs, gold, single,
                                     R["full"]["k1_ms"], dev)
            torch.cuda.synchronize()
            R["scores"] = phase_scores(eng, qs, dev)
            torch.cuda.synchronize()
            csr = eng._scipy_csr
            p1_octet_bytes = eng.hbm_bytes
            del eng                 # the octet engine's words leave the card
            torch.cuda.empty_cache()
        else:
            coo, csr, qs, gold = phase_corpus(dev)
        R["lib"] = phase_library(csr, qs, dev)
        gold_bf16 = _bf16_gold_sets(csr, qs, 100)
        engines = (("slice", SLICE_BATCH, BATCH_GROUP, "sl"),
                   ("default_config", DEFAULT, DEFAULT_GROUP, "df"),
                   ("partitioned_default",
                    dict(DEFAULT, num_partitions=PARTITIONS), DEFAULT_GROUP,
                    "pdf"),
                   ("c3", C3, DEFAULT_GROUP, "c3"),
                   ("c8", C8, BATCH_GROUP, "c8"),
                   ("int8x4", INT8X4, DEFAULT_GROUP, "i8"))
        for name, config, group, key in engines:
            if "slice_engines" in want or name in want:
                R[key] = phase_slice_engine(coo, csr, qs, gold, gold_bf16,
                                            dev, name, config, group)
        if "bucket_path" in want:
            R["bk"], R["bkh"] = phase_bucket_path(coo, csr, qs, gold,
                                                  gold_bf16, R["df"], dev)
        if "octet_engines" in want:
            R["po"] = phase_octet_engine(
                coo, csr, qs, gold, dev, "partitioned_octet",
                dict(HEADLINE, num_partitions=PARTITIONS), p1_octet_bytes)
            R["pof"] = phase_octet_engine(
                coo, csr, qs, gold, dev, "partitioned_octet_f32",
                dict(HEADLINE, query_codec="f32", num_partitions=PARTITIONS),
                p1_octet_bytes)
            R["oc"] = {codec: phase_octet_engine(
                coo, csr, qs, gold, dev, f"octet_{codec}",
                dict(HEADLINE, query_codec=codec), p1_octet_bytes)
                for codec in ("f32", "int8x4", "i8s", "i4s")}
            torch.cuda.synchronize()
        if "dense" in want:
            dense, dense_answers, dense_batch = phase_dense(coo, qs, gold,
                                                            dev)
            torch.cuda.synchronize()
        if "sharded" in want:
            R["sharded"] = phase_sharded(coo, qs, gold, gold_bf16, dev,
                                         R["main_res"].pop("_answers"),
                                         R["df"].pop("_answers"))
            R["sharded"]["dense"] = phase_sharded_dense(
                coo, dense_batch, gold, dev, dense_answers)
        if "dense" in want:
            del dense_answers
        torch.cuda.empty_cache()
    if "labs" in want:
        R["labs"] = phase_labs(dev)
        torch.cuda.synchronize()
    if "pack16" in want:
        R["p16"] = phase_pack16(dev)
        torch.cuda.synchronize()
    summarize(R, complete=want == set(PHASES))
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def summarize(R, complete):
    """Emit each path's launch counts and the kernel summary line; raise
    unless every kernel of every path was launched there. R: the results
    of the phases that ran (main_res, full, batch, scores: the main path;
    lib: the library yardsticks; sl, df, pdf, c3, c8, i8: the slice
    engines; po, oc: the octet engines, oc by codec; bk and bkh: the
    per-bucket paths (f32 and h16); labs: each lab's timing its path; p16:
    L9's phase; sharded: the sharded engines' paths, K10a-d with the
    quantized codecs nested under the partitioned kernels' entries). A
    kernel's entry stands in the line when the phases it reads ran, which
    ``complete`` (a run of every phase) requires of every entry."""
    def have(*keys):
        return all(R.get(key) is not None for key in keys)

    if have("pdf", "df"):
        require(R["pdf"]["words_bytes"] >= R["df"]["words_bytes"],
                "the partition skeleton adds words, never drops them")
    by_path = {}
    if have("main_res", "batch", "scores"):
        by_path["main_path"] = dict(
            R["main_res"]["launches"],
            octet_topk_batch_h16=R["batch"]["launches"],
            octet_scores_h16=R["scores"]["launches"])
    for key, path in (("sl", "slice_path"), ("df", "default_path"),
                      ("po", "partitioned_octet_path"),
                      ("pof", "partitioned_octet_f32_path"),
                      ("pdf", "partitioned_default_path"),
                      ("c3", None), ("c8", None), ("i8", None),
                      ("bk", "bucket_path"), ("bkh", "bucket_h16_path"),
                      ("p16", "pack16_lab_path")):
        if have(key):
            by_path[path or R[key]["phase"]] = R[key]["launches"]
    if have("pdf"):
        by_path["partitioned_int8x4_path"] = dict(
            slice_topk=R["pdf"]["k10a_int8x4_launches"],
            slice_topk_batch=R["pdf"]["k10c_int8x4_launches"])
    for codec, r in (R.get("oc") or {}).items():
        by_path[f"octet_{codec}_path"] = r["launches"]
    for lab in ("kernel_lab", "fused_lab", "h16_lab", "fold_lab", "batch_lab",
                "dma_lab", "i16_probe", "mxu_gather_lab"):
        if have("labs"):
            by_path[f"{lab}_path"] = R["labs"][lab]["launches"]
    for n, r in (R.get("sharded") or {}).items():
        if "launches" in r:
            by_path[f"sharded_{n}_path"] = r["launches"]
    words = {}
    if have("po", "pdf", "df"):
        words = dict(words_bytes=dict(
            octet_one_partition=R["po"]["words_bytes_one_partition"],
            octet_partitioned=R["po"]["words_bytes"],
            default_one_partition=R["df"]["words_bytes"],
            default_partitioned=R["pdf"]["words_bytes"]))
    emit(dict(phase="launch_counts", **by_path, **words))
    for path in by_path.values():
        for name, n in path.items():
            require(n > 0, f"its path launched {name}")

    # library yardsticks: SpMV alone for the SpMV kernels, SpMV and
    # torch.topk (two calls) for the Top-K sweeps, at each sweep's queries
    lib = R.get("lib") or {}
    spmv, topk1 = lib.get("spmv_ms"), lib.get("spmv_topk_1_ms")
    two = dict(library_calls="torch.sparse.mm + torch.topk")
    one = dict(library_calls="torch.sparse.mm")
    ker = "spmv_topk_tpu/ops/kernel.py"
    launches = by_path.get("main_path", {})

    def octet_codecs(name, source, line, kn, library, extra_of=None,
                     **extra):
        """The octet kernel's entry of each codec but h16 (its path's
        launches and times; ``source`` a file, or one a codec;
        ``extra_of(results)`` the keys of a codec's own)."""
        return {c: kernel_entry(
            name.replace("h16", c),
            source[c] if isinstance(source, dict) else source,
            f"{ker}:{line}", r["launches"][name.replace("h16", c)], r, kn,
            library, **extra, **(extra_of(r) if extra_of else {}))
            for c, r in R["oc"].items()}

    def k1_extra(r, kn):
        """K1's keys beside kernel_entry's: alone on the card with its
        merge and without it (``_k1_alone_ms``), its template."""
        return dict(alone_ms=r[f"{kn}_alone_ms"],
                    unmerged_ms=r[f"{kn}_unmerged_ms"],
                    template="spmv_topk_tpu_torch/csrc/octet_topk.cuh")

    def k7_extra(r, kn):
        """K7's keys beside kernel_entry's: alone on the card with its
        merge and without it (``_k7_alone_ms``), its template (each
        codec's unit is its source, K7_UNITS)."""
        return dict(alone_ms=r[f"{kn}_alone_ms"],
                    unmerged_ms=r[f"{kn}_unmerged_ms"],
                    template="spmv_topk_tpu_torch/csrc/slice_topk.cuh")

    def k8_extra(r, kn):
        """K8's keys beside kernel_entry's: alone on the card with its
        merge and without it, its pass, passes and slots, the registers
        and spills of its instantiation (``_k8_times``), its template
        (each codec's unit is its source, K8_UNITS)."""
        return dict(alone_ms=r[f"{kn}_alone_ms"],
                    unmerged_ms=r[f"{kn}_unmerged_ms"],
                    topk_merge_of_the_slots_ms=r[
                        f"{kn}_topk_merge_of_the_slots_ms"],
                    pass_queries=r[f"{kn}_pass_queries"],
                    passes=r[f"{kn}_passes"], slots=r[f"{kn}_slots"],
                    registers=r[f"{kn}_registers"],
                    spill_bytes=r[f"{kn}_spill_bytes"],
                    template="spmv_topk_tpu_torch/csrc/slice_topk_batch.cuh")

    def k6_extra(r, kn):
        """K6's keys beside kernel_entry's: alone on the card with its
        merge and without it, the ``torch.topk`` merge of its unmerged
        slots, its pass, passes and slots, the registers and spills of its
        instantiation (``_k6_times``), its template."""
        return dict(alone_ms=r[f"{kn}_alone_ms"],
                    unmerged_ms=r[f"{kn}_unmerged_ms"],
                    topk_merge_of_the_slots_ms=r[
                        f"{kn}_topk_merge_of_the_slots_ms"],
                    pass_queries=r[f"{kn}_pass_queries"],
                    passes=r[f"{kn}_passes"], slots=r[f"{kn}_slots"],
                    registers=r[f"{kn}_registers"],
                    spill_bytes=r[f"{kn}_spill_bytes"],
                    template="spmv_topk_tpu_torch/csrc/octet_topk_batch.cuh")

    def slice_entry(name, src, kn, line, q, fq):
        sl, df, sc = R["sl"], R["df"], dict(i8s=R["c3"], i4s=R["c8"],
                                            int8x4=R["i8"])
        units = dict(k7=K7_UNITS, k8=K8_UNITS).get(kn)

        def extra(r):
            return (k7_extra(r, kn) if kn == "k7" else
                    k8_extra(r, kn) if kn == "k8" else scores_extra(r, kn))

        def unit(codec):
            return units[codec] if units else src

        return kernel_entry(
            name, unit("h16"), f"{ker}:{line}", sl["launches"][name], sl,
            kn, lib[f"spmv_topk_{q}_ms"] if kn != "k9" else spmv,
            **extra(sl),
            **{codec: kernel_entry(name, unit(codec), f"{ker}:{line}",
                                   r["launches"][name], r, kn,
                                   lib[f"spmv_topk_{cq}_ms"] if kn != "k9"
                                   else spmv, **extra(r))
               for codec, r, cq in (
                   ("f32", df, fq), ("i8s", sc["i8s"], fq),
                   ("i4s", sc["i4s"], q), ("int8x4", sc["int8x4"], fq))})

    def sharded(key):
        return R["sharded"][key]

    def scores_extra(r, kn):
        """K4's and K9's keys beside kernel_entry's (``ms`` is the row-order
        launch that scores() makes): the slice-order form's times and
        bound (``_scores_times``), and scores() whole (``_scores_path``)."""
        return dict(store="row order",
                    slice_order_ms=r[f"{kn}_slice_order_ms"],
                    slice_order_plain_ms=r[f"{kn}_slice_order_plain_ms"],
                    slice_order_bound_ms=r[f"{kn}_slice_order_bound_ms"],
                    slice_order_bound_by=r[f"{kn}_slice_order_bound_by"],
                    scores_device_ms=r["scores_device_ms_median"],
                    scores_host_ms=r["scores_host_ms_median"],
                    scores_before_row_store_device_ms=r[
                        "scores_before_row_store_device_ms_median"])

    def k12_extra(r):
        """K12's keys beside kernel_entry's (``_bucket_times``)."""
        return dict(alone_ms=r["k12_alone_ms"],
                    unmerged_ms=r["k12_unmerged_ms"],
                    topk_merge_of_the_slots_ms=r[
                        "k12_topk_merge_of_the_slots_ms"],
                    template="spmv_topk_tpu_torch/csrc/bucket_topk_batch.cuh")

    def k13_extra(r):
        return dict(alone_ms=r["k13_alone_ms"],
                    host_enqueue_ms=r["k13_host_enqueue_ms_median"],
                    host_launches_ms=r["k13_host_launches_ms_median"])

    slices = ("sl", "df", "c3", "c8", "i8", "lib")
    # (the results an entry reads, the entry)
    specs = [
        # K1: ms through its wrapper, alone_ms the launch on the card,
        # unmerged_ms the sweep without its lane merge; each codec's own
        # translation unit
        (("main_res", "full", "oc", "lib"), lambda: kernel_entry(
            "octet_topk_h16", K1_UNITS["h16"], f"{ker}:1057",
            launches["octet_topk_h16"], R["full"], "k1", topk1, **two,
            **k1_extra(R["full"], "k1"),
            topk_merge_of_the_slots_ms=R["full"][
                "k1_topk_merge_of_the_slots_ms"],
            **octet_codecs("octet_topk_h16", K1_UNITS, 1057, "k1", topk1,
                           extra_of=lambda r: k1_extra(r, "k1"), **two))),
        (("main_res", "batch", "oc", "lib"), lambda: kernel_entry(
            "octet_topk_batch_h16", "octet_topk_batch_h16.cu", f"{ker}:1641",
            launches["octet_topk_batch_h16"], R["batch"], "k6",
            lib[f"spmv_topk_{BATCH_GROUP}_ms"], queries=BATCH_GROUP, **two,
            alone_ms=R["batch"]["k6_alone_ms"],
            **octet_codecs("octet_topk_batch_h16", K6_UNITS, 1641, "k6",
                           lib[f"spmv_topk_{BATCH_GROUP}_ms"],
                           extra_of=lambda r: k6_extra(r, "k6"),
                           queries=BATCH_GROUP, **two))),
        (("main_res", "scores", "oc", "lib"), lambda: kernel_entry(
            "octet_scores_h16", "octet_scores.cu", f"{ker}:2039",
            launches["octet_scores_h16"], R["scores"], "k4", spmv, **one,
            **scores_extra(R["scores"], "k4"),
            **octet_codecs("octet_scores_h16", "octet_scores.cu", 2039,
                           "k4", spmv,
                           extra_of=lambda r: scores_extra(r, "k4"),
                           **one))),
        (("main_res", "full"), lambda: kernel_entry(
            "stream_words", "stream_probe.cu",
            "spmv_topk_tpu/ops/streamprobe.py:54", launches["stream_words"],
            R["full"], "k3", R["full"]["k3_library_ms"],
            library_calls="words.view(-1, 8, 128).sum(0, dtype=torch.int32)"
            " + salt", alone_ms=R["full"]["k3_alone_ms"])),
        *((slices, lambda a=a: slice_entry(*a)) for a in (
            ("slice_topk", "slice_topk.cu", "k7", 864, 1, 1),
            ("slice_topk_batch", "slice_topk_batch.cuh", "k8", 1381,
             BATCH_GROUP, DEFAULT_GROUP),
            ("slice_scores", "slice_scores.cu", "k9", 1909, 1, 1))),
        # K10a-d and the partitioned K4/K9: the same kernels with a
        # partition axis, on the partitioned paths
        (("po", "pof", "sharded", "lib"), lambda: kernel_entry(
            "octet_topk_h16_partitioned", K1_UNITS["h16"], f"{ker}:1116",
            R["po"]["launches"]["octet_topk_h16"], R["po"], "k10b", topk1,
            partitions=PARTITIONS, **two, **k1_extra(R["po"], "k10b"),
            f32=kernel_entry(
                "octet_topk_f32_partitioned", K1_UNITS["f32"],
                f"{ker}:1116", R["pof"]["launches"]["octet_topk_f32"],
                R["pof"], "k10b", topk1, partitions=PARTITIONS,
                path="partitioned_octet_f32_path", **two,
                **k1_extra(R["pof"], "k10b")),
            i4s=kernel_entry(
                "octet_topk_i4s_partitioned", K1_UNITS["i4s"],
                f"{ker}:1116", sharded("octet_i4s_p2")["launches"][
                    "octet_topk"], sharded("octet_i4s_p2"), "k10b", topk1,
                partitions=PARTITIONS, path="sharded_octet_i4s_p2",
                **two, **k1_extra(sharded("octet_i4s_p2"), "k10b")))),
        (("po", "pof", "sharded", "lib"), lambda: kernel_entry(
            "octet_topk_batch_h16_partitioned", "octet_topk_batch_h16.cu",
            f"{ker}:1693", R["po"]["launches"]["octet_topk_batch_h16"],
            R["po"], "k10d", lib[f"spmv_topk_{BATCH_GROUP}_ms"],
            partitions=PARTITIONS, queries=BATCH_GROUP, **two,
            **dict(k6_extra(R["po"], "k10d"),
                   template="spmv_topk_tpu_torch/csrc/"
                   "octet_topk_batch_h16.cu"),
            f32=kernel_entry(
                "octet_topk_batch_f32_partitioned", K6_UNITS["f32"],
                f"{ker}:1693", R["pof"]["launches"]["octet_topk_batch_f32"],
                R["pof"], "k10d", lib[f"spmv_topk_{BATCH_GROUP}_ms"],
                partitions=PARTITIONS, queries=BATCH_GROUP,
                path="partitioned_octet_f32_path", **two,
                **k6_extra(R["pof"], "k10d")),
            i4s=kernel_entry(
                "octet_topk_batch_i4s_partitioned", K6_UNITS["i4s"],
                f"{ker}:1693", sharded("octet_i4s_p2")["launches"][
                    "octet_topk_batch"], sharded("octet_i4s_p2"), "k10d",
                lib[f"spmv_topk_{BATCH_GROUP}_ms"], partitions=PARTITIONS,
                queries=BATCH_GROUP, path="sharded_octet_i4s_p2", **two))),
        (("po", "pof", "lib"), lambda: kernel_entry(
            "octet_scores_h16_partitioned", "octet_scores.cu",
            f"{ker}:2039", R["po"]["launches"]["octet_scores_h16"], R["po"],
            "k4", spmv, partitions=PARTITIONS, **one,
            **scores_extra(R["po"], "k4"),
            f32=kernel_entry(
                "octet_scores_f32_partitioned", "octet_scores.cu",
                f"{ker}:2039", R["pof"]["launches"]["octet_scores_f32"],
                R["pof"], "k4", spmv, partitions=PARTITIONS,
                path="partitioned_octet_f32_path", **one,
                **scores_extra(R["pof"], "k4")))),
        (("pdf", "sharded", "lib"), lambda: kernel_entry(
            "slice_topk_partitioned", K7_UNITS["f32"], f"{ker}:927",
            R["pdf"]["launches"]["slice_topk"], R["pdf"], "k7", topk1,
            partitions=PARTITIONS, **two, **k7_extra(R["pdf"], "k7"),
            i8s=kernel_entry(
                "slice_topk_i8s_partitioned", K7_UNITS["i8s"], f"{ker}:927",
                sharded("slice_i8s_p2")["launches"]["slice_topk"],
                sharded("slice_i8s_p2"), "k10a", topk1,
                partitions=PARTITIONS, path="sharded_slice_i8s_p2",
                template="spmv_topk_tpu_torch/csrc/slice_topk.cuh", **two),
            int8x4=kernel_entry(
                "slice_topk_int8x4_partitioned", K7_UNITS["int8x4"],
                f"{ker}:927", R["pdf"]["k10a_int8x4_launches"], R["pdf"],
                "k10a_int8x4", topk1, partitions=PARTITIONS,
                path="partitioned_int8x4_path",
                alone_ms=R["pdf"]["k10a_int8x4_alone_ms"],
                unmerged_ms=R["pdf"]["k10a_int8x4_unmerged_ms"],
                template="spmv_topk_tpu_torch/csrc/slice_topk.cuh", **two))),
        (("pdf", "sharded", "lib"), lambda: kernel_entry(
            "slice_topk_batch_partitioned", K8_UNITS["f32"],
            f"{ker}:1440", R["pdf"]["launches"]["slice_topk_batch"],
            R["pdf"], "k8", lib[f"spmv_topk_{DEFAULT_GROUP}_ms"],
            partitions=PARTITIONS, queries=DEFAULT_GROUP, **two,
            **k8_extra(R["pdf"], "k8"),
            i8s=kernel_entry(
                "slice_topk_batch_i8s_partitioned", K8_UNITS["i8s"],
                f"{ker}:1440", sharded("slice_i8s_p2")["launches"][
                    "slice_topk_batch"], sharded("slice_i8s_p2"), "k10c",
                lib[f"spmv_topk_{DEFAULT_GROUP}_ms"], partitions=PARTITIONS,
                queries=DEFAULT_GROUP, path="sharded_slice_i8s_p2", **two,
                **k8_extra(sharded("slice_i8s_p2"), "k10c")),
            int8x4=kernel_entry(
                "slice_topk_batch_int8x4_partitioned", K8_UNITS["int8x4"],
                f"{ker}:1440", R["pdf"]["k10c_int8x4_launches"], R["pdf"],
                "k10c_int8x4", lib[f"spmv_topk_{DEFAULT_GROUP}_ms"],
                partitions=PARTITIONS, queries=DEFAULT_GROUP,
                path="partitioned_int8x4_path", **two,
                **k8_extra(R["pdf"], "k10c_int8x4")))),
        (("pdf", "lib"), lambda: kernel_entry(
            "slice_scores_partitioned", "slice_scores.cu", f"{ker}:1909",
            R["pdf"]["launches"]["slice_scores"], R["pdf"], "k9", spmv,
            partitions=PARTITIONS, **one, **scores_extra(R["pdf"], "k9"))),
        # the per-bucket ops over every bucket of pack_sell_buckets: f32
        # (the default config), h16 nested; times summed over the buckets,
        # alone_ms the kernels on the card with no host time
        (("bk", "bkh", "lib"), lambda: kernel_entry(
            "bucket_scores", "bucket_scores.cu", f"{ker}:2107",
            R["bk"]["launches"]["bucket_scores"], R["bk"], "k11", spmv,
            buckets=R["bk"]["buckets"], alone_ms=R["bk"]["k11_alone_ms"],
            **one,
            h16=kernel_entry("bucket_scores", "bucket_scores.cu",
                             f"{ker}:2107",
                             R["bkh"]["launches"]["bucket_scores"], R["bkh"],
                             "k11", spmv, buckets=R["bkh"]["buckets"],
                             alone_ms=R["bkh"]["k11_alone_ms"], **one))),
        # K13: ms back to back through its wrapper, alone_ms the kernel
        # on the card with no host time (_bucket_times)
        (("bk", "bkh", "lib"), lambda: kernel_entry(
            "bucket_topk", "bucket_topk.cu", f"{ker}:2276",
            R["bk"]["launches"]["bucket_topk"], R["bk"], "k13", topk1,
            buckets=R["bk"]["buckets"], **two, **k13_extra(R["bk"]),
            h16=kernel_entry("bucket_topk", "bucket_topk.cu", f"{ker}:2276",
                             R["bkh"]["launches"]["bucket_topk"], R["bkh"],
                             "k13", topk1, buckets=R["bkh"]["buckets"],
                             **two, **k13_extra(R["bkh"])))),
        # K12: its unit per codec, alone with and without its merge, the
        # torch.topk merge of its slots (the kernel before's)
        (("bk", "bkh", "lib"), lambda: kernel_entry(
            "bucket_topk_batch", K12_UNITS["f32"], f"{ker}:2225",
            R["bk"]["launches"]["bucket_topk_batch"], R["bk"], "k12",
            lib[f"spmv_topk_{DEFAULT_GROUP}_ms"], buckets=R["bk"]["buckets"],
            queries=DEFAULT_GROUP, **two, **k12_extra(R["bk"]),
            h16=kernel_entry(
                "bucket_topk_batch", K12_UNITS["h16"], f"{ker}:2225",
                R["bkh"]["launches"]["bucket_topk_batch"], R["bkh"], "k12",
                lib[f"spmv_topk_{DEFAULT_GROUP}_ms"],
                buckets=R["bkh"]["buckets"], queries=DEFAULT_GROUP, **two,
                **k12_extra(R["bkh"])))),
        # the measurement labs: each variant nested, v_prod (K7) under
        # fused_lab's entry
        (("labs",), lambda: lab_entry(
            "lab_kernel", "lab_kernel.cu", "experiments/kernel_lab.py:282",
            R["labs"]["kernel_lab"], "int8/exact")),
        (("labs",), lambda: lab_entry(
            "lab_fused", "lab_fused.cu", "experiments/fused_lab.py:108",
            R["labs"]["fused_lab"], "v_bare",
            variants_of=dict(v_prod=dict(
                name="slice_topk", source=(
                    "spmv_topk_tpu_torch/csrc/slice_topk_q.cu"),
                template="spmv_topk_tpu_torch/csrc/slice_topk.cuh",
                replaces=f"{ker}:864")))),
        (("labs",), lambda: lab_entry(
            "lab_h16", "lab_h16.cu", "experiments/h16_lab.py:189",
            R["labs"]["h16_lab"], "cur")),
        (("labs",), lambda: lab_entry(
            "lab_fold", "lab_fold.cu", "experiments/fold_lab.py:129",
            R["labs"]["fold_lab"], "base")),
        (("labs",), lambda: lab_entry(
            "lab_batch", "lab_batch.cu", "experiments/batch_lab.py:213",
            R["labs"]["batch_lab"], "shared", queries=BATCH_Q)),
        (("labs",), lambda: lab_entry(
            "lab_dma", "lab_dma.cu", "experiments/dma_lab.py:71",
            R["labs"]["dma_lab"], "1024x1")),
        (("labs",), lambda: lab_entry(
            "lab_i16", "lab_i16.cu", "experiments/i16_probe.py:84",
            R["labs"]["i16_probe"], "s32")),
        # the one-hot arm (torch, not a kernel of the port) beside the VPU
        # arm: a different function (one h16 half against an f32 table)
        (("labs",), lambda: lab_entry(
            "lab_mxu", "lab_mxu.cu", "experiments/mxu_gather_lab.py:108",
            R["labs"]["mxu_gather_lab"], "vpu", queries=BATCH_Q,
            onehot_ms=R["labs"]["mxu_gather_lab"]["variants"]["vpu"][
                "onehot_ms"],
            onehot_calls="torch.where one-hot + torch.matmul (f32)",
            variants_of={v: dict(onehot_ms=r["onehot_ms"])
                         for v, r in R["labs"]["mxu_gather_lab"][
                             "variants"].items()})),
        (("p16",), lambda: pack16_entry(R["p16"])),
    ]
    ready = [build for needs, build in specs if have(*needs)]
    if complete:
        require(len(ready) == len(specs),
                "a run of every phase has every kernel's entry")
    emit({"kernels": [build() for build in ready]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
