"""Capacity planning: size an H100 deployment for a corpus and project
serving rates.

BASELINE.json config 5 asks for a 500M-row corpus served across many
accelerators. This tool combines the MEASURED one-card constants (the
port's kernels on one NVIDIA H100 80GB HBM3 at its 700 W limit,
``chip_smoke.py``; PERF.md sections 5 and 6) with the sharded engine's
cost model — per-card sweeps are independent (the reference's
embarrassingly-parallel partition property, host_spmv_bscsr.cpp:323-397),
the merge is an all-gather of k (value, row) pairs per card
(``parallel/sharded_buckets.py``), and the exact rescore is row-sharded
across hosts — to report memory fit, per-query latency, qps and scaling
efficiency for any (corpus, mesh) pair.

Every projected number is labeled; every constant says where it was
measured, or that it is a data-sheet value.

Usage:
  python -m spmv_topk_tpu_torch.bench.capacity --rows 500e6 --mesh h100-8 --batch 64
  python -m spmv_topk_tpu_torch.bench.capacity --baseline-config5 --json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

# ---------------------------------------------------------------- constants
# The card everything below was measured on (nvidia-smi name, power.limit).
CARD = "NVIDIA H100 80GB HBM3, 700 W"
# nnz of the corpus every rate was measured on: 10M x 1024, gamma degrees,
# mean degree 20, seed 1 (chip_smoke.py's full-size corpus)
CORPUS_NNZ = 194_994_789


def _gnnz(ms: float, queries: int = 1) -> float:
    """Gnnz/s a query of a sweep of that corpus taking ``ms`` for
    ``queries`` queries."""
    return CORPUS_NNZ / (ms * 1e-3 / queries) / 1e9


MEASURED = {
    # Gnnz/s a card, its range over the runs, words (4 bytes) per nnz on
    # the card incl. padding, and the per-query rate of query groups
    # (batch_gnnz_core: group size -> Gnnz/s a query), each measured by
    # chip_smoke.py on the 10M corpus on the card; PERF.md section 6 (the
    # kernel table) names the run of each figure. "core" keeps the JAX
    # planner's key names: an H100 is one core here.
    # h16: the octet layout at width quantum 2 (the headline engine).
    # Single query K1 0.189 ms (0.187 in another run, 0.192 alone); groups
    # of 32 K6 h16 0.725 ms; words 449,314,816 bytes (PERF.md "Port
    # status").
    "h16": dict(gnnz_core=_gnnz(0.189),
                gnnz_range=(_gnnz(0.192), _gnnz(0.187)),
                words_per_nnz=449_314_816 / 4 / CORPUS_NNZ,
                batch_gnnz_core={1: _gnnz(0.189), 32: _gnnz(0.725, 32)}),
    # i4s / i8s / f32: the slice layout (tune._candidates' layout for
    # them), K7 single query: c8 (i4s, quantum 4) 0.422 ms, c3 (i8s,
    # quantum 4) 0.420, the default engine (f32, quantum 8) 0.440 (alone
    # 0.424-0.441); groups: K8 c8 3.445 ms a group of 32, c3 1.198 and the
    # default f32 1.159 a group of 8; words of c3 and c8 861,405,184 bytes,
    # the default's 937,426,944 (chip_smoke.py's words_bytes of those
    # engines). tune._candidates' quantum 2 for these codecs is not
    # measured on the card.
    "i4s": dict(gnnz_core=_gnnz(0.422),
                gnnz_range=(_gnnz(0.438), _gnnz(0.422)),
                words_per_nnz=861_405_184 / 4 / CORPUS_NNZ,
                batch_gnnz_core={1: _gnnz(0.422), 32: _gnnz(3.445, 32)}),
    "i8s": dict(gnnz_core=_gnnz(0.420),
                gnnz_range=(_gnnz(0.438), _gnnz(0.420)),
                words_per_nnz=861_405_184 / 4 / CORPUS_NNZ,
                batch_gnnz_core={1: _gnnz(0.420), 8: _gnnz(1.198, 8)}),
    "f32": dict(gnnz_core=_gnnz(0.440),
                gnnz_range=(_gnnz(0.441), _gnnz(0.440)),
                words_per_nnz=937_426_944 / 4 / CORPUS_NNZ,
                batch_gnnz_core={1: _gnnz(0.440), 8: _gnnz(1.159, 8)}),
}
# host ms a query of the exact rescore of a pool of 400: the headline
# engine's rescored minus raw query_batch time a query, 256 queries in
# groups of 32 (chip_smoke.py's batch32_e2e_ms_per_query 0.8118 less
# batch32_e2e_raw_ms_per_query 0.0449); the host's time spreads widely
# between runs (0.275 to 0.767 ms, PERF.md section 7)
RESCORE_MS_PER_QUERY = 0.7669
# host pack of the headline engine, nnz a second: chip_smoke.py's
# pack_and_upload_s, 8.61 s for the 10M corpus
PACK_NNZ_PER_SEC = CORPUS_NNZ / 8.61
MERGE_BYTES_PER_DEV = 8         # (f32 value, i32 row) per candidate
# NVLink 4 between the cards of one host: 900 GB/s per card both ways
# (data sheet, H100 SXM), 450 GB/s each way. Not measured: no collective
# has run beyond a group of one process on one card.
LINK_BYTES_PER_SEC = 450e9
# the merge's floor per group: an assumption, not measured (as above)
MERGE_FLOOR_MS = 5e-3

# Card table: (memory GB, memory GB/s, cores per card, cards per host).
# NVIDIA's data sheet for the H100 SXM: 80 GB of HBM3 at 3,350 GB/s; eight
# cards a host (HGX H100). One "core": the planner's rates are per card.
CHIPS = {
    "h100": dict(hbm_gb=80.0, hbm_gbps=3350.0, cores=1, chips_per_host=8),
}


def parse_mesh(mesh: str):
    """'h100-16' -> (card dict, num_cards, num_hosts): the number is the
    count of cards (cores / cores a card), so h100-16 = 16 cards = 2
    hosts."""
    name, _, n = mesh.partition("-")
    if name not in CHIPS or not n.isdigit():
        raise ValueError(f"unknown mesh {mesh!r}; use e.g. h100-8, h100-32")
    chip = CHIPS[name]
    cores = int(n)
    chips = max(1, cores // chip["cores"])
    hosts = max(1, chips // chip["chips_per_host"])
    return dict(chip, name=name), chips, hosts


@dataclasses.dataclass
class Plan:
    """One sized deployment; every field is derived from measured
    constants except where `assumptions` says otherwise."""
    mesh: str
    rows: int
    cols: int
    nnz: int
    codec: str
    batch: int
    packed_gb: float
    per_chip_gb: float
    hbm_utilization: float
    fits: bool
    sweep_ms: float
    merge_ms: float
    rescore_ms: float
    per_query_ms: float
    qps: float
    aggregate_gnnz: float
    scaling_efficiency: float
    pack_minutes_per_host: float
    raw_precision_lower_bound: float
    assumptions: list

    def as_json(self):
        return json.dumps(dataclasses.asdict(self))


def plan(
    rows: int,
    cols: int = 1024,
    nnz_per_row: float = 20.0,
    codec: str = "h16",
    k: int = 100,
    lane_k: int = 8,
    mesh: str = "h100-8",
    batch: int = 64,
    rescore_pool: int = 400,
    words_per_nnz: Optional[float] = None,
) -> Plan:
    """Size `mesh` for a (rows x cols, nnz_per_row) corpus under `codec`.

    The model: corpus rows split evenly across cards (the reference's
    partition rule, host_spmv_bscsr.cpp:136-150, generalized); each card
    sweeps its packed words at the measured per-card rate; the merge
    all-gathers merge_k (value,row) pairs per card over NVLink; hosts
    rescore their own row slice of the exact CSR concurrently."""
    m = MEASURED[codec]
    chip, chips, hosts = parse_mesh(mesh)
    nnz = int(rows * nnz_per_row)
    wpn = m["words_per_nnz"] if words_per_nnz is None else words_per_nnz
    packed_gb = nnz * wpn * 4 / 1e9
    # row_ids + nreal metadata are < 1% of words; the rescore CSR lives in
    # HOST memory (row-sliced per host), not on the card.
    per_chip_gb = packed_gb / chips * 1.01
    hbm_util = per_chip_gb / chip["hbm_gb"]

    lo, hi = m["gnnz_range"]
    assumptions = [
        f"per-card rate = {m['gnnz_core']:.1f} Gnnz/s measured on one "
        f"{CARD} (range {lo:.1f}-{hi:.1f} over the runs; PERF.md section "
        f"6); every card of {mesh} is assumed to sweep at that rate",
        f"{chip['hbm_gb']:.0f} GB of memory at {chip['hbm_gbps']:.0f} GB/s "
        f"and {chip['chips_per_host']} cards a host are NVIDIA data-sheet "
        "values (H100 SXM, HGX), not measurements",
    ]

    # Batch rate: interpolate measured group points (per-query Gnnz/s/card).
    pts = sorted(m["batch_gnnz_core"].items())
    if batch <= pts[0][0]:
        rate_core = pts[0][1]
    elif batch >= pts[-1][0]:
        rate_core = pts[-1][1]
        if batch > pts[-1][0]:
            assumptions.append(
                f"batch {batch} > largest measured group {pts[-1][0]}: "
                f"using the group-{pts[-1][0]} rate (conservative — the "
                f"shared-decode amortization only improves)")
    else:
        import bisect
        i = bisect.bisect_left([p[0] for p in pts], batch)
        (b0, r0), (b1, r1) = pts[i - 1], pts[i]
        rate_core = r0 + (r1 - r0) * (batch - b0) / (b1 - b0)

    # Memory-bound check: the card's read demand must stay under its
    # memory rate (with 15% headroom); clamp if not. A group of queries
    # reads the stream once (K6, K8), so the demand of a per-query rate is
    # divided by the queries that share a read.
    share = min(max(batch, 1), pts[-1][0])
    demand_gbps = rate_core * chip["cores"] * wpn * 4 / share
    cap_gbps = chip["hbm_gbps"] * 0.85
    if demand_gbps > cap_gbps:
        rate_core *= cap_gbps / demand_gbps
        assumptions.append(
            f"clamped to the memory ceiling: demand {demand_gbps:.0f} GB/s "
            f"> 85% of {chip['hbm_gbps']} GB/s")

    nnz_per_chip = nnz / chips
    sweep_ms = nnz_per_chip / (rate_core * chip["cores"] * 1e9) * 1e3
    merge_k = max(k, rescore_pool)
    # all-gather of merge_k pairs per card over NVLink, at least
    # MERGE_FLOOR_MS; neither is measured (see the constants)
    merge_ms = max(MERGE_FLOOR_MS, merge_k * MERGE_BYTES_PER_DEV * chips
                   / LINK_BYTES_PER_SEC * 1e3)
    assumptions.append(
        f"merge over NVLink at {LINK_BYTES_PER_SEC / 1e9:.0f} GB/s a "
        f"direction (data sheet) with a {MERGE_FLOOR_MS * 1e3:.0f} us floor: "
        "assumed, not measured; a mesh past one host merges over its "
        "network, which the model does not price")
    # hosts rescore their row slice concurrently; the measured ms is a
    # full-corpus-on-one-host figure, so the per-host cost only drops.
    rescore_ms = RESCORE_MS_PER_QUERY if rescore_pool else 0.0

    # sweep_ms is per QUERY at the batched rate; a group of `batch`
    # queries shares one merge, and each query pays the host rescore
    # (conservatively serial — in production it overlaps the next sweep).
    B = max(batch, 1)
    group_ms = sweep_ms * B + merge_ms + rescore_ms * B
    per_query_ms = group_ms / B
    qps = 1e3 / per_query_ms
    aggregate_gnnz = nnz / per_query_ms / 1e6
    single_chip_ms = nnz / (rate_core * chip["cores"] * 1e9) * 1e3
    scaling_eff = (single_chip_ms / chips) / per_query_ms

    pack_min = nnz / hosts / PACK_NNZ_PER_SEC / 60.0

    from ..eval.accuracy_model import closed_form_precision
    raw_prec = closed_form_precision(
        n=min(rows, 10**7), b=128, k=k, partition_k=lane_k)
    assumptions.append(
        "raw_precision_lower_bound is the closed-form single-device "
        "128-lane model (eval/accuracy_model.py); more cards only widen "
        "the candidate pool, and the exact rescore lifts measured "
        f"precision@100 to 1.0 on the {CARD} (PERF.md)")

    return Plan(
        mesh=mesh, rows=rows, cols=cols, nnz=nnz, codec=codec, batch=batch,
        packed_gb=round(packed_gb, 2), per_chip_gb=round(per_chip_gb, 2),
        hbm_utilization=round(hbm_util, 3), fits=hbm_util < 0.9,
        sweep_ms=round(sweep_ms, 3), merge_ms=round(merge_ms, 4),
        rescore_ms=rescore_ms, per_query_ms=round(per_query_ms, 3),
        qps=round(qps, 1), aggregate_gnnz=round(aggregate_gnnz, 1),
        scaling_efficiency=round(scaling_eff, 3),
        pack_minutes_per_host=round(pack_min, 1),
        raw_precision_lower_bound=round(raw_prec, 4),
        assumptions=assumptions,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=float, default=500e6)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--nnz-per-row", type=float, default=20.0)
    ap.add_argument("--codec", default="h16", choices=sorted(MEASURED))
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--mesh", default="h100-8")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--baseline-config5", action="store_true",
                    help="the BASELINE.json config-5 geometry "
                         "(500M x 1024, batched streaming) on one host "
                         "of eight cards, h100-8")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.baseline_config5:
        p = plan(rows=500_000_000, cols=1024, mesh="h100-8", batch=64)
    else:
        p = plan(rows=int(args.rows), cols=args.cols,
                 nnz_per_row=args.nnz_per_row, codec=args.codec,
                 k=args.k, mesh=args.mesh, batch=args.batch)

    if args.json:
        print(p.as_json())
        return p
    d = dataclasses.asdict(p)
    assump = d.pop("assumptions")
    width = max(len(k_) for k_ in d)
    for k_, v in d.items():
        print(f"{k_:<{width}}  {v}")
    print("\nassumptions / provenance:")
    for a in assump:
        print(f"  - {a}")
    return p


if __name__ == "__main__":
    main()
