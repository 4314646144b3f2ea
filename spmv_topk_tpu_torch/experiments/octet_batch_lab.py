"""Octet vs slice BATCH sweep A/B on the headline corpus.

The counterpart of experiments/octet_batch_lab.py on the card: the batch
sweep of the h16 octet engine at quantum 1 (K6) against the h16 slice
engine at quantum 2 (K8), per query at Q in {8, 32} (the arguments),
and the JAX lab's third arm, octet-q1 with ``batch_subgroup=8``. The
port's kernels do not read ``batch_subgroup`` (K6 h16 takes a pass of up
to 32 queries whatever it says), so that arm is the octet-q1 engine's
launches: the lab prints so and reports the octet-q1 time for it
rather than timing the same route twice.

The JAX lab loads bench.py's cached 10M-row corpus and engines; this one
generates the same corpus (``--rows`` x 1024, degree 20, gamma, seed 1)
and packs the engines in the run.

    python -m spmv_topk_tpu_torch.experiments.octet_batch_lab [Q ...]
        [--rows N] [--device cpu]
"""

from __future__ import annotations

from . import _drivers as D

ROWS, COLS, DEG = 10_000_000, D.COLS, D.DEG
REPS = 5
SUBGROUP = 8          # the third arm's batch_subgroup (groups past it)
SUBGROUP_NOTE = ("batch_subgroup is not read by the port's batch sweeps: "
                 "this arm is octet-q1's launches, timed once, there")


def corpus(rows=ROWS):
    return D.corpus(rows)


def engine(coo, layout, wq, subgroup=0, device="cuda"):
    """(engine, seconds to pack and upload)."""
    cfg = D.h16_config(fused_layout=layout, width_quantum=wq,
                       fused_block_sublanes=1024, fold_tile=8,
                       batch_subgroup=subgroup)
    return D.build(coo, cfg, device)


def measure(name, eng, nnz, Q, n_short=2, n_long=8):
    run_n = D.batch_runner(eng, D.group_tables(eng, Q, n_long, seed=4))
    warm_s = D.warm(run_n, n_short, n_long)
    sl = sorted(s / Q for s in D.slopes(dict(r=run_n), n_short, n_long,
                                        REPS)["r"])
    per_q = sl[len(sl) // 2]
    return D.emit(dict(lab="octet_batch_lab", variant=name, Q=Q,
                       ms_per_query=per_q * 1e3,
                       gnnz_per_sec_per_query=nnz / per_q / 1e9,
                       warm_s=warm_s, device=D.device_name(eng.device)))


def main(argv=None):
    args = D.parse_args(argv, __doc__, ROWS, lambda ap: ap.add_argument(
        "qs", nargs="*", type=int, metavar="Q",
        help="queries a group (default 8 32)"))
    qlist = args.qs or [8, 32]
    coo = corpus(args.rows)
    nnz = coo.nnz
    out = [D.emit(dict(lab="octet_batch_lab", rows=args.rows, nnz=nnz))]
    engs = {}
    for name, layout, wq in (("octet-q1", "octet", 1),
                             ("slice-q2", "slice", 2)):
        engs[name], pack_s = engine(coo, layout, wq, device=args.device)
        out.append(D.emit(dict(lab="octet_batch_lab", engine=name,
                               pack_s=pack_s, **D.geometry(engs[name]))))
    res = {}
    for Q in qlist:
        by_name = {name: measure(name, eng, nnz, Q)
                   for name, eng in engs.items()}
        for name, r in by_name.items():
            res[f"{name}/Q{Q}"] = r["ms_per_query"]
            out.append(r)
        if Q > SUBGROUP:   # the JAX lab's sub8 arm
            out.append(D.emit(dict(by_name["octet-q1"],
                                   variant=f"octet-q1-sub{SUBGROUP}",
                                   note=SUBGROUP_NOTE)))
    s, o = res.get("slice-q2/Q32"), res.get("octet-q1/Q32")
    if s and o:
        out.append(D.emit(dict(lab="octet_batch_lab",
                               octet_over_slice_batch32=s / o)))
    return out


if __name__ == "__main__":
    main()
