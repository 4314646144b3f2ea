"""Measured accuracy-vs-K sweep: the reference's central accuracy figure.

The reference reports precision / Kendall-tau / NDCG at
K in {8, 16, 32, 50, 75, 100} per matrix class, with published bars
>= 0.96 on uniform and >= 0.80 on gamma corpora (plot_errors.py:36,
85-94, 133-138; sweep grid test_spmv_topk.py:15-32). This module measures
the full K sweep by running the real engine, the production h16 + rescore
config and the raw (un-rescored) sweep, against the exact gold per query
(the reference's differential protocol, host_spmv_bscsr.cpp:638-663).
The counterpart of ``spmv_topk_tpu.bench.accuracy_sweep``: the same
engine config, corpora, queries, aggregation and JSON.

Run (the card: full size; the CPU, the kernels' plain versions: pass
``--rows 20000`` or so and ``--device cpu``):

    python -m spmv_topk_tpu_torch.bench.accuracy_sweep --rows 1000000

Output: one JSON with per-(dist, mode, K) mean metrics over the query
trials, written to ``--out`` (default
``build/spmv_topk_tpu_torch/eval/accuracy_sweep.json``), plus a
matplotlib figure next to it (plot_errors analog) where matplotlib is
installed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

KS = (8, 16, 32, 50, 75, 100)
# where the port's evaluation tools write (.gitignore lists build/)
DEFAULT_OUT_DIR = os.path.join("build", "spmv_topk_tpu_torch", "eval")


def run(rows: int = 1_000_000, cols: int = 512, deg: int = 20,
        trials: int = 5, ks=KS, dists=("uniform", "gamma"),
        rescore_pool: int = 400, seed: int = 7, device="cuda") -> dict:
    """Per-(dist, mode, K) mean precision, Kendall tau and NDCG of the h16
    slice engine (quantum 2, fold 8, 1024-row blocks) on ``device``, the
    production mode (rescored from a pool of ``rescore_pool``) and the raw
    mode (``rescore_pool=0``), against ``ops.gold.topk_exact``."""
    from ..api import TopKSpMV
    from ..config import TopKSpMVConfig
    from ..eval import metrics
    from ..formats import create_query_batch, create_sparse_matrix
    from ..ops.gold import topk_exact

    kmax = max(ks)
    out = {"rows": rows, "cols": cols, "deg": deg, "trials": trials,
           "ks": list(ks), "configs": []}
    for dist in dists:
        t0 = time.time()
        coo = create_sparse_matrix(rows, cols, deg, dist, seed=seed)
        cfg = TopKSpMVConfig(k=kmax, lane_k=8, max_cols=cols,
                             query_codec="h16", width_quantum=2,
                             fused_block_sublanes=1024, fold_tile=8,
                             rescore_pool=rescore_pool)
        eng = TopKSpMV(coo, cfg, device=device)
        queries = create_query_batch(trials, cols, seed=seed + 1)
        per_mode: dict = {"production": [], "raw": []}
        for q in queries:
            gi, _ = topk_exact(coo, q, kmax)
            runs = {
                # the shipped serving config: h16 sweep + exact rescore
                "production": eng.query(q, k=kmax)[0].cpu().numpy(),
                # the raw device ranking (no rescore): what the sweep's
                # approximation alone delivers
                "raw": eng.query(q, k=kmax, rescore_pool=0)[0].cpu().numpy(),
            }
            for mode, ki in runs.items():
                row = {}
                for K in ks:
                    g, t = gi[:K], ki[:K]
                    row[K] = dict(
                        precision=metrics.precision_at_k(g, t),
                        kendall_tau=metrics.kendall_tau(g, t),
                        ndcg=metrics.ndcg(g, t),
                    )
                per_mode[mode].append(row)
        for mode, rows_ in per_mode.items():
            agg = {}
            for K in ks:
                agg[K] = {
                    m: float(np.mean([r[K][m] for r in rows_]))
                    for m in ("precision", "kendall_tau", "ndcg")
                }
            out["configs"].append(dict(
                dist=dist, mode=mode, metrics=agg,
                seconds=round(time.time() - t0, 1)))
        del eng, coo
    return out


def plot(result: dict, out_png: str) -> None:
    """plot_errors analog: one panel per metric, lines per (dist, mode)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ks = result["ks"]
    names = ("precision", "kendall_tau", "ndcg")
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.4), sharey=True)
    for ax, m in zip(axes, names):
        for c in result["configs"]:
            ys = [c["metrics"][K][m] if K in c["metrics"]
                  else c["metrics"][str(K)][m] for K in ks]
            style = "-" if c["mode"] == "production" else "--"
            ax.plot(ks, ys, style, marker="o", ms=3,
                    label=f"{c['dist']}/{c['mode']}")
        # the reference's published bars (plot_errors.py:133-138)
        ax.axhline(0.96, color="gray", lw=0.6, ls=":")
        ax.axhline(0.80, color="gray", lw=0.6, ls=":")
        ax.set_title(m)
        ax.set_xlabel("K")
        ax.set_ylim(0.5, 1.02)
        ax.grid(alpha=0.3)
    axes[0].set_ylabel("score vs exact gold")
    axes[0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=140)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--deg", type=int, default=20)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--rescore-pool", type=int, default=400)
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="directory of the JSON and figure (default %(default)s)")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (default OUT_DIR/accuracy_sweep.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cpu: the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.out_dir, "accuracy_sweep.json")
    res = run(rows=args.rows, cols=args.cols, deg=args.deg,
              trials=args.trials, rescore_pool=args.rescore_pool,
              device=args.device)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1)
    try:
        plot(res, out.replace(".json", ".png"))
    except Exception as e:  # matplotlib is optional at runtime
        print(f"figure skipped: {e!r}")
    for c in res["configs"]:
        last = c["metrics"][max(res["ks"])]
        print(f"{c['dist']:8s} {c['mode']:10s} "
              + " ".join(f"{m}@100={last[m]:.3f}"
                         for m in ("precision", "kendall_tau", "ndcg")))
    print(f"wrote {out}")
    return res


if __name__ == "__main__":
    main()
