"""Figure generation from sweep CSVs.

The counterpart of ``spmv_topk_tpu.bench.plots`` (the reference's plotting
suite: plot_exec_time.py, plot_errors.py, plot_roofline.py). Reads the
CSVs written by ``bench.sweep`` (the reference's naming convention,
{impl}_{rows}_{cols}_{dist}_{deg}_{bits}_{parts}_{k}_{iters}.csv,
cf. plot_errors.py:52; impl ``cuda-{codec}`` on the card) and produces:

  - exec-time / throughput bars across configurations (plot_exec_time.py)
  - accuracy curves: precision / NDCG / Kendall-tau per config
    (plot_errors.py:85-94)
  - a roofline chart: achieved nnz/s vs the card's HBM roofline at the
    format's operational intensity (plot_roofline.py:178-209)

The port reads the CSVs with the ``csv`` module and numpy (no pandas), and
what each figure draws is a plain function that returns numbers
(``exec_time_stats``, ``error_means``, ``roofline_gnnz``,
``sparsity_ratios``, ``convergence_curves``); the figures only draw them,
with matplotlib, which is imported where a figure is drawn.

Usage: python -m spmv_topk_tpu_torch.bench.plots results/ --out results/plots
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os

import numpy as np

# Per-device peaks for roofline accounting (plot_roofline.py hard-codes the
# U280/P100/Xeon equivalents at :180-209). h100: the H100 SXM's HBM3 rate
# from NVIDIA's data sheet, not a measurement.
CHIP_PEAKS_GBPS = {
    "h100": 3350.0,
    "cpu": 100.0,
}

REFERENCE_POINTS = [
    # label, GNNZ/s (BASELINE.md)
    ("CPU 2x Xeon 6248 (sparse_dot_topn)", 0.4),
    ("GPU P100 F32 (cuSPARSE)", 27.0),
    ("GPU P100 F16", 30.0),
    ("FPGA U280 32c 32-bit", 50.0),
    ("FPGA U280 32c 20-bit", 76.9),
]

ERROR_METRICS = ("precision", "ndcg", "kendall_tau")


def _parse_name(path: str) -> dict:
    parts = os.path.basename(path)[:-4].split("_")
    return dict(impl=parts[0], rows=int(parts[1]), cols=int(parts[2]),
                dist=parts[3], deg=int(parts[4]), bits=parts[5],
                partitions=int(parts[6]), k=int(parts[7]),
                iters=int(parts[8]))


class SweepResults:
    """The rows of every sweep CSV of a directory as columns: each CSV
    column (numeric ones as float64 arrays, the others as object arrays
    of strings), the fields of its file name (``_parse_name``) and
    ``config`` (the name without ``.csv``), one entry per row."""

    def __init__(self, columns: dict):
        self.columns = columns

    def __len__(self) -> int:
        return len(self.columns["config"])

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def configs(self) -> list:
        """The configurations in sorted order (a pandas groupby's)."""
        return sorted(set(self.columns["config"].tolist()))

    def rows_of(self, config: str, warmup_skip: int = 0) -> np.ndarray:
        """A boolean mask of ``config``'s rows from iteration
        ``warmup_skip`` on."""
        return (self.columns["config"] == config) & \
            (self.columns["iteration"] >= warmup_skip)


def _column(values: list) -> np.ndarray:
    try:
        return np.array([float(v) for v in values], np.float64)
    except ValueError:
        return np.array(values, dtype=object)


def load_results(results_dir: str) -> SweepResults:
    cols: dict = {}
    n = 0
    for path in sorted(glob.glob(os.path.join(results_dir, "*.csv"))):
        meta = _parse_name(path)
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        for row in rows:
            for key, val in row.items():
                cols.setdefault(key, [None] * n).append(val)
            for key, val in meta.items():
                cols.setdefault(key, [None] * n).append(val)
            cols.setdefault("config", [None] * n).append(
                os.path.basename(path)[:-4])
            n += 1
    if not n:
        raise FileNotFoundError(f"no CSVs in {results_dir}")
    return SweepResults({k: _column(v) for k, v in cols.items()})


def exec_time_stats(df: SweepResults, warmup_skip: int = 2) -> dict:
    """{config: (mean, std)} of ``hw_exec_time_ms`` from iteration
    ``warmup_skip`` on; std with one degree of freedom (NaN for one
    row), as plot_exec_time's pandas aggregation."""
    out = {}
    for c in df.configs():
        t = df["hw_exec_time_ms"][df.rows_of(c, warmup_skip)]
        out[c] = (float(np.mean(t)) if len(t) else float("nan"),
                  float(np.std(t, ddof=1)) if len(t) > 1 else float("nan"))
    return out


def error_means(df: SweepResults) -> dict:
    """{metric: {config: mean over every row}} for precision, ndcg and
    kendall_tau (plot_errors)."""
    return {m: {c: float(np.mean(df[m][df["config"] == c]))
                for c in df.configs()} for m in ERROR_METRICS}


def roofline_gnnz(df: SweepResults, warmup_skip: int = 2) -> dict:
    """{config: GNNZ/s}: the configuration's nominal nnz (rows x deg)
    over its mean ``hw_exec_time_ms`` from iteration ``warmup_skip`` on
    (plot_roofline)."""
    out = {}
    for c in df.configs():
        first = np.flatnonzero(df["config"] == c)[0]
        nnz = df["rows"][first] * df["deg"][first]
        t = float(np.mean(df["hw_exec_time_ms"][df.rows_of(c, warmup_skip)]))
        out[c] = (nnz / (t / 1e3)) / 1e9
    return out


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_exec_time(df: SweepResults, out: str, warmup_skip: int = 2):
    plt = _pyplot()
    g = exec_time_stats(df, warmup_skip)
    names = list(g)
    fig, ax = plt.subplots(figsize=(max(6, 0.6 * len(g)), 4))
    ax.bar(range(len(g)), [g[c][0] for c in names],
           yerr=[g[c][1] for c in names], capsize=3)
    ax.set_xticks(range(len(g)))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("exec time [ms]")
    fig.tight_layout()
    fig.savefig(os.path.join(out, "exec_time.png"), dpi=150)
    plt.close(fig)


def plot_errors(df: SweepResults, out: str):
    plt = _pyplot()
    means = error_means(df)
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5), sharey=True)
    for ax, mname in zip(axes, ERROR_METRICS):
        g = means[mname]
        ax.bar(range(len(g)), list(g.values()))
        ax.set_xticks(range(len(g)))
        ax.set_xticklabels(list(g), rotation=45, ha="right", fontsize=6)
        ax.set_title(mname)
        ax.set_ylim(0.0, 1.02)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "errors.png"), dpi=150)
    plt.close(fig)


def plot_roofline(df: SweepResults, out: str, bytes_per_nnz: float = 4.25,
                  chip: str = "h100", warmup_skip: int = 2):
    """Achieved nnz/s per config vs the card's HBM roofline and the
    published reference points (plot_roofline.py:178-209)."""
    plt = _pyplot()
    peak = CHIP_PEAKS_GBPS.get(chip, CHIP_PEAKS_GBPS["h100"])
    roof_gnnz = peak / bytes_per_nnz
    gnnz = roofline_gnnz(df, warmup_skip)

    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.bar(range(len(gnnz)), list(gnnz.values()), label=f"{chip} (this work)")
    ax.axhline(roof_gnnz, ls="--", c="k",
               label=f"HBM roofline {roof_gnnz:.0f} GNNZ/s @ {bytes_per_nnz} B/nnz")
    for label, val in REFERENCE_POINTS:
        ax.axhline(val, ls=":", lw=0.8, c="gray")
        ax.annotate(label, (len(gnnz) - 0.5, val), fontsize=6, va="bottom",
                    ha="right")
    ax.set_xticks(range(len(gnnz)))
    ax.set_xticklabels(list(gnnz), rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("GNNZ/s")
    ax.set_yscale("log")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "roofline.png"), dpi=150)
    plt.close(fig)


def sparsity_ratios(coo) -> list:
    """[(layout label, packed stream words per nnz word)] for the layout
    variants plot_sparsity draws: the HBM stream inflation from width
    quantization + block padding (h16 packs 2 nnz a word, so its bar is
    words per PACKED word: layout padding, not codec compression)."""
    from ..config import TopKSpMVConfig
    from ..formats.sell_buckets import pack_sell_buckets, fuse_buckets

    variants = [
        ("sigma q8", dict(sigma_sort=True, width_quantum=8)),
        ("sigma q4", dict(sigma_sort=True, width_quantum=4)),
        ("no-sigma q8", dict(sigma_sort=False, width_quantum=8)),
        ("sigma q4 h16", dict(sigma_sort=True, width_quantum=4,
                              query_codec="h16")),
    ]
    ratios = []
    for label, kw in variants:
        cfg = TopKSpMVConfig(max_cols=-(-coo.num_cols // 128) * 128, **kw)
        f = fuse_buckets(pack_sell_buckets(coo, cfg),
                         block_sublanes=cfg.fused_block_sublanes)
        denom = (coo.nnz + 1) // 2 if kw.get("query_codec") == "h16" \
            else coo.nnz
        ratios.append((label, f.words.size / max(denom, 1)))
    return ratios


def plot_sparsity(coo, out: str, name: str = "matrix"):
    """Degree distribution + packing overhead figure (the analog of the
    reference's plot_sparsity.py, which histograms nnz/row per dataset).

    Left: row-degree histogram. Right: ``sparsity_ratios``, the figure
    that guides W_LADDER / width_quantum tuning: the gap between a bar and
    1.0 is bandwidth spent streaming padding. Returns the ratios.
    """
    plt = _pyplot()
    deg = coo.row_degrees()
    ratios = sparsity_ratios(coo)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.8))
    ax1.hist(deg, bins=min(100, max(int(deg.max()), 2)), log=True)
    ax1.set_xlabel("nnz per row")
    ax1.set_ylabel("rows")
    ax1.set_title(f"{name}: degree distribution "
                  f"(mean {deg.mean():.1f}, max {deg.max()})", fontsize=9)
    labels = [r[0] for r in ratios]
    ax2.bar(range(len(ratios)), [r[1] for r in ratios])
    ax2.axhline(1.0, ls="--", c="k", lw=0.8)
    for i, (_, v) in enumerate(ratios):
        ax2.annotate(f"{v:.3f}", (i, v), ha="center", va="bottom",
                     fontsize=8)
    ax2.set_xticks(range(len(ratios)))
    ax2.set_xticklabels(labels, rotation=20, ha="right", fontsize=8)
    ax2.set_ylabel("stream words / nnz word")
    ax2.set_title("packing overhead by layout", fontsize=9)
    fig.tight_layout()
    path = os.path.join(out, "sparsity.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return ratios


CONVERGENCE_LANE_KS = (1, 2, 3, 4, 6, 8, 12, 16)
CONVERGENCE_PARTS = ((32, "32 parts (FPGA)"), (128, "128 (1 device)"),
                     (512, "512 (4 devices)"), (1024, "1024 (8 devices)"))
CONVERGENCE_SIGMAS = ((0.0, "exact scores"), (0.01, "codec noise σ=0.01"),
                      (0.03, "codec noise σ=0.03"))


def convergence_curves(n: int = 200_000, k: int = 100,
                       num_tests: int = 5) -> dict:
    """The numbers plot_convergence draws: per partition count the
    closed-form precision@k over ``CONVERGENCE_LANE_KS`` and Monte-Carlo
    checks at lane_k 2, 4, 8 (``partitions``); per codec noise the
    Monte-Carlo precision@k after an exact rescore of pools k, 2k, 4k, 8k
    (128 partitions, lane_k 8; ``rescore``)."""
    from ..eval.accuracy_model import (closed_form_precision,
                                       monte_carlo_precision,
                                       monte_carlo_rescore_precision)

    parts = []
    for b, label in CONVERGENCE_PARTS:
        parts.append(dict(
            partitions=b, label=label,
            closed_form=[closed_form_precision(n, b, k, pk)
                         for pk in CONVERGENCE_LANE_KS],
            monte_carlo=[monte_carlo_precision(n, b, k, pk,
                                               num_tests=num_tests, seed=1)
                         for pk in (2, 4, 8)]))
    pools = [k, 2 * k, 4 * k, 8 * k]
    rescore = [dict(sigma=sigma, label=label, pools=pools,
                    precision=[monte_carlo_rescore_precision(
                        n, 128, k, 8, pool, noise_sigma=sigma,
                        num_tests=num_tests, seed=2) for pool in pools])
               for sigma, label in CONVERGENCE_SIGMAS]
    return dict(lane_ks=list(CONVERGENCE_LANE_KS), partitions=parts,
                rescore=rescore)


def plot_convergence(out: str, n: int = 200_000, k: int = 100,
                     num_tests: int = 5):
    """Accuracy-convergence figure (the analog of the reference's
    plot_convergence.py; this method is one-shot, so its convergence axes
    are the approximation knobs approaching exactness, the knobs
    topk_errors.py sweeps).

    Left: closed-form precision@K vs per-partition k (lane_k) for
    partition counts of one card (128 lanes), four and eight, and the
    FPGA's 32, with Monte-Carlo dots as a check. Right: Monte-Carlo
    precision@K of the full serving pipeline vs rescore-pool size under
    codec score noise, where the shipped pool=400 default sits.
    """
    plt = _pyplot()
    cur = convergence_curves(n, k, num_tests)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.8))

    for p in cur["partitions"]:
        line, = ax1.plot(cur["lane_ks"], p["closed_form"], marker=".",
                         label=p["label"])
        ax1.scatter([2, 4, 8], p["monte_carlo"], s=14, c=line.get_color(),
                    zorder=3)
    ax1.set_xlabel("per-partition k (lane_k)")
    ax1.set_ylabel(f"precision@{k}")
    ax1.set_ylim(0.0, 1.02)
    ax1.legend(fontsize=7)
    ax1.set_title("partition-survival convergence "
                  "(lines: closed form, dots: MC)", fontsize=9)

    for r in cur["rescore"]:
        ax2.plot(r["pools"], r["precision"], marker=".", label=r["label"])
    ax2.axvline(4 * k, ls="--", c="k", lw=0.8)
    ax2.annotate("shipped pool=400", (4 * k, ax2.get_ylim()[0]),
                 fontsize=7, ha="left", va="bottom", rotation=90)
    ax2.set_xlabel("rescore pool size")
    ax2.set_ylabel(f"precision@{k} after exact rescore")
    ax2.legend(fontsize=7)
    ax2.set_title("rescore-pool convergence (128 parts, lane_k=8)",
                  fontsize=9)

    fig.tight_layout()
    path = os.path.join(out, "convergence.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def summary(df: SweepResults, chip: str = "h100",
            warmup_skip: int = 2) -> dict:
    """Every number the three sweep figures draw, per configuration, and
    the roofline's peak."""
    stats = exec_time_stats(df, warmup_skip)
    errs = error_means(df)
    gnnz = roofline_gnnz(df, warmup_skip)
    configs = {c: dict(mean_exec_ms=stats[c][0], std_exec_ms=stats[c][1],
                       gnnz_per_sec=gnnz[c],
                       **{m: errs[m][c] for m in ERROR_METRICS})
               for c in df.configs()}
    return dict(chip=chip, peak_gbps=CHIP_PEAKS_GBPS.get(
        chip, CHIP_PEAKS_GBPS["h100"]), configs=configs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results_dir", nargs="?")
    ap.add_argument("--out", default=None)
    ap.add_argument("--chip", default="h100", choices=sorted(CHIP_PEAKS_GBPS))
    ap.add_argument("--sparsity", default=None, metavar="ROWSxCOLSxDEGxDIST",
                    help="also emit the degree/padding figure for a "
                    "synthetic matrix, e.g. 1000000x1024x20xgamma")
    ap.add_argument("--convergence", action="store_true",
                    help="also emit the accuracy-convergence figure "
                    "(lane_k / rescore-pool sweeps of the analytic model)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.results_dir or ".", "plots")
    os.makedirs(out, exist_ok=True)
    try:
        _pyplot()
        draw = True
    except ImportError as e:  # the numbers are printed all the same
        print(f"figures skipped: {e!r}")
        draw = False
    if args.convergence:
        if draw:
            print(f"  convergence -> {plot_convergence(out)}")
        else:
            print(json.dumps(dict(convergence=convergence_curves())))
    if args.sparsity:
        from ..formats.synthetic import create_sparse_matrix

        r, c, d, dist = args.sparsity.split("x")
        coo = create_sparse_matrix(int(r), int(c), int(d), dist, seed=1)
        ratios = (plot_sparsity(coo, out, name=args.sparsity) if draw
                  else sparsity_ratios(coo))
        for label, v in ratios:
            print(f"  {label:16s} {v:.3f} words/nnz-word")
    if args.results_dir:
        df = load_results(args.results_dir)
        print(json.dumps(dict(summary=summary(df, args.chip))))
        if draw:
            plot_exec_time(df, out)
            plot_errors(df, out)
            plot_roofline(df, out, chip=args.chip)
    print(f"wrote plots to {out}" if draw else f"no figures in {out}")


if __name__ == "__main__":
    main()
