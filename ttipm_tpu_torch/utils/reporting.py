"""Post-processing: results JSON -> LaTeX table rows / heatmap grids /
runtime-memory scatter data.

Counterpart of ``ttipm_tpu/utils/reporting.py`` (a copy of it: the port
imports nothing of the JAX package), covering the reference's three
scripts (produce_table.py / produce_heatmap.py / produce_scatter.py):

    python -m ttipm_tpu_torch.utils.reporting table maxcut
    python -m ttipm_tpu_torch.utils.reporting heatmap maxcut --dims 3 13
    python -m ttipm_tpu_torch.utils.reporting scatter maxcut

Reads the ``results/<config>_trackmem_*_seeds_*_ranks_<r>.json`` files
that ``ttipm_tpu_torch.utils.runner`` writes, which have the JAX runner's
schema, so either package's results read the same.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from collections import defaultdict

import numpy as np

__all__ = [
    "format_scientific",
    "result_row_stats",
    "results_to_latex_table",
    "collect_heatmap_data",
    "collect_scatter_data",
]


def format_scientific(mean_val: float, std_val: float) -> str:
    """LaTeX `(m ± s) x 10^e` formatting (produce_table.py:8-36)."""
    if mean_val == 0 and std_val == 0:
        return "$0.00 \\pm 0.00$"
    if mean_val == 0:
        exponent = int(np.floor(np.log10(abs(std_val)))) if std_val != 0 else 0
        mean_mantissa = 0.0
    else:
        exponent = int(np.floor(np.log10(abs(mean_val))))
        mean_mantissa = mean_val / 10**exponent
    std_mantissa = 0.0 if std_val == 0 else std_val / 10**exponent
    if exponent == 0:
        return f"${mean_mantissa:.2f} \\pm {std_mantissa:.2f}$"
    return f"$({mean_mantissa:.2f} \\pm {std_mantissa:.2f}) \\times 10^{{{exponent}}}$"


def _load(file_path):
    with open(file_path) as fh:
        return json.load(fh)


def _dim_from_name(filename, problem):
    m = re.search(rf"{problem}_(\d+)_", os.path.basename(filename))
    return int(m.group(1)) if m else 0


def _rank_from_name(filename):
    m = re.search(r"_ranks_(\d+)\.json", os.path.basename(filename))
    return int(m.group(1)) if m else 0


def result_row_stats(data: dict) -> dict:
    """Mean/std of every recorded metric of one results JSON."""
    out = {}
    for key in ("runtimes", "feasibility_errors", "dual_feasibility_errors",
                "complementary_slackness", "num_iters", "memory"):
        arr = np.asarray(data.get(key, [[np.nan]]), dtype=float).ravel()
        out[key] = (float(np.nanmean(arr)), float(np.nanstd(arr)))
    ranks = np.asarray(data.get("ranksX", [[[0]]]), dtype=float)
    out["storage"] = float(np.nanmean(np.nansum(ranks, axis=-1)))
    return out


def results_to_latex_table(problem: str, results_dir: str = "results",
                           method_name: str = "TT-IPM") -> str:
    """LaTeX rows, one per dimension (produce_table.py:38-155)."""
    pattern = os.path.join(results_dir, f"{problem}_*_seeds_*_ranks_*.json")
    files = sorted(glob.glob(pattern), key=lambda f: _dim_from_name(f, problem))
    lines = [
        "Method & Storage & Runtime & Primal Error & Dual Error & "
        "Duality Gap & Iterations & Size \\\\",
        "\\midrule",
    ]
    for i, fp in enumerate(files):
        data = _load(fp)
        stats = result_row_stats(data)
        dim = _dim_from_name(fp, problem)
        method_cell = (
            f"\\multirow{{{len(files)}}}{{*}}{{{method_name}}}" if i == 0 else ""
        )
        row = (
            f"{method_cell} & {stats['storage']:.0f} & "
            f"{format_scientific(*stats['runtimes'])} & "
            f"{format_scientific(*stats['feasibility_errors'])} & "
            f"{format_scientific(*stats['dual_feasibility_errors'])} & "
            f"{format_scientific(*stats['complementary_slackness'])} & "
            f"{stats['num_iters'][0]:.1f} & $2^{{{dim}}}$ \\\\"
        )
        lines.append(row)
    return "\n".join(lines)


def collect_heatmap_data(problem: str, dim_range=None, results_dir="results"):
    """{dim: {rank: {primal, dual, dualslack}}} (produce_heatmap.py:9-80)."""
    pattern = os.path.join(results_dir, f"{problem}_*_seeds_*_ranks_*.json")
    plot_data = defaultdict(dict)
    for fp in glob.glob(pattern):
        dim = _dim_from_name(fp, problem)
        rank = _rank_from_name(fp)
        if dim_range and not (dim_range[0] <= dim <= dim_range[1]):
            continue
        data = _load(fp)
        stats = result_row_stats(data)
        plot_data[dim][rank] = {
            "primal": stats["feasibility_errors"][0],
            "dual": stats["dual_feasibility_errors"][0],
            "dualslack": stats["complementary_slackness"][0],
        }
    return dict(plot_data)


def collect_scatter_data(problem: str, dim_range=None, results_dir="results"):
    """{dim: {runtime_points, memory_points}} (produce_scatter.py:9-60)."""
    pattern = os.path.join(results_dir, f"{problem}_*_seeds_*_ranks_*.json")
    plot_data = defaultdict(lambda: {"runtime_points": [], "memory_points": []})
    for fp in glob.glob(pattern):
        dim = _dim_from_name(fp, problem)
        rank = _rank_from_name(fp)
        if dim_range and not (dim_range[0] <= dim <= dim_range[1]):
            continue
        data = _load(fp)
        for rt in np.asarray(data.get("runtimes", []), dtype=float).ravel():
            plot_data[dim]["runtime_points"].append((rank, float(rt)))
        for mem in np.asarray(data.get("memory", []), dtype=float).ravel():
            plot_data[dim]["memory_points"].append((rank, float(mem)))
    return dict(plot_data)


def main(argv=None):
    parser = argparse.ArgumentParser(description="TT-IPM results post-processing")
    parser.add_argument("mode", choices=["table", "heatmap", "scatter"])
    parser.add_argument("problem",
                        choices=["maxcut", "max_stable_set", "graphm", "corr_clust"])
    parser.add_argument("--dims", type=int, nargs=2, default=None)
    parser.add_argument("--results_dir", type=str, default="results")
    args = parser.parse_args(argv)

    if args.mode == "table":
        print(results_to_latex_table(args.problem, args.results_dir))
    elif args.mode == "heatmap":
        data = collect_heatmap_data(args.problem, args.dims, args.results_dir)
        print(json.dumps(data, indent=2, sort_keys=True))
    else:
        data = collect_scatter_data(args.problem, args.dims, args.results_dir)
        print(json.dumps(data, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
