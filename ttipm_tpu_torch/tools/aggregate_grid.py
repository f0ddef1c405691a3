"""Summarise a grid directory of runner JSONs over seeds.

Counterpart of ``scripts/aggregate_grid.py`` for the port: the port's
runner writes the JAX runner's results schema, so a grid directory of
either package is read alike.  The directory holds one sub-directory a
cell, ``<problem>_<dim>_s<idx>/results/*.json``; the first readable JSON
of each is one seed.  Per (problem, dim): mean±std, median [IQR] and worst
of the solve seconds, the mean iterations, the worst slackness, and
whether every seed's slackness is below 1e-3.

    python -m ttipm_tpu_torch.tools.aggregate_grid results/grid_torch

Writes <dir>/SUMMARY.json (the same file the JAX package's script writes
for the same directory) and prints a markdown table.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

import numpy as np


def collect(root: str) -> dict:
    """{(problem, dim): {"time_s", "slackness", "iters", ...: [per seed]}}."""
    buckets = defaultdict(lambda: defaultdict(list))
    for name in sorted(os.listdir(root)):
        res_dir = os.path.join(root, name, "results")
        if not os.path.isdir(res_dir):
            continue
        problem, dim = name.rsplit("_s", 1)[0].rsplit("_", 1)
        for fn in sorted(os.listdir(res_dir)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(res_dir, fn)) as fh:
                rec = json.load(fh)
            vals = buckets[(problem, int(dim))]
            try:
                vals["time_s"].append(float(rec["runtimes"][0][0]))
                vals["slackness"].append(float(rec["complementary_slackness"][0][0]))
                vals["iters"].append(float(rec["num_iters"][0][0]))
                if rec.get("primal_errors"):
                    vals["primal"].append(float(rec["primal_errors"][0][0]))
                if rec.get("dual_errors"):
                    vals["dual"].append(float(rec["dual_errors"][0][0]))
            except (KeyError, IndexError, TypeError):
                continue
            break
    return buckets


def summarise(buckets: dict):
    """(SUMMARY dict {problem: {dim: entry}}, markdown lines)."""
    summary = {}
    lines = [
        "| problem | dim | seeds | time mean±std (s) | median [IQR] | "
        "worst | iters | worst slack | all conv |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (problem, dim) in sorted(buckets):
        vals = buckets[(problem, dim)]
        t = np.asarray(vals["time_s"], dtype=float)
        sl = np.asarray(vals["slackness"], dtype=float)
        it = np.asarray(vals["iters"], dtype=float)
        if not len(t):
            continue
        q1, med, q3 = np.percentile(t, [25, 50, 75])
        entry = {
            "seeds": len(t),
            "mean_s": round(float(t.mean()), 2),
            "std_s": round(float(t.std()), 2),
            "median_s": round(float(med), 2),
            "iqr_s": [round(float(q1), 2), round(float(q3), 2)],
            "worst_s": round(float(t.max()), 2),
            "mean_iters": round(float(it.mean()), 1),
            "worst_slackness": float(f"{sl.max():.3e}"),
            "converged_all": bool((sl < 1e-3).all()),
        }
        summary.setdefault(problem, {})[str(dim)] = entry
        lines.append(
            f"| {problem} | {dim} | {entry['seeds']} | {entry['mean_s']}±{entry['std_s']} | "
            f"{entry['median_s']} [{entry['iqr_s'][0]},{entry['iqr_s'][1]}] | "
            f"{entry['worst_s']} | {entry['mean_iters']} | {entry['worst_slackness']} | "
            f"{entry['converged_all']} |")
    return summary, lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m ttipm_tpu_torch.tools.aggregate_grid GRID_DIR")
    root = argv[0]
    summary, lines = summarise(collect(root))
    path = os.path.join(root, "SUMMARY.json")
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
    print("\n".join(lines))
    print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
