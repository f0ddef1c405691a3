"""Experiment runner of the port: YAML-configured solves with the
reference's metric schema, pathological-seed resampling and results JSON.

    python -m ttipm_tpu_torch.utils.runner --problem maxcut \\
        --config configs/maxcut_10.yaml [--rank 1] [--track_mem] [--device cuda]

Counterpart of ``ttipm_tpu/utils/runner.py``: the same flags, printed
summary and results JSON (written to ``results/`` under the working
directory).  ``--device`` (``cuda``, the default, or ``cpu``) takes the
place of ``--platform``; without a CUDA device the runner raises unless
``--device cpu`` is given.  Every ``--problem`` is ported (graphm's
``dim`` is n: 2n+1 cores, 2n bonds).  ``--solver`` other than ``ttipm``
hands off to the dense baseline runner (``utils/baseline_runner.py``)
with the problem, config, rank, ``--track_mem`` and ``--device``.  The
configs are read by ``load_yaml``, a reader of the YAML subset they use,
since PyYAML is not everywhere the port runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch

PROBLEMS = ("maxcut", "corr_clust", "max_stable_set", "graphm")
SOLVERS = ("ttipm", "scs", "sdpa", "splitting", "cgal", "scgal", "manopt")

__all__ = ["load_yaml", "load_problem", "run_and_record", "run_experiment",
           "print_results_summary", "save_results_summary"]


# ---------------------------------------------------------------------------
# YAML subset: top-level ``key: value`` entries, block lists of ``- item``
# lines, comments, blank values, the tags !!int / !!float / !!str / !!bool,
# and PyYAML's implicit int, float, bool and null scalars.
# ---------------------------------------------------------------------------

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}


def _float(text: str) -> float:
    t = text.replace("_", "")
    low = t.lower()
    if low.endswith(".inf"):
        return float("-inf") if t.startswith("-") else float("inf")
    if low == ".nan":
        return float("nan")
    return float(t)


def _scalar(text: str):
    text = text.strip()
    if text.startswith("!!"):
        tag, _, body = text.partition(" ")
        body = body.strip()
        if tag == "!!int":
            return int(body.replace("_", ""))
        if tag == "!!float":
            return _float(body)
        if tag == "!!str":
            return body
        if tag == "!!bool":
            return _BOOL[body]
        raise ValueError(f"unsupported YAML tag {tag!r}")
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return _float(text)
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a comment: a ``#`` at its start or after a blank."""
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def load_yaml(path: str) -> dict:
    """The mapping of a config file, as ``yaml.safe_load`` gives it for the
    subset the configs use (a later duplicate key wins)."""
    out: dict = {}
    key = None
    with open(path) as fh:
        for lineno, raw in enumerate(fh, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip():
                continue
            stripped = line.lstrip()
            if stripped.startswith("- ") or stripped == "-":
                if key is None:
                    raise ValueError(f"{path}:{lineno}: list item outside a key")
                if not isinstance(out[key], list):
                    out[key] = []
                out[key].append(_scalar(stripped[1:]))
                continue
            if line[0] in " \t" or ":" not in line:
                raise ValueError(f"{path}:{lineno}: unsupported YAML: {raw.rstrip()!r}")
            key, _, value = line.partition(":")
            key = key.strip()
            out[key] = _scalar(value)
    return out


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------

def load_problem(name: str):
    if name == "maxcut":
        from ttipm_tpu_torch.models.maxcut import create_problem
    elif name == "corr_clust":
        from ttipm_tpu_torch.models.corr_clust import create_problem
    elif name == "max_stable_set":
        from ttipm_tpu_torch.models.max_stable_set import create_problem
    elif name == "graphm":
        from ttipm_tpu_torch.models.graphm import create_problem
    else:
        raise ValueError(f"unknown problem {name!r}; choose from {PROBLEMS}")
    return create_problem


def seeded_problem(create_problem_fn, dim, rank, seed, device):
    """The problem of ``seed`` as the runner solves it, drawn from numpy's
    global RandomState seeded with ``seed`` (as in the JAX package) in the
    dtype of the profile (``config.dtype()``): ``(lag_maps, obj_tt,
    L_op_tt, bias_tt, ineq_mask)``, the arguments of ``ipm.tt_ipm``."""
    from ttipm_tpu_torch import config as tt_config
    from ttipm_tpu_torch.ops.tt import tt_reshape

    np.random.seed(seed)
    problem = create_problem_fn(dim, rank, device=device, dtype=tt_config.dtype())
    if len(problem) == 5:
        obj_tt, L_op_tt, bias_tt, ineq_mask, lag_maps = problem
    else:
        obj_tt, L_op_tt, bias_tt, lag_y = problem
        ineq_mask = None
        lag_maps = {"y": lag_y}
    lag_maps = {k: tt_reshape(v, (4, 4)) for k, v in lag_maps.items()}
    return lag_maps, tt_reshape(obj_tt, (4,)), L_op_tt, tt_reshape(bias_tt, (4,)), ineq_mask


def ipm_kwargs(config) -> dict:
    """The settings of ``ipm.tt_ipm`` that a config gives."""
    return dict(
        max_iter=config["max_iter"],
        verbose=config.get("verbose", False),
        gap_tol=float(config["gap_tol"]),
        op_tol=float(config["op_tol"]),
        warm_up=config["warm_up"],
        abs_tol=float(config["abs_tol"]),
        aho_direction=False,
        mals_restarts=config["mals_restarts"],
        max_refinement=config["max_refinement"],
        lambdaStar=float(config.get("lambdaStar", 1)),
        lambdaStarIneq=float(config.get("lambdaStarIneq", 1)),
    )


def run_and_record(seed, s_i, rank, config, args, create_problem_fn, rec):
    """One seeded solve and its metrics, written into row ``s_i`` of
    ``rec``.  Every draw comes from numpy's global RandomState seeded with
    ``seed``, as in the JAX package; the problem is made in the dtype of
    the profile (``config.dtype()``).  Returns (feasibility error,
    slackness)."""
    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import IneqStatus, tt_ipm
    from ttipm_tpu_torch.utils.memtrack import PeakMemoryTracker

    device = torch.device(args.device)
    tracker = PeakMemoryTracker(device).__enter__() if args.track_mem else None
    t1 = time.time()
    lag_maps, obj_tt, L_op_tt, bias_tt, ineq_mask = seeded_problem(
        create_problem_fn, config["dim"], rank, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.time()
    X_tt, Y_tt, T_tt, Z_tt, info = tt_ipm(
        lag_maps, obj_tt, L_op_tt, bias_tt, ineq_mask=ineq_mask, **ipm_kwargs(config))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.time()

    rec["problem_creation_times"][s_i] = t2 - t1
    rec["runtimes"][s_i] = t3 - t2
    slack, primal, dual = solve_metrics(
        X_tt, Y_tt, Z_tt, obj_tt, L_op_tt, bias_tt, T=T_tt,
        ineq_active=info["status"].ineq_status is IneqStatus.ACTIVE)
    rec["complementary_slackness"][s_i] = slack
    rec["feasibility_errors"][s_i] = primal
    rec["dual_feasibility_errors"][s_i] = dual
    rec["num_iters"][s_i] = info["num_iters"]
    rec["ranksX"][s_i, :] = info["ranksX"]
    rec["ranksY"][s_i, :] = info["ranksY"]
    rec["ranksZ"][s_i, :] = info["ranksZ"]
    if rec.get("ranksT") is not None:
        rec["ranksT"][s_i, :] = info["ranksT"]
    if tracker is not None:
        tracker.__exit__()
        rec["memory"][s_i] = tracker.peak_mb

    print(
        f"Convergence after {rec['num_iters'][s_i]:.0f} iterations. "
        f"Compl slackness: {rec['complementary_slackness'][s_i]:.4e}. "
        f"Feasibility error: {rec['feasibility_errors'][s_i]:.4e}. "
        f"Dual feasibility error: {rec['dual_feasibility_errors'][s_i]:.4e}. "
        f"Time: {rec['runtimes'][s_i]:.2f}s.",
        flush=True,
    )
    return rec["feasibility_errors"][s_i], rec["complementary_slackness"][s_i]


def _parser(problem_name=None):
    parser = argparse.ArgumentParser(description="TT-IPM experiment runner (PyTorch port)")
    parser.add_argument("--problem", type=str, default=problem_name, choices=PROBLEMS)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--rank", type=int, default=1)
    parser.add_argument("--track_mem", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="device of the solve; cuda (the default) raises where there "
                             "is no CUDA device")
    parser.add_argument("--no_resample", action="store_true",
                        help="disable pathological-seed resampling")
    parser.add_argument("--solver", type=str, default="ttipm", choices=SOLVERS,
                        help="ttipm (default) runs the TT-IPM; any other value dispatches "
                             "to the dense baseline runner (utils/baseline_runner.py)")
    return parser


def bond_count(problem: str, dim: int) -> int:
    """Bonds of the solve's trains: graphm's ``dim`` is n, 2n+1 cores."""
    return 2 * dim if problem == "graphm" else dim - 1


def new_record(num_seeds: int, n_bonds: int) -> Dict[str, np.ndarray]:
    return {
        "problem_creation_times": np.zeros(num_seeds),
        "runtimes": np.zeros(num_seeds),
        "memory": np.zeros(num_seeds),
        "complementary_slackness": np.zeros(num_seeds),
        "feasibility_errors": np.zeros(num_seeds),
        "dual_feasibility_errors": np.zeros(num_seeds),
        "num_iters": np.zeros(num_seeds),
        "ranksX": np.zeros((num_seeds, n_bonds)),
        "ranksY": np.zeros((num_seeds, n_bonds)),
        "ranksZ": np.zeros((num_seeds, n_bonds)),
        "ranksT": np.zeros((num_seeds, n_bonds)),
    }


def run_experiment(create_problem_fn=None, argv=None, problem_name=None):
    parser = _parser(problem_name)
    args = parser.parse_args(argv)
    if args.solver != "ttipm":
        from ttipm_tpu_torch.utils.baseline_runner import run_baseline_experiment

        baseline_argv = ["--problem", args.problem or problem_name, "--solver", args.solver,
                         "--config", args.config, "--rank", str(args.rank),
                         "--device", args.device]
        if args.track_mem:
            baseline_argv.append("--track_mem")
        return run_baseline_experiment(baseline_argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    if create_problem_fn is None:
        if args.problem is None:
            parser.error("--problem is required")
        create_problem_fn = load_problem(args.problem)

    config = load_yaml(args.config)
    rec = new_record(len(config["seeds"]), bond_count(args.problem, config["dim"]))

    used_seeds = set(config["seeds"])
    for s_i, seed in enumerate(config["seeds"]):
        print(f"Running seed {seed}", flush=True)
        feas, slack = run_and_record(seed, s_i, args.rank, config, args, create_problem_fn,
                                     rec)
        new_seed = seed
        while (not args.no_resample) and ((feas > 1e-3) or (slack > 1e-3)):
            # pathological-seed resampling; the YAML on disk is not rewritten
            print(f"Seed {new_seed} is pathological (feas {feas:.2e}, "
                  f"slack {slack:.2e}); drawing a new seed.", flush=True)
            new_seed = int(np.random.randint(0, 2**10))
            while new_seed in used_seeds:
                new_seed = int(np.random.randint(0, 2**10))
            used_seeds.add(new_seed)
            config["seeds"][s_i] = new_seed
            feas, slack = run_and_record(new_seed, s_i, args.rank, config, args,
                                         create_problem_fn, rec)

    print_results_summary(config, args, rec)
    save_results_summary(config, args, rec)
    return rec


def _fmt_ranks(mean, std, precision=1):
    if mean is None:
        return "N/A"
    parts = [f"{m:.{precision}f}±{s:.{precision}f}" for m, s in zip(mean, std)]
    return "[" + ", ".join(parts) + "]"


def print_results_summary(config, args, rec):
    """The metric table of the JAX runner."""
    print("\n" + "=" * 80)
    print(f"{'FINAL RESULTS SUMMARY':^80}")
    print("=" * 80)
    rt = np.asarray(rec["runtimes"], dtype=np.float64)
    q1, q3 = np.nanpercentile(rt, [25, 75])
    rows = [
        ("Solution Time (s)", f"{np.nanmean(rt):.3f} ± {np.nanstd(rt):.3f}"),
        ("Runtime Median [IQR] (s)", f"{np.nanmedian(rt):.3f} [{q3-q1:.3f}]"),
        ("Worst Runtime (s)", f"{np.nanmax(rt):.3f}"),
        ("Problem Creation (s)",
         f"{np.nanmean(rec['problem_creation_times']):.3f} ± "
         f"{np.nanstd(rec['problem_creation_times']):.3f}"),
        ("Iterations", f"{np.nanmean(rec['num_iters']):.1f} ± {np.nanstd(rec['num_iters']):.1f}"),
        ("Feasibility Error",
         f"{np.nanmean(rec['feasibility_errors']):.2e} ± "
         f"{np.nanstd(rec['feasibility_errors']):.2e}"),
        ("Dual Feasibility Error",
         f"{np.nanmean(rec['dual_feasibility_errors']):.2e} ± "
         f"{np.nanstd(rec['dual_feasibility_errors']):.2e}"),
        ("Duality Gap",
         f"{np.nanmean(rec['complementary_slackness']):.2e} ± "
         f"{np.nanstd(rec['complementary_slackness']):.2e}"),
    ]
    if args.track_mem:
        rows.append(("Peak Device Memory (MB)",
                     f"{np.nanmean(rec['memory']):.3f} ± {np.nanstd(rec['memory']):.3f}"))
    print(f"  {'Metric':<28} | {'Value':>25}")
    print(f"  {'-'*28} | {'-'*25}")
    for name, value in rows:
        print(f"  {name:<28} | {value:>25}")
    print(f"  {'-'*28} | {'-'*25}")
    print("  Rank Statistics")
    for key in ("ranksX", "ranksY", "ranksZ", "ranksT"):
        arr = rec.get(key)
        if arr is None:
            continue
        print(f"    {key:<24}: {_fmt_ranks(np.nanmean(arr, 0), np.nanstd(arr, 0))}")
    print("=" * 80, flush=True)


def save_results_summary(config, args, rec, filename: Optional[str] = None):
    """Results JSON with the JAX runner's schema, under ``results/`` of the
    working directory unless ``filename`` is given."""
    cfg_tag = os.path.splitext(os.path.basename(args.config))[0]
    base = (f"{cfg_tag}_trackmem_{args.track_mem}"
            f"_seeds_{'-'.join(map(str, config.get('seeds', [])))}"
            f"_ranks_{args.rank}.json")
    base = re.sub(r"[^a-zA-Z0-9_.-]", "_", base)
    if filename is None:
        results_dir = os.path.join(os.getcwd(), "results")
        os.makedirs(results_dir, exist_ok=True)
        filename = os.path.join(results_dir, base)
    data = {
        "config_str": str(config),
        "args_str": str(vars(args)),
        "runtimes": [rec["runtimes"].tolist()],
        "problem_creation_times": [rec["problem_creation_times"].tolist()],
        "num_iters": [rec["num_iters"].tolist()],
        "feasibility_errors": [rec["feasibility_errors"].tolist()],
        "dual_feasibility_errors": [rec["dual_feasibility_errors"].tolist()],
        "complementary_slackness": [rec["complementary_slackness"].tolist()],
        "ranksX": [rec["ranksX"].tolist()],
        "ranksY": [rec["ranksY"].tolist()],
        "ranksZ": [rec["ranksZ"].tolist()],
        "ranksT": [rec["ranksT"].tolist()] if rec.get("ranksT") is not None else [],
        "memory": [rec["memory"].tolist()],
    }
    with open(filename, "w") as fh:
        json.dump(data, fh, indent=2)
    print(f"results written to {filename}")
    return filename


if __name__ == "__main__":
    run_experiment()
