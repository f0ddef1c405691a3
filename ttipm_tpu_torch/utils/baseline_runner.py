"""Parametrised baseline runner: the dense SDP baselines on the port's
problems.

Counterpart of ``ttipm_tpu/utils/baseline_runner.py`` (role parity:
reference psd_system/{maxcut,corr_clust,max_stable_set,graphm}/
*_{scs,sdpa,scgal,manopt}.py): the problem is densified once per
(problem, solver) pair from the port's own TT builders and dispatched;
the retry-with-new-seed loop (maxcut_scs.py:45-95), the metric schema,
the summary and the results JSON are the JAX runner's.

CLI:
    python -m ttipm_tpu_torch.utils.baseline_runner --problem maxcut \\
        --solver scs|sdpa|splitting|cgal|scgal|manopt --config configs/maxcut_8.yaml \\
        [--rank 1] [--track_mem] [--device cuda]

(equivalently ``python -m ttipm_tpu_torch.utils.runner --solver ...``).
The native solvers (splitting, cgal, scgal, manopt) run on ``--device``,
"cuda" by default (it raises where there is no card); scs and sdpa need
the optional CPU packages ``scs`` / ``sdpap`` and fail the seed without
them, as in the JAX package.  Configs are read by ``runner.load_yaml``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ttipm_tpu_torch.models import conic

SOLVERS = ("scs", "sdpa", "splitting", "cgal", "scgal", "manopt")

_SUPPORTED = {
    "maxcut": set(SOLVERS),
    "corr_clust": {"scs", "sdpa", "splitting"},
    "max_stable_set": {"scs", "sdpa", "splitting", "cgal", "scgal"},
    "graphm": {"scs", "sdpa", "splitting"},
}

__all__ = ["SOLVERS", "build_dense_problem", "solve_baseline", "run_baseline_experiment"]


def _dense(tt) -> np.ndarray:
    from ttipm_tpu_torch.ops.tt import tt_matrix_to_matrix

    return tt_matrix_to_matrix(tt).cpu().numpy()


def build_dense_problem(problem: str, dim: int, rank: int) -> Dict:
    """Densify the TT problem family into a ConicSDP plus what the
    CGAL-family solvers need, from the port's TT builders on the CPU.  Must
    be called after ``np.random.seed``: one seed gives the JAX runner's
    dense problem.  maxcut's n diagonal selectors come as one sparse COO
    tensor (n, n, n) (the JAX runner's list of dense matrices, without the
    zeros); max_stable_set's as the JAX runner's list."""
    from ttipm_tpu_torch.ops.random import tt_random_graph
    from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
    from ttipm_tpu_torch.ops.tt import tt_reshape

    cpu = "cpu"
    if problem == "maxcut":
        from ttipm_tpu_torch.models.maxcut import tt_obj_matrix

        C = _dense(tt_reshape(tt_obj_matrix(rank, dim, device=cpu), (2, 2)))
        prob = conic.maxcut_conic(C)
        n = C.shape[0]
        idx = torch.arange(n)
        constraints = torch.sparse_coo_tensor(torch.stack([idx, idx, idx]),
                                              torch.ones(n, dtype=torch.float64), (n, n, n),
                                              check_invariants=True, is_coalesced=True)
        trace_param = float(2 ** dim)
        return {"C": C, "conic": prob, "constraints": constraints,
                "bias": np.ones((n, 1)), "trace_params": (trace_param, trace_param)}

    if problem == "corr_clust":
        from ttipm_tpu_torch.models.corr_clust import tt_obj_matrix_and_ineq_mask

        obj_tt, mask_tt = tt_obj_matrix_and_ineq_mask(rank, dim, device=cpu)
        C = _dense(obj_tt)
        mask = np.round(_dense(mask_tt), 1)
        return {"C": C, "conic": conic.corr_clust_conic(C, mask, beta=0.0), "mask": mask}

    if problem == "max_stable_set":
        adj = np.round(_dense(tt_rank_reduce(tt_random_graph(dim, rank, device=cpu))), 1)
        n = adj.shape[0]
        C = np.ones((n, n))
        prob = conic.max_stable_set_conic(C, adj)
        # CGAL form: per-edge selectors + trace(X) = 1
        constraints, bias_list = [], []
        ii, jj = np.nonzero(np.triu(adj))
        for i, j in zip(ii.tolist(), jj.tolist()):
            A = np.zeros((n, n))
            A[i, j] = A[j, i] = 0.5 * adj[i, j]
            constraints.append(A)
            bias_list.append(0.0)
        constraints.append(np.eye(n))
        bias_list.append(1.0)
        return {"C": C, "conic": prob, "adj": adj, "constraints": constraints,
                "bias": np.asarray(bias_list).reshape(-1, 1), "trace_params": (1.0, 1.0)}

    if problem == "graphm":
        n_g = 2 ** dim
        G_A = _dense(tt_random_graph(dim, rank, device=cpu))
        G_B = _dense(tt_random_graph(dim, rank, device=cpu))
        q = n_g * n_g
        C = np.zeros((q + 1, q + 1))
        C[:q, :q] = np.kron(G_B, G_A)
        return {"C": C, "conic": conic.graphm_conic(C, n_g), "n_graph": n_g}

    raise ValueError(f"unknown problem {problem!r}")


def solve_baseline(solver: str, problem: str, dense: Dict, config: Dict,
                   verbose: bool = False, seed: Optional[int] = None,
                   device: str = "cuda") -> Dict:
    """Dispatch one densified instance; returns at least x_matrix,
    objective, iterations, and (when the solver exposes duals) z_matrix.
    The native solvers run on ``device``."""
    dim = config["dim"]
    prob: conic.ConicSDP = dense["conic"]
    if solver == "scs":
        return conic.solve_scs(prob, eps=1e-5 / dim, verbose=verbose)
    if solver == "sdpa":
        return conic.solve_sdpa(prob)
    if solver == "splitting":
        return conic.solve_splitting(prob, tol=1e-7, verbose=verbose, device=device)
    if solver in ("cgal", "scgal"):
        from ttipm_tpu_torch.models.baselines import cgal, sketchy_cgal

        trace_param = dense["trace_params"][1]
        C = dense["C"].copy()
        # reference scaling: ||C|| = trace budget (maxcut_scgal.py:45-46)
        C *= trace_param / max(np.linalg.norm(C), 1e-300)
        num_iter = 1000 * 2 ** dim
        if solver == "cgal":
            X, gaps, info = cgal(-C, dense["constraints"], dense["bias"], dense["trace_params"],
                                 gap_tol=0.1, num_iter=num_iter, verbose=verbose, device=device)
        else:
            sketch = 2 * int(np.ceil(np.sqrt(2 * (2 ** dim + 1))))
            X, gaps, info = sketchy_cgal(-C, dense["constraints"], dense["bias"],
                                         dense["trace_params"], gap_tol=0.1, num_iter=num_iter,
                                         R=sketch, verbose=verbose, device=device)
        return {"x_matrix": X,
                "objective": float(torch.sum(torch.as_tensor(dense["C"], device=X.device) * X)),
                "iterations": info.get("num_iters", len(gaps)),
                "gap": gaps[-1] if len(gaps) else np.nan}
    if solver == "manopt":
        from ttipm_tpu_torch.models.riemannian import solve_maxcut_manopt

        return solve_maxcut_manopt(
            dense["C"], rank=config.get("riem_rank"),
            max_iterations=int(config.get("riem_max_iter", 500)),
            min_gradient_norm=float(config.get("riem_min_grad_norm",
                                               config.get("gap_tol", 1e-6))),
            seed=seed, verbose=verbose, device=device)
    raise ValueError(f"unknown solver {solver!r}")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def run_baseline_experiment(argv=None) -> Dict:
    from ttipm_tpu_torch.utils.memtrack import PeakMemoryTracker
    from ttipm_tpu_torch.utils.runner import load_yaml

    parser = argparse.ArgumentParser(description="SDP baseline runner (PyTorch port)")
    parser.add_argument("--problem", required=True, choices=tuple(_SUPPORTED))
    parser.add_argument("--solver", required=True, choices=SOLVERS)
    parser.add_argument("--config", required=True)
    parser.add_argument("--rank", type=int, default=1)
    parser.add_argument("--track_mem", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="device of the native solvers; cuda (the default) raises where "
                             "there is no CUDA device")
    args = parser.parse_args(argv)

    if args.solver not in _SUPPORTED[args.problem]:
        parser.error(
            f"{args.solver} is not run for {args.problem} in the reference "
            f"protocol; choose from {sorted(_SUPPORTED[args.problem])}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")

    config = load_yaml(args.config)
    num_seeds = len(config["seeds"])
    rec = {
        "problem_creation_times": np.zeros(num_seeds),
        "runtimes": np.zeros(num_seeds),
        "memory": np.zeros(num_seeds),
        "complementary_slackness": np.full(num_seeds, np.nan),
        "feasibility_errors": np.zeros(num_seeds),
        "dual_feasibility_errors": np.full(num_seeds, np.nan),
        "num_iters": np.zeros(num_seeds),
        "objective": np.zeros(num_seeds),
        "num_failed_seeds": 0,
    }

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    for s_i, seed in enumerate(config["seeds"]):
        for attempt in range(3):  # retry-with-new-seed (maxcut_scs.py:45-95)
            current_seed = seed if attempt == 0 else int(np.random.randint(0, 10000))
            if attempt:
                print(f"Trying with new random seed: {current_seed}", flush=True)
            np.random.seed(current_seed)
            try:
                tracker = PeakMemoryTracker(args.device) if args.track_mem else None
                if tracker is not None:
                    tracker.__enter__()
                t1 = time.time()
                dense = build_dense_problem(args.problem, config["dim"], args.rank)
                t2 = time.time()
                sol = solve_baseline(args.solver, args.problem, dense, config,
                                     verbose=config.get("verbose", False), seed=current_seed,
                                     device=args.device)
                sync()
                t3 = time.time()
                if tracker is not None:
                    tracker.__exit__()
                    rec["memory"][s_i] = tracker.peak_mb
                t_create, t_solve = t2 - t1, t3 - t2
                break
            except Exception as e:  # noqa: BLE001 (a failed seed, as in the JAX runner)
                print(f"{type(e).__name__}: {e}", flush=True)
                if attempt == 2:
                    rec["num_failed_seeds"] += 1
        else:
            continue

        prob = dense["conic"]
        X = _host(sol["x_matrix"])
        rec["problem_creation_times"][s_i] = t_create
        rec["runtimes"][s_i] = t_solve
        rec["objective"][s_i] = sol.get("objective", float(np.sum(prob.C * X)))
        rec["num_iters"][s_i] = float(sol.get("iterations", 0))
        eq_res = prob.eq_residual(X)
        ineq_vio = prob.ineq_violation(X)
        rec["feasibility_errors"][s_i] = float(eq_res @ eq_res) + float(ineq_vio @ ineq_vio)
        if sol.get("z_matrix") is not None:
            Z = _host(sol["z_matrix"])
            rec["complementary_slackness"][s_i] = abs(float(np.sum(X * Z)))

        print(f"[{args.solver}] seed {current_seed}: obj {rec['objective'][s_i]:.6e}, feas "
              f"{rec['feasibility_errors'][s_i]:.3e}, iters {rec['num_iters'][s_i]:.0f}, "
              f"time {t_solve:.2f}s", flush=True)

    _print_summary(args, config, rec)
    _save_summary(args, config, rec)
    return rec


def _print_summary(args, config, rec) -> None:
    print(f"\n=== {args.problem} dim {config['dim']} — {args.solver} ===")
    for key in ("runtimes", "problem_creation_times", "objective",
                "feasibility_errors", "num_iters", "memory"):
        vals = rec[key]
        print(f"  {key}: mean {np.nanmean(vals):.4e} ± "
              f"{np.nanstd(vals):.4e}  median {np.nanmedian(vals):.4e} "
              f" worst {np.nanmax(vals):.4e}")
    print(f"  failed seeds: {rec['num_failed_seeds']}")


def _save_summary(args, config, rec) -> None:
    results_dir = os.path.join(os.getcwd(), "results")
    os.makedirs(results_dir, exist_ok=True)
    payload = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in rec.items()}
    payload["config"] = config
    payload["solver"] = args.solver
    payload["problem"] = args.problem
    out = os.path.join(results_dir,
                       f"{args.problem}_{config['dim']}_{args.solver}_rank{args.rank}.json")
    with open(out, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
    print(f"results written to {out}")


if __name__ == "__main__":
    run_baseline_experiment()
