"""The port's benchmark: MaxCut solves on the card, in ``bench.py``'s protocol.

Counterpart of the repository's ``bench.py`` for ``ttipm_tpu_torch``.  It
solves MaxCut instances end to end with ``ipm.tt_ipm`` (the main path: the
fused ladder, the ragged fallback where the ladder exhausts, the fused
eigensolver; all four kernels on the card) and prints ONE JSON line per
solve as it completes, then a final grid-summary line
``{"metric": "maxcut_grid_geomean_seconds", "value", "unit", "grid",
"skipped", "converged_all", "vs_baseline", ...}``, printed always (even
when a solve raises).

Protocol (bench.py's): the wall of ``tt_ipm`` per seed on the configs/
grid, taken after ``torch.cuda.synchronize``; converged means
complementary slackness < abs_tol; seeds and solver settings come from
configs/maxcut_<dim>.yaml.  The grid runs under a wall-clock budget
(BENCH_BUDGET_S, default 1500 s): before each solve the projected cost
(the reference's mean seconds at that dim times the worst observed
port/reference ratio so far, times 1.5) is checked against what is left,
and the seed is skipped (a "skipped" line) rather than overrunning.

``vs_baseline`` = reference CPU seconds / port seconds on this device:
the reference is the Cython implementation timed on a CPU host
(results/ref_baseline/maxcut_<dim>.json where present, else
BASELINE_MEASURED.json's per-dim means); >1 means the port on this device
is faster than the reference on its CPU host.  The summary's value is the
geometric mean over dims of the per-dim mean seconds, its ``vs_baseline``
the geometric mean of the per-dim ratios.

Env knobs: BENCH_GRID ("dim:seeds,...", default DEFAULT_GRID),
BENCH_PLATFORM (``cuda``: the f64 main path, the default; ``cuda-f32``:
the f32 profile as chip_smoke.py's phase 9 sets it; ``cpu``: the plain
versions on the CPU), BENCH_BUDGET_S.  ``cuda`` and ``cuda-f32`` raise
where there is no card.  The first line names the device (on the card:
nvidia-smi's name and power limit).

    python -m ttipm_tpu_torch.tools.bench
    BENCH_PLATFORM=cpu BENCH_GRID=3:1 python -m ttipm_tpu_torch.tools.bench
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_GRID = "3:2,5:2,6:3,7:3,8:3,9:2,10:1"
PLATFORMS = ("cuda", "cuda-f32", "cpu")


def _load_config(dim: int) -> dict:
    """configs/maxcut_<dim>.yaml: seeds and solver settings."""
    from ttipm_tpu_torch.utils.runner import load_yaml

    return load_yaml(os.path.join(REPO, "configs", f"maxcut_{dim}.yaml"))


def _ref_baseline_mean(dim: int):
    """The reference's measured mean solve seconds for maxcut at ``dim`` (a
    CPU host), or None."""
    fresh = os.path.join(REPO, "results", "ref_baseline", f"maxcut_{dim}.json")
    try:
        with open(fresh) as fh:
            return float(np.mean(json.load(fh)["results"]["runtimes"][0]))
    except (OSError, KeyError, IndexError, TypeError, ValueError):
        pass
    try:
        with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as fh:
            rec = json.load(fh)["maxcut"].get(str(dim))
        return float(rec["mean_s"]) if rec else None
    except (OSError, KeyError, TypeError, ValueError):
        return None


def setup(platform: str) -> torch.device:
    """The device of ``platform`` and its dtype profile; raises on an
    unknown platform or, for the card's platforms, where there is no card."""
    from ttipm_tpu_torch import config

    if platform not in PLATFORMS:
        raise SystemExit(f"BENCH_PLATFORM={platform!r}: one of {', '.join(PLATFORMS)}")
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"BENCH_PLATFORM={platform}: no CUDA device "
                         "(BENCH_PLATFORM=cpu runs the plain versions on the CPU)")
    if platform == "cuda-f32":
        config.set_dtype(torch.float32)
        config.set_eigen_dtype("native")
        config.set_mixed_local("f64")
    return torch.device("cuda")


def device_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "device: cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def solve_once(dim: int, seed: int, cfg: dict, device: torch.device) -> dict:
    """One seeded solve as the runner makes it; the wall of ``tt_ipm``
    alone, synchronised on the card.  Also returns the kernels' launches
    and plain calls in the solve, and the peak device memory."""
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.ops.tt import tt_inner_prod
    from ttipm_tpu_torch.utils.memtrack import PeakMemoryTracker
    from ttipm_tpu_torch.utils.runner import ipm_kwargs, seeded_problem

    lag_maps, obj, L, bias, _ = seeded_problem(create_problem, dim, 1, seed, device)
    K.reset_counts()
    with PeakMemoryTracker(device) as mem:
        t0 = time.perf_counter()
        X, _, _, Z, info = tt_ipm(lag_maps, obj, L, bias, **{**ipm_kwargs(cfg), "verbose": False})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
    return {"seconds": elapsed, "slackness": abs(float(tt_inner_prod(X, Z))),
            "iters": int(info["num_iters"]), "peak_mb": mem.peak_mb,
            "kernels": {n: s.launches for n, s in K.STATS.items()},
            "plain_calls": {n: s.plain_calls for n, s in K.STATS.items()}}


def main() -> int:
    platform = os.environ.get("BENCH_PLATFORM", "") or "cuda"
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1500"))
    grid_spec = os.environ.get("BENCH_GRID", DEFAULT_GRID)
    device = setup(platform)
    print(device_line(device), flush=True)

    t_start = time.time()
    all_ok = True
    times, ratios, skipped = [], [], []
    worst_slowdown = 1.0  # worst observed (port seconds / reference seconds)
    try:
        for part in grid_spec.split(","):
            dim_s, _, nseeds_s = part.partition(":")
            dim, nseeds = int(dim_s), int(nseeds_s or "1")
            cfg = _load_config(dim)
            ref_mean = _ref_baseline_mean(dim)
            dim_times = []
            for seed in cfg["seeds"][:nseeds]:
                remaining = budget_s - (time.time() - t_start)
                projected = (ref_mean or 30.0) * worst_slowdown * 1.5
                if projected > remaining:
                    skipped.append({"dim": dim, "seed": seed, "projected_s": round(projected, 1),
                                    "remaining_s": round(remaining, 1)})
                    print(json.dumps({"metric": f"maxcut_d{dim}_seed{seed}_skipped",
                                      "value": None, "unit": "s", "reason": "budget",
                                      "projected_s": round(projected, 1),
                                      "remaining_s": round(remaining, 1)}), flush=True)
                    continue
                run = solve_once(dim, int(seed), cfg, device)
                elapsed = run["seconds"]
                converged = run["slackness"] < float(cfg["abs_tol"])
                all_ok = all_ok and converged
                dim_times.append(elapsed)
                if ref_mean:
                    worst_slowdown = max(worst_slowdown, elapsed / ref_mean)
                print(json.dumps({
                    "metric": f"maxcut_d{dim}_seed{seed}_solve_seconds",
                    "value": elapsed, "unit": "s",
                    "slackness": run["slackness"], "iters": run["iters"],
                    "converged": converged, "platform": platform,
                    "vs_baseline": ref_mean / elapsed if ref_mean else None,
                    "peak_mb": run["peak_mb"], "kernels": run["kernels"],
                    "plain_calls": run["plain_calls"],
                }), flush=True)
            if dim_times:
                mean_t = float(np.mean(dim_times))
                times.append({"dim": dim, "mean": mean_t, "std": float(np.std(dim_times)),
                              "ref_mean": ref_mean})
                if ref_mean:
                    ratios.append(ref_mean / mean_t)
    except BaseException:
        all_ok = False  # a solve that raised is not converged; the summary still prints
        raise
    finally:
        geomean = float(np.exp(np.mean([np.log(t["mean"]) for t in times]))) if times else None
        print(json.dumps({
            "metric": "maxcut_grid_geomean_seconds", "value": geomean, "unit": "s",
            "grid": times, "skipped": skipped, "platform": platform,
            "converged_all": all_ok and bool(times),
            # geometric mean of (reference CPU seconds / port seconds on
            # this device); > 1: the port here is faster
            "vs_baseline": float(np.exp(np.mean(np.log(ratios)))) if ratios else None,
        }), flush=True)
    return 0 if (all_ok and times) else 1


if __name__ == "__main__":
    sys.exit(main())
