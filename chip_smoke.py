"""Smoke test of the PyTorch port (ttipm_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--dim D --seed S]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: compiles the four CUDA kernels from ttipm_tpu_torch/csrc.
3. kernels: each kernel against its plain PyTorch version on the card,
   at the fused solve's shapes (bond rank R in {8, 16, 32}, operator ranks
   in {1, 4, 9}, panels (4R, R+2), SPD matrices of the orders in
   K4_ORDERS, which span both regimes of K4, and one indefinite one),
   with median times of kernel and plain version taken in turns
   (plain, kernel, kernel, plain) and their ratio.
4. parity: MaxCut d3 (seed 319, configs/maxcut_3.yaml settings) solved by
   the port on the CPU (plain versions) and on the GPU (kernels): equal
   iteration counts and <C, X> equal to 1e-6 relative.
5. slice: MaxCut d8 (seed 24, configs/maxcut_8.yaml settings) on the GPU:
   converged (slackness and feasibility below abs_tol), every kernel
   launched, no plain version run on a CUDA tensor, and every kernel
   within the tolerances of phase 3 at each distinct shape the solve gave
   it (checked on the first call of that shape); K4 and its plain version
   are then timed on the first operand of each of its shapes, and the
   totals weighted by the solve's call counts are printed.

The line before the last is a JSON object with the per-kernel record; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "schur_assemble": ("ttipm_tpu_torch/csrc/schur_assemble.cu", "ttipm_tpu/ops/kernels.py:132"),
    "kkt_block_matvec": ("ttipm_tpu_torch/csrc/kkt_matvec.cu", "ttipm_tpu/ops/kernels.py:82"),
    "panel_qr": ("ttipm_tpu_torch/csrc/panel_qr.cu", "ttipm_tpu/ops/kernels.py:210"),
    "panel_cholesky": ("ttipm_tpu_torch/csrc/panel_cholesky.cu", "ttipm_tpu/ops/kernels.py:313"),
}


# Orders at which K4 is timed against torch.linalg.cholesky_ex: the d8
# solve's common orders, the resident bound 512 and one past it, and the
# blocked regime up to 4 * 36^2.
K4_ORDERS = (16, 64, 144, 256, 400, 512, 513, 1024, 4096, 5184)


def load_config(dim: int) -> dict:
    """The flat ``key: value`` entries of configs/maxcut_<dim>.yaml."""
    out = {}
    with open(os.path.join(REPO, "configs", f"maxcut_{dim}.yaml")) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if ":" not in line or line.startswith("-"):
                continue
            key, val = (s.strip() for s in line.split(":", 1))
            val = val.split()[-1] if val else ""
            if val:
                out[key] = val
    return out


def ipm_settings(cfg: dict) -> dict:
    return dict(
        max_iter=int(cfg.get("max_iter", 22)), gap_tol=float(cfg.get("gap_tol", 3e-4)),
        op_tol=float(cfg.get("op_tol", 1e-4)), abs_tol=float(cfg.get("abs_tol", 1e-3)),
        warm_up=int(cfg.get("warm_up", 3)), aho_direction=False,
        mals_restarts=int(cfg.get("mals_restarts", 2)),
        max_refinement=int(cfg.get("max_refinement", 5)),
        lambdaStar=float(cfg.get("lambdaStar", 1.0)),
    )


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device: {name}", flush=True)
    return name


def phase_build():
    from ttipm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build_library()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({os.path.relpath(path, REPO)})",
          flush=True)


def _times_ms(fn, runs=10, warmup=3):
    """CUDA-event times of single calls (each synchronised), in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def _paired_ms(kernel, plain, runs=10):
    """Median ms of kernel and plain version, timed in turns (plain,
    kernel, kernel, plain) so that drift hits both alike."""
    p = _times_ms(plain, runs)
    k = _times_ms(kernel, runs) + _times_ms(kernel, runs)
    p += _times_ms(plain, runs)
    return float(np.median(k)), float(np.median(p))


def phase_kernels():
    """Every kernel against its plain version on the card; returns per-kernel
    (max_abs_err over all shapes, ms, plain_ms at the largest shape)."""
    import torch

    from ttipm_tpu_torch.checks import PLAIN, check_kernel
    from ttipm_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    summary = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), device=dev)

    def run(name, *args):
        fn, plain = getattr(K, name), PLAIN[name]
        errs = check_kernel(name, args, fn(*args))
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], errs.get("max_abs_err", 0.0))
        s["ms"], s["plain_ms"] = _paired_ms(lambda: fn(*args), lambda: plain(*args))
        print(json.dumps({"kernel": name, "shape": [list(a.shape) for a in args], **errs,
                          "ms": s["ms"], "plain_ms": s["plain_ms"],
                          "ratio": s["ms"] / s["plain_ms"]}), flush=True)

    for R in (8, 16, 32):
        for s in (1, 4, 9):
            pl, A, pr, x = t(R, s, R), t(s, 4, 4, s), t(R, s, R), t(R, 4, R)
            run("kkt_block_matvec", pl, A, pr, x)
            run("schur_assemble", pl, A, pr)
    for R in (8, 16, 32):
        run("panel_qr", t(4 * R, R + 2))
    for n in K4_ORDERS:
        Bm = t(n, n)
        S = Bm @ Bm.T + n * torch.eye(n, dtype=Bm.dtype, device=dev)
        run("panel_cholesky", S)
    S[n // 3, n // 3] = -1.0
    errs = check_kernel("panel_cholesky", (S,), K.panel_cholesky(S))
    if errs["info"] == 0:
        raise AssertionError(f"panel_cholesky: indefinite n={n} reported as SPD")
    print(json.dumps({"kernel": "panel_cholesky", "indefinite_n": n, **errs}), flush=True)
    return summary


def solve(dim, seed, device, settings):
    import torch

    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import tt as T

    rng = np.random.RandomState(seed)
    obj, L, b, lag = create_problem(dim, 1, device=device, rng=rng)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, Y, _, Z, info = tt_ipm({"y": T.tt_reshape(lag, (4, 4))}, obj, L, b, rng=rng, **settings)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for c in X + Y + Z:
        if not bool(torch.isfinite(c).all()):
            raise AssertionError(f"d{dim}: non-finite iterate")
    if len(X) != dim or any(tuple(c.shape[1:3]) != (2, 2) for c in X + Z):
        raise AssertionError(f"d{dim}: unexpected iterate cores")
    slack, primal, dual = solve_metrics(X, Y, Z, obj, L, b)
    return {
        "dim": dim, "seed": seed, "device": device.type, "iters": info["num_iters"],
        "slack": slack, "primal_feas": primal, "dual_feas": dual,
        "cx": T.tt_inner_prod(T.tt_reshape(obj, (2, 2)), X),
        "ranksX": info["ranksX"], "ranksZ": info["ranksZ"], "wall_s": wall,
    }


def phase_parity():
    import torch

    settings = ipm_settings(load_config(3))
    cpu = solve(3, 319, torch.device("cpu"), settings)
    gpu = solve(3, 319, torch.device("cuda"), settings)
    print(json.dumps({"parity": [cpu, gpu]}), flush=True)
    if cpu["iters"] != gpu["iters"]:
        raise AssertionError(f"d3 iterations differ: cpu {cpu['iters']} cuda {gpu['iters']}")
    if abs(gpu["cx"] - cpu["cx"]) > 1e-6 * abs(cpu["cx"]):
        raise AssertionError(f"d3 <C,X> differ: cpu {cpu['cx']} cuda {gpu['cx']}")


def phase_slice(dim, seed):
    """The solve on the card.  On the first call of each distinct operand
    shape, each kernel's output is also held against its plain version
    (called directly, so the counters do not move; K1/K2 errors relative to
    the scale of their terms, since the solver's operands cancel, see
    ttipm_tpu_torch.checks); the seconds these checks take are reported
    apart from the solve's wall."""
    import torch

    from ttipm_tpu_torch.checks import kernel_errors
    from ttipm_tpu_torch.ops import kernels as K

    cfg = load_config(dim)
    settings = ipm_settings(cfg)
    shapes = {name: Counter() for name in KERNELS}
    checked = {name: {} for name in KERNELS}
    check_s = [0.0]
    k4_first = {}  # first operand of each K4 shape, timed after the solve
    originals = {name: getattr(K, name) for name in KERNELS}

    def recorder(name):
        fn = originals[name]

        def wrapped(*args):
            key = str([list(a.shape) for a in args])
            shapes[name][key] += 1
            out = fn(*args)
            if key not in checked[name]:
                t0 = time.perf_counter()
                checked[name][key] = kernel_errors(name, args, out, cancelling=True)
                if name == "panel_cholesky":
                    k4_first[key] = args[0].clone()
                check_s[0] += time.perf_counter() - t0
            return out
        return wrapped

    for name in KERNELS:
        setattr(K, name, recorder(name))
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    try:
        res = solve(dim, seed, torch.device("cuda"), settings)
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)
    counts = {name: (s.launches, s.plain_calls) for name, s in K.STATS.items()}
    res["check_s"] = check_s[0]
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["counts"] = {n: {"launches": c[0], "plain_calls": c[1]} for n, c in counts.items()}
    print(json.dumps({"slice": res}), flush=True)
    print(json.dumps({"shape_histogram": {n: c.most_common(12) for n, c in shapes.items()}}),
          flush=True)
    worst = {}
    for name, by_shape in checked.items():
        w = {"shapes": len(by_shape)}
        for errs in by_shape.values():
            for k, v in errs.items():
                if k in ("rel", "rel_terms", "fact", "orth", "below_diagonal",
                         "max_abs_err"):
                    w[k] = max(w.get(k, 0.0), v)
        w["failed_info"] = sum(1 for e in by_shape.values() if e.get("info", 0) != 0)
        worst[name] = w
    print(json.dumps({"slice_checks": worst}), flush=True)
    bad = [(name, key, errs) for name, by_shape in checked.items()
           for key, errs in by_shape.items() if not errs["ok"]]
    if bad:
        raise AssertionError(f"kernels outside tolerance on the slice's shapes: {bad[:8]}")
    phase_slice_k4_times(shapes["panel_cholesky"], k4_first)
    abs_tol = settings["abs_tol"]
    if not (res["slack"] < abs_tol and res["primal_feas"] < abs_tol
            and res["dual_feas"] < abs_tol):
        raise AssertionError(f"d{dim} seed {seed} did not converge: {res}")
    for name, (launches, plain) in counts.items():
        if launches <= 0:
            raise AssertionError(f"{name}: not launched on the main path")
        if plain != 0:
            raise AssertionError(f"{name}: plain version ran {plain} times on CUDA tensors")
    return counts


def phase_slice_k4_times(counts, first):
    """K4 and cholesky_ex timed on the first operand of each K4 shape of the
    solve; the totals weight each shape by its call count (the K4 device
    time the solve would spend with either)."""
    from ttipm_tpu_torch.checks import PLAIN
    from ttipm_tpu_torch.ops import kernels as K

    rows, total, plain_total = [], 0.0, 0.0
    for key, a in sorted(first.items(), key=lambda kv: kv[1].shape[0]):
        ms, plain_ms = _paired_ms(lambda: K.panel_cholesky(a),
                                  lambda: PLAIN["panel_cholesky"](a), runs=5)
        rows.append({"n": a.shape[0], "count": counts[key], "ms": ms, "plain_ms": plain_ms})
        total += counts[key] * ms
        plain_total += counts[key] * plain_ms
    print(json.dumps({"slice_k4_times": {"shapes": rows, "weighted_ms": total,
                                         "plain_weighted_ms": plain_total,
                                         "ratio": total / plain_total}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=24)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    name = phase_device()
    phase_build()
    summary = phase_kernels()
    phase_parity()
    counts = phase_slice(args.dim, args.seed)

    record = [
        {"name": n, "route": "cuda", "source": KERNELS[n][0], "replaces": KERNELS[n][1],
         "launches": counts[n][0], "max_abs_err": summary[n]["max_abs_err"],
         "ms": summary[n]["ms"], "plain_ms": summary[n]["plain_ms"]}
        for n in KERNELS
    ]
    import torch

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
