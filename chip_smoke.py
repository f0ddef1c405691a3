"""Smoke test of the PyTorch port (ttipm_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--dim D --seed S]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: compiles the four CUDA kernels from ttipm_tpu_torch/csrc (one
   nvcc per source, all started together).
3. kernels: each kernel against its plain PyTorch version on the card,
   at the fused solve's shapes (bond rank R in {8, 16, 32}, operator ranks
   in {1, 4, 9}, the panels of K3_PANELS, which span K3's regimes up to
   its envelope 512 x 128, one of them also as a transposed view and with
   the transposed output, SPD matrices of the orders in K4_ORDERS, which
   span both regimes of K4, and one indefinite one),
   with median times of kernel, plain version and the one library call
   that computes the same function, taken in turns (plain, library,
   kernel, kernel, library, plain), beside the roofline bound of the call.
   The grouped entries of K1 and K2 (several blocks, a whole block
   product, one launch) run at the same R and s with transposed and
   flipped (non-contiguous) operands and unequal operator ranks in a
   group.  The time of an empty kernel launched through the same wrapper
   path is printed: that, not the roofline, is the floor of a small call.
4. parity: MaxCut d3 (seed 319, configs/maxcut_3.yaml settings) solved by
   the port on the CPU (plain versions) and on the GPU (kernels): equal
   iteration counts and <C, X> equal to 1e-6 relative.
5. slice: MaxCut d8 (seed 24, configs/maxcut_8.yaml settings) on the GPU:
   converged (slackness and feasibility below abs_tol), every kernel
   launched, no plain version run on a CUDA tensor, and every kernel
   within the tolerances of phase 3 at each distinct shape the solve gave
   it (checked on the first call of that shape; the grouped entries
   included); every kernel and its plain version are then timed on the
   first operands of each of their shapes, and the totals weighted by the
   solve's call counts are printed (slice_k12_times, slice_k3_times,
   slice_k4_times).
6. fallback: MaxCut d10 (seed 41, configs/maxcut_10.yaml settings, quiet)
   on the GPU through the runner's run_and_record: the fused ladder, the
   ragged AMEn where the ladder exhausts its restarts, the fused
   eigensolver.  Converged, at least one Newton solve through the ragged
   AMEn, every kernel launched, no plain version run on a CUDA tensor, and
   every kernel within phase 3's tolerances on the first call of up to 48
   distinct shapes a kernel, the largest of each entry point included.
   Printed: wall and iterations beside the JAX package's CPU run, the
   solve counts and seconds of the three solver layers, the host syncs by
   file, the peak device memory, the launches, the largest K1 block and K4
   order, and the kernels timed at the solve's heaviest shapes.
7. ineq: corr_clust d6 (seed 764, the first of configs/corr_clust_6.yaml,
   its settings, quiet) on the GPU through run_and_record: the inequality
   path (the IneqStatus machine, the fused ladder's nine-term four-row
   products and six-block Schur groups, the smallest-eigenvector step
   sizes, the ragged inequality local solver where the ladder exhausts).
   Converged, ineq_status left NOT_IN_USE, at least one nine-term K2
   product and one six-block K1 group, every kernel launched, no plain
   version on a CUDA tensor, kernels checked as in phase 6.  Printed as in
   phase 6, with the final ineq_status and T ranks, the local solves and
   the K2 / K1 launches by terms and blocks; also timed: the heaviest
   nine-term product, six-block group and ragged L_Z.  If no ragged
   inequality local solve ran, corr_clust d3 seed 291 is solved with the
   fused ladder made to exhaust at once, so that it runs on the card.

8. graphm: graphm n=2 seed 256 (configs/graphm_2.yaml with GRAPHM_SETTINGS,
   those of the JAX package's graphm test; quiet) on the GPU through
   run_and_record: the lifted QAP relaxation (5 cores, four bonds), whose
   Newton systems need TT ranks near 52, past the fused ladder's cap of 32,
   so that they go through the ragged AMEn with the inequality local
   solver (LGMRES at the large local sizes).
   Checked as phase 7 (converged, the inequalities in use, every kernel
   launched, no plain version on a CUDA tensor, kernels held to phase 3's
   tolerances), and the solve writes a checkpoint every iteration into a
   temporary directory: the last one, loaded back onto the card, holds the
   final iterates bit for bit.  Printed as phase 7, beside the JAX
   package's CPU record, with the ranks of Y, the largest ragged local
   system and the kernels at the solve's heaviest shapes (the ladder's
   largest L_Z and six-block group, the ragged LGMRES product).

The line before the last is a JSON object with the per-kernel record
(launches on the d8, d10, corr_clust d6 and graphm paths); the last line is
{"ok": true, "device": {...}}.  ``--phases`` runs a subset (device and
build always) and then prints neither.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
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


# Peak rates of the roofline bounds (NVIDIA H100 SXM data sheet): device
# memory, and float64 through the tensor cores (the kernels are float64).
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 67e12


# Orders at which K4 is timed against torch.linalg.cholesky_ex: the d8
# solve's common orders, the resident bound 512 and one past it, and the
# blocked regime up to 4 * 36^2.
K4_ORDERS = (16, 64, 144, 256, 400, 512, 513, 1024, 4096, 5184)

# Panels at which K3 is timed against torch.linalg.qr: the largest a cluster
# of CTAs factors (the envelope) and a tall one CTA holds, the (4R, R + 2)
# of bond ranks 36, 32, 16 and 8, and the d8 solve's smallest and largest
# (the last is the one the kernels line reports).
K3_PANELS = ((512, 128), (512, 32), (144, 36), (128, 34), (64, 18), (32, 10), (24, 6), (40, 10))


def config_path(dim: int, problem: str = "maxcut") -> str:
    return os.path.join(REPO, "configs", f"{problem}_{dim}.yaml")


def load_config(dim: int, problem: str = "maxcut") -> dict:
    """configs/<problem>_<dim>.yaml, read by the port runner's YAML reader."""
    from ttipm_tpu_torch.utils.runner import load_yaml

    return load_yaml(config_path(dim, problem))


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


def _turns_ms(fns, runs=10, warmup=3):
    """Median ms of each function, timed in turns: the list forward, then
    backward (plain, kernel, kernel, plain), so that drift hits all alike."""
    times = [_times_ms(fn, runs, warmup) for fn in fns]
    for fn, ts in zip(reversed(fns), reversed(times)):
        ts += _times_ms(fn, runs, warmup)
    return [float(np.median(ts)) for ts in times]


def _tensors(arg):
    import torch

    if isinstance(arg, torch.Tensor):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [t for a in arg for t in _tensors(a)]
    return []


def bound_ms(name, args):
    """Roofline bound of one call of entry point ``name`` on ``args``: the
    larger of its bytes (every distinct input read once, the output
    written once) over the device memory rate and its operations over the
    float64 peak; returns (ms, "bytes" or "operations")."""
    seen, bytes_in = set(), 0
    for t in _tensors(args):
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            bytes_in += 8 * t.numel()

    def dims(term):
        (l, s, r), (_, m, n, S), (L, _, R) = (tuple(t.shape) for t in term[:3])
        return l, s, r, m, n, S, L, R

    if name in ("kkt_block_matvec", "kkt_block_product"):
        terms, nrows = ([args], 1) if name == "kkt_block_matvec" else args
        l, _, _, m, _, _, L, _ = dims(terms[0])
        bytes_out = 8 * l * nrows * m * L
        flops = sum(2 * (l * s * r * n * R + m * S * s * n * l * R + l * m * S * R * L)
                    for l, s, r, m, n, S, L, R in map(dims, terms))
    elif name in ("schur_assemble", "schur_assemble_group"):
        blocks = [args] if name == "schur_assemble" else args[0]
        bytes_out = flops = 0
        for l, s, r, m, n, S, L, R in map(dims, blocks):
            bytes_out += 8 * l * m * L * r * n * R
            flops += 2 * l * m * r * n * S * (s + L * R)
    elif name == "panel_qr":
        m, n = args[0].shape
        bytes_out = 8 * (m * n + n * n)
        flops = 4 * m * n * n - 4 * n**3 // 3  # Householder R, then Q formed
    elif name == "panel_cholesky":
        n = args[0].shape[0]
        bytes_out = 8 * n * n + 4
        flops = n**3 // 3
    else:
        raise KeyError(name)
    by_bytes = 1e3 * (bytes_in + bytes_out) / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F64_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def library_calls():
    """The one PyTorch call that computes the same function as each
    single-call entry point; timed beside the kernels, used nowhere in the
    port."""
    import torch

    return {
        "kkt_block_matvec": lambda pl, A, pr, x: torch.einsum(
            "lsr,smnS,LSR,rnR->lmL", pl, A, pr, x),
        "schur_assemble": lambda pl, A, pr: torch.einsum("lsr,smnS,LSR->lmLrnR", pl, A, pr),
        "panel_qr": lambda a: torch.linalg.qr(a, mode="reduced"),
        "panel_cholesky": torch.linalg.cholesky_ex,
    }


def grouped_operands(t, R, s):
    """Operands of a grouped K2 and a grouped K1 call at bond rank R and
    operator rank about s, as the fused algebra builds them: the (1,0)
    term on flipped interfaces and a transposed core (non-contiguous
    views), x as strided columns of one block core, unequal operator
    ranks within the group."""
    x = t(R, 3, 4, R)
    ranks = {"00": (s, s), "01": (s + 1, s), "12": (1, 1), "21": (s, s + 2), "22": (2, s)}
    op = {k: (t(R, a, R), t(a, 4, 4, b), t(R, b, R)) for k, (a, b) in ranks.items()}
    pl, A, pr = op["01"]
    t10 = (pl.permute(2, 1, 0), A.transpose(1, 2), pr.permute(2, 1, 0))
    terms = [(*op["00"], x[:, 0], 0), (*op["01"], x[:, 1], 0), (*t10, x[:, 0], 1),
             (*op["12"], x[:, 2], 1), (*op["21"], x[:, 1], 2), (*op["22"], x[:, 2], 2)]
    blocks = [op["21"], t10, op["22"], op["00"]]
    return terms, blocks


def phase_kernels():
    """Every entry point against its plain version on the card; returns per
    kernel the max_abs_err over all shapes and, at the largest shape of its
    single-call entry, ms, plain_ms, library_ms and the roofline bound."""
    import torch

    from ttipm_tpu_torch.checks import KERNEL_OF, PLAIN, check_kernel, shape_key
    from ttipm_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    library = library_calls()
    summary = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), device=dev)

    floor = float(np.median(_times_ms(lambda: K.empty_launch(dev), runs=50)))
    print(json.dumps({"empty_launch_ms": floor}), flush=True)

    def run(name, *args, **kw):
        fn, plain, lib = getattr(K, name), PLAIN[name], library.get(name)
        out = fn(*args, **kw)
        if kw.get("transposed"):  # K3 handing back q^T: hold q to the contract
            if tuple(out[0].shape) != args[0].shape[::-1] or not out[0].is_contiguous():
                raise AssertionError(f"{name}: transposed output of shape {out[0].shape}")
            out = (out[0].T, out[1])
        errs = check_kernel(name, args, out)
        s = summary[KERNEL_OF[name]]
        s["max_abs_err"] = max(s["max_abs_err"], errs.get("max_abs_err", 0.0))
        fns = [lambda: plain(*args), lambda: fn(*args, **kw)]
        if lib is not None:
            fns.insert(1, lambda: lib(*args))
        ms = _turns_ms(fns)
        row = {"ms": ms[-1], "plain_ms": ms[0], "library_ms": ms[1] if lib else None}
        row["bound_ms"], row["bound_by"] = bound_ms(name, args)
        if name in KERNELS:
            s.update(row)
        print(json.dumps({"kernel": name, "shape": shape_key(args), **kw, **errs, **row,
                          "ratio": row["ms"] / row["plain_ms"]}), flush=True)

    for R in (8, 16, 32):
        for s in (1, 4, 9):
            pl, A, pr, x = t(R, s, R), t(s, 4, 4, s), t(R, s, R), t(R, 4, R)
            run("kkt_block_matvec", pl, A, pr, x)
            run("schur_assemble", pl, A, pr)
            terms, blocks = grouped_operands(t, R, s)
            run("kkt_block_product", terms, 3)
            run("schur_assemble_group", blocks)
    run("panel_qr", t(34, 128).T)                     # a non-contiguous operand
    run("panel_qr", t(128, 34), transposed=True)      # q^T as the backward split takes it
    for m, n in K3_PANELS:
        run("panel_qr", t(m, n))
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


def report_checks(label, checked, where):
    """Print the worst error of each kernel's checks ({kernel: {shape:
    errors}}) on one line, and raise if a check was outside tolerance."""
    worst = {}
    for name, by_shape in checked.items():
        w = {"shapes": len(by_shape)}
        for errs in by_shape.values():
            for k, v in errs.items():
                if k in ("rel", "rel_terms", "fact", "orth", "below_diagonal", "max_abs_err"):
                    w[k] = max(w.get(k, 0.0), v)
        w["failed_info"] = sum(1 for e in by_shape.values() if e.get("info", 0) != 0)
        w["nonfinite_operands"] = sum(1 for e in by_shape.values() if e.get("nonfinite"))
        worst[name] = w
    print(json.dumps({label: worst}), flush=True)
    bad = [(name, key, errs) for name, by_shape in checked.items()
           for key, errs in by_shape.items() if not errs["ok"]]
    if bad:
        raise AssertionError(f"kernels outside tolerance on {where}: {bad[:8]}")


def phase_slice(dim, seed):
    """The solve on the card.  On the first call of each distinct operand
    shape, each entry point's output is also held against its plain version
    (called directly, so the counters do not move; K1/K2 errors relative to
    the scale of their terms, since the solver's operands cancel, see
    ttipm_tpu_torch.checks); the seconds these checks take are reported
    apart from the solve's wall.  Returns per kernel (launches, plain
    calls, launches through the grouped entry)."""
    import torch

    from ttipm_tpu_torch.checks import KERNEL_OF, kernel_errors, shape_key
    from ttipm_tpu_torch.ops import kernels as K

    cfg = load_config(dim)
    settings = ipm_settings(cfg)
    shapes = {name: Counter() for name in KERNEL_OF}
    checked = {name: {} for name in KERNEL_OF}
    first = {name: {} for name in KERNEL_OF}  # first operands of each shape, timed later
    check_s = [0.0]
    originals = {name: getattr(K, name) for name in KERNEL_OF}

    def recorder(name):
        fn = originals[name]

        def wrapped(*args, **kw):
            key = shape_key(args) + (f" {kw}" if kw else "")
            shapes[name][key] += 1
            out = fn(*args, **kw)
            if key not in checked[name]:
                t0 = time.perf_counter()
                held = (out[0].T, out[1]) if kw.get("transposed") else out
                checked[name][key] = kernel_errors(name, args, held, cancelling=True)
                first[name][key] = ((args[0].clone(),) if name == "panel_cholesky" else args, kw)
                check_s[0] += time.perf_counter() - t0
            return out
        return wrapped

    for name in KERNEL_OF:
        setattr(K, name, recorder(name))
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    try:
        res = solve(dim, seed, torch.device("cuda"), settings)
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)
    counts = {name: (s.launches, s.plain_calls, s.grouped) for name, s in K.STATS.items()}
    res["check_s"] = check_s[0]
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["counts"] = {n: {"launches": c[0], "plain_calls": c[1], "grouped": c[2]}
                     for n, c in counts.items()}
    res["entry_calls"] = {n: sum(c.values()) for n, c in shapes.items()}
    print(json.dumps({"slice": res}), flush=True)
    print(json.dumps({"shape_histogram": {n: c.most_common(6) for n, c in shapes.items()}}),
          flush=True)
    report_checks("slice_checks", checked, "the slice's shapes")
    phase_slice_times("slice_k12_times", shapes, first,
                      ("kkt_block_product", "kkt_block_matvec", "schur_assemble_group",
                       "schur_assemble"))
    phase_slice_times("slice_k3_times", shapes, first, ("panel_qr",))
    phase_slice_times("slice_k4_times", shapes, first, ("panel_cholesky",))
    abs_tol = settings["abs_tol"]
    if not (res["slack"] < abs_tol and res["primal_feas"] < abs_tol
            and res["dual_feas"] < abs_tol):
        raise AssertionError(f"d{dim} seed {seed} did not converge: {res}")
    for name, (launches, plain, grouped) in counts.items():
        if launches <= 0:
            raise AssertionError(f"{name}: not launched on the main path")
        if plain != 0:
            raise AssertionError(f"{name}: plain version ran {plain} times on CUDA tensors")
        if name in ("schur_assemble", "kkt_block_matvec") and grouped <= 0:
            raise AssertionError(f"{name}: its grouped entry was not launched on the main path")
    return counts


def phase_slice_times(label, shapes, first, names):
    """The entry points ``names`` and their plain versions (einsum,
    linalg.qr, cholesky_ex) timed on the first operands of each of their shapes in the
    solve; the totals weight each shape by its call count (the time the
    solve would spend in single calls of either)."""
    from ttipm_tpu_torch.checks import PLAIN
    from ttipm_tpu_torch.ops import kernels as K

    report = {}
    for name in names:
        fn, plain = getattr(K, name), PLAIN[name]
        rows, total, plain_total = [], 0.0, 0.0
        for key, (args, kw) in first[name].items():
            plain_ms, ms = _turns_ms([lambda: plain(*args), lambda: fn(*args, **kw)], runs=3,
                                     warmup=1)
            count = shapes[name][key]
            rows.append({"shape": key, "count": count, "ms": ms, "plain_ms": plain_ms})
            total += count * ms
            plain_total += count * plain_ms
        rows.sort(key=lambda r: -r["count"] * r["ms"])
        report[name] = {"distinct_shapes": len(rows), "calls": sum(r["count"] for r in rows),
                        "weighted_ms": total, "plain_weighted_ms": plain_total,
                        "ratio": total / plain_total if plain_total else None,
                        "heaviest_shapes": rows[:4]}
    print(json.dumps({label: report}), flush=True)


# The fallback cell (maxcut d10 seed 41) and the JAX package's run of it on
# the CPU (BENCH_r05.json): converged in 11 iterations, 410.6 s.
FALLBACK_CELL = ("maxcut", 10, 41)
JAX_CPU_D10 = {"iters": 11, "wall_s": 410.6, "source": "BENCH_r05.json (CPU run)"}
# The inequality cell (corr_clust d6 seed 764, the first seed of
# configs/corr_clust_6.yaml) and the JAX package's run of it on the CPU.
INEQ_CELL = ("corr_clust", 6, 764)
JAX_CPU_CC6 = {"iters": 11, "wall_s": 110.9, "slack": 4.175e-05,
               "ranksX": [5, 13, 9, 5, 3], "ranksT": [5, 5, 3, 3, 3],
               "source": "results/grid_r5_clean/grid_log.jsonl (CPU run)"}
# A corr_clust solve whose fused ladder is made to exhaust at every Newton
# step, so that the ragged inequality local solver runs on the card.
EXHAUST_CELL = ("corr_clust", 3, 291)
FALLBACK_CHECKS = 48  # kernel checks per kernel in phases 6 and 7


def shape_spec(arg):
    """The nested shapes of an entry point's arguments, hashable (a tensor
    becomes the tuple of its shape, other values stay)."""
    import torch

    if isinstance(arg, torch.Tensor):
        return ("T",) + tuple(arg.shape)
    if isinstance(arg, (list, tuple)):
        return tuple(shape_spec(a) for a in arg)
    return arg


def random_operands(name, spec, rng, dev):
    """Random operands of the shapes ``spec`` (an SPD matrix for K4)."""
    import torch

    def build(sp):
        if isinstance(sp, tuple) and sp[:1] == ("T",):
            return torch.as_tensor(rng.randn(*sp[1:]), device=dev)
        if isinstance(sp, tuple):
            return type(sp)(build(x) for x in sp)
        return sp

    args = build(spec)
    if name == "panel_cholesky":
        n = args[0].shape[0]
        args = (args[0] @ args[0].T + n * torch.eye(n, dtype=args[0].dtype, device=dev),)
    if name in ("schur_assemble_group", "kkt_block_product"):
        args = (list(args[0]),) + tuple(args[1:])
    return args


def drive(problem, dim, seed, label, jax_cpu=None, exhaust=False, must_launch=tuple(KERNELS),
          settings=None, ipm_kw=None, keep=None):
    """<problem> d<dim> seed <seed> through the runner's ``run_and_record``
    with configs/<problem>_<dim>.yaml's settings (quiet; ``settings``
    replaces some of them), on the card, ``tt_ipm`` also given ``ipm_kw``
    (its final iterates X, Y, T, Z go to ``keep["iterates"]``).  The
    fused ladder, the ragged AMEn, the fused generalised eigensolver and the
    fused smallest-eigenvector sweep (the inequality step sizes) are timed
    (synchronised) and counted, and so are the ragged local KKT solves;
    host syncs are counted by the file that made them
    (``torch.cuda.set_sync_debug_mode``).  With ``exhaust`` the fused ladder
    raises AmenRestartsExhausted at once, so every Newton solve takes the
    ragged AMEn.  Each kernel is held to phase 3's tolerances on the first
    call of a shape, for the first 46 distinct shapes of a kernel and, at
    the end, for the largest shape of each entry point if it was not among
    them; the seconds of these checks are reported apart.  Prints one JSON
    line under ``label``; raises unless the solve converged, each kernel of
    ``must_launch`` launched and no plain version ran on a CUDA tensor.
    Returns (result, per kernel (launches, plain calls, grouped launches),
    the call record for ``solve_times``)."""
    import argparse
    import warnings

    import torch

    import ttipm_tpu_torch.ipm as ipm
    from ttipm_tpu_torch.checks import KERNEL_OF, kernel_errors, shape_key
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.solvers.amen import AmenRestartsExhausted
    from ttipm_tpu_torch.utils import runner

    config = load_config(dim, problem)
    config.update(settings or {}, verbose=False)
    args = argparse.Namespace(device="cuda", track_mem=True, rank=1,
                              config=config_path(dim, problem))
    rec = runner.new_record(1, runner.bond_count(problem, dim))
    first_checks = FALLBACK_CHECKS - 2  # two kernels have two entry points

    layer = [None]
    layers = {k: {"calls": 0, "s": 0.0, "check_s": 0.0}
              for k in ("fused", "ragged", "eigen", "min_eig")}
    exhausted = [0]
    local = Counter()   # ragged local KKT solves: (solver, dense) -> count
    local_largest = {}  # solver -> shape of its largest local unknown
    info = {}
    calls = {}          # (layer, name, spec) -> count
    bounds = {}         # (name, spec) -> bound_ms of its first call
    largest = {}        # name -> (size, spec, args, kw) of its largest call
    products, groups = Counter(), Counter()  # K2 (terms, rows), K1 blocks per launch
    checked = {name: {} for name in K.STATS}
    check_s = [0.0]
    originals = {name: getattr(K, name) for name in KERNEL_OF}
    solvers = {"fused": "tt_restarted_block_amen_fused", "ragged": "tt_restarted_block_amen",
               "eigen": "tt_max_generalised_eigen_fused", "min_eig": "tt_min_eig_fused"}
    solver_fns = {k: getattr(ipm, v) for k, v in solvers.items()}
    saved = {name: getattr(ipm, name)
             for name in ("tt_ipm", "ipm_local_solver", "ipm_local_solver_ineq")}

    def check(name, spec, a, kw, out):
        t0 = time.perf_counter()
        held = (out[0].T, out[1]) if kw.get("transposed") else out
        checked[KERNEL_OF[name]][(name, spec)] = kernel_errors(name, a, held, cancelling=True)
        dt = time.perf_counter() - t0
        check_s[0] += dt
        if layer[0]:
            layers[layer[0]]["check_s"] += dt

    def recorder(name):
        fn = originals[name]

        def wrapped(*a, **kw):
            spec = shape_spec(a) + (tuple(sorted(kw.items())),)
            key = (layer[0], name, spec)
            calls[key] = calls.get(key, 0) + 1
            if name == "kkt_block_product":
                products[(len(a[0]), a[1])] += 1
            elif name == "schur_assemble_group":
                groups[len(a[0])] += 1
            out = fn(*a, **kw)
            if (name, spec) not in bounds:
                size = bounds[(name, spec)] = bound_ms(name, a)[0]
                if name not in largest or size > largest[name][0]:
                    kept = (a[0].clone(),) if name == "panel_cholesky" else a
                    largest[name] = (size, spec, kept, kw)
                if len(checked[KERNEL_OF[name]]) < first_checks:
                    check(name, spec, a, kw, out)
            return out
        return wrapped

    def exhausted_ladder(*a, **kw):
        raise AmenRestartsExhausted("fused ladder skipped (forced exhaustion)")

    def timed(kind):
        fn = exhausted_ladder if exhaust and kind == "fused" else solver_fns[kind]

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            outer, layer[0] = layer[0], kind
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            except AmenRestartsExhausted:
                if kind == "fused":
                    exhausted[0] += 1
                raise
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                layers[kind]["calls"] += 1
                layers[kind]["s"] += dt
                layer[0] = outer
                if kind in ("fused", "ragged"):
                    print(json.dumps({f"{label}_solve": kind, "s": dt}), file=sys.stderr,
                          flush=True)
        return wrapped

    def counted(name):
        fn = saved[name]

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            local[(name, not out[-1])] += 1  # out[-1]: the direct solve failed or was not tried
            if a[6].numel() > int(np.prod(local_largest.get(name, [0]))):
                local_largest[name] = list(a[6].shape)  # (r, blocks, n, R)
            return out
        return wrapped

    def kept_info(*a, **kw):
        out = saved["tt_ipm"](*a, **kw, **(ipm_kw or {}))
        info.update(out[-1])
        if keep is not None:
            keep["iterates"] = out[:4]
        return out

    for name in KERNEL_OF:
        setattr(K, name, recorder(name))
    for kind, attr in solvers.items():
        setattr(ipm, attr, timed(kind))
    ipm.tt_ipm = kept_info
    for name in ("ipm_local_solver", "ipm_local_solver_ineq"):
        setattr(ipm, name, counted(name))
    K.reset_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                runner.run_and_record(seed, 0, 1, config, args,
                                      runner.load_problem(problem), rec)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)
        for kind, attr in solvers.items():
            setattr(ipm, attr, solver_fns[kind])
        for name, fn in saved.items():
            setattr(ipm, name, fn)
    counts = {name: (s.launches, s.plain_calls, s.grouped) for name, s in K.STATS.items()}
    syncs = Counter(os.path.relpath(w.filename, REPO) for w in caught
                    if "synchroniz" in str(w.message))
    solve_syncs = {f: c for f, c in syncs.items()
                   if f.startswith("ttipm_tpu_torch") and not f.endswith("checks.py")}
    for name, (_, spec, a, kw) in largest.items():
        if (name, spec) not in checked[KERNEL_OF[name]]:
            check(name, spec, a, kw, getattr(K, name)(*a, **kw))

    status = info["status"]
    res = {
        "problem": problem, "dim": dim, "seed": seed, "iters": int(rec["num_iters"][0]),
        "slack": float(rec["complementary_slackness"][0]),
        "primal_feas": float(rec["feasibility_errors"][0]),
        "dual_feas": float(rec["dual_feasibility_errors"][0]),
        "ineq_status": status.ineq_status.name,
        "ranksX": info["ranksX"], "ranksY": info["ranksY"], "ranksZ": info["ranksZ"],
        "ranksT": info["ranksT"],
        "wall_s": float(rec["runtimes"][0]), "check_s": check_s[0],
        "wall_less_checks_s": float(rec["runtimes"][0]) - check_s[0],
        "jax_cpu": jax_cpu,
        "solves": {k: v["calls"] for k, v in layers.items()},
        "fused_exhausted": exhausted[0],
        "local_solves": {f"{n}{'_dense' if d else '_lgmres'}": c for (n, d), c in local.items()},
        "largest_local": local_largest,
        "layer_s_less_checks": {k: v["s"] - v["check_s"] for k, v in layers.items()},
        "host_syncs": sum(solve_syncs.values()),
        "host_syncs_by_file": dict(sorted(solve_syncs.items(), key=lambda kv: -kv[1])),
        "max_memory_allocated": int(rec["memory"][0] * 1e6),
        "counts": {n: {"launches": c[0], "plain_calls": c[1], "grouped": c[2]}
                   for n, c in counts.items()},
        "entry_calls": {n: sum(c for (_, nm, _), c in calls.items() if nm == n)
                        for n in KERNEL_OF},
        "k2_products_by_terms_rows": {f"{t}x{r}": c for (t, r), c in sorted(products.items())},
        "k1_groups_by_blocks": {str(b): c for b, c in sorted(groups.items())},
        "largest": {n: shape_key(v[2]) for n, v in largest.items()},
    }
    print(json.dumps({label: res}), flush=True)
    report_checks(f"{label}_checks", checked, f"the {problem} d{dim} shapes")
    abs_tol = float(config["abs_tol"])
    if not (res["slack"] < abs_tol and res["primal_feas"] < abs_tol
            and res["dual_feas"] < abs_tol):
        raise AssertionError(f"{problem} d{dim} seed {seed} did not converge: {res}")
    for name, (launches, plain, _) in counts.items():
        if launches <= 0 and name in must_launch:
            raise AssertionError(f"{name}: not launched in the {problem} d{dim} solve")
        if plain != 0:
            raise AssertionError(f"{name}: plain version ran {plain} times on CUDA tensors")
    return res, counts, (calls, bounds, largest)


def phase_fallback(problem, dim, seed):
    """Phase 6: the fused ladder, the ragged AMEn where the ladder exhausts
    its restarts (at least one solve), the fused eigensolver; timed at the
    solve's heaviest shapes."""
    res, counts, record = drive(problem, dim, seed, "fallback", JAX_CPU_D10)
    solve_times("fallback_time", *record)
    if res["solves"]["ragged"] < 1:
        raise AssertionError(f"d{dim} seed {seed}: no Newton solve went through the ragged AMEn")
    return counts


def phase_ineq(problem, dim, seed):
    """Phase 7: the inequality path.  Converged, the inequalities in use at
    some point (ineq_status left NOT_IN_USE), at least one nine-term K2
    product and one six-block K1 group; timed at the solve's heaviest shapes
    and at its heaviest nine-term product, six-block group and ragged L_Z.
    If no ragged inequality local solve ran, a forced-exhaustion solve of
    EXHAUST_CELL runs them on the card."""
    res, counts, record = drive(problem, dim, seed, "ineq", JAX_CPU_CC6)
    if res["ineq_status"] == "NOT_IN_USE":
        raise AssertionError(f"{problem} d{dim} seed {seed}: the inequalities were never used")
    if not res["k2_products_by_terms_rows"].get("9x4"):
        raise AssertionError("no nine-term K2 product ran")
    if not res["k1_groups_by_blocks"].get("6"):
        raise AssertionError("no six-block K1 group ran")
    extra = (heaviest(record, "kkt_block_product", lambda lay, sp: len(sp[0]) == 9)
             + heaviest(record, "schur_assemble_group", lambda lay, sp: len(sp[0]) == 6)
             + heaviest(record, "panel_cholesky", lambda lay, sp: lay == "ragged"))
    solve_times("ineq_time", *record, extra=extra)
    if not any(k.startswith("ipm_local_solver_ineq") for k in res["local_solves"]):
        # no fused ladder there, so no K3 (its split steps)
        ex, _, _ = drive(*EXHAUST_CELL, "ineq_exhausted", exhaust=True,
                         must_launch=("schur_assemble", "kkt_block_matvec", "panel_cholesky"))
        if not any(k.startswith("ipm_local_solver_ineq") for k in ex["local_solves"]):
            raise AssertionError("the ragged inequality local solver did not run")
    return counts


def heaviest(record, name, pred):
    """[(name, spec)] of the entry point's shape with the most calls times
    bound among the calls (layer, spec) that ``pred`` admits."""
    calls, bounds = record[0], record[1]
    items = Counter()
    for (lay, nm, spec), c in calls.items():
        if nm == name and pred(lay, spec):
            items[spec] += c * bounds[(nm, spec)]
    return [(name, spec) for spec, _ in items.most_common(1)]


# The graphm cell (graphm n=2 seed 256) and the JAX package's run of it on
# the CPU (BASELINE.md, round 1).  At configs/graphm_2.yaml's settings
# neither package reaches abs_tol on this seed (both end at slackness
# 1.54e-3); the phase takes the two settings of the JAX package's own
# graphm test (tests/test_ipm_e2e.py:206) that differ from the config's.
GRAPHM_CELL = ("graphm", 2, 256)
JAX_CPU_GM2 = {"iters": 8, "wall_s": 1048.6, "slack": 2.0e-4,
               "source": "BASELINE.md:65 (CPU run, round 1)"}
GRAPHM_SETTINGS = {"lambdaStar": 2.0, "max_refinement": 10}


def phase_graphm(problem, dim, seed):
    """Phase 8: graphm through the ragged inequality path, with a checkpoint
    written every iteration and read back onto the card against the final
    iterates; timed at the solve's heaviest shapes."""
    import torch

    from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint

    keep = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graphm.npz")
        res, counts, record = drive(problem, dim, seed, "graphm", JAX_CPU_GM2,
                                    settings=GRAPHM_SETTINGS,
                                    ipm_kw={"checkpoint_path": path, "checkpoint_every": 1},
                                    keep=keep)
        state = load_ipm_checkpoint(path, device="cuda")
    X, Y, T, Z = keep["iterates"]
    same = {name: (state[name] is None and train is None) or (
        len(state[name]) == len(train)
        and all(torch.equal(a, b) for a, b in zip(state[name], train)))
        for name, train in zip("XYZT", (X, Y, Z, T))}
    print(json.dumps({"graphm_checkpoint": {"iteration": state["iteration"],
                                            "iterates_equal": same,
                                            "scalars": state["scalars"]}}), flush=True)
    if not all(same.values()) or state["iteration"] != res["iters"]:
        raise AssertionError(f"graphm: the last checkpoint is not the final iterates: {same}")
    if res["ineq_status"] == "NOT_IN_USE":
        raise AssertionError(f"{problem} n={dim} seed {seed}: the inequalities were never used")
    extra = (heaviest(record, "kkt_block_product", lambda lay, sp: lay == "ragged")
             + heaviest(record, "schur_assemble_group", lambda lay, sp: len(sp[0]) == 6)
             + heaviest(record, "panel_cholesky", lambda lay, sp: lay == "fused")
             + heaviest(record, "panel_cholesky", lambda lay, sp: lay == "ragged"))
    solve_times("graphm_time", *record, extra=extra, tag="heaviest")
    return counts


def solve_times(label, calls, bounds, largest, extra=(), tag="heaviest_ineq"):
    """Kernel, plain version, library call and bound at the heaviest shapes
    of a solve: per entry point and solver layer the two with the most calls
    times bound, per entry point the largest, and the (name, spec) pairs of
    ``extra``; timed on random operands of those shapes (K4 on an SPD
    matrix)."""
    import torch

    from ttipm_tpu_torch.checks import PLAIN, shape_key
    from ttipm_tpu_torch.ops import kernels as K

    rng = np.random.RandomState(7)
    dev = torch.device("cuda")
    library = library_calls()
    totals = Counter()
    by_entry = {}
    for (lay, name, spec), count in calls.items():
        totals[(name, spec)] += count
        by_entry.setdefault((lay, name), []).append((count * bounds[(name, spec)], spec, count))
    picks = {}
    for (lay, name), items in by_entry.items():
        for _, spec, count in sorted(items, key=lambda x: -x[0])[:2]:
            picks.setdefault((name, spec), []).append([lay, count])
    for name, (_, spec, _, _) in largest.items():
        picks.setdefault((name, spec), []).append(["largest", totals[(name, spec)]])
    for name, spec in extra:
        picks.setdefault((name, spec), []).append([tag, totals[(name, spec)]])
    rows = []
    for (name, spec), tags in picks.items():
        a = random_operands(name, spec[:-1], rng, dev)
        kw = dict(spec[-1])
        fn, plain, lib = getattr(K, name), PLAIN[name], library.get(name)
        fns = [lambda: plain(*a), lambda: fn(*a, **kw)]
        if lib is not None:
            fns.insert(1, lambda: lib(*a))
        ms = _turns_ms(fns, runs=3, warmup=1)
        b, by = bound_ms(name, a)
        rows.append({"kernel": name, "shape": shape_key(a), "kw": kw or None, "tags": tags,
                     "calls": totals[(name, spec)], "ms": ms[-1], "plain_ms": ms[0],
                     "library_ms": ms[1] if lib is not None else None, "bound_ms": b,
                     "bound_by": by})
    for row in sorted(rows, key=lambda r: (r["kernel"], -r["calls"])):
        print(json.dumps({label: row}), flush=True)


PHASES = ("kernels", "parity", "slice", "fallback", "ineq", "graphm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES) + " (device and "
                         "build always run); the result lines are printed only for all")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    sys.path.insert(0, REPO)

    name = phase_device()
    phase_build()
    summary = phase_kernels() if "kernels" in phases else None
    if "parity" in phases:
        phase_parity()
    counts = phase_slice(args.dim, args.seed) if "slice" in phases else None
    counts_fb = phase_fallback(*FALLBACK_CELL) if "fallback" in phases else None
    counts_ineq = phase_ineq(*INEQ_CELL) if "ineq" in phases else None
    counts_gm = phase_graphm(*GRAPHM_CELL) if "graphm" in phases else None
    if set(phases) != set(PHASES):
        return 0

    record = [
        {"name": n, "route": "cuda", "source": KERNELS[n][0], "replaces": KERNELS[n][1],
         "launches": counts[n][0], "launches_d10": counts_fb[n][0],
         "launches_ineq": counts_ineq[n][0], "launches_graphm": counts_gm[n][0], **summary[n]}
        for n in KERNELS
    ]
    import torch

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
