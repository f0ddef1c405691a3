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
         "launches": counts[n][0], **summary[n]}
        for n in KERNELS
    ]
    import torch

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
