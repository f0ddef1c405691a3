"""K1, K2, K3, J1 and J2 of two checkouts of the port on one card, in turns.

    python ttipm_tpu_torch/tools/compare_kernels.py --parent DIR [--dim 8 --seed 24]
        [--j2-only [--j2-orders 64,128]] [--j1-only [--j1-orders 118,128]]

``DIR`` holds another checkout of the repository (for example an unpacked
``git archive`` of the parent commit); the script's own checkout is "the
change".  Every measurement runs in a process of its own that imports
``ttipm_tpu_torch`` from one of the two roots, through the entry points
both have: ``kernels.kkt_block_matvec``, ``kernels.schur_assemble``,
the fused block product (``fused_algebra.local_product``, or
``fused_batch.local_product`` on a batch of one) and, where the checkout has it,
``kernels.schur_assemble_group`` (else four ``kernels.schur_assemble``
calls), and ``kernels.panel_qr`` on one contiguous panel.

1. bits: the change solves MaxCut d<dim> and records the operands and
   the result of the first call of every distinct shape of its K1, K2 and
   K3 entry points; the parent computes the same results from the same
   operands with its kernels; the two are compared bit for bit (K3's bits
   follow its reduction order: reported, not required equal).
2. times, in the order parent, change, change, parent: at bond rank 8 /
   operator rank 4 and at 32 / 9, one block matvec, one Schur block, one
   ``local_product`` and the four Schur blocks of a local factor: median
   of single calls (CUDA events, host cost included), back-to-back calls
   (wall of a run of calls over their number), and the device kernels per
   call with their summed device time (torch.profiler); K3 at the panels
   in ``K3_SHAPES`` the same way, beside ``torch.linalg.qr`` on the same
   panel and, where the library exports ``ttipm_panel_qr_stamps``, the
   kernel's own clock stamps (cycles of its load, forward chain, R store,
   Q chain and store); then the wall and the iteration count of the
   MaxCut solve.
3. J2 (``kernels.jacobi_eigh_core``) on the solve's own operands: the
   change records the first J2_RECORD calls of every order, both
   checkouts factor them (bits and eigenvalue differences reported, not
   required equal: the regimes round differently), and every time worker
   times, at each order, the checkout's J2 on the first operand beside
   ``torch.linalg.eigh`` (cuSOLVER) on it, and at order 256 a batch of the
   first ten; with the invariants (||V diag(w) V^T - A|| / ||A||,
   ||V^T V - I||_max, the eigenvalues against LAPACK's on the CPU) and the
   sweeps; where the checkout has ``kernels.j2_plan``'s regimes, the
   element rule and the order's own regime (blocks of 16 from
   ``J2_BLOCK_FROM``) the same way with their clock stamps
   (``kernels.jacobi_eigh_stamps``: cycles of CTA 0's thread 0 by part);
   ``--j2-orders`` adds synthetic operands at other orders (chip_smoke.py's
   ``jacobi_operand``: a pencil with a cluster of eigenvalues near 0, the
   solve's orders lie between) for the regimes' crossover.  ``--j2-only``
   runs step 3 alone (and the solve's wall).
4. ``--j1-only``: J1 (``kernels.jacobi_orthogonalise``) the same way, alone:
   the change records the first J1_RECORD calls of every order of its solve
   (``--dim 10 --seed 41`` gives the census's orders 60-72; ``--profile
   f32`` solves the f32 profile, tools/jacobi_census.py's, whose orders
   reach past 118), the parent
   factors them (bits of w @ v, v and the norms reported), and every time
   worker times, at each order, the checkout's J1 on the first operand
   beside ``torch.linalg.svd`` (cuSOLVER), with the invariants
   (``checks.kernel_errors``) and the sweeps; where the checkout has
   ``kernels.j1_plan``'s regimes, the element regime (to
   ``J1_ELEMENT_MAX_N``) and the block regime the same way with their
   clock stamps (``kernels.jacobi_svd_stamps``);
   ``--j1-orders`` adds synthetic operands (chip_smoke.py's
   ``jacobi_operand``: r2^T of a matrix with singular values from 1 to
   1e-12).  No solve in the time workers.

Prints one JSON line per step.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Panels K3 is timed at: the d8 solve's smallest and largest, the R = 16 and
# R = 32 rungs' (4R, R + 2), and the largest of the reference's envelope.
K3_SHAPES = ((24, 6), (40, 10), (64, 18), (128, 34), (512, 128))

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# J2 operands recorded of each order (the batch row stacks ten of order 256).
J2_RECORD = 10
J2_BATCH = (10, 256)
J1_RECORD = 10


# ---------------------------------------------------------------------------
# Workers (run with --root: import the package from there)
# ---------------------------------------------------------------------------

def _solve(dim, seed, profile="f64"):
    """MaxCut d<dim> seed <seed> on the card: chip_smoke.py's solve, or with
    ``profile`` "f32" tools/jacobi_census.py's solve of the f32 profile."""
    sys.path.append(HERE)  # chip_smoke's config reader and solve routine
    import chip_smoke
    import torch

    if profile == "f32":
        from ttipm_tpu_torch.tools.jacobi_census import census

        res = census(dim, seed, torch.device("cuda"), profile="f32")
        return {"iters": res["iters"], "slack": res["slackness"], "wall_s": res["wall_s"]}
    settings = chip_smoke.ipm_settings(chip_smoke.load_config(dim))
    return chip_smoke.solve(dim, seed, torch.device("cuda"), settings)


def worker_record(args):
    """Solve on the change, keep the first call of every distinct shape."""
    import torch

    from ttipm_tpu_torch.checks import shape_key
    from ttipm_tpu_torch.ops import kernels as K

    def cpu(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().contiguous()
        if isinstance(a, (list, tuple)):
            return [cpu(x) for x in a]
        return a

    names = ("kkt_block_product", "kkt_block_matvec", "schur_assemble_group", "schur_assemble",
             "panel_qr", "jacobi_eigh_core")
    if args.j2_only:
        names = ("jacobi_eigh_core",)
    if args.j1_only:
        names = ("jacobi_orthogonalise",)
    seen, calls = {}, []
    originals = {n: getattr(K, n) for n in names}

    def recorder(name):
        def wrapped(*a, **kw):
            out = originals[name](*a, **kw)
            key = (name, shape_key(a), str(kw))
            seen[key] = seen.get(key, 0) + 1
            if seen[key] <= {"jacobi_eigh_core": J2_RECORD,
                             "jacobi_orthogonalise": J1_RECORD}.get(name, 1):
                calls.append((name, cpu(a), kw, cpu(out)))
            return out
        return wrapped

    for n in names:
        setattr(K, n, recorder(n))
    res = _solve(args.dim, args.seed, args.profile)
    torch.save(calls, args.file)
    print(json.dumps({"recorded": len(calls), "iters": res["iters"], "slack": res["slack"]}))


def worker_replay(args):
    """The recorded calls through this root's single-call kernels."""
    import torch

    from ttipm_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    calls = torch.load(args.file, weights_only=False)
    report = {}
    for name, a, kw, want in calls:
        def cu(t):
            return t.to(dev)
        if name == "jacobi_eigh_core":  # the eigenvalues (the parent's entry takes no flag)
            got = K.jacobi_eigh_core(cu(a[0]))[0]
            want = want[0]
        elif name == "jacobi_orthogonalise":
            try:
                got = torch.cat([t.reshape(-1) for t in K.jacobi_orthogonalise(cu(a[0]))])
            except K.KernelError:  # an order outside this checkout's envelope
                r = report.setdefault(name, {"shapes": 0, "bit_equal": 0, "max_abs_diff": 0.0})
                r["refused"] = r.get("refused", 0) + 1
                continue
            want = torch.cat([t.reshape(-1) for t in want])
        elif name == "panel_qr":  # the parent's entry takes the panel alone
            q, r = K.panel_qr(cu(a[0]))
            got = torch.cat([q.T.reshape(-1) if kw.get("transposed") else q.reshape(-1),
                             r.reshape(-1)])
            want = torch.cat([t.reshape(-1) for t in want])
        elif name == "kkt_block_product":
            terms, nrows = a
            rows = [None] * nrows
            for pl, A, pr, x, row in terms:
                y = K.kkt_block_matvec(cu(pl), cu(A), cu(pr), cu(x))
                rows[row] = y if rows[row] is None else rows[row] + y
            got = torch.stack(rows, dim=1)
        elif name == "kkt_block_matvec":
            got = K.kkt_block_matvec(*(cu(t) for t in a))
        elif name == "schur_assemble_group":
            got = torch.stack([K.schur_assemble(*(cu(t) for t in b)) for b in a[0]])
            want = torch.stack(list(want))
        else:
            got = K.schur_assemble(*(cu(t) for t in a))
        r = report.setdefault(name, {"shapes": 0, "bit_equal": 0, "max_abs_diff": 0.0})
        r["shapes"] += 1
        r["bit_equal"] += int(torch.equal(got.cpu(), want))
        diff = (got.cpu() - want).abs()
        r["max_abs_diff"] = max(r["max_abs_diff"], float(diff[torch.isfinite(diff)].max())
                                if bool(torch.isfinite(diff).any()) else 0.0)
    print(json.dumps({"bits": report}))


def _device_kernels(fn):
    """(device kernels, summed device microseconds) of one call; traced
    again, up to three times, when the trace comes back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            break
    return len(ev), float(sum(e.time_range.elapsed_us() for e in ev))


def _k3_stamps(K, a):
    """Median cycles of K3's phases on the contiguous panel ``a`` from the
    kernel's own clock stamps, or None where the checkout's library has no
    ``ttipm_panel_qr_stamps(a, q, r, m, n, ctas, threads, ws, stamps,
    stream)`` (six stamps: start, loaded, forward chain done, R stored, Q
    chain done, stored)."""
    import ctypes

    import torch

    lib = K._lib()
    if not hasattr(lib, "ttipm_panel_qr_stamps"):
        return None
    fn = lib.ttipm_panel_qr_stamps
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, p, p, i, i, i, i, p, p, p], i
    m, n = a.shape
    ctas, threads, ws_doubles = K.k3_plan(m, n)[:3] if hasattr(K, "k3_plan") else (1, 256, 0)
    q, r = torch.empty_like(a), a.new_empty((n, n))
    ws = a.new_empty(max(ws_doubles, 1))
    stamps = torch.zeros(6 + 2 * n, dtype=torch.int64, device=a.device)
    runs = []
    for _ in range(7):
        err = fn(a.data_ptr(), q.data_ptr(), r.data_ptr(), m, n, ctas, threads, ws.data_ptr(),
                 stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"ttipm_panel_qr_stamps: CUDA error {err}")
        runs.append(np.diff(stamps.cpu().numpy()[:6]))
    med = np.median(np.array(runs[2:]), axis=0)
    return dict(zip(("load", "forward", "r_store", "q_chain", "store"), map(float, med)))


def _j2_invariants(x, w, v):
    """||V diag(w) V^T - A|| / ||A||, ||V^T V - I||_max and the eigenvalues
    against LAPACK's (CPU, f64) relative to the largest, the worst
    instance."""
    import torch

    xc, wc, vc = x.cpu(), w.cpu(), v.cpu()
    ref = torch.linalg.eigvalsh(xc)
    eye = torch.eye(x.shape[-1], dtype=x.dtype)
    fact = torch.linalg.norm(vc @ torch.diag_embed(wc) @ vc.mT - xc, dim=(1, 2)) / \
        torch.linalg.norm(xc, dim=(1, 2))
    return {"fact": float(fact.max()), "orth": float((vc.mT @ vc - eye).abs().max()),
            "values": float(((wc - ref).abs() / ref.abs().amax(1, keepdim=True)).max())}


def j2_rows(K, calls, single_ms, orders=()):
    """Step 3's rows of one checkout: per recorded order, J2 as the
    checkout runs it and every regime of its plan, beside cuSOLVER; then
    the same on a synthetic operand of each of ``orders``."""
    import torch

    sys.path.append(HERE)
    from chip_smoke import jacobi_operand

    dev = torch.device("cuda")
    by_order = {}
    for name, a, kw, _ in calls:
        if name == "jacobi_eigh_core":
            by_order.setdefault(a[0].shape[-1], []).append(a[0].to(dev))
    todo = [(n, ops, "single") for n, ops in sorted(by_order.items())]
    todo += [(n, [jacobi_operand("jacobi_eigh_core", 1, n, np.random.RandomState(n), dev)],
              "synthetic") for n in orders]
    rows = []
    for n, ops, kind in todo:
        cases = [(kind, ops[0])]
        if n == J2_BATCH[1] and len(ops) >= J2_BATCH[0]:
            cases.append(("batch", torch.cat(ops[:J2_BATCH[0]])))
        for label, x in cases:
            row = {"order": n, "case": label, "B": x.shape[0],
                   "library_ms": single_ms(lambda: torch.linalg.eigh(x), runs=10),
                   "ms": single_ms(lambda: K.jacobi_eigh_core(x), runs=10)}
            w, v = K.jacobi_eigh_core(x)
            row.update(_j2_invariants(x, w, v))
            row["sweeps"] = K.jacobi_sweeps("jacobi_eigh_core", x).tolist()
            if hasattr(K, "jacobi_eigh_stamps"):
                plans = {0: K.j2_plan(n, element=True), K.j2_plan(n)[0]: K.j2_plan(n)}
                row["default_plan"] = list(K.j2_plan(n))
                row["regimes"] = {}
                for blk, plan in plans.items():
                    r = {"ms": single_ms(lambda: K._j2_launch(x, plan=plan), runs=10)}
                    w, v = K._j2_launch(x, plan=plan)
                    r.update(_j2_invariants(x, w, v))
                    count = torch.empty((x.shape[0],), dtype=torch.int32, device=dev)
                    K._j2_launch(x, count, vectors=False, plan=plan)
                    r["sweeps"] = count.tolist()
                    if x.shape[0] == 1:
                        r["stamps"] = K.jacobi_eigh_stamps(x, plan)
                    row["regimes"][blk] = r
            rows.append(row)
    return rows


def j1_rows(K, calls, single_ms, orders=()):
    """Step 4's rows of one checkout: per recorded order, J1 as the
    checkout runs it and, where it has them, each regime, beside cuSOLVER;
    then the same on a synthetic operand of each of ``orders``."""
    import torch

    from ttipm_tpu_torch.checks import kernel_errors

    sys.path.append(HERE)
    from chip_smoke import jacobi_operand

    dev = torch.device("cuda")
    by_order = {}
    for name, a, kw, _ in calls:
        if name == "jacobi_orthogonalise":
            by_order.setdefault(a[0].shape[-1], []).append(a[0].to(dev))
    todo = [(n, ops[0], "single", len(ops)) for n, ops in sorted(by_order.items())]
    todo += [(n, jacobi_operand("jacobi_orthogonalise", 1, n, np.random.RandomState(n), dev),
              "synthetic", 1) for n in orders]
    regimes = hasattr(K, "jacobi_svd_stamps")
    rows = []
    for n, x, kind, recorded in todo:
        row = {"order": n, "case": kind, "recorded": recorded,
               "library_ms": single_ms(lambda: torch.linalg.svd(x), runs=10)}
        try:
            row["ms"] = single_ms(lambda: K.jacobi_orthogonalise(x), runs=10)
            out = K.jacobi_orthogonalise(x)
            row["sweeps"] = K.jacobi_sweeps("jacobi_orthogonalise", x).tolist()
        except K.KernelError as e:  # outside the checkout's envelope
            row["refused"] = str(e)[:120]
            out = None
        if out is not None:
            errs = kernel_errors("jacobi_orthogonalise", (x,), out)
            row.update({k: errs[k] for k in ("values", "fact", "orth", "cosine") if k in errs})
        if regimes:
            row["default_plan"] = list(K.j1_plan(n))
            plans = {"element": (K.j1_plan(n, element=True) if n <= K.J1_ELEMENT_MAX_N
                                 else None),
                     "block": K.j1_plan(n, block=True)}
            row["regimes"] = {}
            for label, plan in plans.items():
                if plan is None:
                    continue
                r = {"ms": single_ms(lambda: K._j1_launch(x, plan=plan), runs=10)}
                errs = kernel_errors("jacobi_orthogonalise", (x,), K._j1_launch(x, plan=plan))
                r.update({k: errs[k] for k in ("values", "fact", "orth", "cosine") if k in errs})
                count = torch.empty((1,), dtype=torch.int32, device=dev)
                K._j1_launch(x, count, plan=plan)
                r["sweeps"] = count.tolist()
                r["stamps"] = K.jacobi_svd_stamps(x, plan)
                row["regimes"][label] = r
        rows.append(row)
    return rows


def worker_time(args):
    import torch

    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.solvers import fused_algebra as fa

    if hasattr(fa, "local_product"):  # a checkout with the single-instance algebra
        local_product = fa.local_product
    else:
        from ttipm_tpu_torch.solvers import fused_batch as fb

        def local_product(pl, A, pr, x):
            return fb.local_product(*fb.batch_of_one((pl, A, pr, x)))

    dev = torch.device("cuda")
    rng = np.random.RandomState(7)

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), device=dev)

    def single_ms(fn, runs=30):
        for _ in range(5):
            fn()
        out = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out))

    def back_to_back_ms(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    rows = []
    if args.j1_only:
        calls = torch.load(args.file, weights_only=False)
        orders = [int(n) for n in args.j1_orders.split(",")] if args.j1_orders else []
        print(json.dumps({"j1": j1_rows(K, calls, single_ms, orders)}))
        return
    if args.file:
        calls = torch.load(args.file, weights_only=False)
        orders = [int(n) for n in args.j2_orders.split(",")] if args.j2_orders else []
        j2 = j2_rows(K, calls, single_ms, orders)
    if args.j2_only:
        res = _solve(args.dim, args.seed)
        print(json.dumps({"j2": j2, "solve": {k: res[k] for k in ("iters", "slack", "wall_s")}}))
        return
    for R, s in ((8, 4), (32, 9)):
        keys = ("00", "01", "12", "21", "22")
        pl = {k: t(R, s, R) for k in keys}
        A = {k: t(s, 4, 4, s) for k in keys}
        pr = {k: t(R, s, R) for k in keys}
        x = t(R, 3, 4, R)
        x0 = x[:, 0].contiguous()
        blocks = [(pl[k], A[k], pr[k]) for k in ("21", "01", "22", "00")]
        if hasattr(K, "schur_assemble_group"):
            def factor_blocks():
                return K.schur_assemble_group(blocks)
        else:
            def factor_blocks():
                return [K.schur_assemble(*b) for b in blocks]
        cases = {
            "block_matvec": lambda: K.kkt_block_matvec(pl["00"], A["00"], pr["00"], x0),
            "schur_block": lambda: K.schur_assemble(pl["00"], A["00"], pr["00"]),
            "local_product": lambda: local_product(pl, A, pr, x),
            "factor_blocks": factor_blocks,
        }
        for name, fn in cases.items():
            n_dev, dev_us = _device_kernels(fn)
            rows.append({"case": name, "R": R, "s": s, "single_ms": single_ms(fn),
                         "back_to_back_ms": back_to_back_ms(fn, 200 if R == 8 else 50),
                         "device_kernels": n_dev, "device_us": dev_us})
    for m, n in K3_SHAPES:
        a = t(m, n)
        row = {"case": "panel_qr", "m": m, "n": n,
               "library_ms": single_ms(lambda: torch.linalg.qr(a, mode="reduced"))}
        try:
            K.panel_qr(a)
            torch.cuda.synchronize()
        except K.KernelError as e:  # a checkout whose kernel does not take the panel
            row["refused"] = str(e)[:120]
            rows.append(row)
            continue
        n_dev, dev_us = _device_kernels(lambda: K.panel_qr(a))
        row.update({"single_ms": single_ms(lambda: K.panel_qr(a)),
                    "back_to_back_ms": back_to_back_ms(lambda: K.panel_qr(a)),
                    "device_kernels": n_dev, "device_us": dev_us,
                    "stamps": _k3_stamps(K, a)})
        rows.append(row)
    res = _solve(args.dim, args.seed)
    print(json.dumps({"times": rows, "j2": j2 if args.file else None,
                      "solve": {k: res[k] for k in ("iters", "slack", "wall_s")}}))


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

def run_worker(root, mode, args, file=None):
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", mode, "--root", root,
           "--dim", str(args.dim), "--seed", str(args.seed)]
    if file:
        cmd += ["--file", file]
    if args.j2_only:
        cmd += ["--j2-only"]
    if args.j2_orders:
        cmd += ["--j2-orders", args.j2_orders]
    if args.j1_only:
        cmd += ["--j1-only", "--profile", args.profile]
    if args.j1_orders:
        cmd += ["--j1-orders", args.j1_orders]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"worker {mode} in {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--worker", choices=("record", "replay", "time"))
    ap.add_argument("--root")
    ap.add_argument("--file")
    ap.add_argument("--j2-only", action="store_true", help="J2 alone (step 3)")
    ap.add_argument("--j2-orders", default="",
                    help="comma-separated orders of synthetic J2 operands (step 3)")
    ap.add_argument("--j1-only", action="store_true", help="J1 alone (step 4)")
    ap.add_argument("--profile", default="f64", choices=("f64", "f32"),
                    help="the recorded solve's profile (step 4)")
    ap.add_argument("--j1-orders", default="",
                    help="comma-separated orders of synthetic J1 operands (step 4)")
    args = ap.parse_args(argv)
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.root))
        {"record": worker_record, "replay": worker_replay, "time": worker_time}[args.worker](args)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    parent = os.path.abspath(args.parent)
    with tempfile.TemporaryDirectory() as tmp:
        file = os.path.join(tmp, "calls.pt")
        print(json.dumps({"change": run_worker(HERE, "record", args, file)}), flush=True)
        print(json.dumps({"parent": run_worker(parent, "replay", args, file)}), flush=True)
        for who, root in (("parent", parent), ("change", HERE), ("change", HERE),
                          ("parent", parent)):
            print(json.dumps({who: run_worker(root, "time", args, file)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
