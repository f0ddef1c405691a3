"""The fused KKT solve of two checkouts of the port, bit for bit.

    python ttipm_tpu_torch/tools/compare_solves.py --parent DIR [--device cuda]
        [--cell maxcut:5:7:f64 ...]

``DIR`` holds another checkout of the repository (for example an unpacked
``git archive`` of the parent commit); the script's own checkout is "the
change".  The change captures the first Newton system of each cell of
``CELLS`` (``checks.first_newton_system``: the IPM's own assembly and
equilibration at the config's settings; the f32 cell is the f64 system
rounded to float32).  Then each checkout, in a process of its own that
imports ``ttipm_tpu_torch`` from its root, solves every system through
``solvers.fused``: the fixed-rank ``tt_block_amen_fused`` at R = 16 (eight
sweeps) and the restart ladder ``tt_restarted_block_amen_fused``, each from
a seeded RandomState.  The cores and residuals of the two are compared bit
for bit.

``--cell problem:dim:seed:dtype`` (repeated) takes other cells at the
config's settings.  Prints the package each checkout's solves imported,
then one JSON line per cell (``bit_equal``, the largest absolute difference
of a core, both residuals), and exits 1 where a solve differs.
Runs on the card by default (``--device cpu`` here).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# problem:dim:seed:dtype, the cells of chip_smoke.py's phases 5-9, and the
# settings over the config's that the phases take.
CELLS = ("maxcut:8:24:f64", "maxcut:10:41:f64", "corr_clust:6:764:f64", "graphm:2:256:f64",
         "maxcut:8:319:f32")
SETTINGS = {"graphm:2:256:f64": {"lambdaStar": 2.0, "max_refinement": 10}}


def _cells(args):
    out = []
    for cell in args.cell or CELLS:
        problem, dim, seed, dtype = cell.split(":")
        out.append((cell, problem, int(dim), int(seed), dtype))
    return out


def worker_capture(args):
    import torch

    from ttipm_tpu_torch.checks import first_newton_system
    from ttipm_tpu_torch.solvers.blocks import cast_block_matrix, cast_block_vector
    from ttipm_tpu_torch.utils.runner import load_yaml

    systems = []
    for cell, problem, dim, seed, dtype in _cells(args):
        cfg = load_yaml(os.path.join(HERE, "configs", f"{problem}_{dim}.yaml"))
        cfg.update(SETTINGS.get(cell, {}))
        lhs, rhs, _, _ = first_newton_system(problem, cfg, seed, args.device)
        if dtype == "f32":
            lhs = cast_block_matrix(lhs, torch.float32)
            rhs = cast_block_vector(rhs, torch.float32)
        systems.append((lhs, rhs))
    torch.save(systems, args.file)
    print(json.dumps({"captured": len(systems)}))


def worker_solve(args):
    import torch

    from ttipm_tpu_torch.solvers import fused as F

    systems = torch.load(args.file, map_location=args.device, weights_only=False)
    out = []
    for (_, problem, *_), (lhs, rhs) in zip(_cells(args), systems):
        ineq = problem != "maxcut"
        x, res = F.tt_block_amen_fused(lhs, rhs, 1e-6, 16, nswp=8,
                                       rng=np.random.RandomState(5), ineq=ineq)
        y, res_y = F.tt_restarted_block_amen_fused(lhs, rhs, 1000, 1e-4,
                                                   rng=np.random.RandomState(3), ineq=ineq)
        out.append({"fixed": ([c.cpu() for c in x], float(res)),
                    "ladder": ([c.cpu() for c in y], float(res_y))})
    torch.save(out, args.file + f".{args.tag}")
    print(json.dumps({"solved": len(out), "package": os.path.dirname(os.path.dirname(F.__file__))}))


def run_worker(root, mode, args, tag=""):
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", mode, "--root", root,
           "--device", args.device, "--file", args.file, "--tag", tag]
    for cell in args.cell or ():
        cmd += ["--cell", cell]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"worker {mode} in {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare(args):
    import torch

    parent, change = torch.load(args.file + ".parent"), torch.load(args.file + ".change")
    same = True
    for (cell, *_), p, c in zip(_cells(args), parent, change):
        row = {"cell": cell}
        for kind in ("fixed", "ladder"):
            (xp, rp), (xc, rc) = p[kind], c[kind]
            shapes = [tuple(t.shape) for t in xp] == [tuple(t.shape) for t in xc]
            equal = shapes and rp == rc and all(torch.equal(a, b) for a, b in zip(xp, xc))
            diff = (max(float((a.double() - b.double()).abs().max()) for a, b in zip(xp, xc))
                    if shapes else None)
            row[kind] = {"bit_equal": equal, "max_abs_diff": diff, "res_parent": rp,
                         "res_change": rc}
            same = same and equal
        print(json.dumps(row), flush=True)
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", choices=("capture", "solve"))
    ap.add_argument("--root")
    ap.add_argument("--file")
    ap.add_argument("--tag", default="")
    ap.add_argument("--cell", action="append", help="problem:dim:seed:dtype (repeated)")
    args = ap.parse_args(argv)
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.root))
        {"capture": worker_capture, "solve": worker_solve}[args.worker](args)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("compare_solves: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
            flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        args.file = os.path.join(tmp, "systems.pt")
        run_worker(HERE, "capture", args)
        for tag, root in (("parent", os.path.abspath(args.parent)), ("change", HERE)):
            print(json.dumps({tag: run_worker(root, "solve", args, tag)}), flush=True)
        return 0 if compare(args) else 1


if __name__ == "__main__":
    sys.exit(main())
