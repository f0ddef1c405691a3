"""The f32 profile's upcasts, taken out one at a time: maxcut d8 seed 319.

    python ttipm_tpu_torch/tools/f32_repairs.py [--dim 8 --seed 319 --device cuda]
        [--variants shipped,native_linalg,...] [--instance_only]

Under the float32 profile the port departs from plain float32 in three
places (ROADMAP Queue 3):

* ``linalg``: the SVDs, QRs and symmetric eigensolves of f32 operands run
  in f64 and are rounded back (``ops/linalg.py``); the JAX package's host
  engine calls numpy's f32 LAPACK;
* ``fits``: the ALS product fits of f32 trains run in f64 and are rounded
  back (``ops/products.py``), as the JAX package's host fits turn f64;
* ``instance``: ``create_problem(..., dtype=float32)`` builds the f64
  instance and rounds it (``models/maxcut.py``); the JAX package builds it
  in f32.

The script solves the f32 cell (chip_smoke.py's phase 9: the profile of
``scripts/f32_repro.py`` with its settings, rank bucket 4, through the
runner's ``run_and_record``) as shipped, with each of the three taken
out, and with all three out, each variant in a process of its own.  A
variant takes an upcast out by putting the undecorated function (its
``__wrapped__``) in place of the decorated one in every module of the
port, or by building the instance with ``maxcut.build_problem`` in f32.
Prints one JSON line per variant: iterations, slackness, feasibility
errors, whether the solve converged (each below ``abs_tol``), its wall,
the fused ladder's exhaustions and the final ranks of X, and for the
f32-built instance how far its objective lies from the rounded f64 one
(``--instance_only``: that distance alone, no solve).  The walls include
the f64 work of the upcasts a variant keeps.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UPCASTS = {
    "linalg": ("ttipm_tpu_torch.ops.linalg",
               ("safe_svd", "svd_econ", "safe_eigh", "safe_eigvalsh", "qr_econ")),
    "fits": ("ttipm_tpu_torch.ops.products",
             ("tt_approx_mat_mat_mul", "tt_approx_mat_vec_mul")),
}
VARIANTS = {
    "shipped": (),
    "native_linalg": ("linalg",),
    "native_fits": ("fits",),
    "f32_instance": ("instance",),
    "all_native": ("linalg", "fits", "instance"),
}
SETTINGS = {"max_iter": 22, "gap_tol": 3e-4, "op_tol": 1e-4, "abs_tol": 1e-3,
            "warm_up": 3, "mals_restarts": 2, "max_refinement": 5, "lambdaStar": 1.0}


def _unwrap(module_name, names):
    """Put each function's undecorated version in every module of the
    port that holds the decorated one (every module imported first)."""
    import importlib
    import pkgutil

    import ttipm_tpu_torch

    for info in pkgutil.walk_packages(ttipm_tpu_torch.__path__, "ttipm_tpu_torch."):
        if ".tools" not in info.name:
            importlib.import_module(info.name)
    module = importlib.import_module(module_name)
    for name in names:
        fn = getattr(module, name)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("ttipm_tpu_torch"):
                for attr, value in list(vars(mod).items()):
                    if value is fn:
                        setattr(mod, attr, fn.__wrapped__)


def run_variant(variant, dim, seed, device, instance_only=False):
    sys.path.insert(0, ROOT)
    import torch

    import ttipm_tpu_torch.ipm as ipm
    from ttipm_tpu_torch import config as tconfig
    from ttipm_tpu_torch.models import maxcut
    from ttipm_tpu_torch.ops.tt import tt_norm, tt_sub
    from ttipm_tpu_torch.solvers.amen import AmenRestartsExhausted
    from ttipm_tpu_torch.utils import runner

    out = {"variant": variant, "takes_out": list(VARIANTS[variant]), "dim": dim, "seed": seed}
    if device == "cuda":
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    tconfig.set_dtype(torch.float32)
    tconfig.set_eigen_dtype("native")
    tconfig.set_mixed_local("f64")
    tconfig.set_rank_bucket(4)
    for unit in VARIANTS[variant]:
        if unit in UPCASTS:
            _unwrap(*UPCASTS[unit])
    make = maxcut.create_problem
    if "instance" in VARIANTS[variant]:
        make = maxcut.build_problem
        np.random.seed(seed)
        own = make(dim, 1, device=device, dtype=torch.float32)
        np.random.seed(seed)
        rounded = maxcut.create_problem(dim, 1, device=device, dtype=torch.float32)
        out["instance_rel_diff"] = float(tt_norm(tt_sub(own[0], rounded[0]))
                                         / tt_norm(rounded[0]))
    if instance_only:
        return out

    fused, exhausted = ipm.tt_restarted_block_amen_fused, [0]

    def counted(*a, **kw):
        try:
            return fused(*a, **kw)
        except AmenRestartsExhausted:
            exhausted[0] += 1
            raise

    ipm.tt_restarted_block_amen_fused = counted
    config = runner.load_yaml(os.path.join(ROOT, "configs", f"maxcut_{dim}.yaml"))
    config.update(SETTINGS, verbose=False)
    args = argparse.Namespace(device=device, track_mem=device == "cuda", rank=1)
    rec = runner.new_record(1, runner.bond_count("maxcut", dim))
    t0 = time.perf_counter()
    try:
        runner.run_and_record(seed, 0, 1, config, args, make, rec)
    except Exception as exc:  # a native factorization may raise: reported
        out.update(error=f"{type(exc).__name__}: {exc}", s=time.perf_counter() - t0)
        return out
    metrics = {"slack": float(rec["complementary_slackness"][0]),
               "primal_feas": float(rec["feasibility_errors"][0]),
               "dual_feas": float(rec["dual_feasibility_errors"][0])}
    out.update(iters=int(rec["num_iters"][0]), **metrics,
               converged=max(metrics.values()) < float(config["abs_tol"]),
               wall_s=float(rec["runtimes"][0]), fused_exhausted=exhausted[0],
               ranksX=[int(r) for r in rec["ranksX"][0]])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=319)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--instance_only", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # a worker: this variant only
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_variant(args.one, args.dim, args.seed, args.device,
                                     args.instance_only)), flush=True)
        return 0
    rc = 0
    for variant in args.variants.split(","):
        if variant not in VARIANTS:
            ap.error(f"unknown variant {variant}: one of {sorted(VARIANTS)}")
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", variant, "--dim",
             str(args.dim), "--seed", str(args.seed), "--device", args.device]
            + ["--instance_only"] * args.instance_only,
            capture_output=True, text=True)
        lines = done.stdout.strip().splitlines()
        print(lines[-1] if done.returncode == 0 and lines else json.dumps(
            {"variant": variant, "rc": done.returncode, "stderr": done.stderr[-2000:]}),
            flush=True)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
