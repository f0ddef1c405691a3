"""Dry run of the (seeds x kkt) mesh: the production path on n ranks.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (its lines
98-200).  Spawns ``--ranks`` processes on ``--device`` (see
``parallel.mesh.rank_devices``) in a (ranks / kkt, kkt) mesh and runs,
on every rank:

1. the Newton micro-step (``sharded_newton_micro``): K1 over this rank's
   slice of the operator bond, one ``all_reduce`` over the kkt row, the
   solve; the mean residual must be finite;
2. a real maxcut d4 Newton system (seed 319, the port's capture from
   ``tt_ipm`` by ``checks.first_newton_system``) solved by the mesh batch
   (two instances a seeds row, R = 8, term_tol 1e-4, nswp 12, seed 3)
   against the single-device solver at the same settings: the JAX gate
   ``rn_mesh <= max(2 rn_single, 1e-4 ||b||)``, the residuals measured by
   ``checks.kkt_residual_norm`` (the solver's own expansion cancels to 0
   below ~1.5e-8 relative);
3. a full ``tt_newton_step_batch`` on the mesh at the captured iterates:
   step sizes finite and in (0, 1], directions finite.

Usage (CPU ranks use gloo; two ranks sharing one card need
``--backend gloo``; ranks on cards of their own default to nccl):

    python -m ttipm_tpu_torch.tools.dryrun_mesh --ranks 4 --kkt 2 --device cpu
    python -m ttipm_tpu_torch.tools.dryrun_mesh --ranks 2 --kkt 2 --device cuda:0 --backend gloo

Prints one JSON line per rank and exits non-zero if a rank fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# tt_ipm's settings of the JAX dry run's capture (__graft_entry__.py:76-81)
CAPTURE = {"dim": 4, "max_iter": 2, "gap_tol": 3e-4, "op_tol": 1e-4, "abs_tol": 1e-3,
           "warm_up": 3, "mals_restarts": 2, "max_refinement": 5, "lambdaStar": 1.0}
CAPTURE_SEED = 319


def micro_inputs(seeds: int, kkt: int, device):
    """The JAX dry run's micro-step inputs: two instances a seeds row,
    operator rank 2 per kkt rank, SPD-ish operators (RandomState(0))."""
    rng = np.random.RandomState(0)
    b, r, n, rA = seeds * 2, 3, 4, 2 * kkt
    phi_l = rng.randn(b, r, rA, r)
    A_core = rng.randn(b, rA, n, n, rA) * 0.01 + np.eye(n)[None, None, :, :, None]
    phi_r = rng.randn(b, r, rA, r)
    rhs = rng.randn(b, r, n, r)
    return tuple(torch.as_tensor(a, device=device) for a in (phi_l, A_core, phi_r, rhs))


def run_parts(mesh) -> dict:
    """The three parts on this rank; raises AssertionError where a gate
    fails."""
    from ttipm_tpu_torch.checks import first_newton_system, kkt_residual_norm
    from ttipm_tpu_torch.parallel.fused_mesh import (tt_block_amen_fused_batch,
                                                     tt_newton_step_batch)
    from ttipm_tpu_torch.parallel.mesh import sharded_newton_micro
    from ttipm_tpu_torch.solvers import fused as F

    dev = mesh.device
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape), "device": str(dev),
           "backend": mesh.backend}
    t0 = time.perf_counter()
    _, mean_res = sharded_newton_micro(mesh)(*micro_inputs(mesh.seeds, mesh.kkt, dev))
    out["micro_mean_res"] = float(mean_res)
    if not np.isfinite(out["micro_mean_res"]):
        raise AssertionError("sharded KKT micro-step produced NaNs")

    lhs, rhs, X, Z = first_newton_system("maxcut", CAPTURE, CAPTURE_SEED, dev)
    S = mesh.seeds
    xs_b, res_b = tt_block_amen_fused_batch([lhs] * S, [rhs] * S, R=8, ineq=False, mesh=mesh,
                                            term_tol=1e-4, nswp=12, seed=3)
    if not np.isfinite(res_b).all():
        raise AssertionError("mesh-batched fused solve NaN'd")
    x_s, _ = F.tt_block_amen_fused(lhs, rhs, 1e-4, 8, nswp=12, rng=np.random.RandomState(3))
    d = len(x_s)
    A, b = F.prep_operator(lhs), F.prep_rhs(rhs, d, x_s[0])
    rn_mesh = kkt_residual_norm(A, b, list(xs_b[0]))
    rn_single = kkt_residual_norm(A, b, list(x_s))
    out.update(rn_mesh=rn_mesh, rn_single=rn_single, rhs_norm=rhs.norm)
    if not rn_mesh <= max(2 * rn_single, 1e-4 * rhs.norm):
        raise AssertionError(f"mesh solve quality regressed: {rn_mesh:.3e} vs single "
                             f"{rn_single:.3e} (rhs norm {rhs.norm:.3e})")

    xsteps, zsteps, dirs = tt_newton_step_batch([(lhs, rhs)] * S, [X] * S, [Z] * S, mesh=mesh,
                                                R=8, seed=3, nswp=8)
    out.update(x_steps=list(map(float, xsteps)), z_steps=list(map(float, zsteps)))
    if not (np.isfinite(xsteps).all() and np.isfinite(zsteps).all()):
        raise AssertionError("batched Newton step produced non-finite step sizes")
    if not ((xsteps > 0).all() and (xsteps <= 1).all() and (zsteps > 0).all()
            and (zsteps <= 1).all()):
        raise AssertionError(f"steps outside (0, 1]: {xsteps} {zsteps}")
    if not all(bool(torch.isfinite(c).all()) for dd in dirs for t in dd for c in t):
        raise AssertionError("batched Newton direction has non-finite cores")
    out["wall_s"] = time.perf_counter() - t0
    out["collectives"] = mesh.stats.as_dict()
    return out


def main(argv=None) -> int:
    from ttipm_tpu_torch.parallel.mesh import spawn_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--kkt", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cpu, cuda (rank r on card r %% count) "
                                                     "or cuda:<index> (every rank on it)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu)")
    for rec in spawn_mesh(run_parts, args.ranks, args.kkt, args.device, args.backend):
        print(json.dumps(rec), flush=True)
    print("dryrun_mesh ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
