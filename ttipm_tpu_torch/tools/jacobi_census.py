"""The Jacobi factorizations of a MaxCut solve: calls, sweeps, failures.

Solves maxcut at each ``--cells`` dim:seed and records every call of the
Jacobi cores J1 (``kernels.jacobi_orthogonalise``) and J2
(``kernels.jacobi_eigh_core``): the instances, the sweeps each needed (a
histogram), the instances that came out NaN, and those of them whose
operand was finite (a non-converged factorization: the operand is saved
to ``--out`` as ``nan_<core>_<dim>_<seed>.pt``, at most six a core, for a
replay of the plain version on the CPU), and the instances and sweeps by
order (``by_order``: J1's operand order, J2's; J2's block regime counts
outer sweeps).  ``--route cusolver`` runs the solve with
``jacobi.forced(False)`` (torch.linalg on the card) for its iterations
and wall; ``--eigh-floor`` / ``--svd-floor`` override
``jacobi.EIGH_FLOOR`` / ``SVD_FLOOR`` for the run.  J2's regime for the
run: ``--j2-from`` overrides ``kernels.J2_BLOCK_FROM`` (the order from
which J2 takes its block regime; above ``J2_MAX_N``: the element regime
throughout), ``--j2-to`` gives the element regime again from that order
on, and ``--j2-calls values`` (``vectors``) keeps the block regime to the
calls without (with) eigenvectors; ``--j1-from`` overrides
``kernels.J1_BLOCK_FROM`` (J1's; above ``J1_MAX_N``: the element regime
to ``J1_ELEMENT_MAX_N``).  ``--checkpoints DIR`` writes the iterates of
every iteration to ``DIR/iter_<k>.npz`` (``utils/checkpoint.py``'s
layout) and the Newton solvers' outcomes (``tools/replay_step.py``'s
record: the fused ladder's, each tagged with the last checkpoint written
before it) to ``DIR/ladder.json``; the solve's line gives the iterations
whose ladder exhausted and the ragged AMEn's outcomes.  ``--check`` holds every J2 call's
finite instances to ``torch.linalg.eigvalsh``'s eigenvalues (relative to
the largest) and, with V, to ||V diag(w) V^T - A|| / ||A|| and
||V^T V - I||_max, the worst of each by order (``by_order[n]["check"]``).
``--profile f32`` runs
chip_smoke.py's phase 9 settings (the f32 profile, rank bucket 4).  One
JSON line a solve: iterations, slackness, wall (synchronised; the
recording reads each call's sweeps back, so the wall is not the solve's
own), and the two cores' records.  The problem is built on the default
route before the solve (so ``--route cusolver`` records that build's
factorizations).  The first line names the device.

    python -m ttipm_tpu_torch.tools.jacobi_census --cells 10:41,8:24
    python -m ttipm_tpu_torch.tools.jacobi_census --cells 3:319 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import Counter

import torch

from ttipm_tpu_torch.tools.bench import device_line
from ttipm_tpu_torch.tools.replay_step import profile_config, profile_settings


def _j2_check(x, out):
    """The worst invariants of a J2 output over the instances whose operand
    and output are finite: eigenvalues against ``torch.linalg.eigvalsh``'s
    (relative to the largest), and with V the factorization and
    orthogonality; None where no instance is."""
    w, v = out[0], out[1]
    ok = torch.isfinite(x.reshape(x.shape[0], -1)).all(1) & torch.isfinite(w).all(1)
    if not bool(ok.any()):
        return None
    x, w = x[ok], w[ok]
    ref = torch.linalg.eigvalsh(x)
    errs = {"values": float(((w - ref).abs() / ref.abs().amax(1, keepdim=True)
                             .clamp_min(1e-300)).max())}
    if v is not None:
        v = v[ok]
        res = torch.linalg.norm(v @ torch.diag_embed(w) @ v.mT - x, dim=(1, 2))
        errs["fact"] = float((res / torch.linalg.norm(x, dim=(1, 2)).clamp_min(1e-300)).max())
        eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
        errs["orth"] = float((v.mT @ v - eye).abs().max())
    return errs


class _Recorder:
    """Wraps ``kernels.jacobi_orthogonalise`` / ``jacobi_eigh_core`` for a
    solve: each call is made again through ``kernels.jacobi_sweeps`` (no
    counter moves) for its sweeps.  ``block_from(n, vectors)``: the
    ``kernels.J2_BLOCK_FROM`` a J2 call runs under; ``check``: hold J2's
    outputs to their invariants (``_j2_check``)."""

    def __init__(self, out_dir, tag, block_from=None, check=False):
        self.out_dir, self.tag, self.cores = out_dir, tag, {}
        self.block_from, self.check = block_from, check

    def wrap(self, kernels, entry, core):
        fn = getattr(kernels, entry)

        def wrapped(x, **kw):
            if core == "eigh" and self.block_from is not None:
                kernels.J2_BLOCK_FROM = self.block_from(x.shape[-1], kw.get("vectors", True))
                kernels.j2_plan.cache_clear()
            out = fn(x, **kw)
            sweeps = kernels.jacobi_sweeps(entry, x).tolist()
            rec = self.cores.setdefault(core, {"instances": 0, "nan": 0, "nan_finite_operand": 0,
                                               "sweeps": Counter(), "saved": [], "by_order": {}})
            order = rec["by_order"].setdefault(x.shape[-1], {"calls": 0, "instances": 0,
                                                             "sweeps": Counter()})
            order["calls"] += 1
            order["instances"] += len(sweeps)
            order["sweeps"].update(sweeps)
            errs = _j2_check(x, out) if core == "eigh" and self.check else None
            for k, e in (errs or {}).items():
                worst = order.setdefault("check", {})
                worst[k] = max(worst.get(k, 0.0), e)
            nan = torch.isnan(out[0].reshape(out[0].shape[0], -1)).any(1).tolist()
            finite = torch.isfinite(x.reshape(x.shape[0], -1)).all(1).tolist()
            rec["instances"] += len(sweeps)
            rec["sweeps"].update(sweeps)
            for i, (bad, ok) in enumerate(zip(nan, finite)):
                rec["nan"] += int(bad)
                if bad and ok:
                    rec["nan_finite_operand"] += 1
                    if len(rec["saved"]) < 6:
                        rec["saved"].append(x[i].detach().cpu())
            return out
        return wrapped

    def report(self):
        out = {}
        for core, rec in self.cores.items():
            if rec["saved"]:
                os.makedirs(self.out_dir, exist_ok=True)
                torch.save(rec["saved"], os.path.join(self.out_dir, f"nan_{core}_{self.tag}.pt"))
            out[core] = {"instances": rec["instances"], "nan": rec["nan"],
                         "nan_finite_operand": rec["nan_finite_operand"],
                         "sweeps": sorted(rec["sweeps"].items()),
                         "by_order": {n: {"calls": o["calls"], "instances": o["instances"],
                                          "sweeps": sorted(o["sweeps"].items()),
                                          **({"check": o["check"]} if "check" in o else {})}
                                      for n, o in sorted(rec["by_order"].items())}}
        return out


def census(dim, seed, device, route="jacobi", profile="f64", eigh_floor=None, svd_floor=None,
           out_dir="results/jacobi_census", j2_from=None, j2_to=None, j2_calls="all",
           check=False, j1_from=None, checkpoints=None):
    from contextlib import nullcontext

    import ttipm_tpu_torch.utils.checkpoint as ck
    from ttipm_tpu_torch import ipm
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import jacobi
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.ops.tt import tt_inner_prod
    from ttipm_tpu_torch.utils.runner import seeded_problem

    settings = profile_settings(dim, profile)
    saved = {"entries": (K.jacobi_orthogonalise, K.jacobi_eigh_core),
             "floors": (jacobi.EIGH_FLOOR, jacobi.SVD_FLOOR), "j2_from": K.J2_BLOCK_FROM, "j1_from": K.J1_BLOCK_FROM, "save": ck.save_ipm_checkpoint}
    first = saved["j2_from"] if j2_from is None else j2_from
    block_from = None
    if j2_to is not None or j2_calls != "all":
        def block_from(n, vectors):
            within = n < (K.J2_MAX_N + 2 if j2_to is None else j2_to)
            takes = j2_calls == "all" or (j2_calls == "vectors") == vectors
            return first if within and takes else K.J2_MAX_N + 2
    rec = _Recorder(out_dir, f"{dim}_{seed}", block_from, check)
    K.jacobi_orthogonalise = rec.wrap(K, "jacobi_orthogonalise", "svd")
    K.jacobi_eigh_core = rec.wrap(K, "jacobi_eigh_core", "eigh")
    jacobi.EIGH_FLOOR = saved["floors"][0] if eigh_floor is None else eigh_floor
    jacobi.SVD_FLOOR = saved["floors"][1] if svd_floor is None else svd_floor
    K.J2_BLOCK_FROM = first
    K.j2_plan.cache_clear()
    K.J1_BLOCK_FROM = saved["j1_from"] if j1_from is None else j1_from
    K.j1_plan.cache_clear()
    solvers, kw = nullcontext({}), {}
    if checkpoints is not None:
        from ttipm_tpu_torch.tools.replay_step import record_solver

        os.makedirs(checkpoints, exist_ok=True)
        events = {"ladder": [], "ragged": [], "step": None, "iteration": 0}

        def per_iteration(path, *a, iteration=0, **kws):
            saved["save"](os.path.join(checkpoints, f"iter_{iteration:02d}.npz"), *a,
                          iteration=iteration, **kws)
            events["iteration"] = iteration

        ck.save_ipm_checkpoint = per_iteration
        solvers = record_solver(ipm, rec=events, stop_after_step=False)
        kw = {"checkpoint_path": os.path.join(checkpoints, "last.npz"), "checkpoint_every": 1}
    try:
        with profile_config(profile):
            lag, obj, L, b, _ = seeded_problem(create_problem, dim, 1, seed, device)
            t0 = time.perf_counter()
            with jacobi.forced(False if route == "cusolver" else True if device.type == "cpu"
                               else None), solvers as events:
                X, _, _, Z, info = tt_ipm(lag, obj, L, b, **settings, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        K.jacobi_orthogonalise, K.jacobi_eigh_core = saved["entries"]
        jacobi.EIGH_FLOOR, jacobi.SVD_FLOOR = saved["floors"]
        K.J2_BLOCK_FROM = saved["j2_from"]
        K.j2_plan.cache_clear()
        K.J1_BLOCK_FROM = saved["j1_from"]
        K.j1_plan.cache_clear()
        ck.save_ipm_checkpoint = saved["save"]
    solver_log = {}
    if checkpoints is not None:
        with open(os.path.join(checkpoints, "ladder.json"), "w") as fh:
            json.dump(events["ladder"], fh)
        solver_log = {"ladder_exhausted_after": [e["iteration"] for e in events["ladder"]
                                                 if e.get("exhausted")],
                      "ragged": events["ragged"]}
    return {"dim": dim, "seed": seed, "route": route, "profile": profile,
            "eigh_floor": jacobi.EIGH_FLOOR if eigh_floor is None else eigh_floor,
            "svd_floor": jacobi.SVD_FLOOR if svd_floor is None else svd_floor,
            "j2_from": first, "j2_to": j2_to, "j2_calls": j2_calls,
            "j1_from": saved["j1_from"] if j1_from is None else j1_from, **solver_log,
            "wall_s": wall, "iters": int(info["num_iters"]),
            "slackness": abs(float(tt_inner_prod(X, Z))), **rec.report()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="10:41,8:24", help="dim:seed,...")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--route", default="jacobi", choices=("jacobi", "cusolver"))
    ap.add_argument("--profile", default="f64", choices=("f64", "f32"))
    ap.add_argument("--eigh-floor", type=float, default=None)
    ap.add_argument("--svd-floor", type=float, default=None)
    ap.add_argument("--j2-from", type=int, default=None)
    ap.add_argument("--j2-to", type=int, default=None)
    ap.add_argument("--j2-calls", default="all", choices=("all", "values", "vectors"))
    ap.add_argument("--j1-from", type=int, default=None)
    ap.add_argument("--checkpoints", default=None, help="directory of per-iteration checkpoints")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default="results/jacobi_census")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("jacobi_census: no CUDA device (--device cpu runs the plain versions)")
    print(device_line(device), flush=True)
    for cell in args.cells.split(","):
        dim, seed = (int(x) for x in cell.split(":"))
        print(json.dumps(census(dim, seed, device, args.route, args.profile, args.eigh_floor,
                                args.svd_floor, args.out, args.j2_from, args.j2_to,
                                args.j2_calls, args.check, args.j1_from,
                                None if args.checkpoints is None else
                                os.path.join(args.checkpoints, f"d{dim}_seed{seed}"))),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
