"""MaxCut d3 seed 319 through ``tt_ipm`` in both packages with the
whole-solve path on (``config.set_fused_whole_solve(True)``), at rank
bucket 1: every Newton solve of seven or more sweeps through the fused
AMEn program, every step-size solve through the generalised program.  In
a file of its own: the JAX package's programs take about a minute of
compiles on the CPU.  Checks: equal iterations (7) and final ranks of X
and Z, <C, X> to 1e-6 relative, and the port's slackness and
feasibilities below 1e-3.

Run as a script, one solve in each package on the CPU at rank bucket 4
(the card's) and the config's settings, with the switch on or off; one
JSON line each (iterations, ranks of X, slackness, <C, X>, seconds):

    python -m tests.test_torch_whole_solve_e2e --dim 8 --seed 24 --whole on

With ``--pencils`` the port's solve keeps every warm-started step-size
pencil, and each is then solved by the port's program, the port's host
loop and the JAX program (each from the same random state), beside the
exact step min(1, largest alpha with A + alpha Delta PSD) of the dense
pencil: one JSON line a pencil, then the count of steps off the exact one
by more than 1e-6 relative, by solver.
"""

import argparse
import json
import time

import numpy as np
import pytest

from ttipm_tpu import config as jconfig
from ttipm_tpu.ipm import tt_ipm as ipm_j
from ttipm_tpu.models.maxcut import create_problem as cp_j
from ttipm_tpu.ops import tt as J
import ttipm_tpu_torch.ipm as ipm
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.checks import solve_metrics
from ttipm_tpu_torch.ipm import tt_ipm as ipm_t
from ttipm_tpu_torch.models.maxcut import create_problem as cp_t
from ttipm_tpu_torch.ops import tt as T
from ttipm_tpu_torch.solvers import fused_eigen_batch as feb
from ttipm_tpu_torch.solvers import graphs

SETTINGS = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)


@pytest.fixture(autouse=True)
def _whole_solve():
    tconfig.set_rank_bucket(1)
    jconfig.set_fused_whole_solve(True)
    tconfig.set_fused_whole_solve(True)
    yield
    jconfig.set_fused_whole_solve(None)
    tconfig.set_fused_whole_solve(None)
    tconfig.set_rank_bucket(4)


def test_maxcut_d3_whole_solve_matches_jax(monkeypatch):
    pairs, programs, solves = [], [], []
    run, single, eigen = graphs.run, feb.gen_eigen_single, ipm.tt_max_generalised_eigen_fused
    monkeypatch.setattr(graphs, "run", lambda *a: pairs.append(a[0][0]) or run(*a))
    monkeypatch.setattr(feb, "gen_eigen_single",
                        lambda *a: programs.append(1) or single(*a))
    monkeypatch.setattr(ipm, "tt_max_generalised_eigen_fused",
                        lambda *a, **kw: solves.append(1) or eigen(*a, **kw))
    np.random.seed(319)
    obj_t, L_t, b_t, lag_t = cp_t(3, 1, device="cpu")
    X_t, Y_t, _, Z_t, info_t = ipm_t({"y": T.tt_reshape(lag_t, (4, 4))}, obj_t, L_t, b_t,
                                     **SETTINGS)
    np.random.seed(319)
    obj_j, L_j, b_j, lag_j = cp_j(3, 1)
    X_j, _, _, _, info_j = ipm_j({"y": J.tt_reshape(lag_j, (4, 4))}, obj_j, L_j, b_j,
                                 **SETTINGS)
    assert info_t["num_iters"] == info_j["num_iters"] == 7
    assert info_t["ranksX"] == info_j["ranksX"]
    assert info_t["ranksZ"] == info_j["ranksZ"]
    cx_j = J.tt_inner_prod(J.tt_reshape(obj_j, (2, 2)), X_j)
    cx_t = T.tt_inner_prod(T.tt_reshape(obj_t, (2, 2)), X_t)
    assert cx_t == pytest.approx(cx_j, rel=1e-6)
    slack, feas, dfeas = solve_metrics(X_t, Y_t, Z_t, obj_t, L_t, b_t)
    assert slack < 1e-3 and feas < 1e-3 and dfeas < 1e-3
    # every step-size solve ran the program, and pairs of both kinds ran
    assert len(programs) == len(solves) >= 2 * info_t["num_iters"]
    assert {"fused_pair", "gen_eigen_pair"} <= set(pairs)


def _solve(pkg, dim, seed, settings):
    config, ipm_fn, create, tt = ((tconfig, ipm_t, cp_t, T) if pkg == "port"
                                  else (jconfig, ipm_j, cp_j, J))
    np.random.seed(seed)
    obj, L, b, lag = create(dim, 1, device="cpu") if pkg == "port" else create(dim, 1)
    t0 = time.perf_counter()
    X, _, _, Z, info = ipm_fn({"y": tt.tt_reshape(lag, (4, 4))}, obj, L, b, **settings)
    return {"package": pkg, "whole": config.fused_whole_solve(), "dim": dim, "seed": seed,
            "iters": int(info["num_iters"]), "ranksX": [int(r) for r in info["ranksX"]],
            "slack": abs(float(tt.tt_inner_prod(X, Z))),
            "cx": float(tt.tt_inner_prod(tt.tt_reshape(obj, (2, 2)), X)),
            "seconds": time.perf_counter() - t0}


def _dense(cores):
    """The matrix of a train of (r, n, n, r') cores."""
    out = cores[0]
    for c in cores[1:]:
        a, i, j, _ = out.shape
        out = np.einsum("aijb,bklc->aikjlc", out, c).reshape(
            a, i * c.shape[1], j * c.shape[2], c.shape[3])
    return out[0, :, :, 0]


def _exact_step(A, D):
    """min(1, the largest alpha with A + alpha D PSD), A positive definite."""
    li = np.linalg.inv(np.linalg.cholesky(A))
    m = li @ D @ li.T
    lo = np.linalg.eigvalsh((m + m.T) / 2)[0]
    return 1.0 if lo >= -1.0 else -1.0 / lo


def _pencils(dim, seed, settings):
    import jax.numpy as jnp
    import torch

    from ttipm_tpu.solvers import fused_eigen as FE
    from ttipm_tpu_torch.solvers import fused_eigen as TE

    kept, eigen = [], ipm.tt_max_generalised_eigen_fused

    def keep(A, D, x0=None, **kw):
        if x0 is not None:
            kept.append(([c.numpy().copy() for c in t] for t in (A, D, x0)))
        return eigen(A, D, x0=x0, **kw)

    ipm.tt_max_generalised_eigen_fused = keep
    try:
        print(json.dumps(_solve("port", dim, seed, settings)), flush=True)
    finally:
        ipm.tt_max_generalised_eigen_fused = eigen
    whole, off = tconfig.fused_whole_solve(), {}
    jconfig.set_fused_whole_solve(True)
    for k, (A, D, x0) in enumerate(tuple(t) for t in kept):
        row = {"call": k, "exact": float(_exact_step(_dense(A), _dense(D)))}
        for label, flag in (("program", True), ("host_loop", False)):
            tconfig.set_fused_whole_solve(flag)
            row[label] = TE.tt_max_generalised_eigen_fused(
                *([torch.as_tensor(c) for c in t] for t in (A, D)),
                x0=[torch.as_tensor(c) for c in x0], tol=1e-8, rng=np.random.RandomState(k))[0]
        np.random.seed(k)
        row["jax_program"] = float(FE.tt_max_generalised_eigen_fused(
            *([jnp.asarray(c) for c in t] for t in (A, D)),
            x0=[jnp.asarray(c) for c in x0], tol=1e-8)[0])
        for label in ("program", "host_loop", "jax_program"):
            off[label] = off.get(label, 0) + int(abs(row[label] - row["exact"])
                                                 > 1e-6 * row["exact"])
        print(json.dumps(row), flush=True)
    tconfig.set_fused_whole_solve(whole)
    print(json.dumps({"pencils": len(kept), "off_the_exact_step": off}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="one solve in each package with the whole-solve "
                                             "switch (CPU)")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--whole", choices=("on", "off"), default="on")
    ap.add_argument("--package", choices=("port", "jax", "both"), default="both")
    ap.add_argument("--pencils", action="store_true",
                    help="the port's step-size pencils through three solvers (see above)")
    args = ap.parse_args(argv)
    from ttipm_tpu_torch.tools.bench import _load_config
    from ttipm_tpu_torch.utils.runner import ipm_kwargs

    settings = {**ipm_kwargs(_load_config(args.dim)), "verbose": False}
    for config in (jconfig, tconfig):
        config.set_rank_bucket(4)
        config.set_fused_whole_solve(args.whole == "on")
    if args.pencils:
        return _pencils(args.dim, args.seed, settings)
    for pkg in (("port", "jax") if args.package == "both" else (args.package,)):
        print(json.dumps(_solve(pkg, args.dim, args.seed, settings)), flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
