"""The port's dense baselines (``models/conic.py``, ``models/baselines.py``,
``models/riemannian.py``, ``utils/baseline_runner.py``) against the JAX
package's numpy versions, on the CPU.

* ``build_dense_problem`` gives the JAX runner's dense problem for one
  numpy seed (maxcut, corr_clust and max_stable_set at d3, graphm at n=2):
  the objective to 1e-12 relative (the two packages' TT roundings differ
  in the last digits), the masks, adjacencies, constraint lists and
  right-hand sides exactly, maxcut's selectors (a sparse tensor in the
  port) equal to the JAX runner's dense matrices.
* The SCS and SDPA encodings of those problems equal the JAX ones as dense
  arrays.
* ``solve_splitting`` (torch ``cholesky_solve`` / ``eigh``) takes the JAX
  solver's iterations to the same point (1e-10) on maxcut d3 and on
  tests/test_conic.py:178's inequality problem, and keeps its known
  defect: no converged flag, a run cut at ``max_iter`` returns as one that
  converged (ROADMAP Queue 3).
* ``cgal`` on maxcut d3 / d4 and max_stable_set d3 at the runner's
  settings: both packages end by the stop test, feasible to 1e-3, their
  objectives within the stop test's gap of each other (the gradient's
  smallest eigenvalue is degenerate on these graphs, and the two packages'
  ``eigh`` pick different vectors in its eigenspace, so the iterates part
  and may stop at different iterations).  ``cgal`` and ``sketchy_cgal``
  step for step on a generic problem: 30 iterations to 1e-10.  The
  runner's sketch size at d3 makes both packages' reconstructions fail
  alike.
* ``solve_maxcut_manopt`` / ``oblique_trust_regions`` reach the JAX
  solver's point (1e-6, objective 1e-9) on tests/test_baselines_extra.py's
  problems.
* The Lanczos of ``min_eigpair`` (the port's stand-in for ARPACK above
  order 128) matches numpy's ``eigh``: eigenvalue 1e-10 relative,
  eigenvector 1e-7 up to sign.
* The runner's ``--solver splitting --device cpu`` writes the JAX runner's
  JSON schema and values.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from ttipm_tpu.models import baselines as JBL
from ttipm_tpu.models import conic as JC
from ttipm_tpu.models import riemannian as JRM
from ttipm_tpu.utils import baseline_runner as JB
from ttipm_tpu_torch.models import baselines as TBL
from ttipm_tpu_torch.models import conic as TC
from ttipm_tpu_torch.models import riemannian as TRM
from ttipm_tpu_torch.utils import baseline_runner as TB
from ttipm_tpu_torch.utils import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(problem, dim, seed=7):
    np.random.seed(seed)
    dj = JB.build_dense_problem(problem, dim, 1)
    np.random.seed(seed)
    dt = TB.build_dense_problem(problem, dim, 1)
    return dj, dt


def _dense_constraints(c):
    return c.to_dense().numpy() if torch.is_tensor(c) else np.stack(c)


@pytest.mark.parametrize("problem,dim", [("maxcut", 3), ("corr_clust", 3),
                                         ("max_stable_set", 3), ("graphm", 2)])
def test_build_dense_problem_matches_jax(problem, dim):
    dj, dt = _both(problem, dim, seed=24)
    assert set(dj) == set(dt)
    assert np.abs(dt["C"] - dj["C"]).max() <= 1e-12 * max(np.abs(dj["C"]).max(), 1.0)
    for key in ("mask", "adj", "bias", "trace_params", "n_graph"):
        if key in dj:
            assert np.array_equal(np.asarray(dt[key]), np.asarray(dj[key])), key
    if "constraints" in dj:
        assert np.array_equal(_dense_constraints(dt["constraints"]), np.stack(dj["constraints"]))
    pj, pt = dj["conic"], dt["conic"]
    assert pt.eq_entries == pj.eq_entries and pt.eq_rhs == pj.eq_rhs
    assert pt.ineq_entries == pj.ineq_entries and pt.ineq_rhs == pj.ineq_rhs


@pytest.mark.parametrize("problem,dim", [("maxcut", 3), ("corr_clust", 3),
                                         ("max_stable_set", 3), ("graphm", 2)])
def test_encodings_match_jax(problem, dim):
    dj, dt = _both(problem, dim, seed=24)
    A_j, b_j, c_j, cone_j = JC.scs_encode(dj["conic"])
    A_t, b_t, c_t, cone_t = TC.scs_encode(dt["conic"])
    assert cone_t == cone_j
    assert np.array_equal(A_t.toarray(), A_j.toarray()) and np.array_equal(b_t, b_j)
    assert np.abs(c_t - c_j).max() <= 1e-12 * max(np.abs(c_j).max(), 1.0)
    A_j, b_j, c_j, *m_j = JC.sdpa_encode(dj["conic"])
    A_t, b_t, c_t, *m_t = TC.sdpa_encode(dt["conic"])
    assert m_t == m_j
    assert np.array_equal(A_t.toarray(), A_j.toarray()) and np.array_equal(b_t, b_j)
    assert np.abs(c_t - c_j).max() <= 1e-12 * max(np.abs(c_j).max(), 1.0)


def _ineq_problem():
    """tests/test_conic.py:178's problem."""
    rng = np.random.RandomState(11)
    A = rng.randn(6, 6)
    mask = np.zeros((6, 6))
    mask[0, 1] = mask[1, 0] = 1.0
    return JC.corr_clust_conic(0.5 * (A + A.T), mask, beta=0.1)


@pytest.mark.parametrize("case", ["maxcut_d3", "ineq"])
def test_splitting_matches_jax(case):
    if case == "ineq":
        prob, kw = _ineq_problem(), dict(tol=1e-8, max_iter=50000)
    else:
        prob, kw = _both("maxcut", 3, seed=24)[0]["conic"], dict(tol=1e-8)
    want = JC.solve_splitting(prob, **kw)
    got = TC.solve_splitting(prob, device="cpu", **kw)
    assert got["iterations"] == want["iterations"]
    assert np.abs(got["x_matrix"].numpy() - want["x_matrix"]).max() <= 1e-10
    assert got["objective"] == pytest.approx(want["objective"], rel=1e-10)
    assert got["primal_res"] < 1e-6


def test_splitting_keeps_the_missing_converged_flag():
    """A run cut at max_iter returns the same keys as a converged one and
    no flag (the JAX solver's defect, mirrored)."""
    got = TC.solve_splitting(_ineq_problem(), tol=1e-14, max_iter=5, device="cpu")
    want = JC.solve_splitting(_ineq_problem(), tol=1e-14, max_iter=5)
    assert set(got) == set(want) and "converged" not in got
    assert got["iterations"] == want["iterations"] == 5


def _cgal_slack(dense, X):
    """A(X) - b of the CGAL form (max_stable_set's selectors and trace)."""
    return np.einsum("kij,ij->k", np.stack(dense["constraints"]), X) - dense["bias"][:, 0]


def _cgal_inputs(problem, dim, seed):
    dj, dt = _both(problem, dim, seed)
    C = dj["C"] * dj["trace_params"][1] / max(np.linalg.norm(dj["C"]), 1e-300)
    return dj, dt, -C


@pytest.mark.parametrize("problem,dim,seed", [("maxcut", 3, 8), ("maxcut", 4, 10),
                                              ("max_stable_set", 3, 1)])
def test_cgal_matches_jax(problem, dim, seed):
    dj, dt, C = _cgal_inputs(problem, dim, seed)
    kw = dict(gap_tol=0.1, num_iter=1000 * 2 ** dim)
    X_j, _, info_j = JBL.cgal(C, dj["constraints"], dj["bias"], dj["trace_params"], **kw)
    X_t, _, info_t = TBL.cgal(C, dt["constraints"], dt["bias"], dt["trace_params"],
                              device="cpu", **kw)
    X_t = X_t.numpy()
    for X, info in ((X_t, info_t), (X_j, info_j)):  # both end by the stop test
        assert info["num_iters"] < kw["num_iter"] - 1
        assert np.linalg.norm(dj["conic"].eq_residual(X) if problem == "maxcut"
                              else _cgal_slack(dj, X)) < 1e-3
    # each objective is within the stop test's gap (0.1) of the optimum
    assert abs(float(np.sum(C * X_t)) - float(np.sum(C * X_j))) <= 0.2


def _generic(n, seed):
    """A random objective (simple eigenvalues) with maxcut's constraints."""
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n)
    C = 0.5 * (A + A.T)
    cons = [np.outer(e, e) for e in np.eye(n)]
    return C * n / np.linalg.norm(C), cons, np.ones((n, 1)), (float(n), float(n))


@pytest.mark.parametrize("solver", ["cgal", "sketchy_cgal"])
def test_cgal_family_step_for_step(solver):
    """The first 30 iterations on a generic problem agree to 1e-10: the
    same algorithm.  (CGAL's iterates amplify rounding: a 1e-15
    difference reaches 1e-12 by iteration 30 and 1e-4 by iteration 100 in
    either package against the other.)"""
    C, cons, b, trace = _generic(16, 0)
    kw = dict(gap_tol=1e-9, num_iter=30)
    if solver == "sketchy_cgal":
        kw["R"] = 2
    np.random.seed(3)
    X_j, gaps_j, info_j = getattr(JBL, solver)(C, cons, b, trace, **kw)
    np.random.seed(3)
    X_t, gaps_t, info_t = getattr(TBL, solver)(C, cons, b, trace, device="cpu", **kw)
    assert info_t == info_j and len(gaps_t) == len(gaps_j)
    assert np.abs(np.asarray(gaps_t) - np.asarray(gaps_j)).max(initial=0.0) <= 1e-10
    assert np.abs(X_t.numpy() - X_j).max() <= 1e-10


def _sketchy_trajectory(mod, C, cons, b, trace, iters, **kw):
    """Per iteration (gap, feasibility, objective) of ``mod.sketchy_cgal``
    run for ``iters`` iterations with the stop test recorded (both packages
    call ``_stop_test(gap, feas, obj, ...)`` once an iteration), and every
    gradient handed to the JAX package's eigenpair."""
    rows, grads = [], []
    stop, eig = mod._stop_test, getattr(mod, "_min_eigpair", None)

    def recorded(gap, feas, obj, *a):
        rows.append((float(gap), float(feas), float(obj)))
        return stop(gap, feas, obj, *a)

    def recorded_eig(H, ncv):
        grads.append(np.array(H))
        return eig(H, ncv)

    mod._stop_test = recorded
    if eig is not None:
        mod._min_eigpair = recorded_eig
    try:
        mod.sketchy_cgal(C, cons, b, trace, num_iter=iters + 1, **kw)
    finally:
        mod._stop_test = stop
        if eig is not None:
            mod._min_eigpair = eig
    return np.asarray(rows), grads


def _sketchy_cases(case):
    """(C, constraints, bias, trace, settings) of an order above 128, where
    the JAX package's eigenpair is ARPACK's and the port's its Lanczos:
    max_stable_set d8 seed 46 (order 256) at the runner's scaling and
    sketch size, or _generic(200, 0); gap_tol 1e-9 so neither stops."""
    if case == "generic200":
        C, cons, b, trace = _generic(200, 0)
        return C, cons, b, trace, dict(gap_tol=1e-9, R=2)
    dj, _ = _both("max_stable_set", 8, 46)
    C = dj["C"] * dj["trace_params"][1] / max(np.linalg.norm(dj["C"]), 1e-300)
    sketch = 2 * int(np.ceil(np.sqrt(2 * (2 ** 8 + 1))))
    return -C, dj["constraints"], dj["bias"], dj["trace_params"], dict(gap_tol=1e-9, R=sketch)


@pytest.mark.parametrize("case,iters,tol", [("generic200", 30, 1e-7), ("mss8", 4, 1e-12)])
def test_sketchy_cgal_above_order_128_matches_jax(case, iters, tol):
    """SketchyCGAL above order 128, where the JAX package takes ARPACK's
    smallest eigenpair and the port its restarted Lanczos: gap,
    feasibility and objective agree iteration by iteration to ``tol``
    (relative) over the first ``iters`` iterations.  On the generic
    problem (simple spectrum) the difference grows from 1e-13 by CGAL's own
    amplification (1e-8 at iteration 30).  On max_stable_set d8 seed 46
    the two agree to 1e-13 for four iterations; the fifth gradient's
    smallest eigenvalue is double (its two smallest eigenvalues within
    1e-12 relative), so the two eigensolvers return different exact
    vectors of that eigenspace and the trajectories part there (d9 and d10
    are out of reach: the JAX package's dense constraint stack takes ~20 s
    an iteration at order 512 on the CPU)."""
    C, cons, b, trace, kw = _sketchy_cases(case)
    np.random.seed(3)
    want, grads = _sketchy_trajectory(JBL, C, cons, b, trace, iters + (case == "mss8"), **kw)
    np.random.seed(3)
    got, _ = _sketchy_trajectory(TBL, torch.as_tensor(C), cons, b, trace, iters, device="cpu",
                                 **kw)
    assert len(got) == iters and len(want) >= iters
    rel = np.abs(got - want[:iters]) / np.abs(want[:iters])
    assert rel.max() <= tol, rel.max(axis=0)
    if case == "mss8":
        w = np.linalg.eigvalsh(grads[iters])
        assert abs(w[1] - w[0]) <= 1e-12 * abs(w[0])
        assert abs(w[2] - w[0]) > 1e-4 * abs(w[0])


def test_runner_sketch_fails_alike_at_d3():
    dj, dt = _both("maxcut", 3, seed=8)
    with pytest.raises(np.linalg.LinAlgError):
        JB.solve_baseline("scgal", "maxcut", dj, {"dim": 3}, seed=8)
    with pytest.raises(torch.linalg.LinAlgError):
        TB.solve_baseline("scgal", "maxcut", dt, {"dim": 3}, seed=8, device="cpu")


@pytest.mark.parametrize("n,rank,seed,tol", [(10, 10, 0, 1e-8), (9, 3, 1, 1e-6),
                                              (32, None, 24, 1e-6)])
def test_manopt_matches_jax(n, rank, seed, tol):
    """tests/test_baselines_extra.py's Laplacian objectives and settings:
    the same point (1e-6; where the gradient norm stalls near the
    tolerance the two packages may take different numbers of iterations
    to it) and objective (1e-9 relative)."""
    rng = np.random.RandomState(seed)
    A = np.triu((rng.rand(n, n) < 0.5).astype(float), 1)
    A = A + A.T
    C = (np.diag(A.sum(axis=1)) - A) / 4.0
    kw = dict(rank=rank, seed=seed, min_gradient_norm=tol, max_iterations=300)
    want = JRM.solve_maxcut_manopt(C, **kw)
    got = TRM.solve_maxcut_manopt(C, device="cpu", **kw)
    assert got["objective"] == pytest.approx(want["objective"], rel=1e-9)
    assert np.abs(got["x_matrix"].numpy() - want["x_matrix"]).max() <= 1e-6
    np.testing.assert_allclose(np.diag(got["x_matrix"].numpy()), 1.0, atol=1e-9)


def test_rtr_on_the_sphere_matches_jax():
    """tests/test_baselines_extra.py's quadratic on the unit sphere."""
    rng = np.random.RandomState(2)
    Q = np.linalg.qr(rng.randn(12, 12))[0]
    A = Q @ np.diag(np.linspace(1.0, 10.0, 12)) @ Q.T
    U0 = rng.randn(12, 1)
    want = JRM.oblique_trust_regions(lambda U: float(U.T @ A @ U), lambda U: 2.0 * A @ U,
                                     lambda U, H: 2.0 * A @ H, U0, min_gradient_norm=1e-9)
    At = torch.as_tensor(A)
    got = TRM.oblique_trust_regions(lambda U: float(U.T @ At @ U), lambda U: 2.0 * At @ U,
                                    lambda U, H: 2.0 * At @ H, torch.as_tensor(U0),
                                    min_gradient_norm=1e-9)
    assert got.iterations == want.iterations and got.grad_norm < 1e-7
    assert got.cost == pytest.approx(want.cost, rel=1e-12)
    assert got.cost == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("n,gap", [(200, 1.0), (300, 1e-3)])
def test_lanczos_matches_eigh(n, gap):
    rng = np.random.RandomState(n)
    Q = np.linalg.qr(rng.randn(n, n))[0]
    w = np.concatenate([[-2.0, -2.0 + gap], rng.uniform(0, 5, n - 2)])
    H = (Q * w) @ Q.T
    lam, v, _ = TBL.min_eigpair(torch.as_tensor(H), 20)
    w_ref, V = np.linalg.eigh(H)
    assert abs(lam - w_ref[0]) <= 1e-10 * abs(w_ref[0])
    v = v.numpy()
    assert min(np.abs(v - V[:, 0]).max(), np.abs(v + V[:, 0]).max()) <= 1e-7


def test_runner_splitting_writes_the_jax_schema(tmp_path, monkeypatch):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "maxcut_3.yaml")))
    cfg["seeds"] = [24]
    path = tmp_path / "maxcut_3.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    rec_t = runner.run_experiment(argv=["--problem", "maxcut", "--solver", "splitting",
                                        "--config", str(path), "--device", "cpu"])
    out = tmp_path / "results" / "maxcut_3_splitting_rank1.json"
    got = json.load(open(out))
    rec_j = JB.run_baseline_experiment(["--problem", "maxcut", "--solver", "splitting",
                                        "--config", str(path)])
    want = json.load(open(out))
    assert set(got) == set(want)
    assert rec_t["num_failed_seeds"] == rec_j["num_failed_seeds"] == 0
    assert got["num_iters"] == want["num_iters"]
    assert got["objective"] == pytest.approx(want["objective"], rel=1e-10)
    assert got["feasibility_errors"][0] < 1e-10


def main(argv):
    """``python -m tests.test_torch_baselines sketchy CASE ITERS``: both
    packages' SketchyCGAL on CASE (generic200 or mss8) for ITERS
    iterations; prints the relative difference of gap, feasibility and
    objective at a few iterations and the first iteration past 1e-6."""
    _, case, iters = argv[0], argv[1], int(argv[2])
    C, cons, b, trace, kw = _sketchy_cases(case)
    np.random.seed(3)
    want, _ = _sketchy_trajectory(JBL, C, cons, b, trace, iters, **kw)
    np.random.seed(3)
    got, _ = _sketchy_trajectory(TBL, torch.as_tensor(C), cons, b, trace, iters, device="cpu",
                                 **kw)
    n = min(len(got), len(want))
    rel = np.abs(got[:n] - want[:n]) / np.abs(want[:n])
    for t in sorted({0, 4, 9, 29, 49, 99, 199, 299, n - 1} & set(range(n))):
        print(f"iteration {t + 1}: rel diff gap {rel[t, 0]:.3e} feas {rel[t, 1]:.3e} "
              f"obj {rel[t, 2]:.3e}; jax gap {want[t, 0]:.6e} feas {want[t, 1]:.6e} "
              f"obj {want[t, 2]:.6e}; port gap {got[t, 0]:.6e}", flush=True)
    parted = next((t + 1 for t in range(n) if rel[t].max() > 1e-6), None)
    print(f"{case}: {n} iterations, first past 1e-6 relative: {parted}", flush=True)


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
