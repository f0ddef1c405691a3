"""The port's (seeds x kkt) mesh over ``torch.distributed`` against the JAX
package's mesh, on spawned CPU ranks (``gloo``) at (S, K) = (2, 1),
(1, 2) and (2, 2).

One world is spawned a mesh shape; its ranks run every case of
``torch_mesh_cases.run_all`` and the tests compare what rank 0 returns:

* ``sharded_newton_micro`` equals, seed for seed, the JAX package's on its
  8-device virtual mesh (the inputs of tests/test_parallel.py:19) to 1e-10
  relative, and ``batched_solve_metrics`` its mean (test_parallel.py:48).
* A seeds-only mesh (2, 1) gives the bits of ``mesh=None`` on
  ``tt_block_amen_fused_batch``, ``tt_step_sizes_batch`` and
  ``tt_newton_step_batch`` (rank 0 runs both, in one process).
* With K > 1, the cases of tests/test_parallel.py at its bounds, the JAX
  package's mesh run taking the place of the reference: the fused batch
  (:54; every instance's relative residual below 1e-6, instance 0's within
  10x of the JAX mesh solve's or 1e-8), the step sizes (:104; 2e-6), the
  Newton step on three synthetic systems (:146; 1e-5, cone steps, finite
  directions) and a full IPM iteration on two maxcut d3 instances (:177;
  steps 1e-5, next iterates 1e-4 relative, the gap reduced).
* ``make_mesh`` raises for CUDA ranks that share a card without
  ``backend="gloo"`` (by argument; no card needed).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import _dense, _pencils, _systems, to_port
from torch_mesh_cases import run_all
from ttipm_tpu import config as jconfig
from ttipm_tpu.parallel import fused_mesh as JM
from ttipm_tpu.parallel import mesh as JMESH
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.checks import first_newton_system, kkt_residual_norm
from ttipm_tpu_torch.interop import tt_to_torch
from ttipm_tpu_torch.ops import tt as TT
from ttipm_tpu_torch.parallel.mesh import choose_backend, make_mesh, spawn_mesh
from ttipm_tpu_torch.solvers import fused as TF
from ttipm_tpu_torch.utils.runner import load_yaml

SHAPES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def _micro_inputs():
    """tests/test_parallel.py:19's inputs."""
    rng = np.random.RandomState(0)
    b, r, n, rA = 8, 3, 4, 4
    phi_l = rng.randn(b, r, rA, r)
    A_core = rng.randn(b, rA, n, n, rA) * 0.01 + np.broadcast_to(
        np.eye(n)[None, None, :, :, None], (b, rA, n, n, rA))
    phi_r = rng.randn(b, r, rA, r)
    rhs = rng.randn(b, r, n, r)
    return phi_l, A_core, phi_r, rhs


def _jax_full_instances():
    """tests/test_parallel.py:177's two maxcut d3 instances: (lhs, rhs, X,
    Z, eta) of their first equilibrated Newton systems."""
    from ttipm_tpu.ipm import (IPMStatus, IneqStatus, _tt_build_row_scaled_kkt,
                               tt_infeasible_newton_system)
    from ttipm_tpu.models.maxcut import create_problem
    from ttipm_tpu.ops import tt as J
    from ttipm_tpu.solvers.blocks import TTBlockMatrix

    d = 3
    out = []
    for seed in (319, 7):
        np.random.seed(seed)
        obj, L, bias, lag_y = create_problem(d, 1)
        obj, bias = J.tt_reshape(obj, (4,)), J.tt_reshape(bias, (4,))
        status = IPMStatus(d, 2 * 3e-4, 3e-4 / np.sqrt(d), 1e-4, 1e-12, False, False, np.inf,
                           False, np.inf, False, np.inf, np.inf, False, IneqStatus.NOT_IN_USE,
                           False, 1, 1, 2 * d)
        status.primal_error_normalisation = 1 + J.tt_norm(bias)
        status.dual_error_normalisation = 1 + J.tt_norm(obj)
        lhs = TTBlockMatrix()
        lhs[1, 2] = J.tt_reshape(J.tt_identity(2 * d), (4, 4))
        lhs[0, 1] = J.tt_scale(-1, L)
        lhs.add_alias((0, 1), (1, 0), is_transpose=True)
        lhs[0, 0] = J.tt_reshape(lag_y, (4, 4))
        X, Z = J.tt_identity(d), J.tt_identity(d)
        Y = J.tt_reshape(J.tt_zero_matrix(d), (4,))
        lhs, rhs, status = tt_infeasible_newton_system(lhs, obj, X, Y, Z, None, L,
                                                       J.tt_transpose(L), bias, None, status)
        lhs_s, rhs_s = _tt_build_row_scaled_kkt(lhs, rhs, status)
        out.append((lhs_s, rhs_s, X, Z, status.eta))
    return out


@pytest.fixture(scope="module")
def jax_mesh_runs():
    """The JAX package's mesh runs of every case (8 virtual devices)."""
    from test_fused import _make_kkt_system
    from ttipm_tpu.ops import tt as J
    from ttipm_tpu.ops.rounding import tt_psd_rank_reduce

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jconfig.set_rank_bucket(1)
    mesh8 = JMESH.make_mesh(8, kkt=2)
    pl, A, pr, rhs = (jnp.asarray(a) for a in _micro_inputs())
    xs, mean = JMESH.sharded_newton_micro(mesh8)(pl, A, pr, rhs)
    out = {"micro": (np.asarray(xs), float(mean)),
           "metrics": float(JMESH.batched_solve_metrics(mesh8, jnp.arange(8.0)))}
    fmesh = JM.make_mesh(8, kkt=2)
    systems = _systems(False)
    x, r = JM.tt_block_amen_fused_batch([s[0] for s in systems], [s[1] for s in systems],
                                        R=16, ineq=False, mesh=fmesh, term_tol=1e-10, nswp=14,
                                        seed=7)
    out["fused"] = (x, r, systems)
    pencils = _pencils()
    np.random.seed(7)
    out["steps"] = (JM.tt_step_sizes_batch(pencils, mesh=mesh8)[0], pencils)
    newton = []
    for seed in (11, 12, 13):
        newton.append((_make_kkt_system(3, np.random.RandomState(seed)),
                       J.tt_scale(1.0 + 0.1 * seed, J.tt_identity(3)),
                       J.tt_scale(2.0, J.tt_identity(3))))
    xs3, zs3, _ = JM.tt_newton_step_batch([n[0] for n in newton], [n[1] for n in newton],
                                          [n[2] for n in newton], mesh=mesh8, R=12, seed=5)
    out["newton"] = (xs3, zs3, newton)
    inst = _jax_full_instances()
    xs, zs, dirs = JM.tt_newton_step_batch([i[:2] for i in inst], [i[2] for i in inst],
                                           [i[3] for i in inst], mesh=mesh8, R=12, seed=5)
    nxt = [[tt_psd_rank_reduce(J.tt_add(base, J.tt_scale(float(step), d[which])), eps=i[4])
            for base, step, which in ((i[2], xs[k], 1), (i[3], zs[k], 2))]
           for k, (i, d) in enumerate(zip(inst, dirs))]
    out["full"] = (xs, zs, nxt, inst)
    return out


@pytest.fixture(scope="module")
def port_inputs(jax_mesh_runs):
    tconfig.set_rank_bucket(1)  # module fixtures set up before the autouse one
    try:
        systems = [to_port(*s) for s in jax_mesh_runs["fused"][2]]
        pencils = [(tt_to_torch(a, device="cpu"), tt_to_torch(b, device="cpu"))
                   for a, b in jax_mesh_runs["steps"][1]]
        newton = [to_port(*n[0]) for n in jax_mesh_runs["newton"][2]]
        cfg = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "maxcut_3.yaml"))
        built = [first_newton_system("maxcut", cfg, seed, "cpu") for seed in (319, 7)]
    finally:
        tconfig.set_rank_bucket(4)
    d3 = TT.tt_identity(3, device="cpu")
    return {
        "micro": tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in _micro_inputs()),
        "errs": torch.arange(8.0, dtype=torch.float64),
        "fused": ([s[0] for s in systems], [s[1] for s in systems]),
        "pencils": pencils,
        "newton": (newton, [TT.tt_scale(1.0 + 0.1 * s, d3) for s in (11, 12, 13)],
                   [TT.tt_scale(2.0, d3)] * 3),
        "full": ([b[:2] for b in built], [b[2] for b in built], [b[3] for b in built]),
        "eta": [i[4] for i in jax_mesh_runs["full"][3]],
    }


@pytest.fixture(scope="module")
def mesh_runs(port_inputs):
    """The ranks' results of each mesh shape, spawned at the first use."""
    cache = {}

    def run(name):
        if name not in cache:
            S, K = SHAPES[name]
            ranks = spawn_mesh(run_all, S * K, K, "cpu", args=(port_inputs,), timeout_s=600)
            assert all(r["mesh"] == {"seeds": S, "kkt": K} for r in ranks)
            cache[name] = ranks
        return cache[name]

    return run


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sharded_newton_micro_matches_jax(shape, mesh_runs, jax_mesh_runs):
    ranks = mesh_runs(shape)
    xs_j, mean_j = jax_mesh_runs["micro"]
    scale = float(np.abs(_micro_inputs()[3]).max())
    for r in ranks:  # every rank holds every seed's solution
        xs, mean = r["micro"]
        assert _rel(xs, xs_j) < 1e-10
        # the mean residual is roundoff (~1e-14): held against the rhs scale
        assert abs(mean - mean_j) <= 1e-10 * scale


@pytest.mark.parametrize("shape", list(SHAPES))
def test_batched_solve_metrics_matches_jax(shape, mesh_runs, jax_mesh_runs):
    ranks = mesh_runs(shape)
    assert all(r["metrics"] == jax_mesh_runs["metrics"] == 3.5 for r in ranks)


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["fused", "steps", "newton"])
def test_seeds_mesh_bit_equal_to_no_mesh(case, mesh_runs):
    """Every rank holds two or more instances in these cases.  (A shard of
    one instance runs the single solve's kernel entries, the batch of one,
    whose plain versions on the CPU sum in another order than the batched
    ones: the full iteration's two instances on two rows; held to the JAX
    bounds in test_mesh_full_iteration.)"""
    ranks = mesh_runs("2x1")
    got, want = ranks[0]["cases"][case], ranks[0]["cases_no_mesh"][case]
    assert _same(got, want)
    assert all(_same(r["cases"][case], got) for r in ranks[1:])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_kkt_mesh_fused_batch(shape, mesh_runs, jax_mesh_runs, port_inputs):
    """tests/test_parallel.py:54 on the kkt mesh."""
    ranks = mesh_runs(shape)
    x_t, res_t = ranks[0]["cases"]["fused"]
    x_j = jax_mesh_runs["fused"][0]
    assert np.isfinite(res_t).all() and len(x_t) == 4
    lhs, rhs = port_inputs["fused"]
    rn = []
    for A_blk, b_blk, x in zip(lhs, rhs, x_t):
        x = [torch.as_tensor(c) for c in x]
        A, b = TF.prep_operator(A_blk), TF.prep_rhs(b_blk, 3, x[0])
        # the exact residual: the solver's expansion cancels below ~1.5e-8
        rn.append(kkt_residual_norm(A, b, x) / b_blk.norm)
        assert rn[-1] < 1e-6
    from ttipm_tpu.solvers.fused import _fused_residual_norm, _prep_operator, _prep_rhs

    lhs_j, rhs_j = jax_mesh_runs["fused"][2][0]
    rn_j = _fused_residual_norm(_prep_operator(lhs_j, 3, ineq=False),
                                _prep_rhs(rhs_j, 3, ineq=False), list(x_j[0]),
                                ineq=False) / rhs_j.norm
    assert rn[0] < max(10 * rn_j, 1e-8)
    for xj, xt in zip(x_j, x_t):
        dj, dt = _dense(xj), _dense(xt)
        assert np.abs(dt - dj).max() <= 1e-6 * np.abs(dj).max()


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_kkt_mesh_step_sizes(shape, mesh_runs, jax_mesh_runs):
    """tests/test_parallel.py:104 on the kkt mesh: 2e-6 of the JAX mesh's."""
    ranks = mesh_runs(shape)
    steps, warm = ranks[0]["cases"]["steps"]
    steps_j = jax_mesh_runs["steps"][0]
    for s, sj in zip(steps, steps_j):
        assert abs(s - sj) <= 2e-6 * max(1.0, abs(sj))
    assert all(np.isfinite(c).all() for w in warm for c in w)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_kkt_mesh_newton_step(shape, mesh_runs, jax_mesh_runs):
    """tests/test_parallel.py:146 on the kkt mesh: the JAX mesh's steps to
    1e-5, cone steps, finite directions."""
    ranks = mesh_runs(shape)
    got = ranks[0]["cases"]["newton"]
    xs_j, zs_j, _ = jax_mesh_runs["newton"]
    for a, b in ((got["x"], xs_j), (got["z"], zs_j)):
        assert np.all(np.abs(a - b) < 1e-5 * np.maximum(1.0, np.abs(b)))
        assert np.all(a > 0) and np.all(a <= 1.0)
    assert all(np.isfinite(c).all() for d in got["dirs"] for t in d for c in t)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mesh_full_iteration(shape, mesh_runs, jax_mesh_runs, port_inputs):
    """tests/test_parallel.py:177 on every mesh: steps 1e-5, next iterates
    1e-4 relative of the JAX mesh's, the duality gap reduced."""
    ranks = mesh_runs(shape)
    got = ranks[0]["cases"]["full"]
    xs_j, zs_j, nxt_j, _ = jax_mesh_runs["full"]
    _, Xs, Zs = port_inputs["full"]
    for i in range(2):
        assert abs(got["x"][i] - xs_j[i]) < 1e-5 * max(1.0, abs(xs_j[i]))
        assert abs(got["z"][i] - zs_j[i]) < 1e-5 * max(1.0, abs(zs_j[i]))
        nxt = [[torch.as_tensor(c) for c in t] for t in got["next"][i]]
        for a, b in zip(nxt, nxt_j[i]):
            b = tt_to_torch(b, device="cpu")
            assert TT.tt_l2_dist(a, b) / max(TT.tt_norm(b), 1e-12) < 1e-4
        assert abs(TT.tt_inner_prod(*nxt)) < abs(TT.tt_inner_prod(Xs[i], Zs[i]))


def test_mesh_backend_rule_by_argument():
    """CUDA ranks on one card need gloo; nccl never takes CPU ranks; the
    check runs before any process group or card is touched."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_mesh(2, 1, device="cuda:0")
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_mesh(2, 1, device="cuda:0", backend="nccl")
    with pytest.raises(ValueError, match="CPU ranks use gloo"):
        make_mesh(2, 1, device="cpu", backend="nccl")
    assert choose_backend(["cuda:0", "cuda:0"], "gloo") == "gloo"
    assert choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert choose_backend(["cpu"] * 4) == "gloo"
    with pytest.raises(RuntimeError, match="initialized world"):
        make_mesh(2, 1, device="cpu")  # no process group in this process
