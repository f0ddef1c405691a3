"""Parity of the port's fused KKT solver and fused step-size eigensolver
with the JAX package (its numpy host engine, the CPU default profile).

* The first Newton system of a real maxcut d4 solve
  (``__graft_entry__._capture_first_newton_system``) is solved by both
  packages; the port's relative residual must be <= max(JAX's * 1.01,
  termination_tol).  Both draw their random starts from numpy streams
  seeded alike.
* ``tt_max_generalised_eigen_fused`` is held against the dense oracle of
  tests/test_fused.py (alpha* = 1 / lambda_max(-Delta) for A = I) and
  against the JAX package's step sizes (1e-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttipm_tpu.ops import tt as J
from ttipm_tpu.ops.random import tt_random_gaussian
from ttipm_tpu.ops.rounding import tt_rank_reduce
from ttipm_tpu.solvers import fused as JF
from ttipm_tpu.solvers.blocks import TTBlockMatrix, TTBlockVector
from ttipm_tpu.solvers.fused_eigen import tt_max_generalised_eigen_fused as eig_j
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.interop import (
    block_matrix_to_torch,
    block_vector_to_torch,
    tt_to_numpy,
    tt_to_torch,
)
from ttipm_tpu_torch.solvers import fused as TF
from ttipm_tpu_torch.solvers.amen import AmenToleranceReached, ladder_rank_cap
from ttipm_tpu_torch.solvers.fused_eigen import tt_max_generalised_eigen_fused as eig_t


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def to_port(lhs, rhs):
    lhs_t = block_matrix_to_torch(
        {k: [np.asarray(c) for c in v] for k, v in lhs._data.items()},
        lhs._aliases, lhs._transposes, device="cpu")
    rhs_t = block_vector_to_torch(
        {i: [np.asarray(c) for c in v] for i, v in rhs.items()}, device="cpu")
    return lhs_t, rhs_t


def rel_residuals(lhs, rhs, lhs_t, rhs_t, x_j, x_t):
    """(JAX's relative residual, the port's, the port's measure of JAX's)."""
    d = len(next(iter(rhs.values())))
    rn_j = JF._fused_residual_norm(JF._prep_operator(lhs, d, ineq=False),
                                   JF._prep_rhs(rhs, d, ineq=False), x_j, ineq=False)
    A_t = TF.prep_operator(lhs_t)
    b_t = TF.prep_rhs(rhs_t, d, next(iter(rhs_t.values()))[0])
    rn_t = TF.fused_residual_norm(A_t, b_t, x_t)
    rn_tj = TF.fused_residual_norm(A_t, b_t, tt_to_torch(tt_to_numpy(x_j), device="cpu"))
    return rn_j / rhs.norm, rn_t / rhs_t.norm, rn_tj / rhs_t.norm


@pytest.fixture
def captured():
    from __graft_entry__ import _capture_first_newton_system

    return to_port_pair(*_capture_first_newton_system(dim=4))


def to_port_pair(lhs, rhs):
    return (lhs, rhs) + to_port(lhs, rhs)


def test_captured_newton_system(captured):
    lhs, rhs, lhs_t, rhs_t = captured
    assert rhs_t.norm == pytest.approx(rhs.norm, rel=1e-14)
    # the IPM's first solve: termination_tol = eta, 7 sweeps, 2 restarts
    kw = dict(rank_restriction=1000, op_tol=1e-4, termination_tol=1e-3,
              num_restarts=2, inner_m=7)
    np.random.seed(3)
    x_j, _ = JF.tt_restarted_block_amen_fused(lhs, rhs, ineq=False, **kw)
    np.random.seed(3)
    x_t, _ = TF.tt_restarted_block_amen_fused(lhs_t, rhs_t, **kw)
    rn_j, rn_t, rn_tj = rel_residuals(lhs, rhs, lhs_t, rhs_t, x_j, x_t)
    # the residual expansion ||b||^2 - 2<b, Ax> + ||Ax||^2 resolves relative
    # residuals down to ~sqrt(eps_f64) = 1.5e-8, so both measures of the
    # same solution agree to that floor
    assert abs(rn_tj - rn_j) <= 1e-7
    assert rn_t <= max(rn_j * 1.01, kw["termination_tol"])
    assert [tuple(c.shape) for c in x_t] == [tuple(c.shape) for c in x_j]


def test_captured_fixed_rank_solve(captured):
    lhs, rhs, lhs_t, rhs_t = captured
    x_j, res_j = JF.tt_block_amen_fused(lhs, rhs, 1e-4, R=8, ineq=False, nswp=12, seed=3)
    x_t, res_t = TF.tt_block_amen_fused(lhs_t, rhs_t, 1e-4, R=8, nswp=12,
                                        rng=np.random.RandomState(3))
    rn_j, rn_t, _ = rel_residuals(lhs, rhs, lhs_t, rhs_t, x_j, x_t)
    assert rn_t <= rn_j * 1.01
    assert res_t == pytest.approx(res_j, rel=1e-6)


def _random_sym_op(d, rank):
    cores = tt_random_gaussian([rank] * (d - 1), (4, 4))
    return tt_rank_reduce([0.5 * (c + jnp.swapaxes(c, 1, 2)) for c in cores], 1e-12)


def _psd_op(d):
    eye = J.tt_reshape(J.tt_identity(2 * d), (4, 4))
    return tt_rank_reduce(J.tt_add(J.tt_scale(0.05, _random_sym_op(d, 2)), eye), 1e-12)


def _synthetic_kkt(d):
    """Equality KKT block system with the canonical key layout
    (tests/test_fused.py::_make_kkt_system)."""
    lhs = TTBlockMatrix()
    lhs[0, 0] = _psd_op(d)
    lhs[0, 1] = _random_sym_op(d, 2)
    lhs.add_alias((0, 1), (1, 0), is_transpose=True)
    lhs[1, 2] = J.tt_reshape(J.tt_identity(2 * d), (4, 4))
    lhs[2, 1] = _psd_op(d)
    lhs[2, 2] = _psd_op(d)
    rhs = TTBlockVector()
    for i in range(3):
        rhs[i] = tt_random_gaussian([2] * (d - 1), (4,))
    return lhs, rhs


def test_refinement_reaches_target():
    np.random.seed(0)
    lhs, rhs = _synthetic_kkt(3)
    lhs_t, rhs_t = to_port(lhs, rhs)
    target = 1e-6 * rhs.norm
    kw = dict(rank_restriction=64, op_tol=1e-8, termination_tol=1e-2,
              num_restarts=3, inner_m=10, refine_target=target)
    np.random.seed(4)
    x_j, _ = JF.tt_restarted_block_amen_fused(lhs, rhs, ineq=False, **kw)
    np.random.seed(4)
    x_t, _ = TF.tt_restarted_block_amen_fused(lhs_t, rhs_t, **kw)
    rn_j, rn_t, _ = rel_residuals(lhs, rhs, lhs_t, rhs_t, x_j, x_t)
    assert rn_t < 1e-6
    assert rn_t <= max(rn_j * 1.01, 1e-6)


def test_fused_residual_matches_block_product():
    np.random.seed(0)
    lhs, rhs = _synthetic_kkt(3)
    lhs_t, rhs_t = to_port(lhs, rhs)
    rng = np.random.RandomState(1)
    x = [torch.as_tensor(rng.randn(1, 4, 2)), torch.as_tensor(rng.randn(2, 4, 2)),
         torch.as_tensor(rng.randn(2, 3, 4, 1))]
    rn = TF.fused_residual_norm(TF.prep_operator(lhs_t), TF.prep_rhs(rhs_t, 3, x[0]), x)
    ragged = (rhs_t - lhs_t.block_product(x, 1e-10, eps=1e-14)).norm
    assert rn == pytest.approx(ragged, rel=1e-6)


def test_local_solve_keeps_prev_when_cholesky_fails():
    """A failed L_Z factorization keeps the previous core and reports the
    old residual (the host engine's semantics)."""
    rng = np.random.RandomState(5)
    one3 = torch.ones((1, 1, 1), dtype=torch.float64)
    eye = torch.eye(4, dtype=torch.float64).reshape(1, 4, 4, 1)
    A = {"00": eye, "01": torch.as_tensor(rng.randn(1, 4, 4, 1)), "12": eye,
         "21": -eye, "22": eye}
    pl = {k: one3 for k in A}
    bl = [torch.ones((1, 1), dtype=torch.float64)] * 3
    b = [torch.as_tensor(rng.randn(1, 4, 1)) for _ in range(3)]
    prev = torch.as_tensor(rng.randn(1, 3, 4, 1))
    sol, _, res_old, res_min, dx = TF._solve_local(pl, A, pl, bl, b, bl, prev)
    assert torch.equal(sol, prev)
    assert float(res_min) == float(res_old) and float(dx) == 0.0
    # with a positive definite L_Z the same system is solved exactly
    A["21"] = 2.0 * eye
    sol, _, res_old, res_min, _ = TF._solve_local(pl, A, pl, bl, b, bl, prev)
    assert float(res_min) < 1e-9 < float(res_old)


def test_ladder_cap_and_tolerance_reached():
    """The port fixes the reference's duplicated ladder cap
    (ttipm_tpu/solvers/fused.py:954 and ttipm_tpu/ipm.py:829) by computing
    it once; the values are the reference formula's."""
    assert ladder_rank_cap(1000, 8) == 32
    assert ladder_rank_cap(1000, 3) == 16
    assert ladder_rank_cap(6, 8) == 6
    np.random.seed(6)
    lhs, rhs = _synthetic_kkt(3)
    for i in (0, 1, 2):
        rhs[i] = J.tt_scale(1e-9, rhs.get_row(i))
    lhs_t, rhs_t = to_port(lhs, rhs)
    with pytest.raises(AmenToleranceReached):
        TF.tt_restarted_block_amen_fused(lhs_t, rhs_t, rank_restriction=64, op_tol=1e-4)


def test_max_generalised_eigen_matches_dense():
    np.random.seed(2)
    d = 3
    D_j = tt_rank_reduce([0.5 * (c + jnp.swapaxes(c, 1, 2))
                          for c in tt_random_gaussian([2] * (d - 1), (2, 2))], 1e-12)
    D_dense = np.asarray(J.tt_matrix_to_matrix(D_j))
    lam_min = np.linalg.eigvalsh(0.5 * (D_dense + D_dense.T))[0]
    alpha_true = 1.0 if lam_min >= 0 else min(1.0, 1.0 / (-lam_min))
    np.random.seed(8)
    alpha_j, _ = eig_j(J.tt_identity(d), D_j, tol=1e-9)
    np.random.seed(8)
    alpha_t, x_t = eig_t(J_identity_t(d), tt_to_torch(tt_to_numpy(D_j), device="cpu"), tol=1e-9)
    assert alpha_true * 0.9 <= alpha_t <= alpha_true * (1 + 1e-4)
    assert alpha_t == pytest.approx(alpha_j, rel=1e-8)
    assert len(x_t) == d


def J_identity_t(d):
    from ttipm_tpu_torch.ops.tt import tt_identity

    return tt_identity(d, device="cpu")


@pytest.mark.parametrize("d,seed", [(3, 0), (4, 1)])
def test_max_generalised_eigen_matches_jax_with_warm_start(d, seed):
    from ttipm_tpu.ops.products import tt_fast_mat_mat_mul

    np.random.seed(seed)
    B = tt_random_gaussian([2] * (d - 1), (2, 2))
    A_j = J.tt_add(tt_fast_mat_mat_mul(B, J.tt_transpose(B), 1e-12),
                   J.tt_scale(0.5, J.tt_identity(d)))
    Dl = tt_random_gaussian([2] * (d - 1), (2, 2))
    D_j = J.tt_add(J.tt_add(J.tt_scale(0.5, Dl), J.tt_scale(0.5, J.tt_transpose(Dl))),
                   J.tt_scale(-0.3, J.tt_identity(d)))
    A_t = tt_to_torch(tt_to_numpy(A_j), device="cpu")
    D_t = tt_to_torch(tt_to_numpy(D_j), device="cpu")
    np.random.seed(7)
    s_j, x_j = eig_j(A_j, D_j, tol=1e-8)
    np.random.seed(7)
    s_t, x_t = eig_t(A_t, D_t, tol=1e-8)
    assert s_t == pytest.approx(s_j, rel=1e-8)
    # second call warm-started from each package's own eigenvector train
    s_j2, _ = eig_j(A_j, J.tt_scale(0.5, D_j), x0=x_j, tol=1e-8)
    s_t2, _ = eig_t(A_t, [D_t[0] * 0.5] + D_t[1:], x0=x_t, tol=1e-8)
    assert s_t2 == pytest.approx(s_j2, rel=1e-8)
