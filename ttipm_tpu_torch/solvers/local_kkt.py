"""Per-core Newton/KKT local solvers of the ragged block-AMEn sweeps.

Block layout of the projected KKT system at one core (variables
[dY, dX, dZ] and, with inequality constraints, dT; rows [primal
feasibility, dual feasibility, centrality, inequality complementarity]):

    [ Ky   -L    0    0 ] [dY]   [R_p]
    [-L^T   0    I    I ] [dX] = [R_d]
    [ 0    Lz   Lx    0 ] [dZ]   [R_c]
    [ 0    D_T   0    D ] [dT]   [R_t]

The dense path eliminates dZ through the projected identity (``inv_I``),
Cholesky-factors the SPD ``Lz`` block and QR-solves the Y Schur complement
(with inequalities: eliminates dX through L_Z too and solves the coupled
(dY, dT) system by a second Schur step over D); the back substitution
recovers the rest.  Above the size gate, or when the Cholesky fails,
LGMRES runs on the dZ-eliminated two-block (three-block) operator.

Counterpart of ``ttipm_tpu/solvers/local_kkt.py``.  The projected blocks
of a dense chain come from one K1 launch (``kernels.schur_assemble_group``:
four blocks, six with inequalities), L_Z from K4 (``kernels.panel_cholesky``),
whose ``info`` sends a failed factorization to LGMRES as a NaN does in the
JAX package; the block applies, the local products and the reduced
operator go through K2.  Each solve reads three norms on the host (the
residuals before and after, the norm of the right-hand side); the dense
candidate's acceptance is one more read.  The two dense chains are the JAX
package's: unlike the fused solver's, neither puts a Tikhonov term on L_Z,
and the inequality chain solves its (dY) Schur system without one.
"""

from __future__ import annotations

import numpy as np
import torch

from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.linalg import chol_solve, qr_apply, qr_factor, qr_solve
from ttipm_tpu_torch.solvers.fused_algebra import apply, apply_T, tikhonov
from ttipm_tpu_torch.solvers.lgmres import lgmres

__all__ = ["ipm_local_solver", "ipm_local_solver_ineq"]

_EQ_KEYS = ((0, 0), (0, 1), (2, 1), (2, 2))
_INEQ_KEYS = _EQ_KEYS + ((3, 1), (3, 3))


def _ops(XAX_k, block_A_k, XAX_k1, key):
    return XAX_k[key], block_A_k[key], XAX_k1[key]


def _dense_eq(ops, inv_I, rhs):
    """The equality Schur chain; returns (candidate, ok) with ok a 0-d
    device bool: L_Z factored (K4 info 0) and the candidate finite."""
    r, _, n, R = rhs.shape
    m = r * n * R
    mR_p = rhs[:, 0].reshape(m, 1)
    mR_d = rhs[:, 1].reshape(m, 1)
    mR_c = rhs[:, 2].reshape(m, 1)
    B00, mL_eq, B21, B22 = kernels.schur_assemble_group([ops[k] for k in _EQ_KEYS])
    L_L_Z, info = kernels.panel_cholesky(B21)
    L_X_I_inv = B22 * inv_I.reshape(1, -1)
    b = mR_p - mL_eq @ chol_solve(L_L_Z, mR_c - L_X_I_inv @ mR_d)
    S = mL_eq @ (chol_solve(L_L_Z, L_X_I_inv) @ mL_eq.T)
    y = qr_solve(tikhonov(S + B00), b)
    y3 = y.reshape(r, n, R)
    z = inv_I * (rhs[:, 1] - apply_T(*ops[0, 1], y3))
    x = chol_solve(L_L_Z, mR_c - apply(*ops[2, 2], z).reshape(m, 1))
    cand = torch.stack([y3, x.reshape(r, n, R), z], dim=1)
    return cand, (info == 0) & torch.isfinite(cand).all()


def _reduced_matvec_eq(ops, inv_I, vec):
    """The dZ-eliminated two-block operator on (dY, dX): one K2 launch for
    A01^T dY, then one for the four terms of the two rows."""
    yx = vec.reshape(2, *inv_I.shape)
    dy, dx = yx[0], yx[1]
    dz = -inv_I * apply_T(*ops[0, 1], dy)
    out = kernels.kkt_block_product(
        [(*ops[0, 0], dy, 0), (*ops[0, 1], dx, 0), (*ops[2, 1], dx, 1), (*ops[2, 2], dz, 1)], 2)
    return out.permute(1, 0, 2, 3).reshape(-1)


def ipm_local_solver(XAX_k, block_A_k, XAX_k1, Xb_k, block_b_k, Xb_k1,
                     previous_solution, size_limit, dense_solve=True, rtol=1e-5):
    """Equality-only local KKT solve.  Returns (solution, res_old, res_min,
    rhs, norm_rhs, direct_solve_failure)."""
    x_shape = previous_solution.shape
    m = x_shape[0] * x_shape[2] * x_shape[3]
    rhs = block_b_k.block_local_product(Xb_k, Xb_k1, 1, x_shape)
    norm_rhs = max(float(torch.linalg.norm(rhs)), 1e-10)
    inv_I = 1.0 / torch.einsum("lsr,smnS,LSR->lmL", *_ops(XAX_k, block_A_k, XAX_k1, (1, 2)))
    block_res_old = float(torch.linalg.norm(
        block_A_k.block_local_product(XAX_k, XAX_k1, previous_solution) - rhs)) / norm_rhs

    # Dense gate: the reference's sqrt(r0*r1) <= 3d, floored at 24
    # (m = r0*4*r1 up to ~2300 at the floor).
    dense = (np.sqrt(x_shape[0] * x_shape[3]) <= max(size_limit, 24)
             and dense_solve and block_res_old >= rtol)
    direct_solve_failure = not dense
    solution_now = None
    ops = {key: _ops(XAX_k, block_A_k, XAX_k1, key) for key in _EQ_KEYS}

    if dense:
        cand, ok = _dense_eq(ops, inv_I, rhs)
        if bool(ok):
            solution_now = cand
        else:
            direct_solve_failure = True

    if solution_now is None:
        solution_now = _iterative_eq(ops, rhs, inv_I, previous_solution, x_shape, m, rtol)

    block_res_new = float(torch.linalg.norm(
        block_A_k.block_local_product(XAX_k, XAX_k1, solution_now) - rhs)) / norm_rhs
    if block_res_old < block_res_new:
        solution_now = previous_solution
    return (solution_now, block_res_old, min(block_res_old, block_res_new),
            rhs, norm_rhs, direct_solve_failure)


def _iterative_eq(ops, rhs, inv_I, previous_solution, x_shape, m, rtol):
    """LGMRES on the dZ-eliminated two-block operator, warm-started from the
    previous solution where that lowers the residual."""
    shape3 = (x_shape[0], x_shape[2], x_shape[3])

    def reduced_matvec(vec):
        return _reduced_matvec_eq(ops, inv_I, vec)

    local_rhs = torch.stack([rhs[:, 0], rhs[:, 2] - apply(*ops[2, 2], inv_I * rhs[:, 1])])
    rhs_vec = local_rhs.reshape(-1)
    prev_vec = torch.stack([previous_solution[:, 0], previous_solution[:, 1]]).reshape(-1)
    prev_image = reduced_matvec(prev_vec)
    res_prev, res_zero = torch.stack([torch.linalg.norm(rhs_vec - prev_image),
                                      torch.linalg.norm(rhs_vec)]).tolist()
    use_prev = res_prev < res_zero
    target = rhs_vec - prev_image if use_prev else rhs_vec
    sol, _ = lgmres(reduced_matvec, target, rtol=rtol, restart=min(2 * m, 100), maxiter=5)
    if use_prev:
        sol = sol + prev_vec
    yx = sol.reshape(2, *shape3)
    dz = inv_I * (rhs[:, 1] - apply_T(*ops[0, 1], yx[0]))
    return torch.stack([yx[0], yx[1], dz], dim=1)


def _dense_ineq(ops, inv_I, rhs):
    """The inequality two-level Schur chain; returns (candidate, ok) as
    ``_dense_eq`` does."""
    r, _, n, R = rhs.shape
    m = r * n * R
    B00, mL_eq, B21, B22, T_op, B33 = kernels.schur_assemble_group(
        [ops[k] for k in _INEQ_KEYS])
    L_L_Z, info = kernels.panel_cholesky(B21)
    mR_p = rhs[:, 0].reshape(m, 1)
    mR_d = rhs[:, 1].reshape(m, 1)
    mR_c = rhs[:, 2].reshape(m, 1)
    mR_t = rhs[:, 3].reshape(m, 1)
    Lz_inv_Rc = chol_solve(L_L_Z, mR_c)
    Lz_inv_Lx = chol_solve(L_L_Z, B22)
    Lz_inv_Lx_scaled = Lz_inv_Lx * inv_I.reshape(1, -1)
    u = mR_p - mL_eq @ (Lz_inv_Rc - Lz_inv_Lx_scaled @ mR_d)
    v = mR_t - T_op @ (Lz_inv_Rc - Lz_inv_Lx_scaled @ mR_d)
    S = B00 + mL_eq @ (Lz_inv_Lx_scaled @ mL_eq.T)
    D = tikhonov(B33 + T_op @ Lz_inv_Lx)
    TY = (T_op @ Lz_inv_Lx_scaled) @ mL_eq.T
    YT = mL_eq @ Lz_inv_Lx
    d_qr = qr_factor(D)
    rhs_y = u - YT @ qr_apply(d_qr, v)
    lhs_y = S - YT @ qr_apply(d_qr, TY)
    y = qr_solve(lhs_y, rhs_y)
    t3 = qr_apply(d_qr, v - TY @ y).reshape(r, n, R)
    y3 = y.reshape(r, n, R)
    z3 = inv_I * (rhs[:, 1] - apply_T(*ops[0, 1], y3)) - t3
    x = chol_solve(L_L_Z, mR_c - apply(*ops[2, 2], z3).reshape(m, 1))
    cand = torch.stack([y3, x.reshape(r, n, R), z3, t3], dim=1)
    return cand, (info == 0) & torch.isfinite(cand).all()


def _reduced_matvec_ineq(ops, inv_I, vec):
    """The dZ-eliminated three-block operator on (dY, dX, dT): one K2
    launch for A01^T dY, then one for the six terms of the three rows."""
    yxt = vec.reshape(3, *inv_I.shape)
    dy, dx, dt = yxt[0], yxt[1], yxt[2]
    dz = -inv_I * apply_T(*ops[0, 1], dy) - dt
    out = kernels.kkt_block_product(
        [(*ops[0, 0], dy, 0), (*ops[0, 1], dx, 0), (*ops[2, 1], dx, 1), (*ops[2, 2], dz, 1),
         (*ops[3, 1], dx, 2), (*ops[3, 3], dt, 2)], 3)
    return out.permute(1, 0, 2, 3).reshape(-1)


def ipm_local_solver_ineq(XAX_k, block_A_k, XAX_k1, Xb_k, block_b_k, Xb_k1,
                          previous_solution, size_limit, dense_solve=True, rtol=1e-5):
    """Inequality-path local KKT solve with the dT row.  Returns (solution,
    res_old, res_min, rhs, norm_rhs, direct_solve_failure)."""
    x_shape = previous_solution.shape
    m = x_shape[0] * x_shape[2] * x_shape[3]
    rhs = block_b_k.block_local_product(Xb_k, Xb_k1, 1, x_shape)
    inv_I = 1.0 / torch.einsum("lsr,smnS,LSR->lmL", *_ops(XAX_k, block_A_k, XAX_k1, (1, 2)))
    norm_rhs = max(float(torch.linalg.norm(rhs)), 1e-10)
    block_res_old = float(torch.linalg.norm(
        block_A_k.block_local_product(XAX_k, XAX_k1, previous_solution) - rhs)) / norm_rhs
    dense = (np.sqrt(x_shape[0] * x_shape[3]) <= max(0.95 * size_limit, 24)
             and dense_solve and block_res_old >= rtol)
    direct_solve_failure = not dense
    solution_now = None
    ops = {key: _ops(XAX_k, block_A_k, XAX_k1, key) for key in _INEQ_KEYS}

    if dense:
        cand, ok = _dense_ineq(ops, inv_I, rhs)
        if bool(ok):
            solution_now = cand
        else:
            direct_solve_failure = True

    if solution_now is None:
        solution_now = _iterative_ineq(ops, rhs, inv_I, previous_solution, x_shape, m, rtol)

    block_res_new = float(torch.linalg.norm(
        block_A_k.block_local_product(XAX_k, XAX_k1, solution_now) - rhs)) / norm_rhs
    if block_res_old < block_res_new:
        solution_now = previous_solution
    return (solution_now, block_res_old, min(block_res_old, block_res_new),
            rhs, norm_rhs, direct_solve_failure)


def _iterative_ineq(ops, rhs, inv_I, previous_solution, x_shape, m, rtol):
    """LGMRES on the dZ-eliminated three-block operator, warm-started from
    the previous solution where that lowers the residual."""
    shape3 = (x_shape[0], x_shape[2], x_shape[3])

    def reduced_matvec(vec):
        return _reduced_matvec_ineq(ops, inv_I, vec)

    local_rhs = torch.stack(
        [rhs[:, 0], rhs[:, 2] - apply(*ops[2, 2], inv_I * rhs[:, 1]), rhs[:, 3]])
    rhs_vec = local_rhs.reshape(-1)
    prev_vec = torch.stack([previous_solution[:, 0], previous_solution[:, 1],
                            previous_solution[:, 3]]).reshape(-1)
    prev_image = reduced_matvec(prev_vec)
    res_prev, res_zero = torch.stack([torch.linalg.norm(rhs_vec - prev_image),
                                      torch.linalg.norm(rhs_vec)]).tolist()
    use_prev = res_prev < res_zero
    target = rhs_vec - prev_image if use_prev else rhs_vec
    sol, _ = lgmres(reduced_matvec, target, rtol=rtol, restart=min(3 * m, 100), maxiter=5)
    if use_prev:
        sol = sol + prev_vec
    yxt = sol.reshape(3, *shape3)
    dz = inv_I * (rhs[:, 1] - apply_T(*ops[0, 1], yxt[0])) - yxt[2]
    return torch.stack([yxt[0], yxt[1], dz, yxt[2]], dim=1)
