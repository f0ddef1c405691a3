"""Primal-dual predictor-corrector interior-point method in TT format.

Solves  min <C, X>  s.t.  L(X) = b,  X PSD  (optionally with entrywise
inequality constraints X >= -beta on a mask) with the iterates X, Y, Z, T
held as tensor trains.  Each iteration assembles the block-TT Newton
system, solves it with the fused fixed-rank AMEn ladder (the ragged AMEn
when the ladder exhausts its restarts), line-searches the PSD cone with the
fused TT generalised eigensolver (the masked entries with the smallest-
eigenvector sweep over ``Diag(.)``), and rounds the updated iterates with
PSD-preserving (T: mask-preserving) TT rounding.  The inequality
constraints go through the ``IneqStatus`` machine: they are switched off
when they go slack and back on when a step would cross them.
``config.set_fused_kkt(False)`` selects the ragged (reference-faithful) KKT
solvers and eigensolvers throughout.

Counterpart of ``ttipm_tpu/ipm.py``.  Not ported yet: checkpointing.
"""

from __future__ import annotations

import sys
import traceback
from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.ops.kernels import KernelError
from ttipm_tpu_torch.ops.products import (
    tt_fast_hadamard,
    tt_fast_matrix_vec_mul,
    tt_mat_mat_mul,
    tt_mat_vec_mul,
)
from ttipm_tpu_torch.ops.rounding import (
    tt_mask_rank_reduce,
    tt_psd_rank_reduce,
    tt_rank_reduce,
)
from ttipm_tpu_torch.ops.tt import (
    TT,
    tt_add,
    tt_diag_op,
    tt_entrywise_sum,
    tt_identity,
    tt_IkronM,
    tt_inner_prod,
    tt_MkronI,
    tt_norm,
    tt_normalise,
    tt_one_matrix,
    tt_ranks,
    tt_reshape,
    tt_scale,
    tt_sub,
    tt_trace,
    tt_transpose,
    tt_zero_matrix,
)
from ttipm_tpu_torch.solvers.amen import (
    AmenRestartsExhausted,
    ladder_rank_cap,
    tt_restarted_block_amen,
)
from ttipm_tpu_torch.solvers.blocks import TTBlockMatrix, TTBlockVector, tt_get_block
from ttipm_tpu_torch.solvers.eigen import tt_max_generalised_eigen, tt_min_eig
from ttipm_tpu_torch.solvers.fused import tt_restarted_block_amen_fused
from ttipm_tpu_torch.solvers.fused_eigen import tt_max_generalised_eigen_fused, tt_min_eig_fused
from ttipm_tpu_torch.solvers.local_kkt import ipm_local_solver, ipm_local_solver_ineq

__all__ = ["tt_ipm", "IPMStatus", "IneqStatus"]


# Faults that the Newton step's total-function recovery must not turn into
# a zero step: a kernel that did not build or launch, a device error
# surfacing from an earlier asynchronous launch, device memory exhausted.
_NOT_RECOVERED = (KernelError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


class IneqStatus(Enum):
    """Activation state of the inequality constraints."""

    ACTIVE = 0
    SETTING_ACTIVE = 1
    SETTING_INACTIVE = 2
    INACTIVE = 3
    NOT_IN_USE = 4

    def __str__(self):
        return self.name.lower().replace("_", " ")


@dataclass
class IPMStatus:
    """Mutable solver state threaded through one IPM run."""

    dim: int
    feasibility_tol: float
    centrality_tol: float
    op_tol: float
    eps: float

    aho_direction: bool
    is_primal_feasible: bool
    primal_error: float
    is_dual_feasible: bool
    dual_error: float
    is_central: bool
    centrality_error: float
    mu: float

    is_last_iter: bool
    ineq_status: IneqStatus
    verbose: bool

    primal_error_normalisation: float
    dual_error_normalisation: float
    mals_rank_restriction: int

    boundary_val: float = 1e-10
    ineq_boundary_val: float = 0.01
    sigma: float = 0.5
    num_ineq_constraints: float = 0
    lag_map_t: Optional[TT] = None
    lag_map_y: Optional[TT] = None
    compl_ineq_mask: Optional[TT] = None
    mals_delta0: Optional[TT] = None
    eigen_x0: Optional[TT] = None
    eigen_z0: Optional[TT] = None
    eigen_xt0: Optional[TT] = None
    eigen_zt0: Optional[TT] = None
    kkt_iterations: int = 7
    centrl_error_normalisation: float = 1.0
    eta: float = 1e-3
    # absolute Newton-residual target of the refinement rounds
    refine_target: Optional[float] = None


# ---------------------------------------------------------------------------
# Residuals / KKT assembly
# ---------------------------------------------------------------------------

def tt_compute_primal_feasibility(lin_op_tt, bias_tt, X_tt, status, rng):
    """L(X) - b at the working rounding budget."""
    budget = 0.01 * status.eta * status.primal_error_normalisation
    return tt_rank_reduce(
        tt_sub(tt_mat_vec_mul(lin_op_tt, tt_reshape(X_tt, (4,)), budget,
                              status.eps, rng=rng), bias_tt),
        budget,
    )


def _active(status) -> bool:
    return status.ineq_status is IneqStatus.ACTIVE


def tt_compute_dual_feasibility(obj_tt, lin_op_tt_adj, Z_tt, Y_tt, T_tt, status):
    """L^T(Y) - Z - C [- T]."""
    budget = 0.01 * status.eta * status.dual_error_normalisation
    dual_feas = tt_rank_reduce(
        tt_sub(
            tt_fast_matrix_vec_mul(lin_op_tt_adj, Y_tt, status.eps),
            tt_rank_reduce(tt_add(tt_reshape(Z_tt, (4,)), obj_tt), status.eps),
        ),
        status.eps if _active(status) else budget,
    )
    if _active(status) and T_tt is not None:
        dual_feas = tt_rank_reduce(tt_sub(dual_feas, tt_reshape(T_tt, (4,))), budget)
    return dual_feas


def _tt_symmetrise(matrix_tt, err_bound):
    return tt_rank_reduce(
        tt_scale(0.5, tt_add(matrix_tt, tt_transpose(matrix_tt))), eps=err_bound)


def _tt_psd_symmetrise(matrix_tt, err_bound, return_shift=False):
    return tt_psd_rank_reduce(
        tt_scale(0.5, tt_add(matrix_tt, tt_transpose(matrix_tt))),
        eps=err_bound, return_shift=return_shift)


def _tt_mask_symmetrise(matrix_tt, mask_tt, err_bound):
    return tt_mask_rank_reduce(
        tt_scale(0.5, tt_add(matrix_tt, tt_transpose(matrix_tt))), mask_tt, eps=err_bound)


def tt_compute_centrality(X_tt, Z_tt, status, rng):
    """-(XZ), symmetrised under AHO, as a vec'd TT."""
    budget = 0.01 * status.eta * status.centrl_error_normalisation
    if status.aho_direction:
        prod = _tt_symmetrise(
            tt_mat_mat_mul(X_tt, Z_tt, budget, status.eps, rng=rng), budget)
    else:
        prod = tt_mat_mat_mul(Z_tt, X_tt, budget, status.eps, rng=rng)
    return tt_reshape(tt_scale(-1, prod), (4,))


def tt_infeasible_newton_system(lhs, obj_tt, X_tt, Y_tt, Z_tt, T_tt, lin_op_tt,
                                lin_op_tt_adj, bias_tt, ineq_mask, status, rng):
    """Assemble the per-iteration KKT blocks and right-hand side."""
    rhs = TTBlockVector()

    primal_feas = tt_compute_primal_feasibility(lin_op_tt, bias_tt, X_tt, status, rng)
    status.primal_error = tt_norm(primal_feas) / status.primal_error_normalisation
    status.is_primal_feasible = status.primal_error < status.feasibility_tol

    dual_feas = tt_compute_dual_feasibility(obj_tt, lin_op_tt_adj, Z_tt, Y_tt, T_tt, status)
    status.dual_error = tt_norm(dual_feas) / status.dual_error_normalisation
    status.is_dual_feasible = status.dual_error < (1 + _active(status)) * status.feasibility_tol

    status.is_last_iter = status.is_last_iter or (
        status.is_primal_feasible and status.is_dual_feasible and status.is_central)

    dual_budget = 0.1 * status.eta * status.dual_error_normalisation
    primal_budget = 0.1 * status.eta * status.primal_error_normalisation
    if status.aho_direction:
        lhs[2, 1] = tt_psd_rank_reduce(
            tt_scale(0.5, tt_add(tt_IkronM(Z_tt), tt_MkronI(Z_tt))), eps=dual_budget)
        lhs[2, 2] = tt_psd_rank_reduce(
            tt_scale(0.5, tt_add(tt_MkronI(X_tt), tt_IkronM(X_tt))), eps=primal_budget)
    else:
        lhs[2, 1] = tt_psd_rank_reduce(tt_MkronI(Z_tt), eps=dual_budget)
        lhs[2, 2] = tt_psd_rank_reduce(tt_IkronM(X_tt), eps=primal_budget)

    if not status.is_primal_feasible or status.is_last_iter:
        rhs[0] = primal_feas
    if not status.is_dual_feasible or status.is_last_iter:
        rhs[1] = dual_feas
    if not status.is_central or status.is_last_iter:
        rhs[2] = tt_compute_centrality(X_tt, Z_tt, status, rng)

    if _active(status):
        lhs[3, 1] = tt_diag_op(T_tt, dual_budget)
        masked_X_tt = tt_rank_reduce(
            tt_add(tt_scale(status.ineq_boundary_val, ineq_mask),
                   tt_fast_hadamard(ineq_mask, X_tt, status.eps)),
            eps=status.eps)
        lhs[3, 3] = tt_rank_reduce(
            tt_add(status.lag_map_t, tt_diag_op(masked_X_tt, status.eps)), eps=dual_budget)
        if not status.is_central or status.is_last_iter:
            rhs[3] = tt_rank_reduce(
                tt_reshape(tt_scale(-1, tt_fast_hadamard(masked_X_tt, T_tt, status.eps)), (4,)),
                eps=0.01 * status.eta * status.centrl_error_normalisation)
    return lhs, rhs, status


# ---------------------------------------------------------------------------
# KKT row equilibration: balance the feasibility rows (0, 1) against the
# centrality rows (2, 3) by their rhs norms, clipped into [1e-6, 1e6], with
# a geometric-mean compromise for blocks whose transpose or alias mirror
# lives in a differently-scaled row.
# ---------------------------------------------------------------------------

_SCALE_FLOOR = 1e-6
_SCALE_CEIL = 1e6
_FEAS_ROWS = (0, 1)
_CENT_ROWS = (2, 3)


def _rhs_group_norm(rhs_vec_tt, rows) -> float:
    worst = 0.0
    for r in rows:
        row_tt = rhs_vec_tt.get_row(r)
        if row_tt is None:
            continue
        n = float(tt_norm(row_tt))
        if np.isfinite(n):
            worst = max(worst, n)
    return worst


def _kkt_equilibration(rhs_vec_tt, status) -> Dict[int, float]:
    """Row -> multiplicative scale, empty when no row needs balancing."""
    tol = max(status.op_tol, 1e-12)
    scales: Dict[int, float] = {}
    feas = _rhs_group_norm(rhs_vec_tt, _FEAS_ROWS)
    if feas > tol:
        s_feas = min(max(1.0 / feas, _SCALE_FLOOR), _SCALE_CEIL)
        scales.update(dict.fromkeys(_FEAS_ROWS, s_feas))
    cent = _rhs_group_norm(rhs_vec_tt, _CENT_ROWS)
    if cent > tol:
        s_cent = min(max(1.0 / cent, _SCALE_FLOOR), _SCALE_CEIL)
        if 0 in scales:
            # never let centrality outweigh feasibility
            s_cent = min(s_cent, scales[0])
        scales.update(dict.fromkeys(_CENT_ROWS, s_cent))
    return scales


def _coupled_block_scale(lhs, key, scales) -> float:
    s = scales.get(key[0], 1.0)
    for coupling in (lhs._transposes, lhs._aliases):
        mirror = coupling.get(key)
        if mirror is not None and mirror[0] in scales:
            s = float(np.sqrt(s * scales[mirror[0]]))
    return s


def _apply_equilibration(lhs, rhs, scales):
    if not scales:
        return lhs, rhs
    lhs_eq = TTBlockMatrix()
    lhs_eq._aliases = dict(lhs._aliases)
    lhs_eq._transposes = dict(lhs._transposes)
    for key, block in lhs._data.items():
        s = _coupled_block_scale(lhs, key, scales)
        lhs_eq[key] = block if np.isclose(s, 1.0) else tt_scale(s, block)
    rhs_eq = TTBlockVector()
    for row in rhs.keys():
        s = scales.get(row, 1.0)
        row_tt = rhs.get_row(row)
        rhs_eq[row] = row_tt if np.isclose(s, 1.0) else tt_scale(s, row_tt)
    return lhs_eq, rhs_eq


# ---------------------------------------------------------------------------
# Newton step (predictor + Mehrotra centering-corrector)
# ---------------------------------------------------------------------------

def _solve_kkt(solver, lhs, rhs, status):
    Delta_tt, _ = solver(
        lhs, rhs, status.mals_delta0,
        status.kkt_iterations + status.is_last_iter,
        status.mals_rank_restriction, status.eta,
        refine_target=status.refine_target,
    )
    # Round the warm start to its effective ranks before storing, or the
    # ladder ratchets to the largest solve rank ever reached.
    try:
        eps_ws = 0.1 * status.eta * tt_norm(Delta_tt)
        status.mals_delta0 = tt_rank_reduce(Delta_tt, eps=eps_ws)
    except (torch.linalg.LinAlgError, FloatingPointError):
        status.mals_delta0 = Delta_tt
    return Delta_tt


def _extract_directions(Delta_tt, ineq_mask, status):
    """Block order (0=dY, 1=dX, 2=dZ, 3=dT); dX/dZ symmetrised, dT masked
    (None unless the inequalities are active)."""
    for c in Delta_tt:
        if not bool(torch.isfinite(c).all()):
            raise FloatingPointError("non-finite Newton direction")
    dY = tt_rank_reduce(tt_get_block(0, Delta_tt), eps=status.eps)
    dX = _tt_symmetrise(tt_reshape(tt_get_block(1, Delta_tt), (2, 2)), status.eps)
    dZ = _tt_symmetrise(tt_reshape(tt_get_block(2, Delta_tt), (2, 2)), status.eps)
    dT = None
    if _active(status):
        raw = tt_rank_reduce(tt_get_block(3, Delta_tt), eps=status.eps)
        dT = tt_fast_hadamard(ineq_mask, tt_reshape(raw, (2, 2)), status.eps)
    return dY, dX, dZ, dT


def _accumulate_directions(base, extra, status):
    """Predictor + corrector direction sums (rounded per component)."""
    return tuple(b if b is None or e is None else tt_rank_reduce(tt_add(b, e), eps=status.eps)
                 for b, e in zip(base, extra))


def _affine_gap_estimate(gap0, A_tt, dA, B_tt, dB, a, b):
    """<A + a dA, B + b dB> given gap0 = <A, B>."""
    return (gap0 + a * b * tt_inner_prod(dA, dB) + b * tt_inner_prod(A_tt, dB)
            + a * tt_inner_prod(dA, B_tt))


def _mehrotra_sigma(mu_aff, gap, a, b):
    """sigma = clip((mu_aff / gap)^e), e = max(1, 3 min(a, b)^2)."""
    e = max(1, 3 * min(a, b) ** 2)
    return min(0.99, max(mu_aff / gap, 0) ** e)


def _rhs_augment(rhs_vec_tt, row, terms, budget):
    acc = rhs_vec_tt.get_row(row)
    for t in terms:
        acc = tt_add(acc, t)
    rhs_vec_tt[row] = tt_rank_reduce(acc, budget)


def _corrector_rhs(rhs_vec_tt, dX, dZ, DXZ, ineq_mask, status, dim, rng):
    """Fold sigma*mu*I centering and the -dX dZ second-order term into the
    centrality row; mirror the centering onto the inequality row."""
    budget = 0.1 * status.eta * status.centrl_error_normalisation
    centering = status.sigma > 1e-4
    terms = []
    if centering:
        ref = dX[0]
        eye = tt_identity(dim, device=ref.device, dtype=ref.dtype)
        terms.append(tt_scale(status.sigma * status.mu, tt_reshape(eye, (4,))))
    if DXZ > 0.1 * status.centrality_tol:
        terms.append(tt_compute_centrality(dX, dZ, status, rng))
    if terms:
        _rhs_augment(rhs_vec_tt, 2, terms, budget)
    if centering and _active(status):
        _rhs_augment(rhs_vec_tt, 3,
                     [tt_scale(status.sigma * status.mu, tt_reshape(ineq_mask, (4,)))], budget)


def _tt_ipm_newton_step(lhs_matrix_tt, rhs_vec_tt, ineq_mask, X_tt, Z_tt, T_tt, ZX, TX,
                        status, solver, rng):
    """Predictor solve -> step sizes -> Mehrotra sigma -> corrector solve.
    A numerical failure routes the outer loop into its finishing branch;
    a kernel or device fault raises."""
    try:
        return _newton_step_inner(lhs_matrix_tt, rhs_vec_tt, ineq_mask, X_tt, Z_tt, T_tt, ZX,
                                  TX, status, solver, rng)
    except _NOT_RECOVERED:
        raise
    except Exception as e:
        # Total-function recovery: AmenToleranceReached and numerical
        # failures all route the outer loop into its PSD-boundary /
        # finishing branch, as in the JAX package.
        print(f"\n\tAttention: {e}")
        traceback.print_exc(file=sys.stdout)
        return 0, 0, None, None, None, None, status


def _newton_step_inner(lhs_matrix_tt, rhs_vec_tt, ineq_mask, X_tt, Z_tt, T_tt, ZX, TX,
                       status, solver, rng):
    row_scales = _kkt_equilibration(rhs_vec_tt, status)
    lhs_p, rhs_p = _apply_equilibration(lhs_matrix_tt, rhs_vec_tt, row_scales)
    delta = _solve_kkt(solver, lhs_p, rhs_p, status)
    dY, dX, dZ, dT = _extract_directions(delta, ineq_mask, status)

    x_step, z_step = _tt_get_step_sizes(X_tt, Z_tt, T_tt, dX, dZ, dT, ineq_mask, status, rng)

    if status.is_central or status.is_last_iter:
        status.sigma = 0
        return x_step, z_step, dX, dY, dZ, dT, status

    DXZ = tt_inner_prod(dX, dZ)
    mu_aff = _affine_gap_estimate(ZX, X_tt, dX, Z_tt, dZ, x_step, z_step)
    gap = ZX
    if _active(status):
        mu_aff += _affine_gap_estimate(TX, X_tt, dX, T_tt, dT, x_step, z_step)
        # the barrier shift beta contributes through sum(dT) on the mask
        mu_aff += z_step * status.ineq_boundary_val * tt_entrywise_sum(dT)
        gap = ZX + TX
    status.sigma = _mehrotra_sigma(mu_aff, gap, x_step, z_step)

    _corrector_rhs(rhs_vec_tt, dX, dZ, DXZ, ineq_mask, status, len(X_tt), rng)

    lhs_c, rhs_c = _apply_equilibration(lhs_matrix_tt, rhs_vec_tt, row_scales)
    delta_c = _solve_kkt(solver, lhs_c, rhs_c, status)
    corr = _extract_directions(delta_c, ineq_mask, status)
    dY, dX, dZ, dT = _accumulate_directions((dY, dX, dZ, dT), corr, status)

    x_step, z_step = _tt_get_step_sizes(X_tt, Z_tt, T_tt, dX, dZ, dT, ineq_mask, status, rng)
    return x_step, z_step, dX, dY, dZ, dT, status


# ---------------------------------------------------------------------------
# Step sizes: largest alpha keeping X + alpha dX (and Z) in the cone, then
# the fraction-to-boundary backoff tau = 0.9 + 0.05 min(alpha).
# ---------------------------------------------------------------------------

def _regularised(A_tt, shift, dim):
    ref = A_tt[0]
    return tt_add(A_tt, tt_scale(shift, tt_identity(dim, device=ref.device, dtype=ref.dtype)))


def _tt_get_step_sizes(X_tt, Z_tt, T_tt, Delta_X_tt, Delta_Z_tt, Delta_T_tt, ineq_mask,
                       status, rng):
    dim = len(X_tt)
    if status.is_last_iter:
        # the refinement phase line-searches against a pushed-out boundary
        X_tt = _regularised(X_tt, status.boundary_val, dim)
        Z_tt = _regularised(Z_tt, status.boundary_val, dim)
    eigen = tt_max_generalised_eigen_fused if config.fused_kkt() else tt_max_generalised_eigen
    x_step, status.eigen_x0 = eigen(
        X_tt, Delta_X_tt, x0=status.eigen_x0, tol=1e-8, verbose=status.verbose, rng=rng)
    z_step, status.eigen_z0 = eigen(
        Z_tt, Delta_Z_tt, x0=status.eigen_z0, tol=1e-8, verbose=status.verbose, rng=rng)

    if status.ineq_status is not IneqStatus.NOT_IN_USE:
        if status.is_last_iter:
            shift = status.ineq_boundary_val + status.boundary_val
            X_tt = tt_add(X_tt, tt_scale(shift, ineq_mask))
            T_tt = tt_add(T_tt, tt_scale(shift, ineq_mask))
        x_step, z_step = _tt_get_ineq_step_sizes(
            x_step, z_step, X_tt, T_tt, Delta_X_tt, Delta_T_tt, ineq_mask, status, rng)

    tau = 0.9 + 0.05 * min(x_step, z_step)
    if status.verbose:
        print(f"Step sizes: a_p:{x_step:.2e}, a_d:{z_step:.2e}", flush=True)
    return tau * x_step, tau * z_step


def _ineq_step_size(A_tt, Delta_tt, e_tt, status, rng):
    """Largest alpha with (A + alpha Delta) >= 0 entrywise on the mask: one
    smallest-eigenvector sweep over Diag(A + Delta); where the minimiser
    localises on an entry of the mask, the entries of A and Delta there
    give the exact boundary ratio.  Returns alpha and the eigenvector train
    (the warm start of the next call).  Reads two or three inner products."""
    trial = tt_add(A_tt, Delta_tt)
    if status.compl_ineq_mask is not None:
        trial = tt_add(trial, status.compl_ineq_mask)
    trial = tt_rank_reduce(trial, status.eps)
    min_eig = tt_min_eig_fused if config.fused_kkt() else tt_min_eig
    e_tt, _ = min_eig(tt_diag_op(trial, status.eps), x0=e_tt, tol=1e-8, verbose=status.verbose,
                      rng=rng)
    e_sq = tt_reshape(e_tt, (2, 2))
    if abs(tt_inner_prod(trial, e_sq)) <= status.eps:
        # the minimiser sits on an entry off the mask: the step is free
        return 1.0, e_tt
    weight = tt_normalise(tt_fast_hadamard(e_sq, e_sq, status.eps))
    here_A = abs(tt_inner_prod(A_tt, weight))
    here_D = tt_inner_prod(Delta_tt, weight)
    if here_D >= -status.eps:
        return 1.0, e_tt
    return float(np.clip(-here_A / here_D, 0, 1)), e_tt


def _tt_get_ineq_step_sizes(x_step, z_step, X_tt, T_tt, Delta_X_tt, Delta_T_tt, ineq_mask,
                            status, rng):
    if x_step > 0:
        masked_X = tt_fast_hadamard(ineq_mask, X_tt, status.eps)
        masked_DX = tt_fast_hadamard(ineq_mask, Delta_X_tt, status.eps)
        x_ineq_step, status.eigen_xt0 = _ineq_step_size(
            tt_add(masked_X, tt_scale(status.ineq_boundary_val, ineq_mask)),
            tt_scale(x_step, masked_DX), status.eigen_xt0, status, rng)
        if not status.is_last_iter:
            # the activation state machine: a full step with a vanished T
            # means the inequality constraints have gone slack
            if 1 - x_ineq_step < status.op_tol and tt_norm(T_tt) < status.op_tol:
                if _active(status):
                    status.ineq_status = IneqStatus.SETTING_INACTIVE
            elif status.ineq_status is IneqStatus.INACTIVE:
                status.ineq_status = IneqStatus.SETTING_ACTIVE
        x_step *= x_ineq_step

    if z_step > 0 and _active(status):
        t_step, status.eigen_zt0 = _ineq_step_size(
            T_tt, tt_scale(z_step, Delta_T_tt), status.eigen_zt0, status, rng)
        z_step *= t_step
    return x_step, z_step


# ---------------------------------------------------------------------------
# Outer loop
# ---------------------------------------------------------------------------

def _ipm_check_for_stalled_progress(prev_errors, status, gap_tol):
    if status.is_last_iter:
        return False
    primal = abs(prev_errors["primal"] - status.primal_error) < 0.04 * gap_tol
    dual = abs(prev_errors["dual"] - status.dual_error) < 0.04 * gap_tol
    central = abs(prev_errors["centrality"] - status.centrality_error) < 0.02 * gap_tol
    return primal and dual and central


def _ipm_check_convergence(status, finishing_steps, ZX, TX, abs_tol, max_refinement,
                           prev_slack=np.inf, can_extend=False):
    if not status.is_last_iter:
        return status, finishing_steps
    slack = abs(ZX) + abs(TX)
    converged = (slack < abs_tol and status.primal_error < abs_tol
                 and status.dual_error < abs_tol)
    if converged:
        finishing_steps = 0
    else:
        # Progress-aware countdown: while the absolute slack still halves
        # per iteration (and max_iter has room), hold the countdown at 1.
        rapid = np.isfinite(prev_slack) and slack < 0.5 * prev_slack
        held = finishing_steps == 1 and rapid and can_extend
        if not held:
            finishing_steps -= 1
            if finishing_steps == 1:
                status.kkt_iterations += 1
        status.boundary_val = 0.001 * (1 - (max(finishing_steps, 0) / max_refinement))
    return status, finishing_steps


def _ipm_log_iteration(iteration, status, X_tt, Y_tt, Z_tt, T_tt):
    print(f"\n--- Iteration {iteration - 1} ---")
    print(f"Status: Finishing up={status.is_last_iter}, Ineq={status.ineq_status}")
    print(f"Feasibility: Central={status.is_central}, "
          f"Primal={status.is_primal_feasible}, Dual={status.is_dual_feasible}")
    print(f"Direction: {'AHO' if status.aho_direction else 'XZ'}, Sigma: {status.sigma:.2e}")
    print(f"Errors: Centrality={status.centrality_error:.4e}, "
          f"Primal={status.primal_error:.4e}, Dual={status.dual_error:.4e}")
    print(f"Ranks: X={tt_ranks(X_tt)}, Z={tt_ranks(Z_tt)}, Y={tt_ranks(Y_tt)}, "
          f"T={tt_ranks(T_tt) if T_tt else 'N/A'}", flush=True)


def _make_solver(dim, op_tol, mals_restarts, verbose, rng, local, ineq):
    """The Newton solver of the equality system, or of the inequality
    system (``ineq``, with ``local`` its local KKT solver): the ragged AMEn
    with ``local`` when ``config.fused_kkt()`` is off; else the fused
    ladder, which falls back to the ragged AMEn when it exhausts its
    restarts.  The fallback is sticky (later solves go straight to the
    ragged AMEn) until a warm start fits the ladder's rank cap again, at
    most 3 consecutive failures."""
    def ragged(lhs, rhs, x0, nwsp, restriction, termination_tol, refine_target=None):
        return tt_restarted_block_amen(
            lhs, rhs, rank_restriction=restriction, x0=x0, local_solver=local,
            op_tol=op_tol, termination_tol=termination_tol, num_restarts=mals_restarts,
            inner_m=nwsp, verbose=verbose, refine_target=refine_target, rng=rng)

    if not config.fused_kkt():
        return ragged

    state = {"fused_ok": True, "fails": 0}

    def warm_fits_ladder(x0, restriction):
        if x0 is None:
            return False
        warm_r = max((int(c.shape[-1]) for c in x0[:-1]), default=4)
        return warm_r <= ladder_rank_cap(restriction, dim)

    def solver(lhs, rhs, x0, nwsp, restriction, termination_tol, refine_target=None):
        if not state["fused_ok"]:
            if state["fails"] < 3 and warm_fits_ladder(x0, restriction):
                state["fused_ok"] = True
                if verbose:
                    print("\t[fused] warm start fits ladder cap -> retrying fused (un-stick)")
            else:
                return ragged(lhs, rhs, x0, nwsp, restriction, termination_tol, refine_target)
        try:
            out = tt_restarted_block_amen_fused(
                lhs, rhs, rank_restriction=restriction, op_tol=op_tol,
                termination_tol=termination_tol, num_restarts=mals_restarts,
                inner_m=nwsp, x0=x0, verbose=verbose,
                refine_target=refine_target, rng=rng, ineq=ineq)
            state["fails"] = 0
            return out
        except AmenRestartsExhausted:
            state["fused_ok"] = False
            state["fails"] += 1
            if verbose:
                print(f"\t[fused] restarts exhausted -> ragged AMEn (sticky, fail {state['fails']})")
            return ragged(lhs, rhs, x0, nwsp, restriction, termination_tol, refine_target)
    return solver


def tt_ipm(
    lag_maps,
    obj_tt,
    lin_op_tt,
    bias_tt,
    ineq_mask=None,
    max_iter=100,
    max_refinement=5,
    warm_up=3,
    gap_tol=1e-4,
    aho_direction=True,
    op_tol=1e-5,
    abs_tol=8e-4,
    eps=1e-12,
    mals_restarts=3,
    r_max=1000,
    lambdaStar=1,
    lambdaStarIneq=1,
    checkpoint_path=None,
    checkpoint_every=1,
    resume_from=None,
    verbose=False,
    rng=None,
):
    """TT interior-point driver.  Returns ``(X_tt, Y_tt, T_tt, Z_tt,
    results)`` with results carrying the iteration count, the final TT
    ranks (``ranksT`` zeros without inequalities) and the final
    ``IPMStatus``; ``T_tt`` is None without ``ineq_mask``.  ``ineq_mask``
    (a TT matrix of 0/1 entries) adds the constraints X >= -beta on its
    support, ``lag_maps["t"]`` their multiplier support map.  The device is
    that of the problem trains.  ``rng``: numpy RandomState of every random
    draw of the solve (default numpy's global one, as the JAX package
    draws).

    ``aho_direction`` is accepted for signature parity and, as in the JAX
    package, overridden every iteration: XZ for the first ``warm_up``
    iterations, AHO after."""
    if checkpoint_path is not None or resume_from is not None:
        raise NotImplementedError("checkpointing is not ported yet")
    rng = np.random if rng is None else rng
    ref = obj_tt[0]
    dim = len(obj_tt)
    centrality_tol = gap_tol / np.sqrt(dim)
    feasibility_tol = 2 * gap_tol
    status = IPMStatus(
        dim, feasibility_tol, centrality_tol, op_tol, eps,
        aho_direction, False, np.inf, False, np.inf, False, np.inf, np.inf,
        False, IneqStatus.NOT_IN_USE if ineq_mask is None else IneqStatus.ACTIVE,
        verbose, 1, 1, r_max,
    )
    lag_maps = {k: tt_rank_reduce(v, eps=eps) for k, v in lag_maps.items()}
    obj_tt = tt_rank_reduce(obj_tt, eps=eps)
    lin_op_tt = tt_rank_reduce(lin_op_tt, eps=eps)
    bias_tt = tt_rank_reduce(bias_tt, eps=eps)

    status.primal_error_normalisation = 1 + tt_norm(bias_tt)
    status.dual_error_normalisation = 1 + tt_norm(obj_tt)

    def identity(d):
        return tt_identity(d, device=ref.device, dtype=ref.dtype)

    lhs_skeleton = TTBlockMatrix()
    lhs_skeleton[1, 2] = tt_reshape(identity(2 * dim), (4, 4))
    solver_eq = _make_solver(dim, op_tol, mals_restarts, verbose, rng, ipm_local_solver, False)
    solver_ineq = _make_solver(dim, op_tol, mals_restarts, verbose, rng,
                               ipm_local_solver_ineq, True)
    if _active(status):
        solver = solver_ineq
        status.num_ineq_constraints = tt_inner_prod(ineq_mask, ineq_mask)
        status.compl_ineq_mask = tt_rank_reduce(
            tt_sub(tt_one_matrix(dim, device=ref.device, dtype=ref.dtype), ineq_mask), eps=eps)
        status.lag_map_t = lag_maps["t"]
        lhs_skeleton.add_alias((1, 2), (1, 3))
    else:
        solver = solver_eq

    lin_op_tt_adj = tt_transpose(lin_op_tt)
    lhs_skeleton[0, 1] = tt_scale(-1, lin_op_tt)
    lhs_skeleton.add_alias((0, 1), (1, 0), is_transpose=True)
    lhs_skeleton[0, 0] = lag_maps["y"]
    status.lag_map_y = lag_maps["y"]

    # X = Z = lambda* I, Y = 0; with inequalities T = lambda*_ineq mask and X
    # shifted along the mask as far as X stays PSD
    X_tt = tt_scale(lambdaStar, identity(dim))
    Z_tt = tt_scale(lambdaStar, identity(dim))
    Y_tt = tt_reshape(tt_zero_matrix(dim, device=ref.device, dtype=ref.dtype), (4,))
    T_tt = None
    if _active(status):
        T_tt = tt_scale(lambdaStarIneq, ineq_mask)
        eigen = tt_max_generalised_eigen_fused if config.fused_kkt() else tt_max_generalised_eigen
        x_step, _ = eigen(X_tt, ineq_mask, tol=1e-7, verbose=verbose, rng=rng)
        X_tt = tt_rank_reduce(tt_add(X_tt, tt_scale(0.1 * x_step, ineq_mask)),
                              0.1 * status.eta * status.primal_error_normalisation)

    iteration = 0
    finishing_steps = max_refinement
    prev_errors = {"primal": np.inf, "dual": np.inf, "centrality": np.inf}
    lhs = lhs_skeleton

    while finishing_steps > 0:
        iteration += 1
        status.aho_direction = iteration > warm_up
        if max_iter - max_refinement == iteration - 1 and not status.is_last_iter:
            if verbose:
                print("=== maximum iterations reached: entering finishing phase ===")
            status.is_last_iter = True
        ZX = tt_inner_prod(Z_tt, X_tt)
        TX = (tt_inner_prod(X_tt, T_tt) + status.ineq_boundary_val * tt_entrywise_sum(T_tt)
              if _active(status) else 0)
        status.mu = (abs(ZX) + abs(TX)) / (2**dim + _active(status) * status.num_ineq_constraints)
        status.centrl_error_normalisation = 1 + abs(
            tt_inner_prod(obj_tt, tt_reshape(X_tt, (4,))))
        status.centrality_error = status.mu / status.centrl_error_normalisation
        status.is_central = status.centrality_error < centrality_tol
        status.eta = max(min(status.eta, 2 * status.mu), status.op_tol)
        # Newton-residual refinement target: keep the slack injected by the
        # PSD compensation shifts (~ rn * trace) an order below abs_tol,
        # relaxed while the current slack is still far above it.
        if config.newton_refine():
            tr_scale = max(1.0, abs(float(tt_trace(X_tt))), abs(float(tt_trace(Z_tt))))
            status.refine_target = max(0.1 * abs_tol, 1e-3 * (abs(ZX) + abs(TX))) / tr_scale
        else:
            status.refine_target = None

        lhs_matrix_tt, rhs_vec_tt, status = tt_infeasible_newton_system(
            lhs, obj_tt, X_tt, Y_tt, Z_tt, T_tt, lin_op_tt, lin_op_tt_adj, bias_tt,
            ineq_mask, status, rng)

        if verbose:
            _ipm_log_iteration(iteration, status, X_tt, Y_tt, Z_tt, T_tt)

        status, finishing_steps = _ipm_check_convergence(
            status, finishing_steps, ZX, TX, abs_tol, max_refinement,
            prev_slack=prev_errors.get("slack", np.inf),
            can_extend=iteration < max_iter)
        prev_errors["slack"] = abs(ZX) + abs(TX)
        if finishing_steps == 0:
            iteration -= 1
            break

        x_step, z_step, Delta_X_tt, Delta_Y_tt, Delta_Z_tt, Delta_T_tt, status = (
            _tt_ipm_newton_step(lhs_matrix_tt, rhs_vec_tt, ineq_mask, X_tt, Z_tt, T_tt, ZX, TX,
                                status, solver, rng))

        if (Delta_X_tt is None and Delta_Z_tt is None) or (x_step < 1e-5 and z_step < 1e-5):
            if status.is_last_iter:
                break
            if verbose:
                print("=== hit PSD boundary: entering finishing phase ===")
            status.is_last_iter = True
        else:
            primal_budget = 0.1 * status.eta * status.primal_error_normalisation
            dual_budget = 0.1 * status.eta * status.dual_error_normalisation
            if finishing_steps <= 1:
                X_tt = _tt_symmetrise(tt_add(X_tt, tt_scale(x_step, Delta_X_tt)),
                                      primal_budget)
                Z_tt = _tt_symmetrise(tt_add(Z_tt, tt_scale(z_step, Delta_Z_tt)),
                                      dual_budget)
            else:
                X_tt, shift_x = _tt_psd_symmetrise(
                    tt_add(X_tt, tt_scale(x_step, Delta_X_tt)), primal_budget,
                    return_shift=True)
                Z_tt, shift_z = _tt_psd_symmetrise(
                    tt_add(Z_tt, tt_scale(z_step, Delta_Z_tt)), dual_budget,
                    return_shift=True)
                if verbose and (shift_x > 0 or shift_z > 0):
                    inj = shift_x * tt_trace(Z_tt) + shift_z * tt_trace(X_tt)
                    print(f"\tPSD-shift: X {shift_x:.2e}, Z {shift_z:.2e}, "
                          f"slack injection ~{inj:.2e}")

            Y_tt = tt_rank_reduce(tt_add(Y_tt, tt_scale(z_step, Delta_Y_tt)), status.eps)
            Y_tt = tt_reshape(
                _tt_symmetrise(
                    tt_reshape(
                        tt_sub(Y_tt, tt_fast_matrix_vec_mul(status.lag_map_y, Y_tt,
                                                            status.eps)),
                        (2, 2)),
                    dual_budget),
                (4,))

            if _active(status):
                T_new = tt_add(T_tt, tt_scale(z_step, Delta_T_tt))
                T_tt = (_tt_symmetrise(T_new, dual_budget) if finishing_steps <= 1
                        else _tt_mask_symmetrise(T_new, ineq_mask, dual_budget))
            elif status.ineq_status is IneqStatus.SETTING_INACTIVE:
                solver = solver_eq
                lhs = lhs_skeleton.get_submatrix(2, 2)
                status.mals_delta0 = None
                status.ineq_status = IneqStatus.INACTIVE
            elif status.ineq_status is IneqStatus.SETTING_ACTIVE:
                solver = solver_ineq
                lhs = lhs_skeleton
                status.mals_delta0 = None
                status.ineq_status = IneqStatus.ACTIVE

        if _ipm_check_for_stalled_progress(prev_errors, status, gap_tol):
            if verbose:
                print("=== progress stalled: entering finishing phase ===")
            status.is_last_iter = True

        prev_errors["primal"] = status.primal_error
        prev_errors["dual"] = status.dual_error
        prev_errors["centrality"] = status.centrality_error

    if verbose:
        print(f"--- terminated after {iteration} iterations ---")
    results = {
        "num_iters": iteration,
        "ranksX": tt_ranks(X_tt),
        "ranksY": tt_ranks(Y_tt),
        "ranksZ": tt_ranks(Z_tt),
        "ranksT": tt_ranks(T_tt) if T_tt else [0] * (dim - 1),
        "status": status,
    }
    return X_tt, Y_tt, T_tt, Z_tt, results
