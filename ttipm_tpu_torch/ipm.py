"""Primal-dual predictor-corrector interior-point method in TT format,
equality path.

Solves  min <C, X>  s.t.  L(X) = b,  X PSD  with the iterates X, Y, Z held
as tensor trains.  Each iteration assembles the block-TT Newton system,
solves it with the fused fixed-rank AMEn ladder (the ragged AMEn when the
ladder exhausts its restarts), line-searches the PSD cone with the fused
TT generalised eigensolver, and rounds the updated iterates with
PSD-preserving TT rounding.  ``config.set_fused_kkt(False)`` selects the
ragged (reference-faithful) KKT solver and eigensolver throughout.

Counterpart of ``ttipm_tpu/ipm.py`` (equality path).  Not ported yet:
inequality constraints (``ineq_mask``) and checkpointing.
"""

from __future__ import annotations

import sys
import traceback
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.ops.kernels import KernelError
from ttipm_tpu_torch.ops.products import tt_fast_matrix_vec_mul, tt_mat_mat_mul, tt_mat_vec_mul
from ttipm_tpu_torch.ops.rounding import tt_psd_rank_reduce, tt_rank_reduce
from ttipm_tpu_torch.ops.tt import (
    TT,
    tt_add,
    tt_identity,
    tt_IkronM,
    tt_inner_prod,
    tt_MkronI,
    tt_norm,
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
from ttipm_tpu_torch.solvers.eigen import tt_max_generalised_eigen
from ttipm_tpu_torch.solvers.fused import tt_restarted_block_amen_fused
from ttipm_tpu_torch.solvers.fused_eigen import tt_max_generalised_eigen_fused
from ttipm_tpu_torch.solvers.local_kkt import ipm_local_solver

__all__ = ["tt_ipm", "IPMStatus"]


# Faults that the Newton step's total-function recovery must not turn into
# a zero step: a kernel that did not build or launch, a device error
# surfacing from an earlier asynchronous launch, device memory exhausted.
_NOT_RECOVERED = (KernelError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


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
    verbose: bool

    primal_error_normalisation: float
    dual_error_normalisation: float
    mals_rank_restriction: int

    boundary_val: float = 1e-10
    sigma: float = 0.5
    lag_map_y: Optional[TT] = None
    mals_delta0: Optional[TT] = None
    eigen_x0: Optional[TT] = None
    eigen_z0: Optional[TT] = None
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


def tt_compute_dual_feasibility(obj_tt, lin_op_tt_adj, Z_tt, Y_tt, status):
    """L^T(Y) - Z - C."""
    budget = 0.01 * status.eta * status.dual_error_normalisation
    return tt_rank_reduce(
        tt_sub(
            tt_fast_matrix_vec_mul(lin_op_tt_adj, Y_tt, status.eps),
            tt_rank_reduce(tt_add(tt_reshape(Z_tt, (4,)), obj_tt), status.eps),
        ),
        budget,
    )


def _tt_symmetrise(matrix_tt, err_bound):
    return tt_rank_reduce(
        tt_scale(0.5, tt_add(matrix_tt, tt_transpose(matrix_tt))), eps=err_bound)


def _tt_psd_symmetrise(matrix_tt, err_bound, return_shift=False):
    return tt_psd_rank_reduce(
        tt_scale(0.5, tt_add(matrix_tt, tt_transpose(matrix_tt))),
        eps=err_bound, return_shift=return_shift)


def tt_compute_centrality(X_tt, Z_tt, status, rng):
    """-(XZ), symmetrised under AHO, as a vec'd TT."""
    budget = 0.01 * status.eta * status.centrl_error_normalisation
    if status.aho_direction:
        prod = _tt_symmetrise(
            tt_mat_mat_mul(X_tt, Z_tt, budget, status.eps, rng=rng), budget)
    else:
        prod = tt_mat_mat_mul(Z_tt, X_tt, budget, status.eps, rng=rng)
    return tt_reshape(tt_scale(-1, prod), (4,))


def tt_infeasible_newton_system(lhs, obj_tt, X_tt, Y_tt, Z_tt, lin_op_tt,
                                lin_op_tt_adj, bias_tt, status, rng):
    """Assemble the per-iteration KKT blocks and right-hand side."""
    rhs = TTBlockVector()

    primal_feas = tt_compute_primal_feasibility(lin_op_tt, bias_tt, X_tt, status, rng)
    status.primal_error = tt_norm(primal_feas) / status.primal_error_normalisation
    status.is_primal_feasible = status.primal_error < status.feasibility_tol

    dual_feas = tt_compute_dual_feasibility(obj_tt, lin_op_tt_adj, Z_tt, Y_tt, status)
    status.dual_error = tt_norm(dual_feas) / status.dual_error_normalisation
    status.is_dual_feasible = status.dual_error < status.feasibility_tol

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
    return lhs, rhs, status


# ---------------------------------------------------------------------------
# KKT row equilibration: balance the feasibility rows (0, 1) against the
# centrality row (2) by their rhs norms, clipped into [1e-6, 1e6], with a
# geometric-mean compromise for blocks whose transpose mirror lives in a
# differently-scaled row.
# ---------------------------------------------------------------------------

_SCALE_FLOOR = 1e-6
_SCALE_CEIL = 1e6
_FEAS_ROWS = (0, 1)
_CENT_ROWS = (2,)


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


def _extract_directions(Delta_tt, status):
    """Block order (0=dY, 1=dX, 2=dZ); dX/dZ symmetrised."""
    for c in Delta_tt:
        if not bool(torch.isfinite(c).all()):
            raise FloatingPointError("non-finite Newton direction")
    dY = tt_rank_reduce(tt_get_block(0, Delta_tt), eps=status.eps)
    dX = _tt_symmetrise(tt_reshape(tt_get_block(1, Delta_tt), (2, 2)), status.eps)
    dZ = _tt_symmetrise(tt_reshape(tt_get_block(2, Delta_tt), (2, 2)), status.eps)
    return dY, dX, dZ


def _affine_gap_estimate(gap0, A_tt, dA, B_tt, dB, a, b):
    """<A + a dA, B + b dB> given gap0 = <A, B>."""
    return (gap0 + a * b * tt_inner_prod(dA, dB) + b * tt_inner_prod(A_tt, dB)
            + a * tt_inner_prod(dA, B_tt))


def _mehrotra_sigma(mu_aff, gap, a, b):
    """sigma = clip((mu_aff / gap)^e), e = max(1, 3 min(a, b)^2)."""
    e = max(1, 3 * min(a, b) ** 2)
    return min(0.99, max(mu_aff / gap, 0) ** e)


def _corrector_rhs(rhs_vec_tt, dX, dZ, DXZ, status, dim, rng):
    """Fold sigma*mu*I centering and the -dX dZ second-order term into the
    centrality row."""
    budget = 0.1 * status.eta * status.centrl_error_normalisation
    terms = []
    if status.sigma > 1e-4:
        ref = dX[0]
        eye = tt_identity(dim, device=ref.device, dtype=ref.dtype)
        terms.append(tt_scale(status.sigma * status.mu, tt_reshape(eye, (4,))))
    if DXZ > 0.1 * status.centrality_tol:
        terms.append(tt_compute_centrality(dX, dZ, status, rng))
    if terms:
        acc = rhs_vec_tt.get_row(2)
        for t in terms:
            acc = tt_add(acc, t)
        rhs_vec_tt[2] = tt_rank_reduce(acc, budget)


def _tt_ipm_newton_step(lhs_matrix_tt, rhs_vec_tt, X_tt, Z_tt, ZX, status,
                        solver, rng):
    """Predictor solve -> step sizes -> Mehrotra sigma -> corrector solve.
    A numerical failure routes the outer loop into its finishing branch;
    a kernel or device fault raises."""
    try:
        return _newton_step_inner(lhs_matrix_tt, rhs_vec_tt, X_tt, Z_tt, ZX,
                                  status, solver, rng)
    except _NOT_RECOVERED:
        raise
    except Exception as e:
        # Total-function recovery: AmenToleranceReached and numerical
        # failures all route the outer loop into its PSD-boundary /
        # finishing branch, as in the JAX package.
        print(f"\n\tAttention: {e}")
        traceback.print_exc(file=sys.stdout)
        return 0, 0, None, None, None, status


def _newton_step_inner(lhs_matrix_tt, rhs_vec_tt, X_tt, Z_tt, ZX, status,
                       solver, rng):
    row_scales = _kkt_equilibration(rhs_vec_tt, status)
    lhs_p, rhs_p = _apply_equilibration(lhs_matrix_tt, rhs_vec_tt, row_scales)
    delta = _solve_kkt(solver, lhs_p, rhs_p, status)
    dY, dX, dZ = _extract_directions(delta, status)

    x_step, z_step = _tt_get_step_sizes(X_tt, Z_tt, dX, dZ, status, rng)

    if status.is_central or status.is_last_iter:
        status.sigma = 0
        return x_step, z_step, dX, dY, dZ, status

    DXZ = tt_inner_prod(dX, dZ)
    mu_aff = _affine_gap_estimate(ZX, X_tt, dX, Z_tt, dZ, x_step, z_step)
    status.sigma = _mehrotra_sigma(mu_aff, ZX, x_step, z_step)

    _corrector_rhs(rhs_vec_tt, dX, dZ, DXZ, status, len(X_tt), rng)

    lhs_c, rhs_c = _apply_equilibration(lhs_matrix_tt, rhs_vec_tt, row_scales)
    delta_c = _solve_kkt(solver, lhs_c, rhs_c, status)
    corr = _extract_directions(delta_c, status)
    dY, dX, dZ = (tt_rank_reduce(tt_add(b, e), eps=status.eps)
                  for b, e in zip((dY, dX, dZ), corr))

    x_step, z_step = _tt_get_step_sizes(X_tt, Z_tt, dX, dZ, status, rng)
    return x_step, z_step, dX, dY, dZ, status


# ---------------------------------------------------------------------------
# Step sizes: largest alpha keeping X + alpha dX (and Z) in the cone, then
# the fraction-to-boundary backoff tau = 0.9 + 0.05 min(alpha).
# ---------------------------------------------------------------------------

def _regularised(A_tt, shift, dim):
    ref = A_tt[0]
    return tt_add(A_tt, tt_scale(shift, tt_identity(dim, device=ref.device, dtype=ref.dtype)))


def _tt_get_step_sizes(X_tt, Z_tt, Delta_X_tt, Delta_Z_tt, status, rng):
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
    tau = 0.9 + 0.05 * min(x_step, z_step)
    if status.verbose:
        print(f"Step sizes: a_p:{x_step:.2e}, a_d:{z_step:.2e}", flush=True)
    return tau * x_step, tau * z_step


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


def _ipm_check_convergence(status, finishing_steps, ZX, abs_tol, max_refinement,
                           prev_slack=np.inf, can_extend=False):
    if not status.is_last_iter:
        return status, finishing_steps
    slack = abs(ZX)
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


def _ipm_log_iteration(iteration, status, X_tt, Y_tt, Z_tt):
    print(f"\n--- Iteration {iteration - 1} ---")
    print(f"Status: Finishing up={status.is_last_iter}")
    print(f"Feasibility: Central={status.is_central}, "
          f"Primal={status.is_primal_feasible}, Dual={status.is_dual_feasible}")
    print(f"Direction: {'AHO' if status.aho_direction else 'XZ'}, Sigma: {status.sigma:.2e}")
    print(f"Errors: Centrality={status.centrality_error:.4e}, "
          f"Primal={status.primal_error:.4e}, Dual={status.dual_error:.4e}")
    print(f"Ranks: X={tt_ranks(X_tt)}, Z={tt_ranks(Z_tt)}, Y={tt_ranks(Y_tt)}", flush=True)


def _make_solver(dim, op_tol, mals_restarts, verbose, rng):
    """The Newton solver: the ragged AMEn with the local KKT solver when
    ``config.fused_kkt()`` is off; else the fused ladder, which falls back
    to the ragged AMEn when it exhausts its restarts.  The fallback is
    sticky (later solves go straight to the ragged AMEn) until a warm start
    fits the ladder's rank cap again, at most 3 consecutive failures."""
    def ragged(lhs, rhs, x0, nwsp, restriction, termination_tol, refine_target=None):
        return tt_restarted_block_amen(
            lhs, rhs, rank_restriction=restriction, x0=x0, local_solver=ipm_local_solver,
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
                refine_target=refine_target, rng=rng)
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
    ranks and the final ``IPMStatus``; ``T_tt`` is None on the equality
    path.  The device is that of the problem trains.  ``rng``: numpy
    RandomState of every random draw of the solve (default numpy's global
    one, as the JAX package draws).

    ``aho_direction`` is accepted for signature parity and, as in the JAX
    package, overridden every iteration: XZ for the first ``warm_up``
    iterations, AHO after."""
    if ineq_mask is not None:
        raise NotImplementedError("inequality constraints are not ported yet")
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
        False, verbose, 1, 1, r_max,
    )
    lag_maps = {k: tt_rank_reduce(v, eps=eps) for k, v in lag_maps.items()}
    obj_tt = tt_rank_reduce(obj_tt, eps=eps)
    lin_op_tt = tt_rank_reduce(lin_op_tt, eps=eps)
    bias_tt = tt_rank_reduce(bias_tt, eps=eps)

    status.primal_error_normalisation = 1 + tt_norm(bias_tt)
    status.dual_error_normalisation = 1 + tt_norm(obj_tt)

    lhs = TTBlockMatrix()
    lhs[1, 2] = tt_reshape(tt_identity(2 * dim, device=ref.device, dtype=ref.dtype), (4, 4))
    solver = _make_solver(dim, op_tol, mals_restarts, verbose, rng)

    lin_op_tt_adj = tt_transpose(lin_op_tt)
    lhs[0, 1] = tt_scale(-1, lin_op_tt)
    lhs.add_alias((0, 1), (1, 0), is_transpose=True)
    lhs[0, 0] = lag_maps["y"]
    status.lag_map_y = lag_maps["y"]

    X_tt = tt_scale(lambdaStar, tt_identity(dim, device=ref.device, dtype=ref.dtype))
    Z_tt = tt_scale(lambdaStar, tt_identity(dim, device=ref.device, dtype=ref.dtype))
    Y_tt = tt_reshape(tt_zero_matrix(dim, device=ref.device, dtype=ref.dtype), (4,))

    iteration = 0
    finishing_steps = max_refinement
    prev_errors = {"primal": np.inf, "dual": np.inf, "centrality": np.inf}

    while finishing_steps > 0:
        iteration += 1
        status.aho_direction = iteration > warm_up
        if max_iter - max_refinement == iteration - 1 and not status.is_last_iter:
            if verbose:
                print("=== maximum iterations reached: entering finishing phase ===")
            status.is_last_iter = True
        ZX = tt_inner_prod(Z_tt, X_tt)
        status.mu = abs(ZX) / 2**dim
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
            status.refine_target = max(0.1 * abs_tol, 1e-3 * abs(ZX)) / tr_scale
        else:
            status.refine_target = None

        lhs_matrix_tt, rhs_vec_tt, status = tt_infeasible_newton_system(
            lhs, obj_tt, X_tt, Y_tt, Z_tt, lin_op_tt, lin_op_tt_adj, bias_tt,
            status, rng)

        if verbose:
            _ipm_log_iteration(iteration, status, X_tt, Y_tt, Z_tt)

        status, finishing_steps = _ipm_check_convergence(
            status, finishing_steps, ZX, abs_tol, max_refinement,
            prev_slack=prev_errors.get("slack", np.inf),
            can_extend=iteration < max_iter)
        prev_errors["slack"] = abs(ZX)
        if finishing_steps == 0:
            iteration -= 1
            break

        x_step, z_step, Delta_X_tt, Delta_Y_tt, Delta_Z_tt, status = _tt_ipm_newton_step(
            lhs_matrix_tt, rhs_vec_tt, X_tt, Z_tt, ZX, status, solver, rng)

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
        "ranksT": [0] * (dim - 1),
        "status": status,
    }
    return X_tt, Y_tt, None, Z_tt, results
