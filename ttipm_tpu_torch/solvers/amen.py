"""Ragged block AMEn solver for TT operator equations ``A x = b`` (A a
``TTBlockMatrix``, b a ``TTBlockVector``), the exceptions of the AMEn
solvers and the rank cap of the fused ladder.

The solver alternates backward and forward sweeps over the cores.  At each
core it (1) solves the projected local system through an injected
``local_solver`` (the IPM passes its Schur-elimination KKT solver), (2)
SVD-truncates the local solution with a residual-driven greedy rank
backoff, and (3) enriches the basis with projected-residual directions
("AMEn" z cores with a kick rank).  The interfaces (``XAX``/``Xb`` phis)
are updated per step.  Ranks are ragged: every bond takes the rank its
truncation gives.

Counterpart of ``ttipm_tpu/solvers/amen.py``.  The block products of the
sweeps go through K2 (``TTBlockMatrixView``); the random draws (fresh
guesses, the first z cores) come from the numpy RandomState ``rng`` in the
JAX package's order.  The rank decisions, the sweep residuals and the
per-core ``dx`` are read on the host.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.ops.linalg import qr_econ, qr_solve, safe_svd
from ttipm_tpu_torch.ops.rounding import (
    pad_bond_factors,
    prune_singular_vals,
    tt_rank_retraction,
    truncated_svd,
)
from ttipm_tpu_torch.ops.tt import TT, tt_normalise, tt_ranks
from ttipm_tpu_torch.solvers.fused_algebra import (
    column_scales,
    phi_bck_A,
    phi_bck_rhs,
    phi_fwd_A,
    phi_fwd_rhs,
)

__all__ = [
    "AmenToleranceReached", "AmenRestartsExhausted", "ladder_rank_cap",
    "tt_block_amen", "tt_restarted_block_amen", "make_default_local_solver",
]


class AmenToleranceReached(RuntimeError):
    """The right-hand side is already below the absolute tolerance; callers
    treat this as convergence."""


class AmenRestartsExhausted(RuntimeError):
    """The restart budget is exhausted."""


def ladder_rank_cap(rank_restriction: int, d: int) -> int:
    """Largest solve rank the fused restart ladder may reach: the caller's
    restriction, the structural width 4^ceil(d/2), and the ceiling 32 of the
    dense local factorizations.  (The JAX package spells this formula out
    twice, ``solvers/fused.py:954`` and ``ipm.py:829``.)"""
    return int(min(rank_restriction, 4 ** ((d + 1) // 2), 32))


def _svd(mat):
    u, s, v_t = safe_svd(mat)
    return u, s, s[:, None] * v_t


def _residual_rank_backoff(block_A_k, XAX_k, XAX_k1, u, v, r_start, rx_k, block_size,
                           n_k, rx_k1, rhs, norm_rhs, trunc_lim, bwd: bool):
    """Greedy rank reduction: drop trailing singular directions while the
    projected residual stays under ``trunc_lim``; every candidate is
    evaluated in one batched local product and a cumulative sum.  ``u`` /
    ``v`` are the SVD factors in the sweep direction's layout; returns the
    kept rank."""
    if bwd:
        sol = (u[:, :r_start] @ v[:r_start]).T.reshape(rx_k, block_size, n_k, rx_k1)
        width = int(u.shape[1])
    else:
        sol = torch.einsum("rbR,RdK->rdbK", u[:, :, :r_start].reshape(rx_k, n_k, r_start),
                           v[:r_start].reshape(r_start, block_size, rx_k1))
        width = int(u.shape[-1])
    res0 = block_A_k.block_local_product(XAX_k, XAX_k1, sol) - rhs
    if r_start <= 1:
        return min(2, width)
    if float(torch.linalg.norm(res0)) / norm_rhs > trunc_lim:
        # even the full-rank candidate violates the limit: keep r_start
        return min(r_start, width)
    # rank-1 terms in drop order q = r_start-1 .. 1
    if bwd:
        terms = torch.einsum("mq,qp->qpm", u[:, 1:r_start].flip(1), v[1:r_start].flip(0))
        terms = terms.reshape(r_start - 1, rx_k, block_size, n_k, rx_k1)
    else:
        terms = torch.einsum(
            "rbq,qdK->qrdbK",
            u[:, :, 1:r_start].flip(2).reshape(rx_k, n_k, r_start - 1),
            v[1:r_start].flip(0).reshape(r_start - 1, block_size, rx_k1))
    K_terms = block_A_k.block_local_product_batched(XAX_k, XAX_k1, terms)
    partial = res0[None] - torch.cumsum(K_terms, dim=0)
    norms = torch.sqrt(torch.sum(partial**2, dim=(1, 2, 3, 4))).cpu().numpy()
    hits = np.nonzero(norms / norm_rhs > trunc_lim)[0]
    r = 1 if hits.size == 0 else r_start - 1 - int(hits[0])
    # the last acceptable rank, clamped to the SVD width
    return min(r + 1, width)


def _dx(solution_now, previous_solution) -> float:
    return float(torch.linalg.norm(solution_now - previous_solution)
                 / torch.linalg.norm(solution_now))


def _z_phis(block_A_k, phi, z_core, x_core, update):
    out = {key: update(phi[key], z_core, block_A_k[key], x_core) for key in block_A_k}
    out.update({
        (l, t): update(phi[(l, t)], z_core, block_A_k[(i, j)].transpose(1, 2), x_core)
        for (i, j), (l, t) in block_A_k.transposes.items()
    })
    return out


def _bck_sweep(local_solver, x_cores, z_cores, XAX, ZAX, block_A, Xb, Zb, block_b,
               rx, rz, N, block_size, trunc_tol, d, swp, eps, r_max, kick_rank,
               last, amen, direct_solve_failure):
    """Right-to-left half sweep."""
    local_res = np.inf if swp == 0 else 0.0
    local_dx = np.inf if swp == 0 else 0.0
    for k in range(d - 1, -1, -1):
        block_A_k = block_A[k]
        block_b_k = block_b[k]
        have_solve = swp > 0 and not last
        if have_solve:
            previous_solution = x_cores[k]
            (solution_now, block_res_old, block_res_new, rhs, norm_rhs,
             direct_solve_failure) = local_solver(
                XAX[k], block_A_k, XAX[k + 1], Xb[k], block_b_k, Xb[k + 1],
                previous_solution, 3 * d, not direct_solve_failure)
            local_res = max(local_res, block_res_old)
            local_dx = max(_dx(solution_now, previous_solution), local_dx)
            if amen:
                zshape = (rz[k], block_size, N[k], rz[k + 1])
                Az = block_A_k.compressed_block_local_product(ZAX[k], ZAX[k + 1], solution_now,
                                                              shape=zshape)
                rhsz = block_b_k.block_local_product(Zb[k], Zb[k + 1], 1, zshape)
                resz = (rhsz - Az).reshape(rz[k] * block_size, N[k] * rz[k + 1]).T
        else:
            solution_now = x_cores[k]
            if amen and not last:
                resz = z_cores[k].reshape(rz[k] * block_size, N[k] * rz[k + 1]).T
        scales = column_scales(solution_now)
        solution_mat = (scales * solution_now).reshape(rx[k] * block_size, N[k] * rx[k + 1]).T

        if k > 0:
            u, s, v = _svd(solution_mat)
            if have_solve:
                trunc_lim = max(2 * trunc_tol, block_res_new)
                r_start = min(prune_singular_vals(s, eps), r_max)
                r = _residual_rank_backoff(
                    block_A_k, XAX[k], XAX[k + 1], u, v, r_start, rx[k], block_size, N[k],
                    rx[k + 1], rhs, norm_rhs, trunc_lim, bwd=True)
                u_core = u[:, :r].T.reshape(r, N[k], rx[k + 1])
                v_core = v[:r].T.reshape(rx[k], block_size, r)
                if amen and not last:
                    # enrich the left basis with projected-residual directions
                    xzshape = (rz[k], block_size, N[k], rx[k + 1])
                    sol_trunc = (u[:, :r] @ v[:r]).T.reshape(rx[k], block_size, N[k], rx[k + 1])
                    Axz = block_A_k.lcompressed_block_local_product(
                        ZAX[k], XAX[k + 1], sol_trunc, shape=xzshape)
                    rhsxz = block_b_k.block_local_product(Zb[k], Xb[k + 1], 1, xzshape)
                    kr = min(kick_rank, rz[k] * block_size, N[k] * rx[k + 1])
                    uz, _ = truncated_svd(
                        (rhsxz - Axz).reshape(rz[k] * block_size, N[k] * rx[k + 1]).T, kr)
                    uz = uz.T.reshape(kr, N[k], rx[k + 1])
                    u_aug = torch.cat((u_core, uz), dim=0)
                    q, R = qr_econ(u_aug.reshape(-1, N[k] * rx[k + 1]).T)
                    u_core = q.T.reshape(-1, N[k], rx[k + 1])
                    v_core = torch.einsum("Rdk,kr->Rdr", v_core, R.T[:r])
                    r = int(u_core.shape[0])
            else:
                r = min(prune_singular_vals(s, eps), r_max)
                u_core = u[:, :r].T.reshape(r, N[k], rx[k + 1])
                v_core = v[:r].T.reshape(rx[k], block_size, r)

            v_core, u_core, r = pad_bond_factors(v_core, u_core, r, orth="right")
            x_cores[k] = u_core
            x_cores[k - 1] = torch.einsum("rdc,cbR->rbdR", x_cores[k - 1], v_core) / scales
            rx[k] = r
            XAX[k] = {key: phi_bck_A(XAX[k + 1][key], x_cores[k], block_A_k[key],
                                             x_cores[k]) for key in block_A_k}
            Xb[k] = {i: phi_bck_rhs(Xb[k + 1][i], block_b_k[i], x_cores[k])
                     for i in block_b_k}

            if amen and not last:
                kr = min(kick_rank, *resz.shape)
                uz, vz = truncated_svd(resz, kr)
                uz = uz.T.reshape(kr, N[k], rz[k + 1])
                vz = vz.T.reshape(rz[k], block_size, kr)
                z_cores[k] = uz
                z_cores[k - 1] = torch.einsum("rdc,cbR->rbdR", z_cores[k - 1], vz) / scales
                rz[k] = int(uz.shape[0])
                ZAX[k] = _z_phis(block_A_k, ZAX[k + 1], z_cores[k], x_cores[k],
                                 phi_bck_A)
                Zb[k] = {i: phi_bck_rhs(Zb[k + 1][i], block_b_k[i], z_cores[k])
                         for i in block_b_k}
        else:
            x_cores[k] = solution_mat.T.reshape(rx[k], block_size, N[k], rx[k + 1]) / scales
            if amen and not last:
                z_cores[k] = resz.T.reshape(rz[k], block_size, N[k], rz[k + 1]) / scales

    return x_cores, z_cores, XAX, Xb, rx, local_res, local_dx, direct_solve_failure


def _fwd_sweep(local_solver, x_cores, z_cores, XAX, ZAX, block_A, Xb, Zb, block_b,
               rx, rz, N, block_size, trunc_tol, d, swp, eps, r_max, kick_rank,
               last, amen, direct_solve_failure):
    """Left-to-right half sweep."""
    local_res = np.inf if swp == 0 else 0.0
    local_dx = np.inf if swp == 0 else 0.0
    for k in range(d):
        block_A_k = block_A[k]
        block_b_k = block_b[k]
        have_solve = swp > 0 and not last
        if have_solve:
            previous_solution = x_cores[k]
            (solution_now, block_res_old, block_res_new, rhs, norm_rhs,
             direct_solve_failure) = local_solver(
                XAX[k], block_A_k, XAX[k + 1], Xb[k], block_b_k, Xb[k + 1],
                previous_solution, 3 * d, not direct_solve_failure)
            local_res = max(local_res, block_res_old)
            local_dx = max(_dx(solution_now, previous_solution), local_dx)
            if amen:
                zshape = (rz[k], block_size, N[k], rz[k + 1])
                Az = block_A_k.compressed_block_local_product(ZAX[k], ZAX[k + 1], solution_now,
                                                              shape=zshape)
                rhsz = block_b_k.block_local_product(Zb[k], Zb[k + 1], 1, zshape)
                resz = (rhsz - Az).permute(0, 2, 1, 3).reshape(rz[k] * N[k],
                                                               block_size * rz[k + 1])
        else:
            solution_now = x_cores[k]
            if amen and not last:
                resz = z_cores[k].permute(0, 2, 1, 3).reshape(rz[k] * N[k],
                                                              block_size * rz[k + 1])
        scales = column_scales(solution_now)
        solution_mat = (scales * solution_now).permute(0, 2, 1, 3).reshape(
            rx[k] * N[k], block_size * rx[k + 1])

        if k < d - 1:
            u, s, v = _svd(solution_mat)
            u3 = u.reshape(rx[k], N[k], -1)
            if have_solve:
                trunc_lim = max(2 * trunc_tol, block_res_new)
                r_start = min(prune_singular_vals(s, eps), r_max)
                r = _residual_rank_backoff(
                    block_A_k, XAX[k], XAX[k + 1], u3, v, r_start, rx[k], block_size, N[k],
                    rx[k + 1], rhs, norm_rhs, trunc_lim, bwd=False)
                if amen:
                    # enrich the right basis
                    xzshape = (rx[k], block_size, N[k], rz[k + 1])
                    sol_trunc = torch.einsum("rbR,RdK->rdbK", u3[:, :, :r],
                                             v[:r].reshape(r, block_size, rx[k + 1]))
                    Axz = block_A_k.rcompressed_block_local_product(
                        XAX[k], ZAX[k + 1], sol_trunc, shape=xzshape)
                    rhsxz = block_b_k.block_local_product(Xb[k], Zb[k + 1], 1, xzshape)
                    kr = min(kick_rank, rx[k] * N[k], block_size * rz[k + 1])
                    uz, _ = truncated_svd((rhsxz - Axz).permute(0, 2, 1, 3).reshape(
                        rx[k] * N[k], block_size * rz[k + 1]), kr)
                    uz = uz.reshape(rx[k], N[k], kr)
                    u_aug = torch.cat((u3[:, :, :r], uz), dim=-1)
                    q, R = qr_econ(u_aug.reshape(rx[k] * N[k], -1))
                    u3 = q.reshape(rx[k], N[k], -1)
                    v_kept = torch.einsum("rR,RdK->rdK", R[:, :r],
                                          v[:r].reshape(r, block_size, rx[k + 1]))
                    r = int(v_kept.shape[0])
                else:
                    u3 = u3[:, :, :r]
                    v_kept = v[:r].reshape(r, block_size, rx[k + 1])
            else:
                r = min(prune_singular_vals(s, eps), r_max)
                u3 = u3[:, :, :r]
                v_kept = v[:r].reshape(r, block_size, rx[k + 1])

            u3, v_kept, r = pad_bond_factors(u3, v_kept, r)
            merged = torch.einsum("rbR,RdK->rbdK", v_kept, x_cores[k + 1])
            x_cores[k] = u3
            x_cores[k + 1] = merged.reshape(r, block_size, N[k + 1], rx[k + 2]) / scales
            rx[k + 1] = r
            XAX[k + 1] = {key: phi_fwd_A(XAX[k][key], x_cores[k], block_A_k[key],
                                                 x_cores[k]) for key in block_A_k}
            Xb[k + 1] = {i: phi_fwd_rhs(Xb[k][i], block_b_k[i], x_cores[k])
                         for i in block_b_k}

            if amen and not last:
                kr = min(kick_rank, *resz.shape)
                uz, vz = truncated_svd(resz, kr)
                uz = uz.reshape(rz[k], N[k], kr)
                vz = vz.reshape(kr, block_size, rz[k + 1])
                z_cores[k] = uz
                z_cores[k + 1] = torch.einsum("rbR,RdK->rbdK", vz, z_cores[k + 1]) / scales
                rz[k + 1] = int(uz.shape[-1])
                ZAX[k + 1] = _z_phis(block_A_k, ZAX[k], z_cores[k], x_cores[k],
                                     phi_fwd_A)
                Zb[k + 1] = {i: phi_fwd_rhs(Zb[k][i], block_b_k[i], z_cores[k])
                             for i in block_b_k}
        else:
            x_cores[k] = solution_mat.reshape(rx[k], N[k], block_size, rx[k + 1]).permute(
                0, 2, 1, 3) / scales
            if amen and not last:
                z_cores[k] = resz.reshape(rz[k], N[k], block_size, rz[k + 1]).permute(
                    0, 2, 1, 3) / scales

    return x_cores, z_cores, XAX, Xb, rx, local_res, local_dx, direct_solve_failure


def tt_block_amen(block_A, block_b, term_tol: float, r_max: int = 100, eps: float = 1e-12,
                  nswp: int = 22, x0: Optional[TT] = None,
                  local_solver: Optional[Callable] = None, kick_rank: int = 2,
                  amen: bool = False, verbose: bool = False, rng=None):
    """Alternating block AMEn driver; returns (x_cores, final_local_res).
    ``rng``: numpy RandomState of the fresh guess and the first z cores
    (default numpy's global one)."""
    block_size = int(max(k[0] for k in block_A.keys()) + 1)
    model_entry = next(iter(block_b.values()))
    ref = model_entry[0]
    x_shape = tuple(model_entry[0].shape[1:-1])
    if local_solver is None:
        local_solver = make_default_local_solver()
    rng = np.random if rng is None else rng

    def as_dev(a):
        return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

    def fresh_guess():
        head = tt_normalise([as_dev(rng.randn(1, *c.shape[1:-1], 1)) for c in model_entry[:-1]])
        return head + [as_dev(rng.randn(1, block_size, *x_shape, 1))]

    def find_block_core(cores):
        idxs = [i for i, c in enumerate(cores) if c.ndim == 4 and c.shape[1] == block_size]
        return idxs[0] if len(idxs) == 1 else None

    direction = 1
    if x0 is None:
        x_cores = fresh_guess()
    else:
        x_cores = list(x0)
        block_idx = find_block_core(x_cores)
        if block_idx == 0:
            direction = -1
        elif block_idx == len(x_cores) - 1:
            direction = 1
        else:
            if verbose:
                print("\tAttention: dropping warm start with invalid block-core layout.")
            x_cores = fresh_guess()

    t0 = time.time()
    N = [c.shape[-2] for c in x_cores]
    d = len(N)
    ones3 = ref.new_ones((1, 1, 1))
    ones2 = ref.new_ones((1, 1))
    XAX = ([{key: ones3 for key in block_A}] + [{key: None for key in block_A}
                                               for _ in range(d - 1)]
           + [{key: ones3 for key in block_A}])
    Xb = ([{key: ones2 for key in block_b}] + [{key: None for key in block_b}
                                              for _ in range(d - 1)]
          + [{key: ones2 for key in block_b}])
    rx = np.array([1] + tt_ranks(x_cores) + [1])

    ZAX = Zb = z_cores = rz = None
    if amen:
        tkeys = block_A.tkeys()
        ZAX = ([{key: ones3 for key in tkeys}] + [{key: None for key in tkeys}
                                                 for _ in range(d - 1)]
               + [{key: ones3 for key in tkeys}])
        Zb = ([{key: ones2 for key in block_b}] + [{key: None for key in block_b}
                                                  for _ in range(d - 1)]
              + [{key: ones2 for key in block_b}])
        z_cores = (
            [as_dev(rng.randn(*x_cores[0].shape[:-1], kick_rank)
                    / (int(np.prod(x_cores[0].shape[1:-1])) * kick_rank**2))]
            + [as_dev(rng.randn(kick_rank, *c.shape[1:-1], kick_rank)
                      / (int(np.prod(c.shape[1:-1])) * kick_rank**2)) for c in x_cores[1:-1]]
            + [as_dev(rng.randn(kick_rank, *x_cores[-1].shape[1:])
                      / (int(np.prod(x_cores[-1].shape[1:-1])) * kick_rank**2))]
        )
        rz = np.array([1] + tt_ranks(z_cores) + [1])

    last = False
    final_local_res = np.inf
    direct_solve_failure = False
    trunc_tol = term_tol / np.sqrt(d)
    swp = 0
    for swp in range(nswp + 1):
        sweep = _bck_sweep if direction > 0 else _fwd_sweep
        (x_cores, z_cores, XAX, Xb, rx, local_res, local_dx,
         direct_solve_failure) = sweep(
            local_solver, x_cores, z_cores, XAX, ZAX, block_A, Xb, Zb, block_b,
            rx, rz, N, block_size, trunc_tol, d, swp, eps, r_max, kick_rank,
            last, amen, direct_solve_failure)
        if last:
            break
        if local_res < term_tol or local_dx < eps or swp == nswp - 2:
            last = True
            final_local_res = local_res
        if verbose:
            print("\t===Finishing up===" if last else f"\t=====Sweep {swp+1}=====")
            print(f"\tDirection {direction}")
            print(f"\tResidual {local_res:.3e}")
            print(f"\tTT-sol rank: {rx[1:-1]}")
        direction *= -1

    if verbose:
        print(f"\tAMEn done: rank {rx[1:-1]}, residual {final_local_res:.3e}, "
              f"{swp} sweeps, {time.time() - t0:.2f}s", flush=True)
    return x_cores, final_local_res


def make_default_local_solver(rtol: float = 1e-10):
    """Dense projected local solve for standalone AMEn use (the IPM injects
    its own Schur solver): the block system assembled from K1 blocks and
    QR-solved, or LGMRES on the K2 local product above the size limit."""
    from ttipm_tpu_torch.ops import kernels
    from ttipm_tpu_torch.solvers.lgmres import lgmres

    def local_solver(XAX_k, block_A_k, XAX_k1, Xb_k, block_b_k, Xb_k1,
                     previous_solution, size_limit, dense_ok):
        x_shape = previous_solution.shape
        block_size = x_shape[1]
        m = x_shape[0] * x_shape[2] * x_shape[3]
        rhs = block_b_k.block_local_product(Xb_k, Xb_k1, 1, x_shape)
        norm_rhs = max(float(torch.linalg.norm(rhs)), 1e-10)
        block_res_old = float(torch.linalg.norm(
            block_A_k.block_local_product(XAX_k, XAX_k1, previous_solution) - rhs)) / norm_rhs

        dense = (np.sqrt(x_shape[0] * x_shape[3]) <= size_limit) and dense_ok
        failure = False
        solution_now = None
        if dense:
            B = rhs.new_zeros((block_size, m, block_size, m))
            for (i, j) in block_A_k.keys():
                local = kernels.schur_assemble(XAX_k[i, j], block_A_k[i, j], XAX_k1[i, j])
                B[i, :, j, :] += local
                if (i, j) in block_A_k.transposes:
                    kk, tt_ = block_A_k.transposes[i, j]
                    B[kk, :, tt_, :] += local.T
                if (i, j) in block_A_k.aliases:
                    kk, tt_ = block_A_k.aliases[i, j]
                    B[kk, :, tt_, :] += local
            rhs_flat = rhs.permute(1, 0, 2, 3).reshape(-1)
            x = qr_solve(B.reshape(block_size * m, block_size * m), rhs_flat)
            if bool(torch.isfinite(x).all()):
                solution_now = x.reshape(block_size, x_shape[0], x_shape[2],
                                         x_shape[3]).permute(1, 0, 2, 3)
            else:
                failure = True

        if solution_now is None:
            def mat_vec(vec):
                core = vec.reshape(block_size, x_shape[0], x_shape[2], x_shape[3]).permute(
                    1, 0, 2, 3)
                out = block_A_k.block_local_product(XAX_k, XAX_k1, core)
                return out.permute(1, 0, 2, 3).reshape(-1)

            b_flat = rhs.permute(1, 0, 2, 3).reshape(-1)
            x0_flat = previous_solution.permute(1, 0, 2, 3).reshape(-1)
            x, _ = lgmres(mat_vec, b_flat, x0=x0_flat, rtol=rtol,
                          restart=min(m * block_size, 40), maxiter=100)
            solution_now = x.reshape(block_size, x_shape[0], x_shape[2], x_shape[3]).permute(
                1, 0, 2, 3)

        block_res_new = float(torch.linalg.norm(
            block_A_k.block_local_product(XAX_k, XAX_k1, solution_now) - rhs)) / norm_rhs
        if block_res_old < block_res_new:
            solution_now = previous_solution
        return (solution_now, block_res_old, min(block_res_old, block_res_new),
                rhs, norm_rhs, failure)

    return local_solver


def tt_restarted_block_amen(block_A, block_b, rank_restriction: int, op_tol: float,
                            termination_tol: float = 1e-3, eps: float = 1e-11,
                            num_restarts: int = 3, inner_m: int = 10, x0: Optional[TT] = None,
                            local_solver: Optional[Callable] = None, verbose: bool = False,
                            refine_target: Optional[float] = None, rng=None):
    """Outer restart loop around ``tt_block_amen``: warm-started re-solves
    at enlarged rank until the global residual criterion holds.
    ``refine_target`` (absolute residual) adds residual-equation
    refinement of the accepted solution.

    The acceptance test mirrors a defect of the JAX package
    (``ttipm_tpu/solvers/amen.py:788-801``): the first solve is accepted
    whenever its residual is below the right-hand side's norm, and raises
    ``AmenRestartsExhausted`` otherwise, so the restart loop below can never
    run.  The port keeps it so that the two trajectories agree."""
    rng = np.random if rng is None else rng
    if x0 is not None:
        dim = len(x0)
        x0 = tt_rank_retraction(list(x0), [dim] * (dim - 1))

    def solve_als(rhs, rank, start, iters, kick):
        return tt_block_amen(block_A, rhs, termination_tol, r_max=rank, eps=eps, nswp=iters,
                             x0=start, local_solver=local_solver, kick_rank=kick, amen=True,
                             verbose=verbose, rng=rng)

    # warm starts of the ALS product fits across restarts and refine rounds
    prod_cache: dict = {}

    def residual_norm(rhs, x_cores):
        Ax = block_A.block_product(x_cores, 0.1 * op_tol, cache=prod_cache, rng=rng)
        return (rhs - Ax).norm

    rhs = block_b
    orig_rhs_norm = rhs.norm
    if orig_rhs_norm < 0.5 * op_tol:
        raise AmenToleranceReached(
            f"absolute tolerance already reached: {orig_rhs_norm:4f} < {op_tol:4f}")

    def refined(x_cores, res):
        if refine_target is None:
            return x_cores, res
        from ttipm_tpu_torch.solvers.blocks import tt_block_train_add

        num_blocks = int(x_cores[int(np.argmax([c.ndim for c in x_cores]))].shape[1])
        prod_tol = max(0.01 * refine_target, config.clamp_eps(eps))
        r_blk = rhs - block_A.block_product(x_cores, prod_tol, cache=prod_cache, rng=rng)
        rn = r_blk.norm
        for _ in range(2):
            if not np.isfinite(rn) or rn <= refine_target:
                break
            try:
                e_cores, _ = solve_als(r_blk, rank_restriction, None, inner_m, 2)
                x_new = tt_block_train_add(x_cores, e_cores, num_blocks, eps)
            except (torch.linalg.LinAlgError, FloatingPointError):
                break
            r_new = rhs - block_A.block_product(x_new, prod_tol, cache=prod_cache, rng=rng)
            rn_new = r_new.norm
            if not np.isfinite(rn_new) or rn_new >= 0.5 * rn:
                break
            if verbose:
                print(f"\t[amen refine] res {rn:.3e} -> {rn_new:.3e}", flush=True)
            x_cores, rn, r_blk = x_new, rn_new, r_new
        return x_cores, min(res, rn / max(orig_rhs_norm, 1e-300))

    x_cores, res = solve_als(rhs, rank_restriction, x0, inner_m, 2)
    if res < termination_tol:
        return refined(x_cores, res)
    rhs_norm = residual_norm(rhs, x_cores)
    if rhs_norm < termination_tol * orig_rhs_norm or rhs_norm < orig_rhs_norm:
        return refined(x_cores, res)
    if rhs_norm > 0.9 * orig_rhs_norm:
        raise AmenRestartsExhausted(
            f"basis-limited: first solve stalled at relative error "
            f"{rhs_norm / orig_rhs_norm:.3e}; skipping restarts")

    prev_norm = rhs_norm
    for _ in range(1, num_restarts):
        dim = len(x_cores)
        x_cores = tt_rank_retraction(x_cores, [2 * dim] * (dim - 1))
        x_cores, res = solve_als(rhs, rank_restriction + 4, x_cores, inner_m, 4)
        rhs_norm = residual_norm(rhs, x_cores)
        if rhs_norm < termination_tol * orig_rhs_norm or rhs_norm < orig_rhs_norm:
            return refined(x_cores, res)
        if rhs_norm > 0.9 * prev_norm:
            break  # the enlarged rank bought < 10%
        prev_norm = rhs_norm

    raise AmenRestartsExhausted(
        f"restart budget exhausted, relative error {rhs_norm / orig_rhs_norm:.3e}; "
        "consider raising the rank ceiling")
