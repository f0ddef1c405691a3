"""TT products: exact (rank-product) forms, "fast" forms (exact product
plus one rounding sweep), ALS-fitted approximate forms for large rank
products, and the rank-dispatched wrappers (rank product <= 40 for
mat-mat, <= 80 for mat-vec).

Counterpart of ``ttipm_tpu/ops/products.py``.  The random starts of the
ALS fits and the kick-rank enrichment draw from a numpy RandomState
(``rng``, default numpy's global one) in the JAX package's order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ttipm_tpu_torch.ops.rounding import (
    add_kick_rank,
    pad_bond_factors,
    prune_singular_vals,
    tt_rank_reduce,
)
from ttipm_tpu_torch.ops.linalg import safe_svd
from ttipm_tpu_torch.ops.tt import TT, symmetric_powers_of_two, tt_ranks

__all__ = [
    "tt_mat_vec_exact", "tt_mat_mat_exact", "tt_hadamard_exact",
    "tt_fast_matrix_vec_mul", "tt_fast_mat_mat_mul", "tt_fast_hadamard",
    "tt_approx_mat_mat_mul", "tt_approx_mat_vec_mul", "tt_mat_mat_mul",
    "tt_mat_vec_mul",
]


# ---------------------------------------------------------------------------
# Exact rank-product contractions (one einsum per core)
# ---------------------------------------------------------------------------

def tt_mat_vec_exact(matrix_tt: TT, vec_tt: TT) -> TT:
    """Exact TT matrix @ TT vector; bond ranks multiply."""
    out: TT = []
    for a, x in zip(matrix_tt, vec_tt):
        c = torch.einsum("rmnR,anB->ramRB", a, x)
        out.append(c.reshape(a.shape[0] * x.shape[0], a.shape[1],
                             a.shape[-1] * x.shape[-1]))
    return out


def tt_mat_mat_exact(matrix_tt_1: TT, matrix_tt_2: TT) -> TT:
    """Exact TT matrix @ TT matrix; bond ranks multiply."""
    out: TT = []
    for a, b in zip(matrix_tt_1, matrix_tt_2):
        c = torch.einsum("rmkR,aknB->ramnRB", a, b)
        out.append(c.reshape(a.shape[0] * b.shape[0], a.shape[1], b.shape[2],
                             a.shape[-1] * b.shape[-1]))
    return out


def tt_hadamard_exact(train_tt_1: TT, train_tt_2: TT) -> TT:
    """Exact entrywise (Hadamard) product; bond ranks multiply."""
    out: TT = []
    for a, b in zip(train_tt_1, train_tt_2):
        if a.ndim == 4:
            c = torch.einsum("rmnR,amnB->ramnRB", a, b)
            out.append(c.reshape(a.shape[0] * b.shape[0], a.shape[1],
                                 a.shape[2], a.shape[-1] * b.shape[-1]))
        else:
            c = torch.einsum("rnR,anB->ranRB", a, b)
            out.append(c.reshape(a.shape[0] * b.shape[0], a.shape[1],
                                 a.shape[-1] * b.shape[-1]))
    return out


def tt_fast_matrix_vec_mul(matrix_tt: TT, vec_tt: TT, eps: float = 1e-18) -> TT:
    return tt_rank_reduce(tt_mat_vec_exact(matrix_tt, vec_tt), eps)


def tt_fast_mat_mat_mul(matrix_tt_1: TT, matrix_tt_2: TT, eps: float = 1e-18) -> TT:
    return tt_rank_reduce(tt_mat_mat_exact(matrix_tt_1, matrix_tt_2), eps)


def tt_fast_hadamard(train_tt_1: TT, train_tt_2: TT, eps: float = 1e-18) -> TT:
    return tt_rank_reduce(tt_hadamard_exact(train_tt_1, train_tt_2), eps)


# ---------------------------------------------------------------------------
# ALS approximate products (large-rank regime)
# ---------------------------------------------------------------------------

def _fro(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x))


def _als_product_sweeps(contraction_fwd, contraction_solution, x_cores: TT,
                        phys_shape, kick_rank: np.ndarray, nswp: int,
                        tol: float, rng) -> TT:
    """Alternating-sweep driver shared by the ALS mat-mat / mat-vec fits,
    with norm rebalancing and the stagnation early stop."""
    d = len(x_cores)
    x_cores = list(x_cores)
    ref = x_cores[0]
    rx = np.array([1] + tt_ranks(x_cores) + [1])
    phi = [ref.new_ones((1, 1, 1))] + [None] * (d - 1) + [ref.new_ones((1, 1, 1))]
    norm_phi = np.ones(d - 1)
    normx = np.ones(d - 1)
    nrmsc = 1.0
    tol_bond = tol / np.sqrt(d)

    last = False
    prev_res = np.inf
    stagnant = 0
    for swp in range(nswp):
        max_res = np.inf if swp == 0 else 0.0
        # Backward sweep
        for k in range(d - 1, -1, -1):
            if swp > 0:
                prev = x_cores[k]
                sol = contraction_solution(phi[k], k, phi[k + 1]) * nrmsc
                res = _fro(sol - prev) / max(_fro(sol), 1e-8)
                max_res = max(max_res, res)
                mat = sol.reshape(rx[k], -1).T
            else:
                mat = x_cores[k].reshape(rx[k], -1).T
            if k > 0:
                u, s, v_t = safe_svd(mat)
                v = s[:, None] * v_t
                r = prune_singular_vals(s, tol_bond)
                if not last:
                    u, v, r = add_kick_rank(u[:, :r], v[:r], int(kick_rank[k - 1]),
                                            rng=rng)
                else:
                    u, v = u[:, :r], v[:r]
                u, v, r = pad_bond_factors(u, v, r)
                nrmsc *= normx[k - 1] / norm_phi[k - 1]
                x_cores[k] = u.T.reshape(r, *phys_shape(k), rx[k + 1])
                x_cores[k - 1] = torch.tensordot(x_cores[k - 1], v.T, dims=([-1], [0]))
                norm_now = _fro(x_cores[k - 1])
                normx[k - 1] *= norm_now
                x_cores[k - 1] = x_cores[k - 1] / norm_now
                rx[k] = r
                phi[k] = contraction_fwd(phi[k + 1], k, x_cores[k], True)
                nrm = _fro(phi[k]) or 1.0
                phi[k] = phi[k] / nrm
                norm_phi[k - 1] = nrm
                nrmsc *= norm_phi[k - 1] / normx[k - 1]
            else:
                x_cores[k] = mat.T.reshape(rx[k], *phys_shape(k), rx[k + 1])
        if last:
            break
        if max_res < tol or swp == nswp - 1:
            last = True
        # Forward sweep
        max_res = 0.0
        for k in range(d):
            prev = x_cores[k]
            sol = contraction_solution(phi[k], k, phi[k + 1]) * nrmsc
            res = _fro(sol - prev) / max(_fro(sol), 1e-8)
            max_res = max(max_res, res)
            mat = sol.reshape(-1, rx[k + 1])
            if k < d - 1:
                nrmsc *= normx[k] / norm_phi[k]
                u, s, v_t = safe_svd(mat)
                v = s[:, None] * v_t
                r = prune_singular_vals(s, tol_bond)
                if not last:
                    u, v, r = add_kick_rank(u[:, :r], v[:r, :], int(kick_rank[k]),
                                            rng=rng)
                else:
                    u, v = u[:, :r], v[:r, :]
                u, v, r = pad_bond_factors(u, v, r)
                x_cores[k] = u.reshape(rx[k], *phys_shape(k), r)
                x_cores[k + 1] = torch.tensordot(v, x_cores[k + 1], dims=([1], [0]))
                norm_now = _fro(x_cores[k + 1])
                normx[k] *= norm_now
                x_cores[k + 1] = x_cores[k + 1] / norm_now
                rx[k + 1] = r
                phi[k + 1] = contraction_fwd(phi[k], k, x_cores[k], False)
                nrm = _fro(phi[k + 1]) or 1.0
                phi[k + 1] = phi[k + 1] / nrm
                norm_phi[k] = nrm
                nrmsc *= norm_phi[k] / normx[k]
            else:
                x_cores[k] = mat.reshape(rx[k], *phys_shape(k), rx[k + 1])
        if last:
            break
        if max_res < tol:
            last = True
        # Stagnation early stop: a bounded-rank fit cannot go below its best
        # approximation error; near tol two sweeps without a 5% gain end the
        # fit, far above tol three sweeps under 2%.
        near_tol = max_res <= 10.0 * tol
        factor, need = (1.05, 2) if near_tol else (1.02, 3)
        if np.isfinite(prev_res) and max_res > prev_res / factor:
            stagnant += 1
            if stagnant >= need:
                last = True
        else:
            stagnant = 0
        prev_res = max_res

    norm_total = float(np.exp(np.sum(np.log(normx)) / d))
    return [norm_total * core for core in x_cores]


def _als_start(A: TT, other: TT, x0, nswp, kick_rank, shape, rng):
    from ttipm_tpu_torch.ops.random import tt_random_gaussian

    if x0 is None:
        max_ranks = np.maximum(
            (np.array(tt_ranks(A)) + np.array(tt_ranks(other))) / 2, 2
        ).astype(int)
        ref = A[0]
        x_cores = tt_random_gaussian(list(max_ranks), shape, device=ref.device,
                                     dtype=ref.dtype, rng=rng)
    else:
        x_cores = list(x0)
        max_ranks = np.array(tt_ranks(x0))
    if kick_rank is None:
        kick_rank = np.maximum(
            (symmetric_powers_of_two(len(A) - 1) - max_ranks) / (nswp / 2), 2
        ).astype(int)
    return x_cores, kick_rank


def tt_approx_mat_mat_mul(A: TT, D: TT, x0: Optional[TT] = None, kick_rank=None,
                          nswp: int = 50, tol: float = 1e-6, rng=None) -> TT:
    """ALS fixed-point fit of the TT matrix product A @ D at bounded rank."""
    rng = np.random if rng is None else rng
    x_cores, kick_rank = _als_start(A, D, x0, nswp, kick_rank,
                                    tuple(A[0].shape[1:-1]), rng)

    def phys_shape(k):
        return (A[k].shape[1], D[k].shape[2])

    def solution(phi_l, k, phi_r):
        return torch.einsum("rab,amkA,bknB,RAB->rmnR", phi_l, A[k], D[k], phi_r)

    def fwd(phi, k, core, reverse):
        if reverse:
            return torch.einsum("RAB,amkA,bknB,rmnR->rab", phi, A[k], D[k], core)
        return torch.einsum("rab,amkA,bknB,rmnR->RAB", phi, A[k], D[k], core)

    return _als_product_sweeps(fwd, solution, x_cores, phys_shape, kick_rank,
                               nswp, tol, rng)


def tt_approx_mat_vec_mul(A: TT, d_vec: TT, x0: Optional[TT] = None,
                          kick_rank=None, nswp: int = 50, tol: float = 1e-6,
                          rng=None) -> TT:
    """ALS fixed-point fit of the TT mat-vec A @ d."""
    rng = np.random if rng is None else rng
    x_cores, kick_rank = _als_start(A, d_vec, x0, nswp, kick_rank,
                                    (A[0].shape[2],), rng)

    def phys_shape(k):
        return (A[k].shape[1],)

    def solution(phi_l, k, phi_r):
        return torch.einsum("rab,amkA,bkB,RAB->rmR", phi_l, A[k], d_vec[k], phi_r)

    def fwd(phi, k, core, reverse):
        if reverse:
            return torch.einsum("RAB,amkA,bkB,rmR->rab", phi, A[k], d_vec[k], core)
        return torch.einsum("rab,amkA,bkB,rmR->RAB", phi, A[k], d_vec[k], core)

    return _als_product_sweeps(fwd, solution, x_cores, phys_shape, kick_rank,
                               nswp, tol, rng)


# ---------------------------------------------------------------------------
# Rank-dispatched wrappers
# ---------------------------------------------------------------------------

def tt_mat_mat_mul(mat1: TT, mat2: TT, op_tol: float, eps: float,
                   x0: Optional[TT] = None, rng=None) -> TT:
    rank_prod = np.array(tt_ranks(mat1)) * np.array(tt_ranks(mat2))
    if rank_prod.size == 0 or rank_prod.max() <= 40:
        return tt_rank_reduce(tt_mat_mat_exact(mat1, mat2), eps=op_tol)
    return tt_approx_mat_mat_mul(mat1, mat2, x0=x0, tol=op_tol, rng=rng)


def tt_mat_vec_mul(mat: TT, vec: TT, op_tol: float, eps: float,
                   x0: Optional[TT] = None, rng=None) -> TT:
    """``x0`` warm-starts the ALS path only (the exact path ignores it)."""
    rank_prod = np.array(tt_ranks(mat)) * np.array(tt_ranks(vec))
    if rank_prod.size == 0 or rank_prod.max() <= 80:
        return tt_rank_reduce(tt_mat_vec_exact(mat, vec), op_tol)
    return tt_approx_mat_vec_mul(mat, vec, x0=x0, tol=op_tol, rng=rng)
