"""Ragged TT eigensolvers for the IPM step sizes.

``tt_max_generalised_eigen(A, Delta)`` finds the largest step ``alpha`` with
``A + alpha * Delta`` PSD by MALS sweeps over 2-core windows with ragged
ranks: at each window it takes the smallest eigenpair of the projected
pencil ``A / alpha + Delta`` and, when that eigenvalue is negative, shrinks
``alpha`` to ``1 / lambda_max(-Delta, A)``.

``tt_min_eig(A)`` is the plain smallest-eigenvector sweep of the same
kind, used for the inequality step sizes over ``Diag(.)`` operators.

Counterpart of ``ttipm_tpu/solvers/eigen.py``.  A window of size up to 256 is assembled and solved densely, larger
ones by LOBPCG (k = 1, a host loop with one read of the residual a step),
with a dense rescue up to 1024.  The two pencil matrices of a dense window
come from one K1 launch (a 2-core window is one operator core of merged
physical size), the Cholesky of the generalised pencil from K4, and the
LOBPCG matvecs from K2.

Deviation: the LOBPCG start mixes in a small fixed random component so that
a warm start that is exactly an interior eigenvector cannot hold the
iteration there; the JAX package draws it from ``jax.random.PRNGKey(n)``,
the port from ``numpy.random.default_rng(n)``.  Only windows above 256
reach it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.linalg import safe_eigh, safe_svd
from ttipm_tpu_torch.ops.products import tt_fast_matrix_vec_mul
from ttipm_tpu_torch.ops.random import tt_random_gaussian
from ttipm_tpu_torch.ops.rounding import (
    add_kick_rank,
    add_kick_rank_rev,
    pad_bond_factors,
    prune_singular_vals,
)
from ttipm_tpu_torch.ops.tt import TT, tt_inner_prod, tt_normalise, tt_ranks
from ttipm_tpu_torch.solvers.fused_algebra import phi_bck_A, phi_fwd_A
from ttipm_tpu_torch.solvers.fused_eigen import (
    _eigen_residual_stalled,
    _eigen_step_stalled,
    _merged,
)

__all__ = ["tt_max_generalised_eigen", "tt_min_eig", "lobpcg_smallest", "lobpcg_window"]

TINY = 1e-30
_DENSE_EIG_DIRECT = 256   # assemble and eigh outright
_DENSE_EIG_LIMIT = 1024   # dense rescue ceiling when LOBPCG stalls


# ---------------------------------------------------------------------------
# LOBPCG (k = 1, optionally generalised A x = lam B x)
# ---------------------------------------------------------------------------

def _rayleigh_ritz_smallest(W, AW, BW):
    """Smallest Ritz pair over the span of the columns of W; near-null
    directions of W^T B W are dropped and pushed off the spectrum's bottom
    (an exact-zero row of the reduced matrix would win the argmin on a PSD
    operator with the zero vector)."""
    G_a = W.T @ AW
    G_b = W.T @ BW
    eb, Ub = safe_eigh(0.5 * (G_b + G_b.T))
    keep = eb > 1e-12 * eb.abs().max()
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, eb, 1.0)), 0.0)
    T = Ub * inv_sqrt[None, :]
    H = T.T @ (0.5 * (G_a + G_a.T)) @ T
    H = H + torch.diag((1.0 - keep.to(H.dtype)) * (2.0 * G_a.abs().max() + 1.0))
    ev, Uv = safe_eigh(H)
    return ev[0], W @ (T @ Uv[:, 0])


def lobpcg_smallest(matvec: Callable, x0: torch.Tensor, tol: float, maxiter: int,
                    b_matvec: Optional[Callable] = None):
    """Smallest eigenpair of a symmetric operator (generalised when
    ``b_matvec`` is given).  Returns (eigval, eigvec, residual_norm)."""
    n = x0.numel()
    x = x0.reshape(-1)
    nrm = float(torch.linalg.norm(x))
    x = x / max(nrm, TINY) if nrm > 0 else torch.ones_like(x) / np.sqrt(n)
    bx = b_matvec(x) if b_matvec is not None else x
    x = x / torch.sqrt(torch.dot(x, bx).abs() + TINY)
    p = None
    lam = None
    res_norm = np.inf
    for _ in range(maxiter):
        ax = matvec(x)
        bx = b_matvec(x) if b_matvec is not None else x
        lam = torch.dot(x, ax) / torch.clamp_min(torch.dot(x, bx), TINY)
        r = ax - lam * bx
        res_norm = float(torch.linalg.norm(r))
        if res_norm < tol:
            break
        W = torch.stack([x, r] if p is None else [x, r, p], dim=1)
        W = W / torch.clamp_min(torch.linalg.norm(W, dim=0, keepdim=True), TINY)
        AW = torch.stack([matvec(W[:, i]) for i in range(W.shape[1])], dim=1)
        BW = (torch.stack([b_matvec(W[:, i]) for i in range(W.shape[1])], dim=1)
              if b_matvec is not None else W)
        lam_new, x_new = _rayleigh_ritz_smallest(W, AW, BW)
        p = x_new - x * torch.dot(x, x_new)
        pn = float(torch.linalg.norm(p))
        p = None if pn < 1e-14 else p / pn
        x = x_new / torch.clamp_min(torch.linalg.norm(x_new), TINY)
        lam = lam_new
    if lam is None:
        ax = matvec(x)
        bx = b_matvec(x) if b_matvec is not None else x
        lam = torch.dot(x, ax) / torch.clamp_min(torch.dot(x, bx), TINY)
        res_norm = float(torch.linalg.norm(ax - lam * bx))
    return float(lam), x, res_norm


# ---------------------------------------------------------------------------
# Window operators.  ``kind``: "w2" a 2-core window, "w1" a single core;
# suffix "s" the shifted pencil M = A / alpha + D, "g" the generalised
# pencil D x = lam (A + 1e-12 I) x.  ``ops`` is (phi_l, A_k[, A_k1], phi_r)
# of the first operator, then of the second.
# ---------------------------------------------------------------------------

def _window_ops(kind, ops):
    """The one or two (phi_l, A, phi_r) triples of a window, 2-core windows
    merged into one core."""
    per = 4 if kind.startswith("w2") else 3
    triples = []
    for i in range(2 if len(kind) > 2 else 1):
        op = ops[per * i:per * (i + 1)]
        triples.append((op[0], _merged(op[1], op[2]), op[3]) if per == 4 else tuple(op))
    return triples


def _x_shape(triple):
    pl, A, pr = triple
    return (pl.shape[2], A.shape[2], pr.shape[2])


def _make_matvecs(kind, triples, alpha):
    first = triples[0]
    shape = _x_shape(first)

    def mv1(tr, v):
        return kernels.kkt_block_matvec(*tr, v.reshape(shape)).reshape(-1)

    if kind.endswith("s"):
        def mv(v):
            x = v.reshape(shape)
            return kernels.kkt_block_product(
                [(*first, x / alpha, 0), (*triples[1], x, 0)], 1).reshape(-1)
        return mv, None
    if kind.endswith("g"):
        return (lambda v: mv1(first, v)), (lambda v: mv1(triples[1], v) + 1e-12 * v)
    return (lambda v: mv1(first, v)), None


def _lobpcg_mixed(kind, triples, x0, tol, maxiter, alpha):
    """LOBPCG on a window with the random mixing of the start (see the
    module note); returns (lam, x, res) of the returned vector."""
    mv, bmv = _make_matvecs(kind, triples, alpha)
    bmv = bmv or (lambda v: v)
    n = x0.numel()
    x = x0.reshape(-1)
    nrm = float(torch.linalg.norm(x))
    x = x / max(nrm, TINY) if nrm > 0 else torch.ones_like(x) / np.sqrt(n)
    noise = torch.as_tensor(np.random.default_rng(n).standard_normal(n), dtype=x.dtype,
                            device=x.device)
    x = x + 1e-3 * noise / max(float(torch.linalg.norm(noise)), TINY)
    x = x / torch.clamp_min(torch.linalg.norm(x), TINY)
    x = x / torch.sqrt(torch.dot(x, bmv(x)).abs() + TINY)
    p = torch.zeros_like(x)
    it, res = 0, np.inf
    while it < maxiter and res > tol:
        ax, bx = mv(x), bmv(x)
        lam = torch.dot(x, ax) / torch.clamp_min(torch.dot(x, bx), TINY)
        r = ax - lam * bx
        res_t = torch.linalg.norm(r)
        W = torch.stack([x, r, p], dim=1)
        W = W / torch.clamp_min(torch.linalg.norm(W, dim=0, keepdim=True), TINY)
        AW = torch.stack([mv(W[:, i]) for i in range(3)], dim=1)
        BW = torch.stack([bmv(W[:, i]) for i in range(3)], dim=1)
        _, x_new = _rayleigh_ritz_smallest(W, AW, BW)
        p_new = x_new - x * torch.dot(x, x_new)
        pn = torch.linalg.norm(p_new)
        p = torch.where(pn < 1e-14, torch.zeros_like(p_new), p_new / torch.clamp_min(pn, TINY))
        x = x_new / torch.clamp_min(torch.linalg.norm(x_new), TINY)
        res = float(res_t)
        it += 1
    ax, bx = mv(x), bmv(x)
    lam = torch.dot(x, ax) / torch.clamp_min(torch.dot(x, bx), TINY)
    res = torch.linalg.norm(ax - lam * bx)
    lam, res = torch.stack([lam, res]).tolist()
    return lam, x, res


def _dense_smallest(kind, triples, alpha):
    """Dense smallest eigenpair of a window: the pencil assembled (both
    matrices from one K1 launch) and solved by ``eigh``, the generalised
    one whitened by a K4 Cholesky.  Returns (lam as a float, vec); lam is
    NaN where the Cholesky fails."""
    mats = kernels.schur_assemble_group(triples)
    if kind.endswith("s"):
        M = mats[0] / alpha + mats[1]
    else:
        M = mats[0]
    M = 0.5 * (M + M.T)
    if not kind.endswith("g"):
        ev, U = safe_eigh(M)
        return float(ev[0]), U[:, 0]
    B = mats[1]
    B = 0.5 * (B + B.T) + 1e-11 * torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
    L, info = kernels.panel_cholesky(B)
    if int(info) != 0:
        return float("nan"), M[:, 0]
    W = torch.linalg.solve_triangular(L, M, upper=False)
    W = torch.linalg.solve_triangular(L, W.T, upper=False)
    ev, U = safe_eigh(0.5 * (W + W.T))
    v = torch.linalg.solve_triangular(L.T, U[:, :1], upper=True)[:, 0]
    return float(ev[0]), v / torch.linalg.norm(v)


def lobpcg_window(kind, ops, x0, tol, maxiter, alpha=1.0):
    """Window eigensolve: dense ``eigh`` for windows up to 256 (k = 1
    LOBPCG can lock onto a non-extremal pair of a near-diagonal operator),
    LOBPCG beyond, with a dense rescue up to 1024 when it stalls."""
    m = x0.numel()
    triples = _window_ops(kind, ops)
    if m <= _DENSE_EIG_DIRECT:
        lam_d, xd = _dense_smallest(kind, triples, alpha)
        if np.isfinite(lam_d):
            return lam_d, xd.reshape(x0.shape), 0.0
    lam, x, res = _lobpcg_mixed(kind, triples, x0, tol, maxiter, alpha)
    if m <= _DENSE_EIG_LIMIT and (not np.isfinite(res) or res > max(100 * tol, 1e-7)):
        lam_d, xd = _dense_smallest(kind, triples, alpha)
        if np.isfinite(lam_d) and lam_d <= lam:
            return lam_d, xd.reshape(x0.shape), 0.0
    return lam, x, res


def _maxiter_for(m: int) -> int:
    return max(20, min(300, 5 * int(m)))


# ---------------------------------------------------------------------------
# Window solves of the step-size search
# ---------------------------------------------------------------------------

def _pencil_residual(ops_AD, prev_vec, step_size, kind):
    """Residual of the previous iterate in the updated pencil, and ||M p||
    (a lower bound on the pencil's norm, which floors the penalty)."""
    denom = step_size if step_size > 0 else 1.0
    mv, _ = _make_matvecs(kind + "s", _window_ops(kind + "s", ops_AD), denom)
    Mp = mv(prev_vec)
    lam_prev = torch.dot(prev_vec, Mp)
    old_res, scale = torch.stack([torch.linalg.norm(Mp - lam_prev * prev_vec),
                                  torch.linalg.norm(Mp)]).tolist()
    return old_res, scale


def _shrunk(step_size, lam_g, eps):
    lam_max = -lam_g
    if np.isfinite(lam_max) and lam_max > 0:
        return max(0.0, min(step_size, 1.0 / lam_max))
    return step_size * (1 - eps)


def _step_size_window_solve(sol1, sol2, XAX_l, A_k, A_k1, XAX_r, XDX_l, D_k, D_k1, XDX_r,
                            step_size, trunc_tol, eps, max_rank, rng, bwd=True):
    """Smallest-eigenpair window solve of ``A / alpha + Delta`` with the
    shrink-on-negative rule; re-splits the window with a kick of 4 random
    directions."""
    if (not np.isfinite(step_size)) or step_size <= 0:
        return sol1, sol2, 0.0, np.inf, 0.0
    prev = torch.einsum("rny,ytR->rntR", sol1, sol2)
    shape = prev.shape
    m = int(np.prod(shape))
    prev_vec = prev.reshape(-1)
    ops_AD = (XAX_l, A_k, A_k1, XAX_r, XDX_l, D_k, D_k1, XDX_r)
    lam, sol_vec, _ = lobpcg_window("w2s", ops_AD, prev_vec, eps, _maxiter_for(min(m, 60)),
                                    alpha=step_size)
    if lam < 0:
        # alpha too large: the smallest pair of (Delta, A) gives 1/lambda_max
        ops_DA = (XDX_l, D_k, D_k1, XDX_r, XAX_l, A_k, A_k1, XAX_r)
        lam_g, _, _ = lobpcg_window("w2g", ops_DA, sol_vec, eps, _maxiter_for(min(m, 60)))
        step_size = _shrunk(step_size, lam_g, eps)
    old_res, scale = _pencil_residual(ops_AD, prev_vec, step_size, "w2")

    sol_vec = sol_vec.reshape(-1)
    sol_vec = sol_vec / torch.clamp_min(torch.linalg.norm(sol_vec), TINY)
    mat = sol_vec.reshape(int(np.prod(shape[:2])), int(np.prod(shape[2:])))
    if bwd:
        u, s, v_t = safe_svd(mat.T)
        v = s[:, None] * v_t
        r = min(prune_singular_vals(s, trunc_tol), max_rank)
        s1, s2, r = add_kick_rank_rev(v[:r].T, u[:, :r].T, 4, rng)
        s1, s2, r = pad_bond_factors(s1, s2, r, orth="right")
        sol2_new = s2.reshape(r, shape[2], shape[3])
        sol1_new = s1.reshape(shape[0], shape[1], r)
    else:
        u, s, v_t = safe_svd(mat)
        r = min(prune_singular_vals(s, trunc_tol), max_rank)
        s1, s2, r = add_kick_rank(u[:, :r], s[:r, None] * v_t[:r], 4, rng)
        s1, s2, r = pad_bond_factors(s1, s2, r)
        sol1_new = s1.reshape(shape[0], shape[1], r)
        sol2_new = s2.reshape(r, shape[2], shape[3])
    return sol1_new, sol2_new, float(step_size), old_res, scale


def _step_size_last_solve(prev, XDX_l, D_k, XDX_r, XAX_l, A_k, XAX_r, step_size, eps):
    """Single-core refinement pass of the finishing sweep."""
    if (not np.isfinite(step_size)) or step_size <= 0:
        return prev.reshape(-1, 1), 0.0, np.inf
    m = int(np.prod(prev.shape))
    prev_vec = prev.reshape(-1)
    ops_AD = (XAX_l, A_k, XAX_r, XDX_l, D_k, XDX_r)
    lam, x, _ = lobpcg_window("w1s", ops_AD, prev_vec, eps, _maxiter_for(min(m, 60)),
                              alpha=step_size)
    if lam < 0:
        lam_g, _, _ = lobpcg_window("w1g", (XDX_l, D_k, XDX_r, XAX_l, A_k, XAX_r), x, eps,
                                    _maxiter_for(min(m, 60)))
        step_size = _shrunk(step_size, lam_g, eps)
    old_res, _ = _pencil_residual(ops_AD, prev_vec, step_size, "w1")
    return x.reshape(-1, 1), float(step_size), old_res


def _split_bck(sol, trunc_tol, max_rank):
    u, s, v_t = safe_svd(sol)
    r = min(prune_singular_vals(s, trunc_tol), max_rank)
    return u[:, :r], (s[:, None] * v_t)[:r], r


def tt_max_generalised_eigen(A: TT, Delta: TT, x0: Optional[TT] = None, nswp: int = 10,
                             tol: float = 1e-8, size_limit: int = 256, verbose: bool = False,
                             rng=None):
    """Largest ``alpha`` with ``A + alpha * Delta`` PSD and the eigenvector
    train (the next call's warm start).  ``rng``: numpy RandomState of the
    fresh start and the kicks (default numpy's global one)."""
    rng = np.random if rng is None else rng
    ref = A[0]
    if x0 is None:
        x_cores = tt_random_gaussian([2] * (len(A) - 1), (A[0].shape[2],), device=ref.device,
                                     dtype=ref.dtype, rng=rng)
    else:
        x_cores = list(x0)

    d = len(x_cores)
    rx = np.array([1] + tt_ranks(x_cores) + [1])
    N = np.array([c.shape[1] for c in x_cores])
    ones3 = ref.new_ones((1, 1, 1))
    XAX = [ones3] + [None] * (d - 1) + [ones3]
    XDX = [ones3] + [None] * (d - 1) + [ones3]

    step_size = 1.0
    local_res = np.inf * np.ones((2, max(d - 1, 1)))
    # the pencil scale ||M p|| of each window, beside its residual
    local_scale = np.zeros((2, max(d - 1, 1)))
    max_rank = int(np.floor(2 ** (d / 2)))
    trunc_tol = tol / np.sqrt(d)
    prev_sweep_step = None
    prev_sweep_res = np.inf

    def phis_bck(k):
        XAX[k] = phi_bck_A(XAX[k + 1], x_cores[k], A[k], x_cores[k])
        XDX[k] = phi_bck_A(XDX[k + 1], x_cores[k], Delta[k], x_cores[k])

    def phis_fwd(k):
        XAX[k + 1] = phi_fwd_A(XAX[k], x_cores[k], A[k], x_cores[k])
        XDX[k + 1] = phi_fwd_A(XDX[k], x_cores[k], Delta[k], x_cores[k])

    def finish(direction):
        nonlocal step_size
        for k in (range(d) if direction > 0 else range(d - 1, -1, -1)):
            sol, step_size, _ = _step_size_last_solve(
                x_cores[k], XDX[k], Delta[k], XDX[k + 1], XAX[k], A[k], XAX[k + 1],
                step_size, tol)
            if direction > 0 and k < d - 1:
                u, v, r = _split_bck(sol.reshape(rx[k] * N[k], rx[k + 1]), trunc_tol, max_rank)
                x_cores[k] = u.reshape(rx[k], N[k], r)
                x_cores[k + 1] = torch.einsum("ij,jkl->ikl", v, x_cores[k + 1]).reshape(
                    r, N[k + 1], rx[k + 2])
                rx[k + 1] = r
                phis_fwd(k)
            elif direction < 0 and k > 0:
                u, v, r = _split_bck(sol.reshape(rx[k], N[k] * rx[k + 1]).T, trunc_tol,
                                     max_rank)
                x_cores[k] = u.T.reshape(r, N[k], rx[k + 1])
                x_cores[k - 1] = torch.einsum("rdc,cR->rdR", x_cores[k - 1], v.T)
                rx[k] = r
                phis_bck(k)
            else:
                x_cores[k] = sol.reshape(rx[k], N[k], rx[k + 1])

    for swp in range(nswp):
        zero_step = False
        # backward half sweep over 2-core windows
        for k in range(d - 1, 0, -1):
            if swp > 0:
                x_cores[k - 1], x_cores[k], step_size, res, scl = _step_size_window_solve(
                    x_cores[k - 1], x_cores[k], XAX[k - 1], A[k - 1], A[k], XAX[k + 1],
                    XDX[k - 1], Delta[k - 1], Delta[k], XDX[k + 1],
                    step_size, trunc_tol, tol, max_rank, rng, bwd=True)
                local_res[0, k - 1] = res
                local_scale[0, k - 1] = scl
                if step_size <= 0:
                    zero_step = True
                    break
            else:
                u, v, r = _split_bck(x_cores[k].reshape(rx[k], N[k] * rx[k + 1]).T, trunc_tol,
                                     max_rank)
                x_cores[k] = u.T.reshape(r, N[k], rx[k + 1])
                x_cores[k - 1] = torch.einsum("rdc,cR->rdR", x_cores[k - 1], v.T)
            rx[k] = int(x_cores[k].shape[0])
            phis_bck(k)

        if zero_step:
            break
        if np.max(local_res) < tol or swp == nswp - 1:
            finish(+1)
            break

        # forward half sweep
        for k in range(d - 1):
            x_cores[k], x_cores[k + 1], step_size, res, scl = _step_size_window_solve(
                x_cores[k], x_cores[k + 1], XAX[k], A[k], A[k + 1], XAX[k + 2],
                XDX[k], Delta[k], Delta[k + 1], XDX[k + 2],
                step_size, trunc_tol, tol, max_rank, rng, bwd=False)
            local_res[1, k] = res
            local_scale[1, k] = scl
            if step_size <= 0:
                zero_step = True
                break
            rx[k + 1] = int(x_cores[k + 1].shape[0])
            phis_fwd(k)

        if zero_step:
            break
        if np.max(local_res) < tol:
            finish(-1)
            break

        sweep_res = float(np.max(local_res))
        if swp >= 2 and _eigen_step_stalled(prev_sweep_step, step_size, prev_sweep_res,
                                            sweep_res, tol):
            break
        prev_sweep_step = step_size
        prev_sweep_res = sweep_res

    max_res = float(np.max(local_res))
    x_cores = tt_normalise(x_cores)
    # Unconverged-eigensolve penalty: shrink the step by tol/res, with each
    # window's tolerance floored at the dtype's achievable residual for its
    # own pencil scale; the coarser of the profile's dtype and the
    # operator's sets it (``eigen.py:637-639``).
    eps_dt = max(float(torch.finfo(config.dtype()).eps), float(torch.finfo(ref.dtype).eps))
    floors = np.maximum(max(tol, 30.0 * eps_dt), 4.0 * eps_dt * local_scale)
    with np.errstate(invalid="ignore"):
        ratios = local_res / floors
    ratios = ratios[np.isfinite(ratios)]
    worst = float(np.max(ratios)) if ratios.size else 0.0
    if worst > 1.0 and np.isfinite(max_res) and max_res > 0:
        step_size /= worst
    return step_size, x_cores


# ---------------------------------------------------------------------------
# Plain smallest-eigenvector sweeps (inequality step sizes)
# ---------------------------------------------------------------------------

def _eigen_window_solve(sol1, sol2, XAX_l, A_k, A_k1, XAX_r, trunc_tol, eps, max_rank, rng,
                        bwd=True):
    """Smallest-eigenpair window solve of one operator; re-splits the
    window with a kick of 4 random directions.  Returns (sol1, sol2, the
    previous iterate's residual)."""
    prev = torch.einsum("rny,ytR->rntR", sol1, sol2)
    shape = prev.shape
    m = int(np.prod(shape))
    ops = (XAX_l, A_k, A_k1, XAX_r)
    prev_vec = prev.reshape(-1)
    _, x, _ = lobpcg_window("w2", ops, prev_vec, eps, _maxiter_for(min(m, 60)))
    mv, _ = _make_matvecs("w2", _window_ops("w2", ops), 1.0)
    Ap = mv(prev_vec)
    old_res = float(torch.linalg.norm(torch.dot(prev_vec, Ap) * prev_vec - Ap))
    mat = x.reshape(int(np.prod(shape[:2])), int(np.prod(shape[2:])))
    if bwd:
        u, s, v_t = safe_svd(mat.T)
        v = s[:, None] * v_t
        r = min(prune_singular_vals(s, trunc_tol), max_rank)
        s1, s2, r = add_kick_rank_rev(v[:r].T, u[:, :r].T, 4, rng)
        s1, s2, r = pad_bond_factors(s1, s2, r, orth="right")
        return s1.reshape(shape[0], shape[1], r), s2.reshape(r, shape[2], shape[3]), old_res
    u, s, v_t = safe_svd(mat)
    r = min(prune_singular_vals(s, trunc_tol), max_rank)
    s1, s2, r = add_kick_rank(u[:, :r], s[:r, None] * v_t[:r], 4, rng)
    s1, s2, r = pad_bond_factors(s1, s2, r)
    return s1.reshape(shape[0], shape[1], r), s2.reshape(r, shape[2], shape[3]), old_res


def tt_min_eig(A: TT, x0: Optional[TT] = None, nswp: int = 10, tol: float = 1e-8,
               size_limit: int = 64, return_eig_val: bool = False, verbose: bool = False,
               rng=None):
    """Smallest eigenvector of a symmetric TT operator by ragged MALS over
    2-core windows; returns (the normalised eigenvector train, its Rayleigh
    quotient or None).  ``rng``: numpy RandomState of the fresh start and
    the kicks (default numpy's global one).  ``size_limit`` is accepted for
    signature parity, as in the JAX package."""
    rng = np.random if rng is None else rng
    ref = A[0]
    if x0 is None:
        x_cores = tt_random_gaussian([2] * (len(A) - 1), (A[0].shape[2],), device=ref.device,
                                     dtype=ref.dtype, rng=rng)
    else:
        x_cores = list(x0)
    d = len(x_cores)
    rx = np.array([1] + tt_ranks(x_cores) + [1])
    N = np.array([c.shape[1] for c in x_cores])
    ones3 = ref.new_ones((1, 1, 1))
    XAX = [ones3] + [None] * (d - 1) + [ones3]
    max_rank = int(np.floor(2 ** (d / 2)))
    trunc_tol = 0.1 * tol / np.sqrt(d)
    prev_sweep_res = np.inf

    def finish(direction):
        for k in (range(d) if direction > 0 else range(d - 1, -1, -1)):
            prev = x_cores[k]
            _, x, _ = lobpcg_window("w1", (XAX[k], A[k], XAX[k + 1]), prev.reshape(-1), tol,
                                    _maxiter_for(min(int(np.prod(prev.shape)), 60)))
            if direction > 0 and k < d - 1:
                u, v, r = _split_bck(x.reshape(rx[k] * N[k], rx[k + 1]), trunc_tol, max_rank)
                x_cores[k] = u.reshape(rx[k], N[k], r)
                x_cores[k + 1] = torch.einsum("ij,jkl->ikl", v, x_cores[k + 1]).reshape(
                    r, N[k + 1], rx[k + 2])
                rx[k + 1] = r
                XAX[k + 1] = phi_fwd_A(XAX[k], x_cores[k], A[k], x_cores[k])
            elif direction < 0 and k > 0:
                u, v, r = _split_bck(x.reshape(rx[k], N[k] * rx[k + 1]).T, trunc_tol,
                                     max_rank)
                x_cores[k] = u.T.reshape(r, N[k], rx[k + 1])
                x_cores[k - 1] = torch.einsum("rdc,cR->rdR", x_cores[k - 1], v.T)
                rx[k] = r
                XAX[k] = phi_bck_A(XAX[k + 1], x_cores[k], A[k], x_cores[k])
            else:
                x_cores[k] = x.reshape(rx[k], N[k], rx[k + 1])

    for swp in range(nswp):
        max_res = np.inf if swp == 0 else 0.0
        for k in range(d - 1, 0, -1):
            if swp > 0:
                x_cores[k - 1], x_cores[k], res = _eigen_window_solve(
                    x_cores[k - 1], x_cores[k], XAX[k - 1], A[k - 1], A[k], XAX[k + 1],
                    trunc_tol, tol, max_rank, rng, bwd=True)
                max_res = max(max_res, res)
            else:
                u, v, r = _split_bck(x_cores[k].reshape(rx[k], N[k] * rx[k + 1]).T, trunc_tol,
                                     max_rank)
                x_cores[k] = u.T.reshape(r, N[k], rx[k + 1])
                x_cores[k - 1] = torch.einsum("rdc,cR->rdR", x_cores[k - 1], v.T)
            rx[k] = int(x_cores[k].shape[0])
            XAX[k] = phi_bck_A(XAX[k + 1], x_cores[k], A[k], x_cores[k])

        if max_res < tol or swp == nswp - 1:
            finish(+1)
            break

        max_res = 0.0
        for k in range(d - 1):
            x_cores[k], x_cores[k + 1], res = _eigen_window_solve(
                x_cores[k], x_cores[k + 1], XAX[k], A[k], A[k + 1], XAX[k + 2],
                trunc_tol, tol, max_rank, rng, bwd=False)
            max_res = max(max_res, res)
            rx[k + 1] = int(x_cores[k + 1].shape[0])
            XAX[k + 1] = phi_fwd_A(XAX[k], x_cores[k], A[k], x_cores[k])

        if max_res < tol:
            finish(-1)
            break
        if swp >= 2 and _eigen_residual_stalled(prev_sweep_res, max_res, tol):
            break
        prev_sweep_res = max_res

    x_cores = tt_normalise(x_cores)
    min_eig_value = None
    if return_eig_val:
        min_eig_value = tt_inner_prod(x_cores, tt_fast_matrix_vec_mul(A, x_cores, 1e-12))
    return x_cores, min_eig_value
