"""Conic (SCS / SDPA) encodings of the four SDP families, for
cross-solver ground-truth validation, and the native splitting solver.

Counterpart of ``ttipm_tpu/models/conic.py`` (role parity:
reference psd_system/direct_conic.py:82-271 and the per-problem
``*_scs.py`` / ``*_sdpa.py`` runner scripts).  Constraints are built once
as a solver-independent ``ConicSDP`` (sparse entry lists over the dense
matrix), and each backend encoding is a pure numpy transform of it.
``ConicSDP``, ``svec`` / ``smat`` / ``svec_entries``, the two encodings
and the four builders are the JAX package's numpy code, copied (the port
imports nothing of the JAX package): the encodings feed the CPU packages
``scs`` and ``sdpap``, so they stay numpy and ``scipy.sparse``.
``solve_scs`` / ``solve_sdpa`` need those optional packages for the solve
call alone and raise ``ImportError`` without them, as the JAX package's
do.  ``solve_splitting``, the in-tree solver that needs neither, runs in
PyTorch on ``device`` ("cuda" by default).

All problems are MAXIMISATION of <C, X> subject to
  <A_i, X> = b_i          (equality rows)
  <G_j, X> >= h_j         (inequality rows)
  X PSD.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ConicSDP",
    "svec",
    "smat",
    "svec_entries",
    "scs_encode",
    "sdpa_encode",
    "solve_scs",
    "solve_sdpa",
    "solve_splitting",
    "maxcut_conic",
    "corr_clust_conic",
    "max_stable_set_conic",
    "graphm_conic",
]

_SQRT2 = math.sqrt(2.0)

# One constraint = list of (i, j, coef) meaning  sum coef * X[i, j]
# with symmetric completion (an off-diagonal entry touches X[i,j]+X[j,i]
# through the symmetry of X, handled by the encodings).
Entries = Sequence[Tuple[int, int, float]]


@dataclass
class ConicSDP:
    """Solver-independent maximisation SDP over one PSD block."""

    C: np.ndarray
    eq_entries: List[Entries] = field(default_factory=list)
    eq_rhs: List[float] = field(default_factory=list)
    ineq_entries: List[Entries] = field(default_factory=list)  # <G,X> >= h
    ineq_rhs: List[float] = field(default_factory=list)

    @property
    def n(self) -> int:
        return self.C.shape[0]

    def add_eq(self, entries: Entries, rhs: float) -> None:
        self.eq_entries.append(list(entries))
        self.eq_rhs.append(float(rhs))

    def add_ge(self, entries: Entries, rhs: float = 0.0) -> None:
        self.ineq_entries.append(list(entries))
        self.ineq_rhs.append(float(rhs))

    # dense oracles (used by tests and feasibility reporting)
    def eq_residual(self, X: np.ndarray) -> np.ndarray:
        return np.array(
            [_apply_entries(e, X) for e in self.eq_entries]
        ) - np.asarray(self.eq_rhs)

    def ineq_violation(self, X: np.ndarray) -> np.ndarray:
        vals = np.array([_apply_entries(e, X) for e in self.ineq_entries])
        return np.minimum(vals - np.asarray(self.ineq_rhs), 0.0)


def _apply_entries(entries: Entries, X: np.ndarray) -> float:
    """<A, X> where A has the given (i, j, coef) entries placed
    symmetrically (coef split over (i,j) and (j,i) for i != j... no:
    the convention is coef multiplies X[i, j] once; X symmetric)."""
    return float(sum(c * X[i, j] for i, j, c in entries))


# --- scaled-lower-triangle vectorisation (SCS "s" cone convention) --------


def _tril_indices(n: int):
    """Column-major lower-triangle index pair arrays (SCS ordering)."""
    cols, rows = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    mask = rows >= cols
    # column-major walk: for j in cols, for i in rows >= j
    order = np.argsort(cols[mask] * n + rows[mask], kind="stable")
    return rows[mask][order], cols[mask][order]


def _tril_pos(i: np.ndarray, j: np.ndarray, n: int) -> np.ndarray:
    """Position of lower-tri (i >= j) entry in the column-major packing."""
    return (j * (2 * n - j + 1)) // 2 + (i - j)


def svec(M: np.ndarray) -> np.ndarray:
    """Scaled column-major lower-triangle vectorisation: off-diagonals
    are multiplied by sqrt(2) so <svec(A), svec(B)> == <A, B>."""
    n = M.shape[0]
    r, c = _tril_indices(n)
    v = M[r, c].astype(float).copy()
    v[r != c] *= _SQRT2
    return v


def smat(v: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`svec`."""
    r, c = _tril_indices(n)
    vals = np.asarray(v, dtype=float).copy()
    vals[r != c] /= _SQRT2
    M = np.zeros((n, n))
    M[r, c] = vals
    M[c, r] = vals
    return M


def svec_entries(entries: Entries, n: int):
    """(positions, values) of a constraint row in svec coordinates.
    Duplicate (i, j) hits accumulate; an off-diagonal coefficient on
    X[i, j] of the SYMMETRIC variable contributes coef/sqrt(2) at the
    packed slot (so that packed_row . svec(X) == sum coef * X[i, j])."""
    pos: dict = {}
    for i, j, coef in entries:
        if i < j:
            i, j = j, i
        p = int(_tril_pos(np.asarray(i), np.asarray(j), n))
        w = float(coef) if i == j else float(coef) / _SQRT2
        pos[p] = pos.get(p, 0.0) + w
    idx = np.fromiter(pos.keys(), dtype=np.int64, count=len(pos))
    val = np.fromiter(pos.values(), dtype=float, count=len(pos))
    return idx, val


# --- SCS encoding -----------------------------------------------------------


def scs_encode(prob: ConicSDP):
    """(A, b, c, cone) for ``scs.solve`` in SCS >= 3 convention:
    minimise c.x  s.t.  Ax + s = b,  s in K = {0}^z x R+^l x PSD.
    Maximisation of <C, X> becomes c = -svec(C); inequality rows
    <G, X> >= h become -g.x <= -h; the PSD block enters as -I slack."""
    import scipy.sparse as sp

    n = prob.n
    nvar = n * (n + 1) // 2
    m_eq, m_ineq = len(prob.eq_entries), len(prob.ineq_entries)
    rows, cols, vals = [], [], []
    b = np.zeros(m_eq + m_ineq + nvar)

    for r, entries in enumerate(prob.eq_entries):
        idx, val = svec_entries(entries, n)
        rows.append(np.full(idx.shape, r))
        cols.append(idx)
        vals.append(val)
        b[r] = prob.eq_rhs[r]
    for k, entries in enumerate(prob.ineq_entries):
        r = m_eq + k
        idx, val = svec_entries(entries, n)
        rows.append(np.full(idx.shape, r))
        cols.append(idx)
        vals.append(-val)  # >= h  ->  -g.x <= -h
        b[r] = -prob.ineq_rhs[k]
    # PSD slack: -x + s = 0, s in S+
    rows.append(np.arange(m_eq + m_ineq, m_eq + m_ineq + nvar))
    cols.append(np.arange(nvar))
    vals.append(-np.ones(nvar))

    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m_eq + m_ineq + nvar, nvar),
    ).tocsc()
    c = -svec(prob.C)
    cone = {"z": m_eq, "l": m_ineq, "s": [n]}
    return A, b, c, cone


def solve_scs(prob: ConicSDP, eps: float = 1e-5, verbose: bool = False,
              **scs_kwargs):
    """Solve with SCS (optional dependency).  Returns the same schema as
    the reference glue: x_matrix, z_matrix, y_eq, y_ineq and the raw sol.
    Parity: reference psd_system/direct_conic.py:115-187."""
    import scs

    A, b, c, cone = scs_encode(prob)
    sol = scs.solve(
        {"A": A, "b": b, "c": c}, cone,
        eps_abs=eps, eps_rel=eps, verbose=verbose, **scs_kwargs,
    )
    x = sol.get("x")
    y = sol.get("y")
    if x is None or y is None:
        status = sol.get("info", {}).get("status")
        raise RuntimeError(f"SCS returned no solution (status={status})")
    n = prob.n
    m_eq, m_ineq = len(prob.eq_entries), len(prob.ineq_entries)
    return {
        "x_matrix": smat(np.asarray(x), n),
        "y_eq": np.asarray(y)[:m_eq],
        "y_ineq": np.asarray(y)[m_eq:m_eq + m_ineq],
        "z_matrix": smat(np.asarray(y)[m_eq + m_ineq:], n),
        "iters": float(sol.get("info", {}).get("iter", 0)),
        "sol": sol,
    }


# --- SDPA (sdpap / CLP format) encoding -------------------------------------


def _full_entries(entries: Entries, n: int):
    """(positions, values) over the full column-major n*n vectorisation;
    off-diagonal coefficients are split symmetrically so the row acts on
    a symmetric X exactly like the entry list."""
    pos: dict = {}

    def hit(i, j, w):
        p = i + j * n
        pos[p] = pos.get(p, 0.0) + w

    for i, j, coef in entries:
        if i == j:
            hit(i, i, float(coef))
        else:
            hit(i, j, 0.5 * float(coef))
            hit(j, i, 0.5 * float(coef))
    idx = np.fromiter(pos.keys(), dtype=np.int64, count=len(pos))
    val = np.fromiter(pos.values(), dtype=float, count=len(pos))
    return idx, val


def sdpa_encode(prob: ConicSDP):
    """(A, b, c) + cone sizes for ``sdpap.solve`` (CLP format): variable
    cone K = PSD(n) over the full vectorisation, constraint cone J with
    f equalities then l inequalities (Ax - b >= 0 rows)."""
    import scipy.sparse as sp

    n = prob.n
    nvar = n * n
    m_eq, m_ineq = len(prob.eq_entries), len(prob.ineq_entries)
    rows, cols, vals = [], [], []
    b = np.zeros(m_eq + m_ineq)
    for r, entries in enumerate(prob.eq_entries):
        idx, val = _full_entries(entries, n)
        rows.append(np.full(idx.shape, r))
        cols.append(idx)
        vals.append(val)
        b[r] = prob.eq_rhs[r]
    for k, entries in enumerate(prob.ineq_entries):
        r = m_eq + k
        idx, val = _full_entries(entries, n)
        rows.append(np.full(idx.shape, r))
        cols.append(idx)
        vals.append(val)
        b[r] = prob.ineq_rhs[k]
    A = sp.coo_matrix(
        (np.concatenate(vals) if vals else np.zeros(0),
         (np.concatenate(rows) if rows else np.zeros(0),
          np.concatenate(cols) if cols else np.zeros(0))),
        shape=(m_eq + m_ineq, nvar),
    ).tocsc()
    c = -prob.C.reshape(-1, order="F")
    return A, b, c, m_eq, m_ineq


def _svec_t(M, rows, cols, scale):
    return M[rows, cols] * scale


def _smat_t(v, n, rows, cols, scale):
    vals = v / scale
    M = v.new_zeros((n, n))
    M[rows, cols] = vals
    M[cols, rows] = vals
    return M


def solve_splitting(prob: ConicSDP, rho: float = 1.0,
                    max_iter: int = 20000, tol: float = 1e-7,
                    verbose: bool = False, *, device="cuda"):
    """Native first-order operator-splitting SDP solver (SCS-class ADMM),
    in PyTorch on ``device``.

    The reference's cross-solver ground-truth axis runs the pip ``scs``
    wheel (psd_system/maxcut/maxcut_scs.py:44-110); this is an in-tree
    solver of the same algorithm family (alternating projections onto the
    affine constraint set and the PSD cone with scaled dual updates, minus
    the homogeneous self-dual embedding), the JAX package's
    ``solve_splitting`` step for step: the Schur matrix of the affine
    projection factored once by ``torch.linalg.cholesky`` (where the JAX
    package calls ``cho_factor``) and solved with ``cholesky_solve``, the
    PSD projection by ``torch.linalg.eigh``.  Dense factorizations: meant
    for cross-check sizes.  Its known defects are the JAX package's, kept:
    no converged flag (a run that stops at ``max_iter`` looks like one
    that converged), and the dual residual is rho * ||z - z_old|| without
    the adjoint.  The host reads the two residuals once an iteration.

    Solves  max <C, X>  s.t.  A_eq(X) = b,  A_in(X) >= h,  X PSD.
    Returns dict(x_matrix (a tensor on ``device``), objective, iterations,
    primal_res, dual_res)."""
    dev = torch.device(device)
    n = prob.n
    nvar = n * (n + 1) // 2
    m_eq, m_in = len(prob.eq_entries), len(prob.ineq_entries)

    def rows(entries_list):
        R = np.zeros((len(entries_list), nvar))
        for r, entries in enumerate(entries_list):
            idx, val = svec_entries(entries, n)
            R[r, idx] = val
        return torch.as_tensor(R, device=dev)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=float), device=dev)

    A_eq = rows(prob.eq_entries)
    A_in = rows(prob.ineq_entries)
    b_eq = t(prob.eq_rhs)
    h_in = t(prob.ineq_rhs)
    r_np, c_np = _tril_indices(n)
    tr_r, tr_c = (torch.as_tensor(a, device=dev) for a in (r_np, c_np))
    scale = torch.where(tr_r != tr_c, _SQRT2, 1.0).to(torch.float64)
    C = t(prob.C)
    c = -_svec_t(C, tr_r, tr_c, scale)  # minimise -<C, X>

    A_all = torch.cat([A_eq, A_in]) if m_in else A_eq
    G = (A_all @ A_all.T) / rho
    if m_in:
        G[m_eq:, m_eq:] += torch.eye(m_in, dtype=G.dtype, device=dev) / rho
    G_f = torch.linalg.cholesky(G + 1e-12 * torch.eye(G.shape[0], dtype=G.dtype, device=dev))

    zx = torch.zeros(nvar, dtype=torch.float64, device=dev)
    ux = torch.zeros_like(zx)
    s = torch.zeros(m_in, dtype=torch.float64, device=dev)
    zs = torch.zeros_like(s)
    us = torch.zeros_like(s)

    rhs_const = torch.cat([b_eq, h_in]) if m_in else b_eq
    it = 0
    pri = dual = np.inf
    for it in range(1, max_iter + 1):
        qx = rho * (zx - ux) - c
        qs = rho * (zs - us)
        r_vec = rhs_const - (torch.cat([A_eq @ (qx / rho), A_in @ (qx / rho) - qs / rho])
                             if m_in else A_eq @ (qx / rho))
        lam = torch.cholesky_solve(r_vec[:, None], G_f)[:, 0]
        x = (qx + A_all.T @ lam) / rho
        if m_in:
            s = (qs - lam[m_eq:]) / rho
        zx_old, zs_old = zx, zs
        w, V = torch.linalg.eigh(_smat_t(x + ux, n, tr_r, tr_c, scale))
        zx = _svec_t((V * torch.clamp_min(w, 0.0)) @ V.T, tr_r, tr_c, scale)
        if m_in:
            zs = torch.clamp_min(s + us, 0.0)
        ux = ux + x - zx
        if m_in:
            us = us + s - zs
        norms = torch.stack([torch.linalg.vector_norm(x - zx),
                             torch.linalg.vector_norm(s - zs),
                             torch.linalg.vector_norm(zx - zx_old),
                             torch.linalg.vector_norm(zs - zs_old),
                             torch.linalg.vector_norm(zx)]).cpu().numpy()
        pri = float(norms[0] + (norms[1] if m_in else 0.0))
        dual = float(rho * (norms[2] + (norms[3] if m_in else 0.0)))
        scl = max(1.0, float(norms[4]))
        if pri / scl < tol and dual / scl < tol:
            break
        if verbose and it % 500 == 0:
            print(f"[splitting] it {it}: pri {pri:.2e} dual {dual:.2e}", flush=True)

    X = _smat_t(zx, n, tr_r, tr_c, scale)
    return {
        "x_matrix": X,
        "objective": float(torch.sum(C * X)),
        "iterations": it,
        "primal_res": float(pri),
        "dual_res": float(dual),
    }


def solve_sdpa(prob: ConicSDP, option=None):
    """Solve with sdpap (optional dependency).  Parity:
    reference psd_system/direct_conic.py:202-271."""
    import sdpap

    A, b, c, m_eq, m_ineq = sdpa_encode(prob)
    n = prob.n
    K = sdpap.SymCone(s=(n,))
    J = sdpap.SymCone(f=m_eq, l=m_ineq)
    opts = {
        "print": "no",
        "epsilonDash": 1e-5,
        "epsilonStar": 1e-5,
        "domainMethod": "none",
        "rangeMethod": "none",
    }
    if option:
        opts.update(option)
    x, y, *info = sdpap.solve(A, b, c, K, J, option=opts)
    x_vec = np.asarray(x.todense()).reshape(-1)
    y_vec = np.asarray(y.todense()).reshape(-1)
    X = x_vec.reshape((n, n), order="F")
    Z = (c - A.T @ y_vec).reshape((n, n), order="F")
    return {
        "x_matrix": 0.5 * (X + X.T),
        "y_eq": y_vec[:m_eq],
        "y_ineq": y_vec[m_eq:],
        "z_matrix": 0.5 * (Z + Z.T),
        "info": info,
    }


# --- per-problem constraint builders ----------------------------------------
# Dense-side mirrors of the TT problem generators (models/*.py); used by
# utils/baseline_runner.py.  Parity: psd_system/*/*_scs.py builders.


def maxcut_conic(C: np.ndarray) -> ConicSDP:
    """max <C, X>, diag(X) = 1, X PSD (psd_system/maxcut/maxcut_scs.py:19)."""
    prob = ConicSDP(C)
    for i in range(C.shape[0]):
        prob.add_eq([(i, i, 1.0)], 1.0)
    return prob


def corr_clust_conic(C: np.ndarray, ineq_mask: np.ndarray,
                     beta: float = 0.0) -> ConicSDP:
    """diag(X)=1 plus entrywise X_ij >= -beta on the mask support
    (psd_system/corr_clust/corr_clust_scs.py:17-31)."""
    prob = ConicSDP(C)
    n = C.shape[0]
    for i in range(n):
        prob.add_eq([(i, i, 1.0)], 1.0)
    ii, jj = np.nonzero(np.triu(ineq_mask))
    for i, j in zip(ii.tolist(), jj.tolist()):
        prob.add_ge([(int(i), int(j), float(ineq_mask[i, j]))], -beta)
    return prob


def max_stable_set_conic(C: np.ndarray, adj: np.ndarray) -> ConicSDP:
    """X_ij = 0 on edges, trace(X) = 1
    (psd_system/max_stable_set/max_stable_set_scs.py:22-38)."""
    prob = ConicSDP(C)
    n = C.shape[0]
    ii, jj = np.nonzero(np.triu(adj))
    for i, j in zip(ii.tolist(), jj.tolist()):
        prob.add_eq([(int(i), int(j), float(adj[i, j]))], 0.0)
    prob.add_eq([(k, k, 1.0) for k in range(n)], 1.0)
    return prob


def graphm_conic(C: np.ndarray, n: int) -> ConicSDP:
    """Lifted QAP constraints on the (n^2+1)-sized matrix [[Q, p], [pT, 1]]
    (psd_system/graphm/graphm_scs.py:17-95): block partial traces,
    doubly-stochastic coupling, Q/P nonnegativity."""
    q = n * n
    last = q
    prob = ConicSDP(C)
    prob.add_eq([(last, last, 1.0)], 1.0)
    # sum_i Q_ii block == I_n
    for a in range(n):
        for b_ in range(n):
            prob.add_eq([(i * n + a, i * n + b_, 1.0) for i in range(n)],
                        1.0 if a == b_ else 0.0)
    # trace(Q_ij) == 0 for i != j
    for i in range(n):
        for j in range(n):
            if i != j:
                prob.add_eq([(i * n + a, j * n + a, 1.0) for a in range(n)],
                            0.0)
    # each Q_ij block sums to 1
    for i in range(n):
        for j in range(n):
            prob.add_eq(
                [(i * n + a, j * n + b_, 1.0)
                 for a in range(n) for b_ in range(n)], 1.0)
    # diag(Q) equals the P column of the lifting
    for i in range(n):
        for j in range(n):
            idx = i * n + j
            prob.add_eq([(idx, idx, 1.0), (idx, last, -1.0)], 0.0)
    # doubly stochastic P
    for i in range(n):
        prob.add_eq([(j + i * n, last, 1.0) for j in range(n)], 1.0)
    for j in range(n):
        prob.add_eq([(j + i * n, last, 1.0) for i in range(n)], 1.0)
    # nonnegativity
    for i in range(n):
        for j in range(n):
            prob.add_ge([(j + i * n, last, 1.0)], 0.0)
    for r in range(q):
        for c_ in range(r + 1):
            prob.add_ge([(r, c_, 1.0)], 0.0)
    return prob
