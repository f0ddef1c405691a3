"""Classical dense SDP baselines for cross-checking the TT-IPM, in PyTorch
on a device.

Counterpart of ``ttipm_tpu/models/baselines.py``: ``cgal`` /
``sketchy_cgal`` are the CGAL and SketchyCGAL algorithms of Yurtsever,
Tropp, Fercoq, Udell & Cevher, *Scalable Semidefinite Programming* (SIAM
J. Math. Data Sci. 3(1), 2021), conditional-gradient augmented-Lagrangian
methods on the trace-bounded spectrahedron, step for step the JAX
package's numpy solvers, here on ``device`` ("cuda" by default).
SketchyCGAL tracks only the Nystrom sketch and the scalars (<C, X>,
A(X), tr X), never the full iterate.

Two deviations, both in ROADMAP Queue 3:

* The constraint map keeps the nonzero entries of the constraint
  matrices (their coordinates and values) where the JAX package keeps
  the dense (k, n, n) stack: the same sums without the zeros, so O(nnz)
  work and memory (maxcut d10's 1024 diagonal selectors are 8.6 GB as a
  dense stack).  ``build_dense_problem`` hands the selectors over in that
  form (``utils/baseline_runner.py``).
* The smallest eigenpair of the gradient above order 128 comes from a
  restarted Lanczos of the port's own on the device (full
  reorthogonalisation, warm-started from the previous iteration's
  eigenvector with a fixed Gaussian mixed in), where the JAX package
  calls ARPACK's ``eigsh``; both converge to the smallest pair (the
  vector may differ where that eigenvalue is multiple).  At order 128 and below both call a dense
  symmetric eigensolver.

``solve_scs_psd_max`` / ``solve_sdpa_psd_max`` delegate to the conic
encodings of ``models/conic.py`` and need the optional ``scs`` /
``sdpap`` packages for the solve call.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["cgal", "sketchy_cgal", "solve_scs_psd_max", "solve_sdpa_psd_max",
           "min_eigpair"]


# --- shared machinery --------------------------------------------------------


def _t(a, device):
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


class _ConstraintMap:
    """A(X) = (<A_i, X>)_i and its adjoint over the nonzero entries of the
    constraint matrices: a sequence of n x n matrices, or a sparse COO
    tensor (k, n, n)."""

    def __init__(self, constraint_matrices, device):
        if torch.is_tensor(constraint_matrices) and constraint_matrices.is_sparse:
            coo = constraint_matrices.coalesce()
        else:
            coo = torch.stack([_t(A, "cpu") for A in constraint_matrices]).to_sparse()
        coo = coo.to(device=device, dtype=torch.float64)
        self.k, self.i, self.j = coo.indices()
        self.v = coo.values()
        self.m, self.n = coo.shape[0], coo.shape[1]
        self.flat = self.i * self.n + self.j

    def _rows(self, vals):
        return vals.new_zeros(self.m).index_add_(0, self.k, vals)

    def __call__(self, X):
        return self._rows(self.v * X[self.i, self.j])

    def on_vector(self, v):
        """A(v v^T) without forming the outer product."""
        return self._rows(self.v * v[self.i] * v[self.j])

    def adjoint(self, z):
        out = z.new_zeros(self.n * self.n).index_add_(0, self.flat, z[self.k] * self.v)
        return out.reshape(self.n, self.n)

    @property
    def frob_sum(self) -> float:
        return float(torch.sum(torch.sqrt(self._rows(self.v * self.v))))


def _lanczos_min(H, v0, m, tol=1e-12, max_restarts=200):
    """Smallest eigenpair of the symmetric H (n x n, on the device) by
    Lanczos with full reorthogonalisation, restarted from the Ritz vector
    every ``m`` steps until ||H x - theta x|| <= tol * ||H||_F.  The
    tridiagonal eigenproblem is solved on the host (one transfer a
    restart).  A breakdown (an invariant Krylov space, as a gradient with
    few distinct eigenvalues gives) ends the cycle there: its Ritz pairs
    are exact."""
    n = H.shape[0]
    m = max(2, min(m, n - 1))
    Q = H.new_zeros((m + 1, n))
    h_norm = max(float(torch.linalg.matrix_norm(H)), 1e-300)
    v = v0 / torch.linalg.vector_norm(v0)
    theta, x = None, v
    for _ in range(max_restarts):
        Q[0] = v
        T = H.new_zeros((m + 1, m))
        for j in range(m):
            w = H @ Q[j]
            for _ in range(2):  # classical Gram-Schmidt, twice
                h = Q[:j + 1] @ w
                w = w - Q[:j + 1].T @ h
                T[:j + 1, j] += h
            T[j + 1, j] = torch.linalg.vector_norm(w)
            Q[j + 1] = w / torch.clamp_min(T[j + 1, j], 1e-300)
        Tm = T.cpu().numpy()
        beta = np.diagonal(Tm, -1)
        k = next((j + 1 for j in range(m) if beta[j] <= 1e-13 * h_norm), m)
        w_ritz, S = np.linalg.eigh(0.5 * (Tm[:k, :k] + Tm[:k, :k].T))
        theta = float(w_ritz[0])
        x = Q[:k].T @ torch.as_tensor(S[:, 0], device=H.device)
        x = x / torch.linalg.vector_norm(x)
        if float(torch.linalg.vector_norm(H @ x - theta * x)) <= tol * h_norm:
            break
        v = x
    return theta, x


def min_eigpair(H, ncv: int, v0=None):
    """Smallest eigenpair of a symmetric matrix on the device: a dense
    symmetric eigensolver at order 128 and below (the JAX package's
    rule), the restarted Lanczos of ``ncv`` steps from ``v0`` (default a
    fixed Gaussian) above.  Returns (lambda, v, ncv)."""
    n = H.shape[0]
    if n <= 128:
        w, V = torch.linalg.eigh(H)
        return float(w[0]), V[:, 0], ncv
    lam, v = _lanczos_min(H, _probe(n, H.device) if v0 is None else v0, min(ncv, n - 1))
    return lam, v, ncv


def _probe(n, device):
    """A fixed unit Gaussian (RandomState(0)): the Lanczos start, alone or
    mixed into a warm start, so that the start meets every eigenspace (a
    warm start that is an eigenvector of the next gradient, but not its
    smallest, would end the Krylov space at once)."""
    r = torch.as_tensor(np.random.RandomState(0).randn(n), device=device)
    return r / torch.linalg.vector_norm(r)


def _start(v, probe):
    """The Lanczos start of an iteration: the previous eigenvector plus
    1e-2 of the probe."""
    return probe if v is None else v + 1e-2 * probe


def _stop_test(gap: float, feas: float, obj: float, bias_norm: float,
               gap_tol: float, abs_tol) -> bool:
    """Relative-or-absolute termination contract shared with the runner
    (reference src/baselines.py keeps the same thresholds)."""
    gap_ok = gap < min((1.0 + abs(obj)) * gap_tol, abs_tol[0])
    feas_ok = feas < min((1.0 + bias_norm) * gap_tol, abs_tol[1])
    return gap_ok and feas_ok


# --- CGAL (Algorithm 3.1) ----------------------------------------------------


def cgal(obj_matrix, constraint_matrices, bias, trace_params, R=1,
         gap_tol=1e-5, abs_tol=(0.1, 1e-3), num_iter=100, verbose=False, *, device="cuda"):
    """min <C, X>  s.t.  A(X) = b,  tr X <= alpha,  X PSD, on ``device``.

    Smoothed augmented Lagrangian with beta_t = sqrt(t+1), dual ascent with
    the paper's step-size safeguard; the primal update mixes in the rank-1
    atom alpha * v v^T from the smallest eigenvector of the gradient.
    ``trace_params = (alpha_if_gradient_psd, alpha)`` reproduces the
    trace-or-zero atom selection used for maximisation problems.  Returns
    (X on ``device``, gaps, {"num_iters": t})."""
    C = _t(obj_matrix, device)
    amap = _ConstraintMap(constraint_matrices, C.device)
    b = _t(bias, C.device).reshape(-1)
    b_norm = float(torch.linalg.vector_norm(b))

    X = torch.zeros_like(C)
    y = torch.zeros_like(b)
    slack = -b
    alpha_0 = 4.0 * amap.frob_sum * trace_params[1] ** 2

    gaps: List[float] = []
    gap = np.inf
    ncv = 20
    v = None
    probe = _probe(C.shape[0], C.device)
    t = 0
    for t in range(1, num_iter):
        beta = np.sqrt(t + 1.0)
        shift = amap.adjoint(y + beta * slack)
        lam, v, ncv = min_eigpair(C + shift, ncv, _start(v, probe))
        alpha_tr = trace_params[0] if lam > 0 else trace_params[1]
        obj_val, shift_x = (float(s) for s in torch.stack(
            [torch.sum(C * X), torch.sum(shift * X)]).cpu())
        gap = obj_val + shift_x - alpha_tr * lam

        eta = 2.0 / (t + 1.0)
        X *= 1.0 - eta
        if alpha_tr != 0.0:
            X += (eta * alpha_tr) * torch.outer(v, v)

        slack = amap(X) - b
        feas2, obj_x = (float(s) for s in torch.stack(
            [slack @ slack, torch.sum(C * X)]).cpu())
        gamma = min(alpha_0 / ((t + 1.0) ** 1.5 * max(feas2, 1e-300)), 1.0)
        y = y + gamma * slack

        feas = np.sqrt(feas2)
        if verbose and t % 1000 == 0:
            gaps.append(gap)
            print(f"cgal step {t}: gap {gap:.3e} feas {feas2:.3e}", flush=True)
        if _stop_test(gap, feas, obj_x, b_norm, gap_tol, abs_tol):
            break
    return X, gaps, {"num_iters": t}


# --- SketchyCGAL (Algorithm 6.1) --------------------------------------------


class _NystromSketch:
    """Rank-R randomised range sketch S = X @ Omega with the stabilised
    reconstruction of the paper (sec. 5.2): shift by sigma, Cholesky of
    the core matrix, SVD of the scaled sketch, shift removed from the
    eigenvalues.  Omega is drawn from numpy's global stream, as in the
    JAX package."""

    def __init__(self, n: int, R: int, device):
        self.omega = torch.as_tensor(np.random.randn(n, R), device=device)
        self.S = torch.zeros((n, R), dtype=torch.float64, device=device)

    def rank_one_mix(self, eta: float, weight: float, v):
        """S <- (1 - eta) S + eta * weight * v (v^T Omega)."""
        self.S *= 1.0 - eta
        if weight != 0.0:
            self.S += (eta * weight) * torch.outer(v, v @ self.omega)

    def reconstruct(self):
        n = self.S.shape[0]
        sigma = 2.2e-12 * np.sqrt(n) * float(torch.linalg.matrix_norm(self.S))
        Ss = self.S + sigma * self.omega
        core = self.omega.T @ Ss
        L = torch.linalg.cholesky(0.5 * (core + core.T))
        Bm = torch.linalg.solve(L, Ss.T).T
        U, s, _ = torch.linalg.svd(Bm, full_matrices=False)
        lam = torch.clamp_min(s ** 2 - sigma, 0.0)
        return U, torch.diag(lam)


def sketchy_cgal(obj_matrix, constraint_matrices, bias, trace_params, R=1,
                 gap_tol=1e-5, abs_tol=(0.1, 1e-3), num_iter=100,
                 verbose=False, stagnation_window=100, stagnation_tol=1e-6,
                 improve_window=None, *, device="cuda"):
    """CGAL tracking only (sketch, A(X), <C, X>): O(nR) memory for the
    iterate.  The reconstruction returns the best rank-R PSD approximation
    with the trace correction spread over the spectrum (paper eq. (6.3)).

    Stagnation guard: break when a ``stagnation_window`` of gap estimates
    is flat (mean |diff| and std below ``stagnation_tol``); the
    no-improvement counter runs only with ``improve_window`` (the JAX
    package's rule).  Returns (X on ``device``, gaps, {"num_iters": t})."""
    C = _t(obj_matrix, device)
    amap = _ConstraintMap(constraint_matrices, C.device)
    b = _t(bias, C.device).reshape(-1)
    b_norm = float(torch.linalg.vector_norm(b))
    n = C.shape[0]

    sketch = _NystromSketch(n, 2 * R, C.device)
    zX = torch.zeros_like(b)
    cX = 0.0
    trX = 0.0
    y = torch.zeros_like(b)
    slack = -b
    alpha_0 = 4.0 * amap.frob_sum * trace_params[1] ** 2

    gaps: List[float] = []
    best_gap = np.inf
    no_improve = 0.0
    ncv = 20
    v = None
    probe = _probe(n, C.device)
    gap = np.inf
    t = 0
    for t in range(1, num_iter):
        beta = np.sqrt(t + 1.0)
        grad_shift = y + beta * slack
        lam, v, ncv = min_eigpair(C + amap.adjoint(grad_shift), ncv, _start(v, probe))
        alpha_tr = trace_params[0] if lam > 0 else trace_params[1]
        av = amap.on_vector(v)
        shift_z, vCv = (float(s) for s in torch.stack([grad_shift @ zX, v @ (C @ v)]).cpu())
        gap = cX + shift_z - alpha_tr * lam

        eta = 2.0 / (t + 1.0)
        sketch.rank_one_mix(eta, alpha_tr, v)
        zX = (1.0 - eta) * zX + eta * alpha_tr * av
        cX = (1.0 - eta) * cX + eta * alpha_tr * vCv
        trX = (1.0 - eta) * trX + eta * alpha_tr

        slack = zX - b
        feas2 = float(slack @ slack)
        gamma = min(alpha_0 / ((t + 1.0) ** 1.5 * max(feas2, 1e-300)), 1.0)
        y = y + gamma * slack

        feas = np.sqrt(feas2)
        if _stop_test(gap, feas, cX, b_norm, gap_tol, abs_tol):
            break
        gaps.append(gap)
        if len(gaps) > stagnation_window:
            gaps.pop(0)
        if len(gaps) == stagnation_window:
            arr = np.asarray(gaps)
            if (np.mean(np.abs(np.diff(arr))) < stagnation_tol
                    and np.std(arr) < stagnation_tol):
                break
            if improve_window is not None:
                if gap < best_gap:
                    best_gap = gap
                    no_improve = max(0.0, no_improve - 0.5)
                else:
                    no_improve += 1.0
                if no_improve >= improve_window:
                    break
        if verbose and t % 1000 == 0:
            print(f"scgal step {t}: gap {gap:.3e} feas {feas2:.3e}", flush=True)

    U, Lam = sketch.reconstruct()
    U = U[:, :R]
    Lam = Lam[:R, :R]
    Lam = Lam + (trX - float(torch.trace(Lam))) * torch.eye(R, dtype=Lam.dtype,
                                                            device=Lam.device) / R
    X = U @ Lam @ U.T

    shift = y + np.sqrt(t + 1.0) * slack
    lam, _, _ = min_eigpair(C + amap.adjoint(shift), ncv, _start(v, probe))
    alpha_tr = trace_params[0] if lam > 0 else trace_params[1]
    gap = float(torch.sum(C * X) + shift @ amap(X) - alpha_tr * lam)
    gaps.append(gap)
    return X, list(gaps), {"num_iters": t}


# --- conic glue (delegates to models/conic.py) -------------------------------


def _conic_problem(c_matrix, eq_entries, eq_rhs, ineq_entries, ineq_rhs):
    from ttipm_tpu_torch.models.conic import ConicSDP

    prob = ConicSDP(np.asarray(c_matrix, dtype=float))
    for entries, rhs in zip(eq_entries or [],
                            np.atleast_1d(eq_rhs if eq_rhs is not None else [])):
        prob.add_eq(entries, float(rhs))
    for entries, rhs in zip(ineq_entries or [],
                            np.atleast_1d(ineq_rhs if ineq_rhs is not None else [])):
        prob.add_ge(entries, float(rhs))
    return prob


def solve_scs_psd_max(c_matrix, eq_entries, eq_rhs, ineq_entries=None,
                      ineq_rhs=None, eps=1e-5, verbose=False):
    """SCS cross-check: max <C, X>, <A_i, X> = b_i, <G_j, X> >= h_j, X PSD.
    Constraints are (i, j, coef) entry lists (see models/conic.py).
    Requires the optional ``scs`` package for the solve itself.
    Parity: reference psd_system/direct_conic.py:115-187."""
    from ttipm_tpu_torch.models.conic import solve_scs

    prob = _conic_problem(c_matrix, eq_entries, eq_rhs, ineq_entries, ineq_rhs)
    return solve_scs(prob, eps=eps, verbose=verbose)


def solve_sdpa_psd_max(c_matrix, eq_entries, eq_rhs, ineq_entries=None,
                       ineq_rhs=None, option=None):
    """SDPA cross-check via sdpap (optional dependency).
    Parity: reference psd_system/direct_conic.py:202-271."""
    from ttipm_tpu_torch.models.conic import solve_sdpa

    prob = _conic_problem(c_matrix, eq_entries, eq_rhs, ineq_entries, ineq_rhs)
    return solve_sdpa(prob, option=option)
