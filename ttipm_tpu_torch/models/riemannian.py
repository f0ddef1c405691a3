"""Riemannian trust-region solver on the Oblique manifold (Manopt parity),
in PyTorch.

Counterpart of ``ttipm_tpu/models/riemannian.py`` (role parity:
reference psd_system/maxcut/maxcut_manopt.py:22-60, pymanopt
TrustRegions on ``Oblique(rank, n)`` for the Burer-Monteiro factorisation
``X = U^T U`` of the MaxCut SDP; columns of ``U`` unit-norm, so
``diag(X) = 1``): the Riemannian trust-region method with a
Steihaug-Toint truncated-CG inner solver (Absil, Baker & Gallivan,
"Trust-region methods on Riemannian manifolds", Found. Comput. Math.,
2007), step for step the JAX package's numpy solver, on the device of the
start ``U0``.  The host reads the scalars of each inner CG step.

Oblique manifold Ob(r, n): r x n matrices with unit-norm columns, the
product of n unit spheres S^{r-1}.
  tangent projection   P_U(H) = H - U * diag(colsum(U .* H))
  retraction           R_U(H) = normalize_columns(U + H)
  Riemannian gradient  grad f = P_U(egrad)
  Riemannian Hessian   Hess f[H] = P_U(ehess[H] - H * diag(colsum(U .* egrad)))
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["oblique_trust_regions", "solve_maxcut_manopt", "default_bm_rank"]


def default_bm_rank(n: int) -> int:
    """Burer-Monteiro rank ceil(sqrt(2n)) (maxcut_manopt.py:18-19)."""
    return max(2, int(np.ceil(np.sqrt(2 * n))))


def _normalize_columns(U: torch.Tensor) -> torch.Tensor:
    return U / torch.clamp_min(torch.linalg.vector_norm(U, dim=0, keepdim=True), 1e-300)


def _proj(U: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    return H - U * torch.sum(U * H, dim=0, keepdim=True)


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sum(a * b))


@dataclass
class RTRResult:
    point: torch.Tensor
    cost: float
    grad_norm: float
    iterations: int
    time: float
    stopping_reason: str


def _truncated_cg(U, grad, hess, delta, kappa=0.1, theta=1.0,
                  max_inner: Optional[int] = None):
    """Steihaug-Toint tCG for the trust-region subproblem
    min_eta <grad, eta> + 0.5 <eta, Hess[eta]>, |eta| <= delta: stops on
    negative curvature or the trust-region boundary (moving to the
    boundary along the current direction), or on the
    kappa/theta-superlinear residual test (Absil et al., Alg. 2)."""
    if max_inner is None:
        max_inner = U.numel()
    eta = torch.zeros_like(U)
    r = grad.clone()
    r_norm0 = float(torch.linalg.vector_norm(r))
    if r_norm0 == 0.0:
        return eta, "zero gradient"
    d = -r
    r_sq = r_norm0 ** 2
    eta_sq = 0.0
    stop = "max inner iterations"
    for _ in range(max_inner):
        Hd = hess(U, d)
        dHd, d_sq, eta_d = (float(v) for v in torch.stack(
            [torch.sum(d * Hd), torch.sum(d * d), torch.sum(eta * d)]).cpu())
        if dHd <= 0.0:
            tau = (-eta_d + np.sqrt(eta_d ** 2 + d_sq * (delta ** 2 - eta_sq))) / d_sq
            return eta + tau * d, "negative curvature"
        alpha = r_sq / dHd
        eta_sq_new = eta_sq + 2.0 * alpha * eta_d + alpha ** 2 * d_sq
        if eta_sq_new >= delta ** 2:
            tau = (-eta_d + np.sqrt(eta_d ** 2 + d_sq * (delta ** 2 - eta_sq))) / d_sq
            return eta + tau * d, "exceeded trust region"
        eta = eta + alpha * d
        eta_sq = eta_sq_new
        r = _proj(U, r + alpha * Hd)  # keep the iteration in T_U M
        r_sq_new = _dot(r, r)
        r_norm = np.sqrt(r_sq_new)
        if r_norm <= r_norm0 * min(r_norm0 ** theta, kappa):
            return eta, "superlinear residual"
        beta = r_sq_new / r_sq
        d = _proj(U, -r + beta * d)
        r_sq = r_sq_new
    return eta, stop


def oblique_trust_regions(
    cost: Callable[[torch.Tensor], float],
    egrad: Callable[[torch.Tensor], torch.Tensor],
    ehess: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    U0: torch.Tensor,
    max_iterations: int = 500,
    min_gradient_norm: float = 1e-6,
    verbose: bool = False,
) -> RTRResult:
    """Riemannian trust regions on Ob(r, n) (Absil et al., Alg. 1) from
    ``U0`` (a tensor; the solve runs on its device, in float64).
    ``ehess(U, H)`` is the Euclidean Hessian-vector product; the
    sphere-product Weingarten correction converts it to the Riemannian
    one."""
    t0 = time.time()
    U = _normalize_columns(torch.as_tensor(U0, dtype=torch.float64))
    delta_bar = np.sqrt(U.shape[1])  # manifold "diameter" scale
    delta = delta_bar / 8.0
    rho_prime = 0.1

    def rgrad(Upt):
        return _proj(Upt, egrad(Upt))

    def rhess(Upt, H):
        g = egrad(Upt)
        weingarten = H * torch.sum(Upt * g, dim=0, keepdim=True)
        return _proj(Upt, ehess(Upt, H) - weingarten)

    f = cost(U)
    reason = "max iterations"
    k = 0
    for k in range(1, max_iterations + 1):
        g = rgrad(U)
        g_norm = float(torch.linalg.vector_norm(g))
        if g_norm < min_gradient_norm:
            reason = "gradient norm below tolerance"
            break
        eta, tcg_stop = _truncated_cg(U, g, rhess, delta)
        U_prop = _normalize_columns(U + eta)
        f_prop = cost(U_prop)
        model_decrease = -(_dot(g, eta) + 0.5 * _dot(eta, rhess(U, eta)))
        actual_decrease = f - f_prop
        rho = actual_decrease / max(model_decrease, 1e-300)
        if rho < 0.25:
            delta *= 0.25
        elif rho > 0.75 and tcg_stop in ("negative curvature", "exceeded trust region"):
            delta = min(2.0 * delta, delta_bar)
        if rho > rho_prime and actual_decrease > 0:
            U, f = U_prop, f_prop
        if verbose and (k % 25 == 0 or k == 1):
            print(f"  RTR iter {k}: cost {f:.6e} |grad| {g_norm:.3e} "
                  f"delta {delta:.2e} ({tcg_stop})", flush=True)
    g_norm = float(torch.linalg.vector_norm(rgrad(U)))
    return RTRResult(point=U, cost=f, grad_norm=g_norm, iterations=k,
                     time=time.time() - t0, stopping_reason=reason)


def solve_maxcut_manopt(C, rank: Optional[int] = None, max_iterations: int = 500,
                        min_gradient_norm: float = 1e-6, seed: Optional[int] = None,
                        verbose: bool = False, *, device="cuda") -> dict:
    """MaxCut SDP by Burer-Monteiro RTR: max tr(U C U^T), U in Ob(r, n),
    on ``device``.  The start is the JAX package's: ``randn(r, n)`` of
    ``np.random.RandomState(seed)``.  Returns x_matrix (the lifted X =
    U^T U, a tensor on ``device``), objective and the solver's
    diagnostics (maxcut_manopt.py:22-75)."""
    C = torch.as_tensor(np.asarray(C, dtype=np.float64) if not torch.is_tensor(C) else C,
                        dtype=torch.float64, device=device)
    C = 0.5 * (C + C.T)
    n = C.shape[0]
    r = min(n, rank or default_bm_rank(n))
    rng = np.random.RandomState(seed)
    U0 = _normalize_columns(torch.as_tensor(rng.randn(r, n), device=C.device))

    def cost(U):
        return -float(torch.sum((U @ C) * U))

    def egrad(U):
        return -2.0 * U @ C

    def ehess(U, H):
        return -2.0 * H @ C

    res = oblique_trust_regions(cost, egrad, ehess, U0, max_iterations=max_iterations,
                                min_gradient_norm=min_gradient_norm, verbose=verbose)
    U = res.point
    X = U.T @ U
    return {
        "x_matrix": X,
        "objective": float(torch.sum(C * X)),
        "grad_norm": res.grad_norm,
        "iterations": res.iterations,
        "time": res.time,
        "stopping_reason": res.stopping_reason,
    }
