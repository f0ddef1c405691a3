"""Restarted GMRES and LGMRES for the projected KKT systems of the ragged
local solvers.

Counterpart of ``ttipm_tpu/solvers/lgmres.py``: the Arnoldi cycle runs on
the host (CGS2 over a fixed-width zero-padded basis on the device, the
small least-squares problem in numpy), the matvecs on the device.
``lgmres`` augments each cycle with the last ``k_aug`` normalised restart
corrections (Baker, Jessup & Manteuffel 2005), the PETSc option the
reference enables with ``-ksp_lgmres_augment``.  Each Arnoldi step reads
one norm on the host (the breakdown test).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["gmres_restarted", "lgmres"]


def _arnoldi_cycle(matvec, b, x0, restart, atol, aug=()):
    """One (L)GMRES(restart) cycle; the last ``len(aug)`` Krylov slots take
    the augmentation vectors instead of the newest basis column.  Returns
    (x, residual_norm)."""
    r = b - matvec(x0)
    beta = float(torch.linalg.norm(r))
    if beta <= atol or beta == 0.0:
        return x0, beta
    n = b.numel()
    restart = min(restart, n)
    aug = tuple(aug)[: max(0, restart - 1)]
    n_kry = restart - len(aug)  # pure Krylov steps before the augmented ones
    aug_used = []
    V = b.new_zeros((n, restart + 1))
    V[:, 0] = r / beta
    H = np.zeros((restart + 1, restart))
    k_used = 0
    for k in range(restart):
        if k < n_kry:
            u = V[:, k]
        else:
            u = aug[k - n_kry]
            aug_used.append(u)
        w = matvec(u)
        # CGS2 against the whole zero-padded basis
        h1 = V.T @ w
        w = w - V @ h1
        h2 = V.T @ w
        w = w - V @ h2
        hk1_t = torch.linalg.norm(w)
        h_host = torch.cat([h1 + h2, hk1_t[None]]).cpu().numpy()
        H[: k + 1, k] = h_host[: k + 1]
        hk1 = float(h_host[-1])
        H[k + 1, k] = hk1
        k_used = k + 1
        if hk1 <= 1e-14 * beta:
            break
        V[:, k + 1] = w / hk1
        # a cheap residual estimate from the small least-squares problem
        if (k + 1) % 5 == 0 or k == restart - 1:
            e1 = np.zeros(k_used + 1)
            e1[0] = beta
            y, *_ = np.linalg.lstsq(H[: k_used + 1, :k_used], e1, rcond=None)
            est = float(np.linalg.norm(H[: k_used + 1, :k_used] @ y - e1))
            if est <= atol:
                break
    e1 = np.zeros(k_used + 1)
    e1[0] = beta
    y, *_ = np.linalg.lstsq(H[: k_used + 1, :k_used], e1, rcond=None)
    n_kry_used = min(k_used, n_kry)
    y_pad = np.zeros(restart + 1)
    y_pad[:n_kry_used] = y[:n_kry_used]
    x = x0 + V @ torch.as_tensor(y_pad, dtype=b.dtype, device=b.device)
    for j, z in enumerate(aug_used[: max(0, k_used - n_kry_used)]):
        x = x + float(y[n_kry_used + j]) * z
    res = float(torch.linalg.norm(b - matvec(x)))
    return x, res


def gmres_restarted(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
                    x0: Optional[torch.Tensor] = None, rtol: float = 1e-8,
                    restart: int = 40, maxiter: int = 5):
    """Restarted GMRES for ``matvec(x) = b`` to relative tolerance ``rtol``
    (LGMRES without augmentation).  Returns (x, info), info 0 on
    convergence."""
    return lgmres(matvec, b, x0=x0, rtol=rtol, restart=restart, maxiter=maxiter, k_aug=0)


def lgmres(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
           x0: Optional[torch.Tensor] = None, rtol: float = 1e-8, restart: int = 40,
           maxiter: int = 5, k_aug: int = 3):
    """LGMRES(restart, k_aug): restarted GMRES whose cycles are augmented
    with the last ``k_aug`` normalised restart corrections.  Returns
    (x, info), info 0 on convergence."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    b_norm = float(torch.linalg.norm(b))
    if b_norm == 0.0:
        return torch.zeros_like(b), 0
    atol = rtol * b_norm
    x = x0
    aug: list = []
    for _ in range(maxiter):
        x_new, res = _arnoldi_cycle(matvec, b, x, restart, atol, aug=tuple(aug))
        z = x_new - x
        z_norm = float(torch.linalg.norm(z))
        if z_norm > 0.0 and np.isfinite(z_norm):
            aug.insert(0, z / z_norm)
            del aug[k_aug:]
        x = x_new
        if res <= atol:
            return x, 0
    return x, 1
