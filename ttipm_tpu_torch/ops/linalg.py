"""Dense factorizations on ``torch.linalg``.

The JAX package wraps its factorizations for the TPU's f64 emulation
(Jacobi SVD/eigh, QR in place of LU, ``TINY`` guards:
``ttipm_tpu/ops/jacobi.py:1-31``, ``ttipm_tpu/ops/linalg.py``).  The GPU
runs f64 natively, so the port keeps only the contracts those wrappers
give on the CPU reference path:

* ``safe_svd`` / ``fast_split_svd``: economy SVD, ``u @ diag(s) @ vt == a``,
  ``s`` descending (``jacobi.py:336-363``).
* ``safe_eigh``: symmetric eigendecomposition, ascending (``jacobi.py:455``).
* ``lu_factor`` / ``lu_solve``: the host engine's LAPACK LU for the Schur
  systems (``solvers/fused_host.py:99-111``).
* ``chol_solve``: two triangular solves with a lower Cholesky factor.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "safe_svd", "fast_split_svd", "safe_eigh", "lu_factor", "lu_solve",
    "chol_solve", "qr_econ",
]


def safe_svd(a: torch.Tensor):
    """Economy SVD.  LAPACK's gesdd can fail to converge where gesvd does
    not; the host engine retries with gesvd, and so does this."""
    try:
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
    except torch.linalg.LinAlgError:
        if a.is_cuda:
            return torch.linalg.svd(a, full_matrices=False, driver="gesvd")
        import scipy.linalg as sla

        u, s, vt = sla.svd(a.numpy(), full_matrices=False,
                           lapack_driver="gesvd")
        return tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in (u, s, vt))
    return u, s, vt


fast_split_svd = safe_svd


def safe_eigh(a: torch.Tensor):
    return torch.linalg.eigh(a)


def qr_econ(a: torch.Tensor):
    return torch.linalg.qr(a, mode="reduced")


def lu_factor(a: torch.Tensor):
    """LU with partial pivoting.  A singular or non-finite matrix is not an
    error here: its solves come out non-finite and the caller's
    finiteness guard rejects them."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    return lu, piv


def lu_solve(fac, b: torch.Tensor) -> torch.Tensor:
    lu, piv = fac
    return torch.linalg.lu_solve(lu, piv, b)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)
