"""Dense factorizations: which call reaches which kernel on which device.

* ``safe_svd`` / ``fast_split_svd`` / ``svd_econ``: economy SVD,
  ``u @ diag(s) @ vt == a``, ``s`` descending, u orthonormal.  On CUDA
  tensors the Jacobi pipeline of ``ops/jacobi.py`` (``jacobi.jacobi_svd``:
  K3's QRs of the operand and of r^T, J1's one-sided Jacobi
  ``kernels.jacobi_orthogonalise``, for a tall operand K3's completion QR;
  vt rows are zero at s == 0), as the JAX package's
  ``safe_svd`` / ``fast_split_svd`` send f64 on its accelerator to Jacobi
  (``ttipm_tpu/ops/jacobi.py:336-363``); on CPU tensors LAPACK
  (``torch.linalg.svd``, gesdd with a gesvd retry as the host engine's).
* ``safe_eigh`` / ``safe_eigvalsh``: symmetric eigendecomposition,
  ascending.  On CUDA tensors ``jacobi.jacobi_eigh`` (J2's two-sided Jacobi
  ``kernels.jacobi_eigh_core``, ``jacobi.py:431-455``), on CPU tensors
  ``torch.linalg.eigh`` / ``eigvalsh``.
* ``jacobi.forced(True)`` sends CPU tensors through the Jacobi pipelines
  (their cores' plain versions; the tests), ``jacobi.forced(False)`` CUDA
  tensors to cuSOLVER (comparisons only).  A Jacobi factorization never
  raises: an instance that is not finite or does not converge comes out
  NaN, which the callers' finiteness guards reject.  Shapes outside the
  kernels' envelopes go to ``torch.linalg`` by ``ops/jacobi.py``'s written
  rule, counted in ``kernels.STATS[...].outside``.
* ``qr_econ``, ``lu_factor`` / ``lu_solve`` (the host engine's LAPACK LU
  for the Schur systems, ``solvers/fused_host.py:99-111``), ``chol_solve``
  (two triangular solves with a lower Cholesky factor) and ``qr_factor`` /
  ``qr_apply`` / ``qr_solve`` (the ragged Schur systems'
  square solve, ``ttipm_tpu/ops/linalg.py:23-37``): ``torch.linalg`` on
  every device (cuSOLVER / cuBLAS on the card); the fused sweeps' split QRs
  and L_Z Cholesky call K3 and K4 directly.

Every function takes leading batch dimensions as ``torch.linalg`` does (the
lockstep batched solve of ``parallel/fused_mesh.py`` factors a stack of B
instances in one call); on a single matrix it computes what it did before.

Float32 operands: the SVD, the QR and the symmetric eigensolver run in
f64 on the upcast operands and return their factors rounded to f32
(``config.in_f64``), so f32 factorizations on the card take the f64
Jacobi kernels.  The JAX package's host engine calls numpy's f32
LAPACK; torch's f32 factorizations are noisier (MKL on the CPU: a rank-4
64 x 64 matrix keeps a tail of 3e-6 against numpy's 1e-7), the TT
roundings at the f32 eps floor 1e-7 keep that noise as rank, and with
cuSOLVER's f32 factors maxcut d8 seed 24 in the f32 profile stops at
slackness 0.44 where the upcast solve converges
(``tools/f32_repairs.py``, whose native variants pass f32 to
``torch.linalg``: only float64 operands take the Jacobi pipelines).
(torch's f32 SVD keeps u orthonormal at zero singular values, so the JAX
package's Gram split is not needed: tests/test_torch_f32.py.)
"""

from __future__ import annotations

import numpy as np
import torch

from ttipm_tpu_torch.config import in_f64
from ttipm_tpu_torch.ops import jacobi

__all__ = [
    "safe_svd", "fast_split_svd", "svd_econ", "safe_eigh", "safe_eigvalsh", "lu_factor",
    "lu_solve",
    "chol_solve", "qr_econ", "qr_factor", "qr_apply", "qr_solve",
]


@in_f64
def safe_svd(a: torch.Tensor):
    """Economy SVD.  LAPACK's gesdd can fail to converge where gesvd does
    not; the host engine retries with gesvd, and so does this."""
    if jacobi.use_jacobi(a):
        return jacobi.jacobi_svd(a)
    try:
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
    except torch.linalg.LinAlgError:
        if a.is_cuda:
            return torch.linalg.svd(a, full_matrices=False, driver="gesvd")
        import scipy.linalg as sla

        mats = a.numpy().reshape(-1, *a.shape[-2:])
        parts = [sla.svd(m, full_matrices=False, lapack_driver="gesvd") for m in mats]
        return tuple(torch.from_numpy(np.ascontiguousarray(np.stack(t).reshape(
            *a.shape[:-2], *t[0].shape))) for t in zip(*parts))
    return u, s, vt


fast_split_svd = safe_svd


@in_f64
def svd_econ(a: torch.Tensor):
    """Economy SVD without the gesvd retry (the caller handles failure: a
    LinAlgError from LAPACK, NaN factors from the Jacobi pipeline)."""
    if jacobi.use_jacobi(a):
        return jacobi.jacobi_svd(a)
    return torch.linalg.svd(a, full_matrices=False)


@in_f64
def safe_eigh(a: torch.Tensor):
    if jacobi.use_jacobi(a):
        return jacobi.jacobi_eigh(a)
    return torch.linalg.eigh(a)


@in_f64
def safe_eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of a symmetric matrix, ascending (on the Jacobi route
    J2 without its eigenvectors: the bits of ``safe_eigh``'s)."""
    if jacobi.use_jacobi(a):
        return jacobi.jacobi_eigh(a, vectors=False)[0]
    return torch.linalg.eigvalsh(a)


@in_f64
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


def qr_factor(a: torch.Tensor):
    """Householder QR of a square matrix, kept for several right-hand
    sides."""
    return torch.linalg.qr(a, mode="reduced")


def qr_apply(qr, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given ``qr = qr_factor(A)``."""
    q, r = qr
    if b.dim() == 1:
        return torch.linalg.solve_triangular(r, (q.T @ b)[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(r, q.mT @ b, upper=True)


def qr_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return qr_apply(qr_factor(a), b)
