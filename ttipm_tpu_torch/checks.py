"""Acceptance checks shared by ``chip_smoke.py`` and the tests.

``kernel_errors`` holds one kernel call's output against the kernel's
plain PyTorch version on the same operands, in float64, and
``check_kernel`` raises where it is outside these tolerances:

- ``schur_assemble`` (K1) and ``kkt_block_matvec`` (K2): relative
  Frobenius error <= 1e-12.  On random operands (``cancelling=False``) the
  error is taken relative to the plain result.  The solver's own operands
  can cancel: a block matvec of norm 1e-14 built from terms of norm 1 has
  an f64 rounding error of ~1e-16 in any summation order, cuBLAS's
  included.  With ``cancelling=True`` the error is therefore taken
  relative to the same contraction of the operands' absolute values, the
  scale of the rounding error bound of a sum of products;
- ``panel_qr`` (K3): ||QR - A|| / ||A|| <= 1e-13, ||Q^T Q - I||_max <= 1e-13
  and R exactly zero below the diagonal (Q is not unique for a
  rank-deficient panel, so the factors themselves are compared with the
  plain ones only for the record);
- ``panel_cholesky`` (K4): the same ``info`` as ``torch.linalg.cholesky_ex``
  and, on success, ||L L^T - A|| / ||A|| <= 1e-13.

These are a few hundred ulps of f64 at the solver's sizes; the kernels sum
in another order than cuBLAS / cuSOLVER.  ``solve_metrics`` gives the
slackness and feasibility errors by which a MaxCut solve counts as
converged.
"""

from __future__ import annotations

import torch

from ttipm_tpu_torch.ops import kernels as K
from ttipm_tpu_torch.ops import tt as T
from ttipm_tpu_torch.ops.products import tt_fast_matrix_vec_mul
from ttipm_tpu_torch.ops.rounding import tt_rank_reduce

__all__ = ["TOLERANCE", "PLAIN", "kernel_errors", "check_kernel", "solve_metrics"]

TOLERANCE = {"schur_assemble": 1e-12, "kkt_block_matvec": 1e-12,
             "panel_qr": 1e-13, "panel_cholesky": 1e-13}

PLAIN = {"schur_assemble": K.schur_assemble_plain,
         "kkt_block_matvec": K.kkt_block_matvec_plain,
         "panel_qr": K.panel_qr_plain,
         "panel_cholesky": K.panel_cholesky_plain}


def _rel(diff: torch.Tensor, ref: torch.Tensor) -> float:
    num, den = float(torch.linalg.norm(diff)), float(torch.linalg.norm(ref))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def _max_abs(t: torch.Tensor) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def kernel_errors(name: str, args, out, cancelling: bool = False) -> dict:
    """Errors of ``out = kernels.<name>(*args)`` against the plain version
    on ``args``, with ``"ok"`` false where one exceeds its tolerance.
    Calls the plain function directly, so no wrapper counter moves."""
    tol = TOLERANCE[name]
    want = PLAIN[name](*args)
    if name in ("schur_assemble", "kkt_block_matvec"):
        diff = out - want
        errs = {"max_abs_err": _max_abs(diff), "rel": _rel(diff, want),
                "rel_terms": _rel(diff, PLAIN[name](*(a.abs() for a in args)))}
        ok = errs["rel_terms" if cancelling else "rel"] <= tol
    elif name == "panel_qr":
        (a,), (q, r), (q0, r0) = args, out, want
        eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
        d, d0 = torch.sign(torch.diagonal(r)), torch.sign(torch.diagonal(r0))
        errs = {
            "max_abs_err": max(_max_abs(q * d - q0 * d0),
                               _max_abs(d[:, None] * r - d0[:, None] * r0)),
            "fact": _rel(q @ r - a, a),
            "orth": _max_abs(q.T @ q - eye),
            "below_diagonal": _max_abs(torch.tril(r, -1)),
        }
        ok = errs["fact"] <= tol and errs["orth"] <= tol and errs["below_diagonal"] == 0.0
    elif name == "panel_cholesky":
        (a,), (L, info), (L0, info0) = args, out, want
        sym = torch.tril(a) + torch.tril(a, -1).T
        errs = {"info": int(info), "cholesky_ex_info": int(info0)}
        ok = errs["info"] == errs["cholesky_ex_info"]
        if ok and errs["info"] == 0:
            errs["max_abs_err"] = _max_abs(L - L0)
            errs["fact"] = _rel(L @ L.T - sym, sym)
            ok = errs["fact"] <= tol
    else:
        raise KeyError(name)
    errs["ok"] = bool(ok)
    return errs


def check_kernel(name: str, args, out, cancelling: bool = False) -> dict:
    """``kernel_errors``, raising AssertionError outside the tolerance."""
    errs = kernel_errors(name, args, out, cancelling)
    if not errs["ok"]:
        shapes = [tuple(t.shape) for t in args]
        raise AssertionError(f"{name} {shapes}: outside tolerance {TOLERANCE[name]:g}: {errs}")
    return errs


def solve_metrics(X, Y, Z, obj_tt, L_tt, bias_tt):
    """Slackness |<X,Z>| and the squared primal / dual feasibility errors
    ||L vec(X) - b||^2 and ||L^T y - vec(Z + C)||^2 of a solve."""
    slack = abs(T.tt_inner_prod(X, Z))
    pr = tt_rank_reduce(T.tt_sub(tt_fast_matrix_vec_mul(L_tt, T.tt_reshape(X, (4,))),
                                 bias_tt), eps=1e-12)
    dr = tt_rank_reduce(
        T.tt_sub(
            tt_fast_matrix_vec_mul(T.tt_transpose(L_tt), T.tt_reshape(Y, (4,)), eps=1e-12),
            tt_rank_reduce(T.tt_add(T.tt_reshape(Z, (4,)), obj_tt), eps=1e-12),
        ),
        eps=1e-12,
    )
    return slack, T.tt_inner_prod(pr, pr), T.tt_inner_prod(dr, dr)
