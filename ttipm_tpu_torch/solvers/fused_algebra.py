"""Single-instance block algebra shared by the KKT and eigen solvers.

Counterpart of parts of ``ttipm_tpu/solvers/fused_algebra.py``, written
directly over torch: the KKT block layout (``keys``, ``nrows``,
``row_terms``), the one-term block matvec through K2 (``apply`` /
``apply_T``, ``kernels.kkt_block_matvec``) and the Tikhonov term of the
ragged local solver, the column scales and interface updates of the ragged
AMEn and the eigensolvers, and the residual trains of ``fused.py``'s
residual expansion.  The fused solve's local solves, block products and
split steps carry a batch axis and live in ``fused_batch.py``.

KKT block layout: variables [dY, dX, dZ] and, with inequality constraints
(``ineq``), dT; stored blocks (0,0), (0,1) (transpose-aliased to (1,0)),
(1,2) = I (aliased to (1,3) with inequalities), (2,1) = Lz, (2,2) = Lx and,
with inequalities, (3,1) = Diag(T), (3,3) = lag_t + Diag(masked X), keyed
as strings "00", "01", "12", "21", "22", "31", "33".  The z-side interfaces
additionally carry "10", the transpose image of (0,1).  A block product has
six terms on three rows, or nine on four with inequalities.
"""

from __future__ import annotations

import torch

from ttipm_tpu_torch.ops import kernels

EQ_KEYS = ("00", "01", "12", "21", "22")
INEQ_KEYS = EQ_KEYS + ("31", "33")


def keys(ineq: bool):
    """The stored block keys."""
    return INEQ_KEYS if ineq else EQ_KEYS


def nrows(ineq: bool) -> int:
    return 4 if ineq else 3


# Residual-expansion term tables: row i of K x is the sum of A_key x_col
# (transposed where flagged).
ROW_TERMS_EQ = (
    (("00", 0, False), ("01", 1, False)),
    (("01", 0, True), ("12", 2, False)),
    (("21", 1, False), ("22", 2, False)),
)
ROW_TERMS_INEQ = (
    (("00", 0, False), ("01", 1, False)),
    (("01", 0, True), ("12", 2, False), ("12", 3, False)),
    (("21", 1, False), ("22", 2, False)),
    (("31", 1, False), ("33", 3, False)),
)


def row_terms(ineq: bool):
    return ROW_TERMS_INEQ if ineq else ROW_TERMS_EQ


def _flip(phi: torch.Tensor) -> torch.Tensor:
    """Swap the outer (basis) indices of an interface tensor (l,s,r)."""
    return phi.permute(2, 1, 0)


def _t(a: torch.Tensor) -> torch.Tensor:
    """Swap the physical axes of an operator core (s,m,n,S)."""
    return a.transpose(1, 2)


def apply(p_l, a, p_r, v):
    """y[l,m,L] = p_l[l,s,r] a[s,m,n,S] p_r[L,S,R] v[r,n,R]."""
    return kernels.kkt_block_matvec(p_l, a, p_r, v)


def apply_T(p_l, a, p_r, v):
    """y[r,n,R] = p_l[l,s,r] a[s,m,n,S] p_r[L,S,R] v[l,m,L]."""
    return kernels.kkt_block_matvec(_flip(p_l), _t(a), _flip(p_r), v)


def tikhonov(S):
    """Tikhonov term of the (near-singular) Schur systems.  f64: the
    reference's absolute 1e-11 * I.  f32: 1e-6 max|S| + 1e-11, above the
    data noise eps32 |S|, or a basis-null direction gives a ~1e23 candidate
    that the never-regress guard accepts."""
    if S.dtype == torch.float64:
        lam = 1e-11
    else:
        lam = 1e-6 * S.abs().max() + 1e-11
    return S + lam * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)


def column_scales(core):
    """Per-block-column equilibration norms with a relative floor: 1e-12
    in f64, 1e-5 in f32 (the absolute 1e-10 alone amplifies dead f32
    columns)."""
    norms = torch.sqrt(torch.sum(core**2, dim=(0, 2, 3)))
    rel = 1e-5 if core.dtype == torch.float32 else 1e-12
    floor = torch.clamp_min(rel * norms.max(), 1e-10)
    return torch.maximum(norms, floor).reshape(1, -1, 1, 1)


def phi_bck_A(phi_next, cl, a, cr):
    return torch.einsum("LSR,lML,sMNS,rNR->lsr", phi_next, cl, a, cr)


def phi_fwd_A(phi_prev, cl, a, cr):
    return torch.einsum("lsr,lML,sMNS,rNR->LSR", phi_prev, cl, a, cr)


def phi_bck_rhs(phi_next, cb, c):
    return torch.einsum("BR,bnB,rnR->br", phi_next, cb, c)


def phi_fwd_rhs(phi_prev, cb, c):
    return torch.einsum("br,bnB,rnR->BR", phi_prev, cb, c)


def virtual_term_cores(A, x_cols, key, col, transpose):
    """Cores of the vector train A_key @ x_col, bond = (rA*rx)."""
    out = []
    for a_c, x_c in zip(A[key], x_cols[col]):
        eq = "snmS,xnX->sxmSX" if transpose else "smnS,xnX->sxmSX"
        v = torch.einsum(eq, a_c, x_c)
        s, x, m, S, X = v.shape
        out.append(v.reshape(s * x, m, S * X))
    return out
