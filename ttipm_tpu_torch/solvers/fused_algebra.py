"""Block algebra and per-core sweep steps of the fused fixed-rank AMEn.

Counterpart of ``ttipm_tpu/solvers/fused_algebra.py``, written directly
over torch instead of closed over a numpy/jnp backend.  The hot
contractions go through the hand-written kernels (``ops/kernels.py``):
the block products (``local_product``, ``z_product``, ``mixed_product``)
through one K2 launch each (``kkt_block_product``) and ``apply`` /
``apply_T`` through its one-term case (``kkt_block_matvec``), the dense
projected blocks of the local solves through K1 (``schur_assemble_group``),
and the enrichment panel QR of the split steps through K3 (``panel_qr``).

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
from ttipm_tpu_torch.ops.linalg import fast_split_svd

EQ_KEYS = ("00", "01", "12", "21", "22")
INEQ_KEYS = EQ_KEYS + ("31", "33")
TINY = 1e-300


def keys(ineq: bool):
    """The stored block keys."""
    return INEQ_KEYS if ineq else EQ_KEYS


def zkeys(ineq: bool):
    """The keys of the z-side interfaces: the stored ones and "10"."""
    return keys(ineq) + ("10",)


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


def _block_product(x, t, ineq):
    """The rows of a KKT block product from one launch: ``t`` maps each key
    (and "10", the transpose image of (0,1)) to its ``(p_l, a, p_r)``.  The
    terms of a row are summed in the JAX package's order."""
    terms = [(*t["00"], x[:, 0], 0), (*t["01"], x[:, 1], 0), (*t["10"], x[:, 0], 1),
             (*t["12"], x[:, 2], 1), (*t["21"], x[:, 1], 2), (*t["22"], x[:, 2], 2)]
    if ineq:
        # the (1,3) alias of the identity block, then the dT row
        terms += [(*t["12"], x[:, 3], 1), (*t["31"], x[:, 1], 3), (*t["33"], x[:, 3], 3)]
    return kernels.kkt_block_product(terms, nrows(ineq))


def _terms(pl, A, pr, ineq):
    """(p_l, a, p_r) of the stored blocks."""
    return {k: (pl[k], A[k], pr[k]) for k in keys(ineq)}


def local_product(pl, A, pr, x, ineq=False):
    """K @ x in the projected basis; x: (rl, nrows, n, rr)."""
    t = _terms(pl, A, pr, ineq)
    # the (1,0) block is the transpose of (0,1): apply_T's operands
    t["10"] = (_flip(pl["01"]), _t(A["01"]), _flip(pr["01"]))
    return _block_product(x, t, ineq)


def z_product(zl, A, zr, x, ineq=False):
    """K @ x projected with z-bases on the left and the right."""
    t = _terms(zl, A, zr, ineq)
    # "lsr,snmS,LSR,rnR->lmL": the (1,0) block with its own z interfaces
    t["10"] = (zl["10"], _t(A["01"]), zr["10"])
    return _block_product(x, t, ineq)


def mixed_product(ml, mr, A, x, transpose_right_phi: bool, ineq=False):
    """K @ x with a z basis on one side and the x basis on the other,
    including the reversed outer indices on the transpose row."""
    t = _terms(ml, A, mr, ineq)
    if transpose_right_phi:
        # "rsl,snmS,LSR,rnR->lmL"
        t["10"] = (_flip(ml["01"]), _t(A["01"]), mr["10"])
    else:
        # "lsr,snmS,RSL,rnR->lmL"
        t["10"] = (ml["10"], _t(A["01"]), _flip(mr["01"]))
    return _block_product(x, t, ineq)


def project_rhs(bl, b, br, ineq=False):
    return torch.stack(
        [torch.einsum("br,bmB,BR->rmR", bl[i], b[i], br[i]) for i in range(nrows(ineq))],
        dim=1,
    )


def den_clamp(den):
    """Sign-preserving floor for the projected-identity diagonal that the
    dZ elimination divides by: relative 1e-14 in f64, 1e-6 in f32 (a dead
    basis direction makes den cross 0 at f32 noise level)."""
    rel = 1e-6 if den.dtype == torch.float32 else 1e-14
    floor = rel * den.abs().max()
    sign = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
    return sign * torch.maximum(den.abs(), floor)


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


def unit_fro(core):
    """Unit-Frobenius z cores: the enrichment train is a direction basis."""
    return core / torch.clamp_min(torch.sqrt(torch.sum(core * core)), TINY)


def phi_bck_A(phi_next, cl, a, cr):
    return torch.einsum("LSR,lML,sMNS,rNR->lsr", phi_next, cl, a, cr)


def phi_fwd_A(phi_prev, cl, a, cr):
    return torch.einsum("lsr,lML,sMNS,rNR->LSR", phi_prev, cl, a, cr)


def phi_bck_rhs(phi_next, cb, c):
    return torch.einsum("BR,bnB,rnR->br", phi_next, cb, c)


def phi_fwd_rhs(phi_prev, cb, c):
    return torch.einsum("br,bnB,rnR->BR", phi_prev, cb, c)


def phis_bck(A, b, x_core, z_core, pr, br, zr, zbr, ineq=False):
    """All right-to-left interface updates after core k is re-split."""
    pl_new = {k: phi_bck_A(pr[k], x_core, A[k], x_core) for k in keys(ineq)}
    bl_new = [phi_bck_rhs(br[i], b[i], x_core) for i in range(nrows(ineq))]
    zl_new = {k: phi_bck_A(zr[k], z_core, A[k], x_core) for k in keys(ineq)}
    zl_new["10"] = phi_bck_A(zr["10"], z_core, _t(A["01"]), x_core)
    zbl_new = [phi_bck_rhs(zbr[i], b[i], z_core) for i in range(nrows(ineq))]
    return pl_new, bl_new, zl_new, zbl_new


def phis_fwd(A, b, x_core, z_core, pl, bl, zl, zbl, ineq=False):
    pr_new = {k: phi_fwd_A(pl[k], x_core, A[k], x_core) for k in keys(ineq)}
    br_new = [phi_fwd_rhs(bl[i], b[i], x_core) for i in range(nrows(ineq))]
    zr_new = {k: phi_fwd_A(zl[k], z_core, A[k], x_core) for k in keys(ineq)}
    zr_new["10"] = phi_fwd_A(zl["10"], z_core, _t(A["01"]), x_core)
    zbr_new = [phi_fwd_rhs(zbl[i], b[i], z_core) for i in range(nrows(ineq))]
    return pr_new, br_new, zr_new, zbr_new


def virtual_term_cores(A, x_cols, key, col, transpose):
    """Cores of the vector train A_key @ x_col, bond = (rA*rx)."""
    out = []
    for a_c, x_c in zip(A[key], x_cols[col]):
        eq = "snmS,xnX->sxmSX" if transpose else "smnS,xnX->sxmSX"
        v = torch.einsum(eq, a_c, x_c)
        s, x, m, S, X = v.shape
        out.append(v.reshape(s * x, m, S * X))
    return out


# ---------------------------------------------------------------------------
# Per-core sweep steps.  ``solve_local`` is the engine's local KKT solver
# for the steps' system (``ineq`` or not): (pl, A, pr, bl, b, br, prev) ->
# (sol, rhs, res_old, res_min, dx), the last three as 0-d tensors on the
# solve's device.
# ---------------------------------------------------------------------------

def trunc_svd(mat, k):
    u, s, vt = fast_split_svd(mat)
    return u[:, :k], s[:k, None] * vt[:k]


def _zero(ref):
    return ref.new_zeros(())


def bck_split_step(solve_local, pl, A, pr, bl, b, br, zl, zr, zbl, zbr,
                   x_k, x_km1, z_k, z_km1, r_out, kick, solve, ineq=False):
    """Backward-sweep step at core k>0: (solve), re-split the bond to rank
    ``r_out`` plus ``kick`` projected-residual enrichment directions, merge
    the non-orthogonal factor left, update all backward interfaces."""
    rl, bs, n, rr = x_k.shape
    rz = z_k.shape[0]
    rz1 = z_k.shape[-1]
    r_out = min(r_out, n * rr, rl * bs)
    if solve:
        sol, rhs, res_old, res_min, dx = solve_local(pl, A, pr, bl, b, br, x_k)
    else:
        sol = x_k
        res_old = res_min = dx = _zero(x_k)

    scales = column_scales(sol)
    mat = (scales * sol).reshape(rl * bs, n * rr).T
    u, s, vt = fast_split_svd(mat)
    v = s[:, None] * vt

    width = min(r_out + kick, n * rr, rl * bs) if solve else r_out
    if solve and width > r_out:
        sol_trunc = (u[:, :r_out] @ v[:r_out]).T.reshape(rl, bs, n, rr)
        Axz = mixed_product(zl, pr, A, sol_trunc, transpose_right_phi=False, ineq=ineq)
        rhsxz = project_rhs(zbl, b, br, ineq)
        resxz = (rhsxz - Axz).reshape(rz * bs, n * rr).T
        uz, _ = trunc_svd(resxz, width - r_out)
        u_aug = torch.cat([u[:, :r_out], uz], dim=1)
        qt, Rf = kernels.panel_qr(u_aug, transposed=True)
        u_core = qt.reshape(width, n, rr)
        v_new = (Rf[:, :r_out] @ v[:r_out]).T.reshape(rl, bs, width)
    else:
        u_core = u[:, :width].T.reshape(width, n, rr)
        v_new = v[:width].T.reshape(rl, bs, width)

    x_km1_new = torch.einsum("rdc,cbR->rbdR", x_km1, v_new) / scales

    # z-train update from the (z,z)-projected residual; on no-solve sweeps
    # the raw z core is re-split instead.
    if solve:
        Az = z_product(zl, A, zr, sol, ineq)
        rhsz = project_rhs(zbl, b, zbr, ineq)
        resz = (rhsz - Az).reshape(rz * bs, n * rz1).T
    else:
        resz = z_k.reshape(rz * bs, n * rz1).T
    uzz, vzz = trunc_svd(resz, kick)
    z_core = uzz.T.reshape(uzz.shape[1], n, rz1)
    vz_new = vzz.T.reshape(rz, bs, vzz.shape[0])
    z_km1_new = unit_fro(torch.einsum("rdc,cbR->rbdR", z_km1, vz_new) / scales)

    pl_new, bl_new, zl_new, zbl_new = phis_bck(A, b, u_core, z_core, pr, br, zr, zbr, ineq)
    return (u_core, x_km1_new, z_core, z_km1_new, pl_new, bl_new,
            zl_new, zbl_new, res_old, res_min, dx)


def write_step(solve_local, pl, A, pr, bl, b, br, zl, zr, zbl, zbr, x_k, z_k,
               solve, ineq=False):
    """Step at the sweep's last core: (solve and) write, no split.  The
    same for both sweep directions."""
    if not solve:
        zero = _zero(x_k)
        return x_k, z_k, zero, zero, zero
    sol, rhs, res_old, res_min, dx = solve_local(pl, A, pr, bl, b, br, x_k)
    Az = z_product(zl, A, zr, sol, ineq)
    rhsz = project_rhs(zbl, b, zbr, ineq)
    z_new = unit_fro((rhsz - Az) / column_scales(sol))
    return sol, z_new, res_old, res_min, dx


def fwd_split_step(solve_local, pl, A, pr, bl, b, br, zl, zr, zbl, zbr,
                   x_k, x_kp1, z_k, z_kp1, r_out, kick, solve, ineq=False):
    """Forward-sweep step at core k<d-1."""
    rl, bs, n, rr = x_k.shape
    rz = z_k.shape[0]
    rz1 = z_k.shape[-1]
    r_out = min(r_out, rl * n, bs * rr)
    if solve:
        sol, rhs, res_old, res_min, dx = solve_local(pl, A, pr, bl, b, br, x_k)
    else:
        sol = x_k
        res_old = res_min = dx = _zero(x_k)

    scales = column_scales(sol)
    mat = (scales * sol).permute(0, 2, 1, 3).reshape(rl * n, bs * rr)
    u, s, vt = fast_split_svd(mat)
    v = s[:, None] * vt
    u3 = u.reshape(rl, n, -1)

    width = min(r_out + kick, rl * n, bs * rr) if solve else r_out
    if solve and width > r_out:
        sol_trunc = torch.einsum("rbR,RdK->rdbK", u3[:, :, :r_out],
                                 v[:r_out].reshape(r_out, bs, rr))
        Axz = mixed_product(pl, zr, A, sol_trunc, transpose_right_phi=True, ineq=ineq)
        rhsxz = project_rhs(bl, b, zbr, ineq)
        resxz = (rhsxz - Axz).permute(0, 2, 1, 3).reshape(rl * n, bs * rz1)
        uz, _ = trunc_svd(resxz, width - r_out)
        u_aug = torch.cat([u3.reshape(rl * n, -1)[:, :r_out], uz], dim=1)
        q, Rf = kernels.panel_qr(u_aug)
        u_core = q.reshape(rl, n, width)
        v_new = torch.einsum("rR,RdK->rdK", Rf[:, :r_out],
                             v[:r_out].reshape(r_out, bs, rr))
    else:
        u_core = u3[:, :, :width]
        v_new = v[:width].reshape(width, bs, rr)

    x_kp1_new = torch.einsum("rbR,RdK->rbdK", v_new, x_kp1) / scales

    if solve:
        Az = z_product(zl, A, zr, sol, ineq)
        rhsz = project_rhs(zbl, b, zbr, ineq)
        resz = (rhsz - Az).permute(0, 2, 1, 3).reshape(rz * n, bs * rz1)
    else:
        resz = z_k.permute(0, 2, 1, 3).reshape(rz * n, bs * rz1)
    uzz, vzz = trunc_svd(resz, kick)
    z_core = uzz.reshape(rz, n, uzz.shape[1])
    vz_new = vzz.reshape(vzz.shape[0], bs, rz1)
    z_kp1_new = unit_fro(torch.einsum("rbR,RdK->rbdK", vz_new, z_kp1) / scales)

    pr_new, br_new, zr_new, zbr_new = phis_fwd(A, b, u_core, z_core, pl, bl, zl, zbl, ineq)
    return (u_core, x_kp1_new, z_core, z_kp1_new, pr_new, br_new,
            zr_new, zbr_new, res_old, res_min, dx)
