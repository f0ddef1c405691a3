"""The fused fixed-rank AMEn sweep, for a batch of B structurally
identical KKT systems in lockstep; a single solve is a batch of one.

The local solve, the block products, the interfaces and the split steps
of ``solvers/fused.py``'s solver (counterparts of the JAX package's
``fused_algebra.py`` and the host engine's local solve), with a leading
axis of B instances on every operand.  ``ttipm_tpu/parallel/fused_mesh.py``
gets the batch from ``jax.vmap`` of the single-instance sweep program and
runs none of its Pallas kernels there; here every kernel call takes all
instances at once (``kernels.*_batch``: one launch of K1, K2, K3 for the
batch, K4 one launch up to order 512).  A batch of one calls the single
entries (``kernels.kkt_block_product``, ``schur_assemble_group``,
``panel_qr``, ``panel_cholesky``, and ``kkt_block_matvec`` for one term),
the same kernels at B = 1 and bit-equal to the batched entries there.

Per instance the semantics are the host engine's (LU for the Schur
systems, a failed Cholesky poisons that instance's candidate with NaN,
the never-regress and magnitude-sanity guards), evaluated instance by
instance through (B,) masks, so no instance's values depend on another's.
Every reduction of an instance runs over its own axes in the order of a
single instance's, so a batch of one gives the bits of the single-instance
algebra this module replaced (held core step by core step on the H100, see
PERF.md).  The host reads the (B,) residuals once per sweep.

Operands (B = batch): operator cores (B, s, m, n, S), rhs cores
(B, r, 4, R), solution and z cores (B, r, 4, R) or, at the block core,
(B, r, bs, 4, R); interfaces (B, l, s, r) and (B, l, r).
"""

from __future__ import annotations

import functools

import torch

from ttipm_tpu_torch import config, trace
from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.linalg import chol_solve, fast_split_svd, lu_factor, lu_solve
from ttipm_tpu_torch.solvers.fused_algebra import keys, nrows

__all__ = ["sweep", "sweep_dev", "boundary_phis", "batch_of_one"]

TINY = 1e-300


def batch_of_one(tree):
    """The tensors of a nested dict / list / tuple with a leading batch axis
    of one (views)."""
    if isinstance(tree, dict):
        return {k: batch_of_one(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(batch_of_one(v) for v in tree)
    return tree.unsqueeze(0)


def _col(mask, like):
    """A (B,) mask or value broadcast against ``like`` (B, ...)."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _norm(t):
    """Frobenius norm of each instance: (B,)."""
    return _each(lambda x: torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1), t)


# ---------------------------------------------------------------------------
# Algebra (fused_algebra.py with a batch axis)
# ---------------------------------------------------------------------------

def _flip(phi):
    return phi.permute(0, 3, 2, 1)


def _t(a):
    return a.transpose(2, 3)


def _k2(terms, rows):
    """K2 for a batch of block-product terms: (B, l, rows, m, L)."""
    if terms[0][3].shape[0] == 1:
        return kernels.kkt_block_product(
            [tuple(t[0] for t in term[:4]) + (term[4],) for term in terms], rows).unsqueeze(0)
    return kernels.kkt_block_product_batch(terms, rows)


def _k1(blocks, mesh=None):
    """K1 for a batch of blocks: a list of (B, M, N) blocks; with a
    ``mesh`` of kkt > 1, this rank's slice of the operator bond summed
    over its kkt row (``Mesh.partial_schur``)."""
    if mesh is not None:
        return mesh.partial_schur(blocks, _k1)
    if blocks[0][0].shape[0] == 1:
        return [g.unsqueeze(0) for g in
                kernels.schur_assemble_group([tuple(t[0] for t in b) for b in blocks])]
    return list(kernels.schur_assemble_batch(blocks).unbind(0))


def _k3(a, transposed=False):
    if a.shape[0] == 1:
        q, r = kernels.panel_qr(a[0], transposed=transposed)
        return q.unsqueeze(0), r.unsqueeze(0)
    return kernels.panel_qr_batch(a, transposed=transposed)


def _k4(a):
    if a.shape[0] == 1:
        L, info = kernels.panel_cholesky(a[0])
        return L.unsqueeze(0), info.reshape(1)
    return kernels.panel_cholesky_batch(a)


def apply(p_l, a, p_r, v):
    """y[l,m,L] = p_l[l,s,r] a[s,m,n,S] p_r[L,S,R] v[r,n,R], per instance."""
    if v.shape[0] == 1:
        return kernels.kkt_block_matvec(p_l[0], a[0], p_r[0], v[0]).unsqueeze(0)
    return kernels.kkt_block_product_batch([(p_l, a, p_r, v, 0)], 1)[:, :, 0]


def apply_T(p_l, a, p_r, v):
    return apply(_flip(p_l), _t(a), _flip(p_r), v)


def _block_product(x, t, ineq):
    terms = [(*t["00"], x[:, :, 0], 0), (*t["01"], x[:, :, 1], 0), (*t["10"], x[:, :, 0], 1),
             (*t["12"], x[:, :, 2], 1), (*t["21"], x[:, :, 1], 2), (*t["22"], x[:, :, 2], 2)]
    if ineq:
        terms += [(*t["12"], x[:, :, 3], 1), (*t["31"], x[:, :, 1], 3),
                  (*t["33"], x[:, :, 3], 3)]
    return _k2(terms, nrows(ineq))


def _terms(pl, A, pr, ineq):
    return {k: (pl[k], A[k], pr[k]) for k in keys(ineq)}


def local_product(pl, A, pr, x, ineq=False):
    t = _terms(pl, A, pr, ineq)
    t["10"] = (_flip(pl["01"]), _t(A["01"]), _flip(pr["01"]))
    return _block_product(x, t, ineq)


def z_product(zl, A, zr, x, ineq=False):
    t = _terms(zl, A, zr, ineq)
    t["10"] = (zl["10"], _t(A["01"]), zr["10"])
    return _block_product(x, t, ineq)


def mixed_product(ml, mr, A, x, transpose_right_phi: bool, ineq=False):
    t = _terms(ml, A, mr, ineq)
    if transpose_right_phi:
        t["10"] = (_flip(ml["01"]), _t(A["01"]), mr["10"])
    else:
        t["10"] = (ml["10"], _t(A["01"]), _flip(mr["01"]))
    return _block_product(x, t, ineq)


def project_rhs(bl, b, br, ineq=False):
    return torch.stack(
        [torch.einsum("zbr,zbmB,zBR->zrmR", bl[i], b[i], br[i]) for i in range(nrows(ineq))],
        dim=2)


def den_clamp(den):
    """``fused_algebra.den_clamp`` with the floor of each instance."""
    rel = 1e-6 if den.dtype == torch.float32 else 1e-14
    floor = rel * den.abs().amax(dim=(1, 2, 3), keepdim=True)
    sign = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
    return sign * torch.maximum(den.abs(), floor)


def tikhonov(S):
    """``fused_algebra.tikhonov`` per instance of S (B, m, m)."""
    if S.dtype == torch.float64:
        lam = 1e-11
    else:
        lam = 1e-6 * S.abs().amax(dim=(1, 2), keepdim=True) + 1e-11
    return S + lam * torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)


def column_scales(core):
    """``fused_algebra.column_scales`` per instance of a block core
    (B, r, bs, n, R): (B, 1, bs, 1, 1)."""
    norms = torch.sqrt(_each(lambda x: torch.sum(x**2, dim=(1, 3, 4)), core))
    rel = 1e-5 if core.dtype == torch.float32 else 1e-12
    floor = torch.clamp_min(rel * norms.amax(dim=1, keepdim=True), 1e-10)
    return torch.maximum(norms, floor).reshape(core.shape[0], 1, -1, 1, 1)


def unit_fro(core):
    nrm = torch.sqrt(_each(lambda x: torch.sum(x * x, dim=tuple(range(1, x.dim()))), core))
    return core / _col(torch.clamp_min(nrm, TINY), core)


def phi_bck_A(phi_next, cl, a, cr):
    return torch.einsum("zLSR,zlML,zsMNS,zrNR->zlsr", phi_next, cl, a, cr)


def phi_fwd_A(phi_prev, cl, a, cr):
    return torch.einsum("zlsr,zlML,zsMNS,zrNR->zLSR", phi_prev, cl, a, cr)


def phi_bck_rhs(phi_next, cb, c):
    return torch.einsum("zBR,zbnB,zrnR->zbr", phi_next, cb, c)


def phi_fwd_rhs(phi_prev, cb, c):
    return torch.einsum("zbr,zbnB,zrnR->zBR", phi_prev, cb, c)


def phis_bck(A, b, x_core, z_core, pr, br, zr, zbr, ineq=False):
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


def svd(mat):
    """Economy SVD of each instance of ``mat`` (B, m, n); an instance that
    is not finite is factored as zeros and comes out as NaN (its candidate
    is then rejected or its solve stopped; no other instance is touched)."""
    finite = torch.isfinite(mat).reshape(mat.shape[0], -1).all(dim=1)
    safe = torch.where(_col(finite, mat), mat, torch.zeros_like(mat))
    u, s, vt = fast_split_svd(safe)
    nan = float("nan")
    return (torch.where(_col(finite, u), u, nan), torch.where(_col(finite, s), s, nan),
            torch.where(_col(finite, vt), vt, nan))


def trunc_svd(mat, k):
    u, s, vt = svd(mat)
    return u[:, :, :k], s[:, :k, None] * vt[:, :k]


# ---------------------------------------------------------------------------
# Sweep steps (fused_algebra.py's, per instance of the batch)
# ---------------------------------------------------------------------------

def bck_split_step(solve_local, pl, A, pr, bl, b, br, zl, zr, zbl, zbr,
                   x_k, x_km1, z_k, z_km1, r_out, kick, solve, ineq=False):
    B, rl, bs, n, rr = x_k.shape
    rz = z_k.shape[1]
    rz1 = z_k.shape[-1]
    r_out = min(r_out, n * rr, rl * bs)
    if solve:
        sol, res_old, _, dx = solve_local(pl, A, pr, bl, b, br, x_k)
    else:
        sol = x_k
        res_old = dx = x_k.new_zeros(B)

    with trace.span("kkt.split"):
        scales = column_scales(sol)
        mat = (scales * sol).reshape(B, rl * bs, n * rr).mT
        u, s, vt = svd(mat)
        v = s[:, :, None] * vt

        width = min(r_out + kick, n * rr, rl * bs) if solve else r_out
        if solve and width > r_out:
            sol_trunc = (u[:, :, :r_out] @ v[:, :r_out]).mT.reshape(B, rl, bs, n, rr)
            Axz = mixed_product(zl, pr, A, sol_trunc, transpose_right_phi=False, ineq=ineq)
            rhsxz = project_rhs(zbl, b, br, ineq)
            resxz = (rhsxz - Axz).reshape(B, rz * bs, n * rr).mT
            uz, _ = trunc_svd(resxz, width - r_out)
            u_aug = torch.cat([u[:, :, :r_out], uz], dim=2)
            qt, Rf = _k3(u_aug, transposed=True)
            u_core = qt.reshape(B, width, n, rr)
            v_new = (Rf[:, :, :r_out] @ v[:, :r_out]).mT.reshape(B, rl, bs, width)
        else:
            u_core = u[:, :, :width].mT.reshape(B, width, n, rr)
            v_new = v[:, :width].mT.reshape(B, rl, bs, width)

        x_km1_new = torch.einsum("zrdc,zcbR->zrbdR", x_km1, v_new) / scales

        if solve:
            Az = z_product(zl, A, zr, sol, ineq)
            rhsz = project_rhs(zbl, b, zbr, ineq)
            resz = (rhsz - Az).reshape(B, rz * bs, n * rz1).mT
        else:
            resz = z_k.reshape(B, rz * bs, n * rz1).mT
        uzz, vzz = trunc_svd(resz, kick)
        z_core = uzz.mT.reshape(B, uzz.shape[2], n, rz1)
        vz_new = vzz.mT.reshape(B, rz, bs, vzz.shape[1])
        z_km1_new = unit_fro(torch.einsum("zrdc,zcbR->zrbdR", z_km1, vz_new) / scales)

        pl_new, bl_new, zl_new, zbl_new = phis_bck(A, b, u_core, z_core, pr, br, zr, zbr, ineq)
        return (u_core, x_km1_new, z_core, z_km1_new, pl_new, bl_new,
                zl_new, zbl_new, res_old, dx)


def write_step(solve_local, pl, A, pr, bl, b, br, zl, zr, zbl, zbr, x_k, z_k,
               solve, ineq=False):
    if not solve:
        zero = x_k.new_zeros(x_k.shape[0])
        return x_k, z_k, zero, zero
    sol, res_old, _, dx = solve_local(pl, A, pr, bl, b, br, x_k)
    Az = z_product(zl, A, zr, sol, ineq)
    rhsz = project_rhs(zbl, b, zbr, ineq)
    z_new = unit_fro((rhsz - Az) / column_scales(sol))
    return sol, z_new, res_old, dx


def fwd_split_step(solve_local, pl, A, pr, bl, b, br, zl, zr, zbl, zbr,
                   x_k, x_kp1, z_k, z_kp1, r_out, kick, solve, ineq=False):
    B, rl, bs, n, rr = x_k.shape
    rz = z_k.shape[1]
    rz1 = z_k.shape[-1]
    r_out = min(r_out, rl * n, bs * rr)
    if solve:
        sol, res_old, _, dx = solve_local(pl, A, pr, bl, b, br, x_k)
    else:
        sol = x_k
        res_old = dx = x_k.new_zeros(B)

    with trace.span("kkt.split"):
        scales = column_scales(sol)
        mat = (scales * sol).permute(0, 1, 3, 2, 4).reshape(B, rl * n, bs * rr)
        u, s, vt = svd(mat)
        v = s[:, :, None] * vt
        u3 = u.reshape(B, rl, n, -1)

        width = min(r_out + kick, rl * n, bs * rr) if solve else r_out
        if solve and width > r_out:
            sol_trunc = torch.einsum("zrbR,zRdK->zrdbK", u3[..., :r_out],
                                     v[:, :r_out].reshape(B, r_out, bs, rr))
            Axz = mixed_product(pl, zr, A, sol_trunc, transpose_right_phi=True, ineq=ineq)
            rhsxz = project_rhs(bl, b, zbr, ineq)
            resxz = (rhsxz - Axz).permute(0, 1, 3, 2, 4).reshape(B, rl * n, bs * rz1)
            uz, _ = trunc_svd(resxz, width - r_out)
            u_aug = torch.cat([u3.reshape(B, rl * n, -1)[:, :, :r_out], uz], dim=2)
            q, Rf = _k3(u_aug)
            u_core = q.reshape(B, rl, n, width)
            v_new = torch.einsum("zrR,zRdK->zrdK", Rf[:, :, :r_out],
                                 v[:, :r_out].reshape(B, r_out, bs, rr))
        else:
            u_core = u3[..., :width]
            v_new = v[:, :width].reshape(B, width, bs, rr)

        x_kp1_new = torch.einsum("zrbR,zRdK->zrbdK", v_new, x_kp1) / scales

        if solve:
            Az = z_product(zl, A, zr, sol, ineq)
            rhsz = project_rhs(zbl, b, zbr, ineq)
            resz = (rhsz - Az).permute(0, 1, 3, 2, 4).reshape(B, rz * n, bs * rz1)
        else:
            resz = z_k.permute(0, 1, 3, 2, 4).reshape(B, rz * n, bs * rz1)
        uzz, vzz = trunc_svd(resz, kick)
        z_core = uzz.reshape(B, rz, n, uzz.shape[2])
        vz_new = vzz.reshape(B, vzz.shape[1], bs, rz1)
        z_kp1_new = unit_fro(torch.einsum("zrbR,zRdK->zrbdK", vz_new, z_kp1) / scales)

        pr_new, br_new, zr_new, zbr_new = phis_fwd(A, b, u_core, z_core, pl, bl, zl, zbl, ineq)
        return (u_core, x_kp1_new, z_core, z_kp1_new, pr_new, br_new,
                zr_new, zbr_new, res_old, dx)


# ---------------------------------------------------------------------------
# Local solve (fused.py's, per instance)
# ---------------------------------------------------------------------------

def _cholesky(S):
    """Lower Cholesky factors of S (B, m, m); an instance whose
    factorization fails gets a NaN factor, so that its candidate is
    rejected and its previous core kept (the host engine raises and keeps
    ``prev``: ``fused_host.py:89-96``)."""
    L, info = _k4(S)
    return torch.where(_col(info == 0, L), L, torch.full_like(L, float("nan")))


def _each(fn, *args):
    """``fn`` on each instance of its (B, ...) arguments as a batch of one
    (the single solve's call), the results concatenated.  cuBLAS's batched
    triangular solve, LU and matrix-vector product, and ATen's reductions
    over an instance's thousands of entries, compute an instance in another
    order at another batch size (H100), so the batch takes these an
    instance at a time: an instance then gets the same bits in any batch,
    a seeds mesh's shard included."""
    if args[0].shape[0] == 1:
        return fn(*args)
    outs = [fn(*(a[i:i + 1] for a in args)) for i in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _lu(a):
    return _each(lu_factor, a)


def _lu_solve(fac, b):
    return _each(lambda lu, piv, x: lu_solve((lu, piv), x), *fac, b)


def _chol_solve(L, b):
    return _each(chol_solve, L, b)


def _mv(M, v):
    """M @ v for a (B, m, 1) right-hand side."""
    return _each(torch.matmul, M, v)


def _dense_factor(pl, A, pr, inv_I, ineq=False, mesh=None):
    """The factors of the Schur-elimination local solve, everything that
    depends only on the operator: L_Z by K4, the Y Schur system (and with
    ``ineq`` the T block D) by LU, the projected blocks from one K1 call
    (split over the operator bond across ``mesh``'s kkt row, if given)."""
    B = inv_I.shape[0]
    if not ineq:
        B21, mL_eq, B22, B00 = _k1([(pl[k], A[k], pr[k]) for k in ("21", "01", "22", "00")],
                                   mesh)
        L_L_Z = _cholesky(tikhonov(B21))
        L_X_I_inv = B22 * inv_I.reshape(B, 1, -1)
        S = _chol_solve(L_L_Z, L_X_I_inv)
        S = mL_eq @ (S @ mL_eq.mT)
        S = tikhonov(S + B00)
        return L_L_Z, mL_eq, L_X_I_inv, _lu(S)

    B21, mL_eq, B22, T_op, B00, B33 = _k1(
        [(pl[k], A[k], pr[k]) for k in ("21", "01", "22", "31", "00", "33")], mesh)
    L_L_Z = _cholesky(tikhonov(B21))
    Lz_inv_Lx = _chol_solve(L_L_Z, B22)
    Lz_inv_Lx_scaled = Lz_inv_Lx * inv_I.reshape(B, 1, -1)
    S = B00 + mL_eq @ (Lz_inv_Lx_scaled @ mL_eq.mT)
    D = tikhonov(B33 + T_op @ Lz_inv_Lx)
    TY = (T_op @ Lz_inv_Lx_scaled) @ mL_eq.mT
    YT = mL_eq @ Lz_inv_Lx
    d_lu = _lu(D)
    lhs_y = tikhonov(S - YT @ _lu_solve(d_lu, TY))
    return L_L_Z, mL_eq, Lz_inv_Lx_scaled, T_op, TY, YT, d_lu, _lu(lhs_y)


def _dense_apply(fac, pl, A, pr, inv_I, rhs, ineq=False):
    """Back substitution: the factors of ``_dense_factor`` applied to one
    projected right-hand side per instance."""
    B, r, _, n, R = rhs.shape
    m = r * n * R
    mR_p = rhs[:, :, 0].reshape(B, m, 1)
    mR_d = rhs[:, :, 1].reshape(B, m, 1)
    mR_c = rhs[:, :, 2].reshape(B, m, 1)
    if not ineq:
        L_L_Z, mL_eq, L_X_I_inv, s_lu = fac
        b_vec = mR_p - _mv(mL_eq, _chol_solve(L_L_Z, mR_c - _mv(L_X_I_inv, mR_d)))
        y3 = _lu_solve(s_lu, b_vec).reshape(B, r, n, R)
        z = inv_I * (rhs[:, :, 1] - apply_T(pl["01"], A["01"], pr["01"], y3))
        x = _chol_solve(L_L_Z, mR_c - apply(pl["22"], A["22"], pr["22"], z).reshape(B, m, 1))
        return torch.stack([y3, x.reshape(B, r, n, R), z], dim=2)

    L_L_Z, mL_eq, Lz_inv_Lx_scaled, T_op, TY, YT, d_lu, y_lu = fac
    mR_t = rhs[:, :, 3].reshape(B, m, 1)
    Lz_inv_Rc = _chol_solve(L_L_Z, mR_c)
    u = mR_p - _mv(mL_eq, Lz_inv_Rc - _mv(Lz_inv_Lx_scaled, mR_d))
    v = mR_t - _mv(T_op, Lz_inv_Rc - _mv(Lz_inv_Lx_scaled, mR_d))
    y = _lu_solve(y_lu, u - _mv(YT, _lu_solve(d_lu, v)))
    t3 = _lu_solve(d_lu, v - _mv(TY, y)).reshape(B, r, n, R)
    y3 = y.reshape(B, r, n, R)
    z3 = inv_I * (rhs[:, :, 1] - apply_T(pl["01"], A["01"], pr["01"], y3)) - t3
    x = _chol_solve(L_L_Z, mR_c - apply(pl["22"], A["22"], pr["22"], z3).reshape(B, m, 1))
    return torch.stack([y3, x.reshape(B, r, n, R), z3, t3], dim=2)


def _inv_identity(pl, A, pr):
    """1 / the clamped diagonal of the projected identity block."""
    return 1.0 / den_clamp(torch.einsum("zlsr,zsmnS,zLSR->zlmL", pl["12"], A["12"], pr["12"]))


def solve_local(pl, A, pr, bl, b, br, prev, ineq=False, mesh=None):
    """Local KKT solve of each instance with the never-regress guard: the
    candidate replaces the instance's ``prev`` only if it is finite, does
    not raise the instance's local residual and is not of absurd magnitude.
    Returns (sol, res_old, res_min, dx), the last three (B,) on the device
    (no host sync).  f32 operands take the mixed mode of
    ``config.mixed_local()`` (``fused_host.py:177-254``): the residuals of
    the guard in f64, the factorization in f64 ("f64") or in f32
    ("refine", then two corrections from f64 residuals; "off").  ``mesh``:
    the K1 blocks of the factorization split over its kkt row."""
    with trace.span("kkt.local_solve"):
        mode = config.mixed_local() if prev.dtype == torch.float32 else "off"
        if mode != "off":
            pl_h, A_h, pr_h, prev_h, bl_h, b_h, br_h = config.cast_tree(
                (pl, A, pr, prev, bl, b, br), torch.float64)
            rhs_h = project_rhs(bl_h, b_h, br_h, ineq)
            inv_I_h = _inv_identity(pl_h, A_h, pr_h)
            inv_I, rhs = inv_I_h.to(prev.dtype), rhs_h.to(prev.dtype)
        else:
            pl_h, A_h, pr_h, prev_h = pl, A, pr, prev
            rhs_h = rhs = project_rhs(bl, b, br, ineq)
            inv_I_h = inv_I = _inv_identity(pl, A, pr)
        norm_rhs = torch.clamp_min(_norm(rhs_h), 1e-10)
        res_old = _norm(local_product(pl_h, A_h, pr_h, prev_h, ineq) - rhs_h) / norm_rhs
        if mode == "f64":
            fac = _dense_factor(pl_h, A_h, pr_h, inv_I_h, ineq, mesh)
            cand = _dense_apply(fac, pl_h, A_h, pr_h, inv_I_h, rhs_h, ineq).to(prev.dtype)
        else:
            fac = _dense_factor(pl, A, pr, inv_I, ineq, mesh)
            cand = _dense_apply(fac, pl, A, pr, inv_I, rhs, ineq)
        if mode == "refine":
            for _ in range(2):
                r_h = rhs_h - local_product(pl_h, A_h, pr_h, cand.double(), ineq)
                cand = cand + _dense_apply(fac, pl, A, pr, inv_I, r_h.to(prev.dtype), ineq)
        finite = torch.isfinite(cand).reshape(cand.shape[0], -1).all(dim=1)
        cand = torch.where(_col(finite, cand), cand, prev)
        res_new = _norm(local_product(pl_h, A_h, pr_h, cand.to(rhs_h.dtype), ineq)
                        - rhs_h) / norm_rhs
        sane = _norm(cand) < 1e8 * (1.0 + _norm(prev))
        good = finite & torch.isfinite(res_new) & (res_new <= res_old) & sane
        sol = torch.where(_col(good, cand), cand, prev)
        res_min = torch.where(good, res_new, res_old)
        dx = _norm(sol - prev) / torch.clamp_min(_norm(sol), TINY)
        return sol, res_old, res_min, dx


# ---------------------------------------------------------------------------
# Sweep driver
# ---------------------------------------------------------------------------

def boundary_phis(ref, nb: int, ineq: bool):
    """Unit interfaces at both ends of the trains, for ``nb`` instances."""
    ones3 = ref.new_ones((nb, 1, 1, 1))
    ones2 = ref.new_ones((nb, 1, 1))
    pA = {k: ones3 for k in keys(ineq)}
    pz = {k: ones3 for k in keys(ineq) + ("10",)}
    pb = [ones2] * nrows(ineq)
    return pA, pz, pb


def sweep(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps, kick: int, solve: bool,
          direction: int, ineq: bool = False, mesh=None):
    """One full sweep of every instance; updates the lists in place and
    returns the per-instance maxima of (res_old, dx) over the cores as two
    numpy arrays, read from the device in one transfer.  ``mesh``: the
    local factorizations' K1 blocks split over its kkt row."""
    trace.count("kkt.sweeps")
    with trace.span("kkt.sweep"):
        res, dx = sweep_dev(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps, kick, solve,
                            direction, ineq, mesh)
        both = torch.stack([res, dx]).double().cpu().numpy()
    return both[0], both[1]


def sweep_dev(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps, kick: int, solve: bool,
              direction: int, ineq: bool = False, mesh=None):
    """``sweep`` with the per-instance maxima of (res_old, dx) left on the
    device: two (B,) tensors, no host read (the whole-solve program's
    sweeps, which a CUDA graph captures)."""
    d = len(x_cores)
    solve_local_b = functools.partial(solve_local, ineq=ineq, mesh=mesh)
    res_vals, dx_vals = [], []
    order = range(d - 1, -1, -1) if direction > 0 else range(d)
    for k in order:
        A_k = {key: A[key][k] for key in keys(ineq)}
        b_k = [b[i][k] for i in range(nrows(ineq))]
        args = (XAX[k], A_k, XAX[k + 1], Xb[k], b_k, Xb[k + 1],
                ZAX[k], ZAX[k + 1], Zb[k], Zb[k + 1])
        if direction > 0 and k > 0:
            (x_cores[k], x_cores[k - 1], z_cores[k], z_cores[k - 1],
             XAX[k], Xb[k], ZAX[k], Zb[k], r_old, dx) = bck_split_step(
                solve_local_b, *args, x_cores[k], x_cores[k - 1],
                z_cores[k], z_cores[k - 1], caps[k - 1], kick, solve, ineq)
        elif direction < 0 and k < d - 1:
            (x_cores[k], x_cores[k + 1], z_cores[k], z_cores[k + 1],
             XAX[k + 1], Xb[k + 1], ZAX[k + 1], Zb[k + 1], r_old, dx) = fwd_split_step(
                solve_local_b, *args, x_cores[k], x_cores[k + 1],
                z_cores[k], z_cores[k + 1], caps[k], kick, solve, ineq)
        else:
            x_cores[k], z_cores[k], r_old, dx = write_step(
                solve_local_b, *args, x_cores[k], z_cores[k], solve, ineq)
        res_vals.append(r_old)
        dx_vals.append(dx)
    return torch.stack(res_vals).amax(dim=0), torch.stack(dx_vals).amax(dim=0)
