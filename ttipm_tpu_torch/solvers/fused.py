"""Fused fixed-rank block-AMEn solver for the IPM's KKT systems, equality
path.

One AMEn solve runs at a fixed bond rank R (capped near the boundaries by
the dimension product); each per-core step solves the local KKT system by
Schur elimination, re-splits the bond by SVD with residual ("AMEn")
enrichment folded into the fixed basis, and updates the Petrov-Galerkin
interfaces.  Rank adaptivity lives in the restart ladder (R grows per
restart) and in residual-equation refinement of accepted solutions.

Counterpart of ``ttipm_tpu/solvers/fused.py`` with the semantics of the
JAX package's numpy host engine (``fused_host.py``), which is what runs
in its default CPU profile: ragged operator ranks (no padding), LU for
the Schur system, a failed Cholesky keeps the previous core, and the
never-regress and magnitude-sanity guards.  The port has one engine; its
device is the device of the tensors.  The guards are evaluated on the
device, and the host reads the residuals once per sweep.

Local KKT block elimination (reference src/tt_ipm.py:196-223): dZ is
eliminated elementwise through the projected identity diagonal, Lz is
Cholesky-factored (K4, ``panel_cholesky``), and the Y Schur system is
LU-solved.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.linalg import chol_solve, lu_factor, lu_solve
from ttipm_tpu_torch.solvers import fused_algebra as fa
from ttipm_tpu_torch.solvers.amen import (
    AmenRestartsExhausted,
    AmenToleranceReached,
    ladder_rank_cap,
)

__all__ = ["tt_block_amen_fused", "tt_restarted_block_amen_fused",
           "fused_residual_norm", "prep_operator", "prep_rhs"]

TINY = 1e-300
_KEY_MAP = {"00": (0, 0), "01": (0, 1), "12": (1, 2), "21": (2, 1), "22": (2, 2)}


# ---------------------------------------------------------------------------
# Local solve
# ---------------------------------------------------------------------------

def _cholesky(S):
    """Lower Cholesky factor; a failed factorization poisons the factor
    with NaN so that the candidate is rejected and the previous core kept
    (the host engine raises and keeps ``prev``: ``fused_host.py:89-96``)."""
    L, info = kernels.panel_cholesky(S)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _dense_factor(pl, A, pr, inv_I):
    L_L_Z = _cholesky(fa.tikhonov(fa.proj(pl["21"], A["21"], pr["21"])))
    mL_eq = fa.proj(pl["01"], A["01"], pr["01"])
    L_X_I_inv = fa.proj(pl["22"], A["22"], pr["22"]) * inv_I.reshape(1, -1)
    S = chol_solve(L_L_Z, L_X_I_inv)
    S = mL_eq @ (S @ mL_eq.T)
    S = fa.tikhonov(S + fa.proj(pl["00"], A["00"], pr["00"]))
    return L_L_Z, mL_eq, L_X_I_inv, lu_factor(S)


def _dense_apply(fac, pl, A, pr, inv_I, rhs):
    r, _, n, R = rhs.shape
    m = r * n * R
    mR_p = rhs[:, 0].reshape(m, 1)
    mR_d = rhs[:, 1].reshape(m, 1)
    mR_c = rhs[:, 2].reshape(m, 1)
    L_L_Z, mL_eq, L_X_I_inv, s_lu = fac
    b_vec = mR_p - mL_eq @ chol_solve(L_L_Z, mR_c - L_X_I_inv @ mR_d)
    y3 = lu_solve(s_lu, b_vec).reshape(r, n, R)
    z = inv_I * (rhs[:, 1] - fa.apply_T(pl["01"], A["01"], pr["01"], y3))
    x = chol_solve(L_L_Z, mR_c - fa.apply(pl["22"], A["22"], pr["22"], z).reshape(m, 1))
    return torch.stack([y3, x.reshape(r, n, R), z], dim=1)


def _solve_local(pl, A, pr, bl, b, br, prev):
    """Local KKT solve with the never-regress guard: the candidate replaces
    ``prev`` only if it is finite, does not raise the local residual and is
    not of absurd magnitude.  Returns (sol, rhs, res_old, res_min, dx) with
    the scalars as 0-d device tensors (no host sync)."""
    rhs = fa.project_rhs(bl, b, br)
    inv_I = 1.0 / fa.den_clamp(
        torch.einsum("lsr,smnS,LSR->lmL", pl["12"], A["12"], pr["12"]))
    norm_rhs = torch.clamp_min(torch.linalg.norm(rhs), 1e-10)
    res_old = torch.linalg.norm(fa.local_product(pl, A, pr, prev) - rhs) / norm_rhs
    fac = _dense_factor(pl, A, pr, inv_I)
    cand = _dense_apply(fac, pl, A, pr, inv_I, rhs)
    finite = torch.isfinite(cand).all()
    # a non-finite candidate is where the host engine's numpy raises
    cand = torch.where(finite, cand, prev)
    res_new = torch.linalg.norm(fa.local_product(pl, A, pr, cand) - rhs) / norm_rhs
    sane = torch.linalg.norm(cand) < 1e8 * (1.0 + torch.linalg.norm(prev))
    good = finite & torch.isfinite(res_new) & (res_new <= res_old) & sane
    sol = torch.where(good, cand, prev)
    res_min = torch.where(good, res_new, res_old)
    dx = torch.linalg.norm(sol - prev) / torch.clamp_min(torch.linalg.norm(sol), TINY)
    return sol, rhs, res_old, res_min, dx


# ---------------------------------------------------------------------------
# Sweep driver
# ---------------------------------------------------------------------------

def _sweep(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps, kick: int,
           solve: bool, direction: int):
    """One full sweep; updates the passed lists in place and returns the
    maxima of (res_old, dx) over the cores as host floats."""
    d = len(x_cores)
    res_vals = []
    dx_vals = []
    if direction > 0:  # backward
        order = range(d - 1, -1, -1)
    else:
        order = range(d)
    for k in order:
        A_k = {key: A[key][k] for key in fa.KEYS}
        b_k = [b[i][k] for i in range(fa.NROWS)]
        args = (XAX[k], A_k, XAX[k + 1], Xb[k], b_k, Xb[k + 1],
                ZAX[k], ZAX[k + 1], Zb[k], Zb[k + 1])
        if direction > 0 and k > 0:
            (x_cores[k], x_cores[k - 1], z_cores[k], z_cores[k - 1],
             XAX[k], Xb[k], ZAX[k], Zb[k], r_old, _, dx) = fa.bck_split_step(
                _solve_local, *args, x_cores[k], x_cores[k - 1],
                z_cores[k], z_cores[k - 1], caps[k - 1], kick, solve)
        elif direction < 0 and k < d - 1:
            (x_cores[k], x_cores[k + 1], z_cores[k], z_cores[k + 1],
             XAX[k + 1], Xb[k + 1], ZAX[k + 1], Zb[k + 1], r_old, _, dx) = (
                fa.fwd_split_step(
                    _solve_local, *args, x_cores[k], x_cores[k + 1],
                    z_cores[k], z_cores[k + 1], caps[k], kick, solve))
        else:
            x_cores[k], z_cores[k], r_old, _, dx = fa.write_step(
                _solve_local, *args, x_cores[k], z_cores[k], solve)
        res_vals.append(r_old)
        dx_vals.append(dx)
    res, dxm = torch.stack([torch.stack(res_vals).max(),
                            torch.stack(dx_vals).max()]).tolist()
    return res, dxm


# ---------------------------------------------------------------------------
# Global residual ||b - Ax|| by direct multi-train contraction:
# ||b-Ax||^2 = sum_i [ <b_i,b_i> - 2 sum_t <b_i, t> + sum_{t,t'} <t,t'> ]
# over the row terms t = A_ij x_j (no TT arithmetic, no rounding).
# ---------------------------------------------------------------------------

def _train_dot(tr1, tr2):
    rho = tr1[0].new_ones((1, 1))
    for c1, c2 in zip(tr1, tr2):
        rho = torch.einsum("ab,amA,bmB->AB", rho, c1, c2)
    return rho[0, 0]


def fused_residual_norm(A, b, x_cores) -> float:
    block_pos = int(np.argmax([c.ndim for c in x_cores]))
    x_shared = [c for i, c in enumerate(x_cores) if i != block_pos]
    x_cols = []
    for j in range(fa.NROWS):
        cores = list(x_shared)
        cores.insert(block_pos, x_cores[block_pos][:, j])
        x_cols.append(cores)
    res_sq = x_cores[0].new_zeros(())
    for i, terms in enumerate(fa.ROW_TERMS):
        acc = _train_dot(b[i], b[i])
        vts = [fa.virtual_term_cores(A, x_cols, key, col, tr) for (key, col, tr) in terms]
        for t in vts:
            acc = acc - 2.0 * _train_dot(b[i], t)
        for p, t1 in enumerate(vts):
            acc = acc + _train_dot(t1, t1)
            for t2 in vts[p + 1:]:
                acc = acc + 2.0 * _train_dot(t1, t2)
        res_sq = res_sq + acc
    return float(np.sqrt(max(float(res_sq), 0.0)))


# ---------------------------------------------------------------------------
# Preparation
# ---------------------------------------------------------------------------

def _bucket4(r: int) -> int:
    return ((int(r) + 3) // 4) * 4


def prep_operator(block_A) -> Dict[str, List[torch.Tensor]]:
    """Canonical operator keys; the ranks stay ragged."""
    return {sk: list(block_A[_KEY_MAP[sk]]) for sk in fa.KEYS}


def prep_rhs(block_b, d: int, ref: torch.Tensor) -> List[List[torch.Tensor]]:
    """Rows as a dense list; absent rows become rank-1 zero trains."""
    rows = []
    for i in range(fa.NROWS):
        row = block_b.get_row(i)
        if row is None:
            row = [ref.new_zeros((1, 4, 1)) for _ in range(d)]
        rows.append(list(row))
    return rows


def _bond_caps(d: int, R: int, bs: int, direction: int) -> List[int]:
    """Static bond ranks: R capped by the dimension products on each side;
    the block axis (size bs) sits on the side the sweep merges into."""
    if direction > 0:
        return [min(R, bs * 4 ** (k + 1), 4 ** (d - 1 - k)) for k in range(d - 1)]
    return [min(R, 4 ** (k + 1), bs * 4 ** (d - 1 - k)) for k in range(d - 1)]


def _svd_retract(cores, caps):
    """RL-orthogonalise, then truncate (or zero-pad) each bond to its cap."""
    d = len(cores)
    out = list(cores)
    for i in range(d - 1, 0, -1):
        sh = out[i].shape
        q, r = torch.linalg.qr(out[i].reshape(sh[0], -1).T)
        out[i] = q.T.reshape(-1, *sh[1:])
        prev = out[i - 1]
        out[i - 1] = (prev.reshape(-1, sh[0]) @ r.T).reshape(*prev.shape[:-1], -1)
    for k in range(d - 1):
        sh = out[k].shape
        u, s, vt = torch.linalg.svd(out[k].reshape(-1, sh[-1]), full_matrices=False)
        r = min(caps[k], s.shape[0])
        u_k = u[:, :r]
        nxt = out[k + 1]
        folded = (s[:r, None] * vt[:r]) @ nxt.reshape(nxt.shape[0], -1)
        if r < caps[k]:
            u_k = torch.cat([u_k, u_k.new_zeros((u_k.shape[0], caps[k] - r))], dim=1)
            folded = torch.cat([folded, folded.new_zeros((caps[k] - r, folded.shape[1]))])
        out[k] = u_k.reshape(*sh[:-1], caps[k])
        out[k + 1] = folded.reshape(caps[k], *nxt.shape[1:])
    return out


def _x0_direction(x0, d: int, bs: int) -> int:
    """+1 when the warm start's block axis sits on core d-1 (next sweep
    backward), -1 on core 0 (next sweep forward), 0 = unusable layout."""
    if x0 is None:
        return 0
    idxs = [i for i, c in enumerate(x0) if c.ndim == 4 and c.shape[1] == bs]
    if len(idxs) != 1:
        return 0
    if idxs[0] == 0:
        return -1
    if idxs[0] == d - 1:
        return 1
    return 0


def _to_dev(arrays, ref):
    return [torch.as_tensor(a, dtype=ref.dtype, device=ref.device) for a in arrays]


def _prep_x0(x0, d, bs, caps, direction, rng, ref):
    """Warm start (or a fresh Gaussian from ``rng``) at exact cap ranks with
    the block axis on core 0 (direction -1) or core d-1 (direction +1)."""
    if x0 is not None and _x0_direction(x0, d, bs) == direction:
        if all(bool(torch.isfinite(c).all()) for c in x0):
            try:
                return _svd_retract(list(x0), caps)
            except torch.linalg.LinAlgError:
                pass  # pathological warm start -> fresh Gaussian below
    if direction > 0:
        head = [rng.randn(1, 4, caps[0])] + [
            rng.randn(caps[k - 1], 4, caps[k]) for k in range(1, d - 1)]
        cores = head + [rng.randn(caps[-1] if d > 1 else 1, bs, 4, 1)]
    else:
        tail = [rng.randn(caps[k - 1], 4, caps[k]) for k in range(1, d - 1)] + [
            rng.randn(caps[-1] if d > 1 else 1, 4, 1)]
        cores = [rng.randn(1, bs, 4, caps[0] if d > 1 else 1)] + tail
    nrm = np.sqrt(sum(float(np.sum(c**2)) for c in cores))
    cores = [c / max(nrm, TINY) ** (1.0 / d) for c in cores]
    return _to_dev(cores, ref)


def _prep_z0(d, bs, kick, block_pos, rng, ref):
    cores = []
    for k in range(d):
        rl = 1 if k == 0 else kick
        rr = 1 if k == d - 1 else kick
        if k == block_pos:
            cores.append(rng.randn(rl, bs, 4, rr) / (4 * bs * kick**2))
        else:
            cores.append(rng.randn(rl, 4, rr) / (4 * kick**2))
    return _to_dev(cores, ref)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def tt_block_amen_fused(block_A, block_b, term_tol: float, R: int,
                        eps: float = 1e-12, nswp: int = 22, x0=None,
                        kick_rank: int = 2, verbose: bool = False, rng=None,
                        prepped=None):
    """Fixed-rank fused block-AMEn solve of the IPM KKT system; returns
    (x_cores, final_local_res).  ``rng``: numpy RandomState for the random
    starts (default numpy's global one)."""
    rng = np.random if rng is None else rng
    bs = fa.NROWS
    first_row = next(iter(block_b.values()))
    d = len(first_row)
    ref = first_row[0]
    if prepped is not None:
        A, b = prepped
    else:
        A = prep_operator(block_A)
        b = prep_rhs(block_b, d, ref)
    caps_bck = _bond_caps(d, R, bs, +1)
    caps_fwd = _bond_caps(d, R, bs, -1)
    direction = _x0_direction(x0, d, bs) or 1
    # the warm start is laid out as if the opposite sweep just finished
    x_cores = _prep_x0(x0, d, bs, caps_fwd if direction > 0 else caps_bck,
                       direction, rng, ref)
    block_pos = 0 if direction < 0 else d - 1
    z_cores = _prep_z0(d, bs, kick_rank, block_pos, rng, ref)

    ones3 = ref.new_ones((1, 1, 1))
    ones2 = ref.new_ones((1, 1))
    pA0 = {k: ones3 for k in fa.KEYS}
    pz0 = {k: ones3 for k in fa.ZKEYS}
    pb0 = [ones2] * fa.NROWS
    XAX: List = [pA0] + [None] * (d - 1) + [dict(pA0)]
    Xb: List = [pb0] + [None] * (d - 1) + [list(pb0)]
    ZAX: List = [pz0] + [None] * (d - 1) + [dict(pz0)]
    Zb: List = [pb0] + [None] * (d - 1) + [list(pb0)]

    last = False
    final_res = np.inf
    for swp in range(nswp + 1):
        solve = (swp > 0) and not last
        caps = caps_bck if direction > 0 else caps_fwd
        res_d, dx_d = _sweep(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps,
                             kick_rank, solve, direction)
        if last:
            break
        local_res, local_dx = (res_d, dx_d) if solve else (np.inf, np.inf)
        if local_res < term_tol or local_dx < eps or swp == nswp - 2:
            last = True
            final_res = local_res
        if verbose:
            print(f"\t[fused R={R}] sweep {swp}: res {local_res:.3e} "
                  f"dx {local_dx:.3e}", flush=True)
        direction *= -1
    return list(x_cores), final_res


def tt_restarted_block_amen_fused(block_A, block_b, rank_restriction: int,
                                  op_tol: float, termination_tol: float = 1e-3,
                                  eps: float = 1e-11, num_restarts: int = 3,
                                  inner_m: int = 10, x0=None,
                                  verbose: bool = False,
                                  refine_target: Optional[float] = None,
                                  rng=None):
    """Restart ladder: the solve rank escalates per restart until a solve
    is accepted (strict: relative residual below ``termination_tol``;
    lenient: a tenfold reduction, taken once escalation stops paying).
    ``refine_target`` (absolute residual) enables residual-equation
    refinement of the accepted solution: solve ``A e = b - A x`` at the
    same rank and add ``e`` back while that clearly helps."""
    rng = np.random if rng is None else rng
    first_row = next(iter(block_b.values()))
    d = len(first_row)
    ref = first_row[0]
    bs = fa.NROWS
    A = prep_operator(block_A)
    b = prep_rhs(block_b, d, ref)

    rhs_norm0 = block_b.norm
    if rhs_norm0 < 0.5 * op_tol:
        raise AmenToleranceReached(
            f"absolute tolerance already reached: {rhs_norm0:4f} < {op_tol:4f}")

    r_cap = ladder_rank_cap(rank_restriction, d)
    if x0 is not None:
        warm_r = max((int(c.shape[-1]) for c in x0[:-1]), default=4)
        R = min(max(4, _bucket4(warm_r)), r_cap)
    else:
        R = min(8, r_cap)

    def accepted(rn):
        return rn < termination_tol * rhs_norm0 or rn < 0.1 * rhs_norm0

    def refined(x_cores, res):
        """Residual-equation refinement rounds on an accepted solution."""
        if refine_target is None:
            return x_cores, res
        from ttipm_tpu_torch.solvers.blocks import tt_block_train_add

        rn = fused_residual_norm(A, b, x_cores)
        if not np.isfinite(rn) or rn <= refine_target:
            return x_cores, min(res, rn / max(rhs_norm0, 1e-300))
        prod_cache: dict = {}  # ALS warm starts across refine rounds
        prod_tol = max(0.01 * refine_target, float(eps))
        r_blk = block_b - block_A.block_product(x_cores, prod_tol,
                                                cache=prod_cache, rng=rng)
        rn = r_blk.norm
        for _ in range(2):
            if not np.isfinite(rn) or rn <= refine_target:
                break
            try:
                e_cores, _ = tt_block_amen_fused(
                    block_A, r_blk, termination_tol, R, eps=eps, nswp=inner_m,
                    kick_rank=2, verbose=False, rng=rng,
                    prepped=(A, prep_rhs(r_blk, d, ref)),
                )
                x_new = tt_block_train_add(x_cores, e_cores, bs, eps)
            except (torch.linalg.LinAlgError, FloatingPointError):
                break
            r_new = block_b - block_A.block_product(x_new, prod_tol,
                                                    cache=prod_cache, rng=rng)
            rn_new = r_new.norm
            # keep only clear improvements
            if not np.isfinite(rn_new) or rn_new >= 0.5 * rn:
                break
            if verbose:
                print(f"\t[fused refine] res {rn:.3e} -> {rn_new:.3e}", flush=True)
            x_cores, rn, r_blk = x_new, rn_new, r_new
        return x_cores, min(res, rn / max(rhs_norm0, 1e-300))

    x_cores, res = tt_block_amen_fused(
        block_A, block_b, termination_tol, R, eps=eps, nswp=inner_m, x0=x0,
        kick_rank=2, verbose=verbose, rng=rng, prepped=(A, b))
    if res < termination_tol:
        return refined(x_cores, res)
    rn = fused_residual_norm(A, b, x_cores)
    if rn < termination_tol * rhs_norm0:
        return refined(x_cores, res)
    best = (rn, x_cores, res) if (np.isfinite(rn) and accepted(rn)) else None

    for _ in range(1, num_restarts):
        R_next = min(max(R + 4, 2 * R), r_cap)
        if (rn > 0.9 * rhs_norm0 and R >= 16) or R_next <= R:
            break
        R = R_next
        x_new, res_new = tt_block_amen_fused(
            block_A, block_b, termination_tol, R, eps=eps, nswp=inner_m,
            x0=x_cores, kick_rank=4, verbose=verbose, rng=rng, prepped=(A, b))
        rn_new = fused_residual_norm(A, b, x_new)
        if rn_new < termination_tol * rhs_norm0:
            return refined(x_new, res_new)
        if np.isfinite(rn_new) and accepted(rn_new) and (best is None or rn_new < best[0]):
            best = (rn_new, x_new, res_new)
        if np.isfinite(rn_new) and rn_new < rn:
            x_cores, res = x_new, res_new
            progress = rn_new < 0.9 * rn
            rn = rn_new
        else:
            progress = False
        if not progress and best is not None:
            break

    if best is not None:
        return refined(best[1], best[2])
    raise AmenRestartsExhausted(
        f"restart budget exhausted, relative error {rn / rhs_norm0:.3e}; "
        "consider raising the rank ceiling")
