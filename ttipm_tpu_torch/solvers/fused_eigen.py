"""Fused fixed-rank TT eigensolvers for the IPM step sizes.

``tt_max_generalised_eigen_fused`` finds the largest ``alpha`` with
``A + alpha * Delta`` PSD by a fixed-rank MALS sweep over 2-core windows:
each window assembles the dense pencil, takes its smallest eigenpair,
shrinks alpha when the shifted pencil goes indefinite, re-splits the
window at the fixed rank and updates the interfaces.  ``tt_min_eig_fused``
is the same sweep for the smallest eigenvector of one symmetric operator
(the inequality step sizes, over ``Diag(.)`` operators).

Counterpart of ``ttipm_tpu/solvers/fused_eigen.py`` (``:623`` and ``:826``)
with the semantics of its numpy host engine (``fused_eigen_host.py``), as
eager host loops.  With ``config.set_fused_whole_solve(True)`` and d >= 2
both solvers run the JAX package's whole-eigen programs instead
(``_gen_eigen_program`` ``:371-437``, ``_min_eig_program`` ``:494-530``,
dispatched at ``:639-676`` and ``:843-856``): ``fused_eigen_batch``'s
``gen_eigen_single`` and ``min_eig_program`` on a batch of one, alpha kept
on the device, the lead-in, each half-sweep pair and the finishing sweep
replayed as CUDA graphs on the card (``solvers/graphs.py``), the loop's
test read once a pair, and the JAX dispatch's post-processing here.  The window and single-core assemblies go
through K1 (``schur_assemble_group``, the pencil's two matrices from one
launch; a 2-core window is one operator core of physical size 16 after
merging the pair), and the Cholesky of the whitened shrink pencil through
K4 (``panel_cholesky``).

Deviation: the host engine switches to ARPACK ``eigsh`` (k=1) for windows
of size >= 192 (``fused_eigen_host.py:41-80``); the port takes the dense
``torch.linalg.eigh`` at every window size, in both solvers.  The window
is at most ``16 R^2`` (1024 at the default eigen rank R=8), which the
dense solver handles directly, and dense eigh gives the exact extreme
eigenpair where ARPACK gives it to its tolerance.

Precision: the pencils, interfaces and eigenvector trains are in
``config.eigen_dtype()`` (``fused_eigen.py:553-562,585,615,641``): f64 by
default, the profile's dtype with ``set_eigen_dtype("native")``, so under
the f32 profile K1 and K4 run their f32 instances here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ttipm_tpu_torch import config, trace
from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.linalg import fast_split_svd, safe_eigh, safe_eigvalsh
from ttipm_tpu_torch.ops.products import tt_fast_matrix_vec_mul
from ttipm_tpu_torch.ops.tt import TT, tt_inner_prod, tt_normalise
from ttipm_tpu_torch.solvers.fused import _bucket4, _svd_retract
from ttipm_tpu_torch.solvers.fused_algebra import phi_bck_A, phi_fwd_A

__all__ = ["tt_max_generalised_eigen_fused", "tt_min_eig_fused"]

TINY = 1e-300


def _merged(A_k, A_k1):
    """The operator core of a 2-core window: physical size 16."""
    s, m, n, _ = A_k.shape
    _, p, t, S = A_k1.shape
    return torch.einsum("smnk,kptS->smpntS", A_k, A_k1).reshape(s, m * p, n * t, S)


def _smallest_eigpair(M):
    try:
        ev, U = safe_eigh(0.5 * (M + M.T))
    except torch.linalg.LinAlgError:
        return M.new_tensor(float("nan")), torch.full_like(M[:, 0], float("nan"))
    return ev[0], U[:, 0]


def _shrink_alpha(MA, MD, alpha: float, tol: float) -> float:
    """alpha <- min(alpha, 1/lambda_max(-Delta, A)) via the whitened pencil;
    a failed Cholesky of A gives alpha * (1 - tol)."""
    m = MA.shape[0]
    L, info = kernels.panel_cholesky(
        0.5 * (MA + MA.T) + 1e-12 * torch.eye(m, dtype=MA.dtype, device=MA.device))
    lam_max = float("nan")
    if int(info) == 0:
        W = torch.linalg.solve_triangular(L, 0.5 * (MD + MD.T), upper=False)
        W = torch.linalg.solve_triangular(L, W.T, upper=False)
        try:
            lam_max = -float(safe_eigvalsh(0.5 * (W + W.T))[0])
        except torch.linalg.LinAlgError:
            pass
    if np.isfinite(lam_max) and lam_max > 0:
        return max(0.0, min(float(alpha), 1.0 / lam_max))
    return float(alpha) * (1 - tol)


def _pencil_solve(MA, MD, prev_vec, alpha: float, tol: float):
    """Smallest eigenpair of MA/alpha + MD, the shrink rule, and the
    previous iterate's residual in the updated pencil.  Returns
    (x, alpha_new, old_res, scale) with scale = ||M||_F."""
    M = MA / alpha + MD
    lam, x = _smallest_eigpair(M)
    lam = float(lam)
    alpha_new = _shrink_alpha(MA, MD, alpha, tol) if (np.isfinite(lam) and lam < 0) \
        else float(alpha)
    denom = alpha_new if alpha_new > 0 else 1.0
    Mp = (MA @ prev_vec) / denom + MD @ prev_vec
    lam_prev = torch.dot(prev_vec, Mp)
    old_res = torch.linalg.norm(Mp - lam_prev * prev_vec)
    scale = torch.linalg.norm(M)
    return x, alpha_new, old_res, scale


def _unit(x):
    return x / torch.clamp_min(torch.linalg.norm(x), TINY)


def _split(mat, r_out: int):
    u, s, vt = fast_split_svd(mat)
    r_out = min(r_out, u.shape[1])
    return u[:, :r_out], s[:r_out, None] * vt[:r_out], r_out


def _gen_window_step(pAl, A_k, A_k1, pAr, pDl, D_k, D_k1, pDr, sol1, sol2,
                     alpha, tol, r_out: int, bwd: bool):
    prev = torch.einsum("rny,ytR->rntR", sol1, sol2)
    rl, n1, n2, rr = prev.shape
    # window pencils [(l,m,p,L),(r,n,t,R)], both from one launch
    MA, MD = kernels.schur_assemble_group(
        [(pAl, _merged(A_k, A_k1), pAr), (pDl, _merged(D_k, D_k1), pDr)])
    x, alpha_new, old_res, scale = _pencil_solve(MA, MD, prev.reshape(-1), alpha, tol)
    x = _unit(x)
    if bwd:
        u, sv, r = _split(x.reshape(rl * n1, n2 * rr).T, r_out)
        sol2_new = u.T.reshape(r, n2, rr)
        sol1_new = sv.T.reshape(rl, n1, r)
        pA_upd = phi_bck_A(pAr, sol2_new, A_k1, sol2_new)
        pD_upd = phi_bck_A(pDr, sol2_new, D_k1, sol2_new)
    else:
        u, sv, r = _split(x.reshape(rl * n1, n2 * rr), r_out)
        sol1_new = u.reshape(rl, n1, r)
        sol2_new = sv.reshape(r, n2, rr)
        pA_upd = phi_fwd_A(pAl, sol1_new, A_k, sol1_new)
        pD_upd = phi_fwd_A(pDl, sol1_new, D_k, sol1_new)
    return sol1_new, sol2_new, alpha_new, old_res, scale, pA_upd, pD_upd


def _gen_last_step(pAl, A_k, pAr, pDl, D_k, pDr, neighbor, prev, alpha, tol,
                   r_out: int, bwd: bool, split: bool):
    """Single-core refinement pass of the finishing sweep."""
    rl, n, rr = prev.shape
    MA, MD = kernels.schur_assemble_group([(pAl, A_k, pAr), (pDl, D_k, pDr)])
    x, alpha_new, old_res, _scale = _pencil_solve(MA, MD, prev.reshape(-1), alpha, tol)
    x = _unit(x)
    if not split:
        return x.reshape(rl, n, rr), neighbor, alpha_new, old_res, pAl, pDl
    if bwd:
        u, sv, r = _split(x.reshape(rl, n * rr).T, r_out)
        core = u.T.reshape(r, n, rr)
        nb_new = torch.einsum("rdc,cR->rdR", neighbor, sv.T)
        pA_upd = phi_bck_A(pAr, core, A_k, core)
        pD_upd = phi_bck_A(pDr, core, D_k, core)
    else:
        u, sv, r = _split(x.reshape(rl * n, rr), r_out)
        core = u.reshape(rl, n, r)
        nb_new = torch.einsum("ij,jkl->ikl", sv, neighbor)
        pA_upd = phi_fwd_A(pAl, core, A_k, core)
        pD_upd = phi_fwd_A(pDl, core, D_k, core)
    return core, nb_new, alpha_new, old_res, pA_upd, pD_upd


def _min_window_step(pl, A_k, A_k1, pr, sol1, sol2, r_out: int, bwd: bool):
    """Smallest eigenvector of a 2-core window of one operator, re-split at
    the fixed rank; returns (sol1, sol2, the previous iterate's residual,
    the updated interface)."""
    prev = torch.einsum("rny,ytR->rntR", sol1, sol2)
    rl, n1, n2, rr = prev.shape
    M = kernels.schur_assemble(pl, _merged(A_k, A_k1), pr)
    _, x = _smallest_eigpair(M)
    prev_vec = prev.reshape(-1)
    Mp = M @ prev_vec
    old_res = torch.linalg.norm(torch.dot(prev_vec, Mp) * prev_vec - Mp)
    x = _unit(x)
    if bwd:
        u, sv, r = _split(x.reshape(rl * n1, n2 * rr).T, r_out)
        sol2_new = u.T.reshape(r, n2, rr)
        sol1_new = sv.T.reshape(rl, n1, r)
        p_upd = phi_bck_A(pr, sol2_new, A_k1, sol2_new)
    else:
        u, sv, r = _split(x.reshape(rl * n1, n2 * rr), r_out)
        sol1_new = u.reshape(rl, n1, r)
        sol2_new = sv.reshape(r, n2, rr)
        p_upd = phi_fwd_A(pl, sol1_new, A_k, sol1_new)
    return sol1_new, sol2_new, old_res, p_upd


def _min_last_step(pl, A_k, pr, neighbor, prev, r_out: int, bwd: bool, split: bool):
    """Single-core pass of the finishing sweep of ``tt_min_eig_fused``."""
    rl, n, rr = prev.shape
    _, x = _smallest_eigpair(kernels.schur_assemble(pl, A_k, pr))
    x = _unit(x)
    if not split:
        return x.reshape(rl, n, rr), neighbor, pl
    if bwd:
        u, sv, r = _split(x.reshape(rl, n * rr).T, r_out)
        core = u.T.reshape(r, n, rr)
        return core, torch.einsum("rdc,cR->rdR", neighbor, sv.T), phi_bck_A(pr, core, A_k, core)
    u, sv, r = _split(x.reshape(rl * n, rr), r_out)
    core = u.reshape(rl, n, r)
    return core, torch.einsum("ij,jkl->ikl", sv, neighbor), phi_fwd_A(pl, core, A_k, core)


def _orth_bck_step(x_km1, x_k, ops_k, phis_r, r_out: int):
    """Sweep-0 orthogonalization: re-split at the fixed rank and update the
    interfaces of every operator in ``ops_k``."""
    rl, n, rr = x_k.shape
    u, sv, r = _split(x_k.reshape(rl, n * rr).T, r_out)
    core = u.T.reshape(r, n, rr)
    x_km1_new = torch.einsum("rdc,cR->rdR", x_km1, sv.T)
    phi_upds = tuple(phi_bck_A(p, core, a, core) for p, a in zip(phis_r, ops_k))
    return core, x_km1_new, phi_upds


def _eigen_residual_stalled(prev_res, res, tol):
    return (np.isfinite(prev_res) and np.isfinite(res)
            and res <= 50 * tol and res >= 0.8 * prev_res)


def _eigen_step_stalled(prev_step, step, prev_res, res, tol):
    if prev_step is None:
        return False
    scale = max(abs(step), abs(prev_step), 1.0)
    return (abs(step - prev_step) <= max(10 * tol, 1e-12) * scale
            and _eigen_residual_stalled(prev_res, res, tol))


# ---------------------------------------------------------------------------
# Preparation
# ---------------------------------------------------------------------------

def _prep_operator(cores: TT, ra: Optional[int] = None) -> TT:
    """The operator in the eigen dtype, its bond ranks zero-padded to one
    multiple of 4 (exact), or to ``ra`` where that is larger (a batch's
    common rank, ``fused_eigen.py:552-580``)."""
    d = len(cores)
    cores = [c.to(config.eigen_dtype()) for c in cores]
    if d == 1:
        return [cores[0]]
    ra = max(_bucket4(max(c.shape[-1] for c in cores[:-1])), ra or 0)
    out = []
    for k, c in enumerate(cores):
        rl = 1 if k == 0 else ra
        rr = 1 if k == d - 1 else ra
        pad = c.new_zeros((rl,) + tuple(c.shape[1:-1]) + (rr,))
        pad[:c.shape[0], ..., :c.shape[-1]] = c
        out.append(pad)
    return out


def _vec_caps(d: int, R: int, n: int) -> List[int]:
    return [min(R, n ** (k + 1), n ** (d - 1 - k)) for k in range(d - 1)]


def _prep_vec(x0, d: int, n: int, caps: List[int], rng, ref) -> TT:
    """Eigenvector warm start at exact cap ranks (RL-orthogonalise, then
    truncate or zero-pad), or a fresh Gaussian drawn from ``rng``, in the
    eigen dtype on ``ref``'s device."""
    dtype = config.eigen_dtype()
    if x0 is None:
        cores = []
        for k in range(d):
            rl = 1 if k == 0 else caps[k - 1]
            rr = 1 if k == d - 1 else caps[k]
            cores.append(torch.as_tensor(rng.randn(rl, n, rr), dtype=dtype, device=ref.device))
        return cores
    return _svd_retract([c.to(dtype) for c in x0], caps)


def _eps_floor() -> float:
    """The unit roundoff that floors an eigensolve's achievable residual:
    that of the coarser of the pencil dtype and the iterates' dtype (the
    pencil operands were rounded to the latter).  The pencil's alone lets
    f64 pencils of f32 iterates penalise correct steps
    (``fused_eigen.py:664-675``)."""
    return max(float(torch.finfo(config.eigen_dtype()).eps),
               float(torch.finfo(config.dtype()).eps))


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def tt_max_generalised_eigen_fused(A: TT, Delta: TT, x0: Optional[TT] = None,
                                   nswp: int = 10, tol: float = 1e-8, R: int = 8,
                                   verbose: bool = False, rng=None):
    """Largest ``alpha`` with ``A + alpha*Delta`` PSD and the eigenvector
    train (the next call's warm start).  ``rng``: numpy RandomState of the
    fresh start (default numpy's global one)."""
    with trace.span("eigen.solve", kind="gen"):
        rng = np.random if rng is None else rng
        d = len(A)
        n = A[0].shape[1]
        A_p = _prep_operator(A)
        D_p = _prep_operator(Delta)
        caps = _vec_caps(d, R, n)
        x_cores = _prep_vec(x0, d, n, caps, rng, A[0])

        if config.fused_whole_solve() and d >= 2:
            from ttipm_tpu_torch.solvers import fused_eigen_batch as feb
            from ttipm_tpu_torch.solvers.fused_batch import batch_of_one

            alpha0 = torch.ones(1, dtype=config.eigen_dtype(), device=A_p[0].device)
            xs, alpha, res, scl, _ = feb.gen_eigen_single(
                batch_of_one(A_p), batch_of_one(D_p), batch_of_one(x_cores), alpha0, tol, caps,
                max(nswp - 1, 1))
            step_size, max_res, max_scale = torch.stack(
                [alpha[0], res[0], scl[0]]).double().tolist()
            if not np.isfinite(step_size) or step_size < 0:
                step_size = 0.0
            return _penalised(step_size, max_res, max_scale, tol), tt_normalise([c[0] for c in xs])

        ones3 = A_p[0].new_ones((1, 1, 1))
        XAX = [ones3] + [None] * (d - 1) + [ones3]
        XDX = [ones3] + [None] * (d - 1) + [ones3]
        alpha = 1.0
        local_res = np.inf * np.ones((2, max(d - 1, 1)))
        max_scale = 0.0
        prev_sweep_step = None
        prev_sweep_res = np.inf

        def finish(direction: int):
            nonlocal alpha
            with trace.span("eigen.sweep"):
                ks = range(d) if direction > 0 else range(d - 1, -1, -1)
                for k in ks:
                    split = (k < d - 1) if direction > 0 else (k > 0)
                    nb_idx = k + 1 if direction > 0 else k - 1
                    neighbor = x_cores[nb_idx] if split else x_cores[k]
                    r_out = (caps[k] if direction > 0 else caps[k - 1]) if split else 1
                    core, nb_new, alpha, _, pA_upd, pD_upd = _gen_last_step(
                        XAX[k], A_p[k], XAX[k + 1], XDX[k], D_p[k], XDX[k + 1],
                        neighbor, x_cores[k], alpha, tol,
                        r_out=r_out, bwd=direction < 0, split=split)
                    x_cores[k] = core
                    if split:
                        x_cores[nb_idx] = nb_new
                        j = k + 1 if direction > 0 else k
                        XAX[j] = pA_upd
                        XDX[j] = pD_upd

        def half_sweep(bwd: bool):
            nonlocal alpha, max_scale
            trace.count("eigen.sweeps")
            with trace.span("eigen.sweep"):
                res_list, scl_list = [], []
                ks = range(d - 1, 0, -1) if bwd else range(d - 1)
                for k in ks:
                    i = k - 1 if bwd else k
                    (x_cores[i], x_cores[i + 1], alpha, res, scl, pA_upd, pD_upd) = \
                        _gen_window_step(
                            XAX[i], A_p[i], A_p[i + 1], XAX[i + 2],
                            XDX[i], D_p[i], D_p[i + 1], XDX[i + 2],
                            x_cores[i], x_cores[i + 1], alpha, tol,
                            r_out=caps[i], bwd=bwd)
                    XAX[i + 1] = pA_upd
                    XDX[i + 1] = pD_upd
                    res_list.append(res)
                    scl_list.append(scl)
                vals = torch.stack(res_list + scl_list[-1:]).tolist()
                max_scale = max(max_scale, vals[-1])
                res_host = vals[:-1]
                return res_host[::-1] if bwd else res_host

        for swp in range(nswp):
            if swp > 0:
                local_res[0, :] = half_sweep(bwd=True)
                if not np.isfinite(alpha) or alpha <= 0:
                    break
            else:
                for k in range(d - 1, 0, -1):
                    core, x_prev, (pA_upd, pD_upd) = _orth_bck_step(
                        x_cores[k - 1], x_cores[k], (A_p[k], D_p[k]),
                        (XAX[k + 1], XDX[k + 1]), r_out=caps[k - 1])
                    x_cores[k] = core
                    x_cores[k - 1] = x_prev
                    XAX[k] = pA_upd
                    XDX[k] = pD_upd

            if np.max(local_res) < tol or swp == nswp - 1:
                finish(+1)
                break

            local_res[1, :] = half_sweep(bwd=False)
            if not np.isfinite(alpha) or alpha <= 0:
                break
            if np.max(local_res) < tol:
                finish(-1)
                break

            sweep_res = float(np.max(local_res))
            if swp >= 2 and _eigen_step_stalled(prev_sweep_step, alpha,
                                                prev_sweep_res, sweep_res, tol):
                break
            prev_sweep_step = alpha
            prev_sweep_res = sweep_res

        step_size = float(alpha)
        if not np.isfinite(step_size) or step_size < 0:
            step_size = 0.0
        max_res = float(np.max(local_res))
        return _penalised(step_size, max_res, max_scale, tol), tt_normalise(list(x_cores))


def _penalised(step_size: float, max_res: float, max_scale: float, tol: float) -> float:
    """The unconverged-eigensolve penalty: the step shrunk by tol / res,
    with tol floored at the dtypes' achievable residual (``:650-677``)."""
    eps_dt = _eps_floor()
    tol = max(tol, 30.0 * eps_dt, 4.0 * eps_dt * max_scale)
    if max_res > tol and np.isfinite(max_res) and max_res > 0:
        step_size *= tol / max_res
    return step_size


def tt_min_eig_fused(A: TT, x0: Optional[TT] = None, nswp: int = 10, tol: float = 1e-8,
                     R: int = 8, return_eig_val: bool = False, verbose: bool = False,
                     rng=None):
    """Smallest eigenvector of a symmetric TT operator by fixed-rank MALS
    over 2-core windows; returns (the normalised eigenvector train, its
    Rayleigh quotient or None).  ``rng``: numpy RandomState of the fresh
    start (default numpy's global one).  The host reads each half sweep's
    window residuals once."""
    with trace.span("eigen.solve", kind="min"):
        rng = np.random if rng is None else rng
        d = len(A)
        n = A[0].shape[1]
        A_p = _prep_operator(A)
        caps = _vec_caps(d, R, n)
        x_cores = _prep_vec(x0, d, n, caps, rng, A[0])
        if config.fused_whole_solve() and d >= 2:
            from ttipm_tpu_torch.solvers import fused_eigen_batch as feb
            from ttipm_tpu_torch.solvers.fused_batch import batch_of_one

            xs, _, _ = feb.min_eig_program(batch_of_one(A_p), batch_of_one(x_cores), tol,
                                           caps, max(nswp - 1, 1))
            return _with_eig_val(A, [c[0] for c in xs], return_eig_val)

        ones3 = A_p[0].new_ones((1, 1, 1))
        XAX = [ones3] + [None] * (d - 1) + [ones3]
        prev_sweep_res = np.inf

        def finish(direction: int):
            with trace.span("eigen.sweep"):
                ks = range(d) if direction > 0 else range(d - 1, -1, -1)
                for k in ks:
                    split = (k < d - 1) if direction > 0 else (k > 0)
                    nb_idx = k + 1 if direction > 0 else k - 1
                    neighbor = x_cores[nb_idx] if split else x_cores[k]
                    r_out = (caps[k] if direction > 0 else caps[k - 1]) if split else 1
                    core, nb_new, p_upd = _min_last_step(
                        XAX[k], A_p[k], XAX[k + 1], neighbor, x_cores[k],
                        r_out=r_out, bwd=direction < 0, split=split)
                    x_cores[k] = core
                    if split:
                        x_cores[nb_idx] = nb_new
                        XAX[k + 1 if direction > 0 else k] = p_upd

        def half_sweep(bwd: bool) -> float:
            trace.count("eigen.sweeps")
            with trace.span("eigen.sweep"):
                res_list = []
                for k in (range(d - 1, 0, -1) if bwd else range(d - 1)):
                    i = k - 1 if bwd else k
                    x_cores[i], x_cores[i + 1], res, p_upd = _min_window_step(
                        XAX[i], A_p[i], A_p[i + 1], XAX[i + 2], x_cores[i], x_cores[i + 1],
                        r_out=caps[i], bwd=bwd)
                    XAX[i + 1] = p_upd
                    res_list.append(res)
                return float(torch.stack(res_list).max())

        for swp in range(nswp):
            if swp > 0:
                max_res = half_sweep(bwd=True)
            else:
                max_res = np.inf
                for k in range(d - 1, 0, -1):
                    core, x_prev, (p_upd,) = _orth_bck_step(
                        x_cores[k - 1], x_cores[k], (A_p[k],), (XAX[k + 1],), r_out=caps[k - 1])
                    x_cores[k] = core
                    x_cores[k - 1] = x_prev
                    XAX[k] = p_upd
            if max_res < tol or swp == nswp - 1:
                finish(+1)
                break
            max_res = half_sweep(bwd=False)
            if max_res < tol:
                finish(-1)
                break
            if swp >= 2 and _eigen_residual_stalled(prev_sweep_res, max_res, tol):
                break
            prev_sweep_res = max_res

        return _with_eig_val(A, list(x_cores), return_eig_val)


def _with_eig_val(A, x_cores, return_eig_val: bool):
    """(the normalised train, its Rayleigh quotient <x, A x> or None)."""
    x_cores = tt_normalise(x_cores)
    min_eig_value = None
    if return_eig_val:
        # in the wider of the two dtypes, as jnp promotes
        wide = torch.promote_types(A[0].dtype, x_cores[0].dtype)
        xw = [c.to(wide) for c in x_cores]
        min_eig_value = tt_inner_prod(xw, tt_fast_matrix_vec_mul([c.to(wide) for c in A], xw,
                                                                  1e-12))
    return x_cores, min_eig_value
