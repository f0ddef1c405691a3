"""The step-size eigensolve for a batch of pencils of one structure, in
lockstep.

The generalised solve of ``solvers/fused_eigen.py`` for a batch, with the
semantics of the JAX package's whole-eigen device program
(``ttipm_tpu/solvers/fused_eigen.py:371-437``, ``_gen_eigen_program``)
that ``ttipm_tpu/parallel/fused_mesh.py`` maps over a batch with
``jax.vmap``: the sweep-0 orthogonalisation, a first forward solving half
sweep, then (backward, forward) half-sweep pairs while an instance's alpha
is finite and positive, its sweep residual is at or above ``tol``, it has
not stalled and it has pairs left (the forward half only where it is still
needed after the backward one), then a single-core finishing sweep.  The
finishing sweep follows the JAX package's host loop
(``_tt_max_generalised_eigen_fused_impl``, ``finish`` at
``ttipm_tpu/solvers/fused_eigen.py:710-732``), not its program, which
always finishes backward: it runs backward after a forward half sweep and
forward after a backward one (a pair that skipped its forward half:
``finish(+1)``, ``:770``), and not at all where alpha is not finite and
positive (``:788``) or the loop stopped on a stall above ``tol``
(``:796``).  Both directions run and each instance keeps its own, so the
end reads nothing on the host.  A backward finisher started from the
left-orthogonal train a backward half sweep leaves reads right interfaces
as left ones (one pencil of maxcut d8 seed 24: a step of 0.3832 where the
exact one is 1).  Each
instance keeps its own alpha, residual, stall flag, pair count and the
direction of its last half sweep, as the vmapped ``while_loop`` gives
them; an instance that has stopped rides along frozen by (B,) masks,
so the shapes stay uniform.  The host reads the instances' loop conditions
once per pair.  On a batch of one the same program is the single solve's
whole-solve path (``gen_eigen_single``, with ``min_eig_program`` for the
smallest eigenvector, ``_min_eig_program`` ``:494-530``, finishing as
``tt_min_eig_fused``'s host loop does): the host decisions inside a pair
become selects, and the lead-in, each pair and the finishing sweep are
CUDA graphs on the card (``solvers/graphs.py``).
Without the whole-solve switch the single solve keeps its own loop: it
follows the host engine (``fused_eigen_host.py``: the orthogonalisation,
then backward and forward half sweeps per sweep, a finishing sweep in the
direction that
converged, and its own stall test), a different order of windows from
this program's, so a batch of one here is not the single solve; the two
agree to the JAX package's bound for its batch against its single solve
(2e-6, ``tests/test_torch_parallel.py``).

Every window's two pencil matrices come from one K1 launch for the whole
batch (``kernels.schur_assemble_batch``) and the Cholesky of the whitened
shrink pencil from one K4 call (``kernels.panel_cholesky_batch``).  The
shrink rule is computed for the batch where any instance's shifted pencil
is indefinite and taken where that instance's is (the device program's
``lax.cond``, which ``vmap`` turns into a select).
"""

from __future__ import annotations

import torch

from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.linalg import safe_eigh, safe_eigvalsh
from ttipm_tpu_torch.solvers.fused_batch import TINY, _col, phi_bck_A, phi_fwd_A, svd

__all__ = ["gen_eigen_program", "gen_eigen_single", "min_eig_program"]


# A seeds mesh runs this program on its shard of the batch (5 of 10 pencils
# a rank on two), so an instance must not depend on the batch size.  On the
# H100 three batched calls compute an instance in another order at another
# batch size: cuBLAS's batched matrix-vector product, the batched
# triangular solve and a reduction over long instances (65536 entries, 5
# against 10).  Those are taken an instance at a time, or as an elementwise
# product and a short sum.


def _norm(t):
    """Frobenius norm of each instance of ``t`` (B, ...), one reduction an
    instance."""
    return torch.stack([torch.linalg.vector_norm(x) for x in t])


def _matvec(M, v):
    """M v for each instance, as a product and a sum over the last axis."""
    return (M * v[:, None, :]).sum(dim=2)


def _solve_lower(L, B):
    """L^-1 B for each instance, one triangular solve an instance."""
    return torch.stack([torch.linalg.solve_triangular(l, b, upper=False) for l, b in zip(L, B)])


def _finite(t):
    return torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)


def _merged(A_k, A_k1):
    B, s, m, n, _ = A_k.shape
    _, _, p, t, S = A_k1.shape
    return torch.einsum("zsmnk,zkptS->zsmpntS", A_k, A_k1).reshape(B, s, m * p, n * t, S)


def _sym(M):
    return 0.5 * (M + M.mT)


def _eye_like(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)


def _smallest_eigpair(M):
    """Smallest eigenpair of each instance's symmetrised M; an instance
    that is not finite gets NaN (the single solver's failed eigh)."""
    ok = _finite(M)
    ev, U = safe_eigh(torch.where(_col(ok, M), _sym(M), _eye_like(M)))
    nan = float("nan")
    return torch.where(ok, ev[:, 0], nan), torch.where(_col(ok, U[:, :, 0]), U[:, :, 0], nan)


def _shrink_alpha(MA, MD, alpha, tol):
    """alpha <- min(alpha, 1 / lambda_max(-Delta, A)) per instance, via the
    whitened pencil; a failed Cholesky of A gives alpha (1 - tol)."""
    L, info = kernels.panel_cholesky_batch(_sym(MA) + 1e-12 * _eye_like(MA))
    ok = info == 0
    L = torch.where(_col(ok, L), L, _eye_like(L))
    W = _solve_lower(L, _sym(MD))
    W = _solve_lower(L, W.mT)
    ok = ok & _finite(W)
    lam_max = -safe_eigvalsh(torch.where(_col(ok, W), _sym(W), _eye_like(W)))[:, 0]
    good = ok & torch.isfinite(lam_max) & (lam_max > 0)
    shrunk = torch.clamp_min(torch.minimum(alpha, 1.0 / torch.where(good, lam_max, 1.0)), 0.0)
    return torch.where(good, shrunk, alpha * (1 - tol))


def _any(mask, mesh):
    """True where any instance of the batch (over ``mesh``'s seeds axis,
    if given) has ``mask`` set."""
    flag = bool(mask.any())
    return flag if mesh is None else mesh.any(flag)


def _pencils(blocks, mesh):
    """The two pencil matrices of a window from one K1 launch (this rank's
    slice of the operator bond, summed over ``mesh``'s kkt row)."""
    def assemble(bl):
        return list(kernels.schur_assemble_batch(bl).unbind(0))
    return assemble(blocks) if mesh is None else mesh.partial_schur(blocks, assemble)


def _pencil_solve(MA, MD, prev_vec, alpha, tol, mesh=None, selects=False):
    """Smallest eigenpair of MA/alpha + MD, the shrink rule and the previous
    iterate's residual in the updated pencil, per instance; returns (x,
    alpha_new, old_res, scale) with scale = ||M||_F.  The shrink rule runs
    where any instance's shifted pencil is indefinite, or always with
    ``selects`` (no host decision: a CUDA graph's body), and is taken
    where the instance's is."""
    M = MA / _col(alpha, MA) + MD
    lam, x = _smallest_eigpair(M)
    neg = lam < 0
    alpha_new = alpha
    if selects or _any(neg, mesh):
        alpha_new = torch.where(neg, _shrink_alpha(MA, MD, alpha, tol), alpha)
    denom = torch.where(alpha_new > 0, alpha_new, torch.ones_like(alpha_new))
    Mp = _matvec(MA, prev_vec) / denom[:, None] + _matvec(MD, prev_vec)
    lam_prev = (prev_vec * Mp).sum(dim=1)
    old_res = _norm(Mp - lam_prev[:, None] * prev_vec)
    return x, alpha_new, old_res, _norm(M)


def _unit(x):
    return x / torch.clamp_min(_norm(x), TINY)[:, None]


def _split(mat, r_out: int):
    u, s, vt = svd(mat)
    r_out = min(r_out, u.shape[-1])
    return u[:, :, :r_out], s[:, :r_out, None] * vt[:, :r_out], r_out


def _window_step(pAl, A_k, A_k1, pAr, pDl, D_k, D_k1, pDr, sol1, sol2, alpha, tol,
                 r_out: int, bwd: bool, mesh=None, selects=False):
    prev = torch.einsum("zrny,zytR->zrntR", sol1, sol2)
    B, rl, n1, n2, rr = prev.shape
    MA, MD = _pencils([(pAl, _merged(A_k, A_k1), pAr), (pDl, _merged(D_k, D_k1), pDr)], mesh)
    x, alpha_new, old_res, scale = _pencil_solve(MA, MD, prev.reshape(B, -1), alpha, tol,
                                                 mesh, selects)
    x = _unit(x)
    if bwd:
        u, sv, r = _split(x.reshape(B, rl * n1, n2 * rr).mT, r_out)
        sol2_new = u.mT.reshape(B, r, n2, rr)
        sol1_new = sv.mT.reshape(B, rl, n1, r)
        pA_upd = phi_bck_A(pAr, sol2_new, A_k1, sol2_new)
        pD_upd = phi_bck_A(pDr, sol2_new, D_k1, sol2_new)
    else:
        u, sv, r = _split(x.reshape(B, rl * n1, n2 * rr), r_out)
        sol1_new = u.reshape(B, rl, n1, r)
        sol2_new = sv.reshape(B, r, n2, rr)
        pA_upd = phi_fwd_A(pAl, sol1_new, A_k, sol1_new)
        pD_upd = phi_fwd_A(pDl, sol1_new, D_k, sol1_new)
    return sol1_new, sol2_new, alpha_new, old_res, scale, pA_upd, pD_upd


def _last_step(pAl, A_k, pAr, pDl, D_k, pDr, neighbor, prev, alpha, tol, r_out: int,
               split: bool, bwd: bool, mesh=None):
    """Single-core refinement step of a finishing sweep (``bwd``: backward,
    the interface updated at ``k``; forward: at ``k + 1``), the shrink rule
    a select."""
    B, rl, n, rr = prev.shape
    MA, MD = _pencils([(pAl, A_k, pAr), (pDl, D_k, pDr)], mesh)
    x, alpha_new, _, _ = _pencil_solve(MA, MD, prev.reshape(B, -1), alpha, tol, mesh, True)
    x = _unit(x)
    if not split:
        return x.reshape(B, rl, n, rr), neighbor, alpha_new, pAl, pDl
    if bwd:
        u, sv, r = _split(x.reshape(B, rl, n * rr).mT, r_out)
        core = u.mT.reshape(B, r, n, rr)
        nb_new = torch.einsum("zrdc,zcR->zrdR", neighbor, sv.mT)
        return (core, nb_new, alpha_new, phi_bck_A(pAr, core, A_k, core),
                phi_bck_A(pDr, core, D_k, core))
    u, sv, r = _split(x.reshape(B, rl * n, rr), r_out)
    core = u.reshape(B, rl, n, r)
    nb_new = torch.einsum("zij,zjkl->zikl", sv, neighbor)
    return (core, nb_new, alpha_new, phi_fwd_A(pAl, core, A_k, core),
            phi_fwd_A(pDl, core, D_k, core))


def _orth_sweep(ops, xs, phis, caps):
    """The sweep-0 orthogonalisation: the trains ``xs`` re-split at the
    fixed ranks from the right, the interfaces ``phis`` of each operator
    of ``ops`` updated (lists, in place)."""
    d = len(xs)
    for k in range(d - 1, 0, -1):
        B, rl, n, rr = xs[k].shape
        u, sv, r = _split(xs[k].reshape(B, rl, n * rr).mT, caps[k - 1])
        xs[k] = u.mT.reshape(B, r, n, rr)
        xs[k - 1] = torch.einsum("zrdc,zcR->zrdR", xs[k - 1], sv.mT)
        for op, phi in zip(ops, phis):
            phi[k] = phi_bck_A(phi[k + 1], xs[k], op[k], xs[k])


def _half_sweep(A_p, D_p, st, alpha, tol, caps, bwd: bool, mesh=None, selects=False):
    """One half sweep of every instance on a copy of the state ``st`` =
    (xs, XAX, XDX); returns (state, alpha, max window residual, max
    window scale), the last three (B,)."""
    xs, XAX, XDX = (list(t) for t in st)
    d = len(xs)
    res_vals, scale_vals = [], []
    for k in (range(d - 1, 0, -1) if bwd else range(d - 1)):
        i = k - 1 if bwd else k
        xs[i], xs[i + 1], alpha, res, scl, pA, pD = _window_step(
            XAX[i], A_p[i], A_p[i + 1], XAX[i + 2], XDX[i], D_p[i], D_p[i + 1], XDX[i + 2],
            xs[i], xs[i + 1], alpha, tol, r_out=caps[i], bwd=bwd, mesh=mesh, selects=selects)
        XAX[i + 1] = pA
        XDX[i + 1] = pD
        res_vals.append(res)
        scale_vals.append(scl)
    return ((xs, XAX, XDX), alpha, torch.stack(res_vals).amax(dim=0),
            torch.stack(scale_vals).amax(dim=0))


def _finish_order(d: int, bwd: bool):
    """(k, split, neighbour, interface index) of each step of a finishing
    sweep, in the host loop's order (``finish(-1)`` / ``finish(+1)``)."""
    if bwd:
        return [(k, k > 0, k - 1, k) for k in range(d - 1, -1, -1)]
    return [(k, k < d - 1, k + 1, k + 1) for k in range(d)]


def _finish_sweep(A_p, D_p, st, alpha, tol, caps, bwd: bool, mesh=None):
    xs, XAX, XDX = (list(t) for t in st)
    for k, split, nb, j in _finish_order(len(xs), bwd):
        core, nb_new, alpha, pA, pD = _last_step(
            XAX[k], A_p[k], XAX[k + 1], XDX[k], D_p[k], XDX[k + 1],
            xs[nb] if split else xs[k], xs[k], alpha, tol,
            r_out=caps[min(k, nb)] if split else 1, split=split, bwd=bwd, mesh=mesh)
        xs[k] = core
        if split:
            xs[nb] = nb_new
            XAX[j] = pA
            XDX[j] = pD
    return (xs, XAX, XDX), alpha


def _select(mask, new, old):
    """Per instance: ``new`` where ``mask``, else ``old`` (nested lists of
    (B, ...) tensors, or (B,) tensors)."""
    if isinstance(new, (list, tuple)):
        return type(new)(_select(mask, n, o) for n, o in zip(new, old))
    return torch.where(_col(mask, new), new, old)


def _ok(alpha):
    return torch.isfinite(alpha) & (alpha > 0)


def _stalled(prev_step, step, prev_res, res, tol):
    """Device form of the single solver's step-and-residual stall test."""
    scale = torch.clamp_min(torch.maximum(step.abs(), prev_step.abs()), 1.0)
    res_stall = (torch.isfinite(prev_res) & torch.isfinite(res) & (res <= 50 * tol)
                 & (res >= 0.8 * prev_res))
    return (torch.abs(step - prev_step) <= max(10 * tol, 1e-12) * scale) & res_stall


def _gen_active(carry, tol):
    """The loop's test of each instance, but for its pair count."""
    alpha, sweep_res, stalled = carry[1], carry[3], carry[6]
    return _ok(alpha) & (sweep_res >= tol) & ~stalled


def _gen_pair(A_p, D_p, carry, tol, caps, mesh=None, selects=False):
    """One (backward, forward) half-sweep pair of the generalised program
    (the JAX ``while_loop``'s body) on the carry (state, alpha, the last
    forward residual, the sweep residual, the previous step and residual,
    the stall flag, the largest scale, the pair count, whether the last
    half sweep was forward), each instance's carry kept where it is not
    active.  The forward half runs where any
    active instance still needs it, or always with ``selects``, and is
    taken where the instance needs it (the JAX program's ``lax.cond``)."""
    st, alpha, res_f, sweep_res, prev_step, prev_res, stalled, scl, p, fwd = carry
    active = _gen_active(carry, tol)
    st1, alpha1, res_b, scl_b = _half_sweep(A_p, D_p, st, alpha, tol, caps, bwd=True,
                                            mesh=mesh, selects=selects)
    run_fwd = _ok(alpha1) & (torch.maximum(res_b, res_f) >= tol)
    st2, alpha2, res_f2, scl_f = st1, alpha1, res_b, scl_b
    if selects or _any(run_fwd & active, mesh):
        st_f, alpha_f, res_ff, scl_ff = _half_sweep(A_p, D_p, st1, alpha1, tol, caps,
                                                    bwd=False, mesh=mesh, selects=selects)
        st2 = _select(run_fwd, st_f, st1)
        alpha2, res_f2, scl_f = (torch.where(run_fwd, a, b) for a, b in
                                 ((alpha_f, alpha1), (res_ff, res_b), (scl_ff, scl_b)))
    new_res = torch.maximum(res_b, res_f2)
    new_stalled = (p >= 1) & _stalled(prev_step, alpha2, prev_res, new_res, tol)
    st = _select(active, st2, st)
    return (st,) + tuple(torch.where(active, a, b) for a, b in (
        (alpha2, alpha), (res_f2, res_f), (new_res, sweep_res), (alpha2, prev_step),
        (new_res, prev_res), (new_stalled, stalled),
        (torch.maximum(scl, torch.maximum(scl_b, scl_f)), scl), (p + 1, p), (run_fwd, fwd)))


def _gen_start(A_p, D_p, xs, alpha0, tol, caps, mesh=None, selects=False):
    """The program's lead-in: the sweep-0 orthogonalisation and the first
    forward half sweep; returns the loop's first carry (the last half
    sweep forward)."""
    d = len(xs)
    B = alpha0.shape[0]
    ones3 = A_p[0].new_ones((B, 1, 1, 1))
    xs = list(xs)
    XAX = [ones3] * (d + 1)
    XDX = [ones3] * (d + 1)
    _orth_sweep((A_p, D_p), xs, (XAX, XDX), caps)
    st, alpha, res_f, scl = _half_sweep(A_p, D_p, (xs, XAX, XDX), alpha0, tol, caps, bwd=False,
                                        mesh=mesh, selects=selects)
    inf = torch.full_like(alpha, float("inf"))
    stalled = torch.zeros(B, dtype=torch.bool, device=alpha.device)
    pairs = torch.zeros(B, dtype=torch.int64, device=alpha.device)
    fwd = torch.ones(B, dtype=torch.bool, device=alpha.device)
    return (st, alpha, res_f, inf, alpha, inf, stalled, scl, pairs, fwd)


def _finish_masks(carry_fwd, sweep_res, stalled, tol, ok=None):
    """Per instance, where the finishing sweep runs backward and where
    forward, and its direction (-1, +1, 0 for none): after the last half
    sweep taken, in the other direction, and none where the loop stopped
    on a stall above ``tol`` or ``ok`` (alpha finite and positive) fails,
    as the host loops end."""
    finish = ~(stalled & (sweep_res >= tol))
    if ok is not None:
        finish = finish & ok
    bwd, fwd = finish & carry_fwd, finish & ~carry_fwd
    return bwd, fwd, fwd.long() - bwd.long()


def _gen_end(A_p, D_p, carry, tol, caps, mesh=None):
    """The finishing sweep of each instance (``_finish_masks``): both
    directions run, with the shrink rule as a select, and each is kept
    where the instance takes it, so the end reads nothing on the host.
    Returns (cores, alpha, the sweep residual, the scale, the direction
    (B,))."""
    st, alpha, _, sweep_res, _, _, stalled, scl, _, fwd = carry
    bwd_fin, fwd_fin, direction = _finish_masks(fwd, sweep_res, stalled, tol, _ok(alpha))
    xs, alpha_out = st[0], alpha
    for bwd, mask in ((True, bwd_fin), (False, fwd_fin)):
        st_fin, alpha_fin = _finish_sweep(A_p, D_p, st, alpha, tol, caps, bwd, mesh)
        xs = _select(mask, st_fin[0], xs)
        alpha_out = torch.where(mask, alpha_fin, alpha_out)
    return xs, alpha_out, sweep_res, scl, direction


def gen_eigen_program(A_p, D_p, xs, alpha0, tol: float, caps, max_pairs: int, mesh=None):
    """The whole generalised eigensolve of B pencils: ``A_p``, ``D_p`` and
    ``xs`` are lists of (B, ...) cores (operators padded to one rank, the
    eigenvector trains at the cap ranks), ``alpha0`` (B,).  Returns (the
    eigenvector cores, alpha, the last sweep residual, the largest window
    scale, the finishing sweep's direction: -1 backward, +1 forward, 0
    none), the last four (B,) on the device.

    ``mesh``: this rank's B pencils are its seeds row's shard of a larger
    batch.  The batch's decisions (the loop's end, whether a forward half
    sweep or the shrink rule runs) are then taken over the whole batch by
    an ``all_reduce`` over the seeds axis, so that every rank runs the
    program the batch would run on one device; with kkt > 1 every window's
    pencil pair is K1 over this rank's slice of the operator bond, summed
    over its kkt row."""
    carry = _gen_start(A_p, D_p, xs, alpha0, tol, caps, mesh)
    pairs = 0
    while pairs < max_pairs:
        if not _any(_gen_active(carry, tol), mesh):
            break
        carry = _gen_pair(A_p, D_p, carry, tol, caps, mesh)
        pairs += 1
    return _gen_end(A_p, D_p, carry, tol, caps, mesh)


def gen_eigen_single(A_p, D_p, xs, alpha0, tol: float, caps, max_pairs: int):
    """``gen_eigen_program`` of a batch of one as a whole-solve program
    (``ttipm_tpu/solvers/fused_eigen.py:371-437``): the host decisions of
    the shrink rule, the forward half sweep and the finishing direction
    are selects (both finishing sweeps run, one is kept), so that the
    lead-in, each pair and the finishing sweep are ``graphs.run`` steps
    (CUDA graphs on the card), and the host reads the loop's test once a
    pair.  A selected branch keeps its bits: on the CPU this is
    ``gen_eigen_program``'s instance bit for bit."""
    from ttipm_tpu_torch.solvers import graphs

    key = (len(xs), tuple(caps), float(tol))

    def start(args):
        carry = _gen_start(*args, tol, caps, selects=True)
        return carry, _gen_active(carry, tol)

    def pair(args):
        A, D, c = args
        c = _gen_pair(A, D, c, tol, caps, selects=True)
        return c, _gen_active(c, tol)

    carry, active = graphs.run(("gen_eigen_start",) + key, start, (A_p, D_p, xs, alpha0))
    for _ in range(max_pairs):
        if not bool(active[0]):
            break
        carry, active = graphs.run(("gen_eigen_pair",) + key, pair, (A_p, D_p, carry))
    return graphs.run(("gen_eigen_end",) + key,
                      lambda args: _gen_end(*args, tol, caps), (A_p, D_p, carry))


# ---------------------------------------------------------------------------
# The smallest-eigenvector program (``ttipm_tpu/solvers/fused_eigen.py:439-530``)
# ---------------------------------------------------------------------------

def _min_window_step(pl, A_k, A_k1, pr, sol1, sol2, r_out: int, bwd: bool):
    """Smallest eigenvector of each instance's 2-core window, re-split at
    the fixed rank; returns (sol1, sol2, the previous iterate's residual,
    the updated interface)."""
    prev = torch.einsum("zrny,zytR->zrntR", sol1, sol2)
    B, rl, n1, n2, rr = prev.shape
    M = kernels.schur_assemble_batch([(pl, _merged(A_k, A_k1), pr)])[0]
    _, x = _smallest_eigpair(M)
    prev_vec = prev.reshape(B, -1)
    Mp = _matvec(M, prev_vec)
    old_res = _norm((prev_vec * Mp).sum(dim=1)[:, None] * prev_vec - Mp)
    x = _unit(x)
    if bwd:
        u, sv, r = _split(x.reshape(B, rl * n1, n2 * rr).mT, r_out)
        sol2_new = u.mT.reshape(B, r, n2, rr)
        sol1_new = sv.mT.reshape(B, rl, n1, r)
        return sol1_new, sol2_new, old_res, phi_bck_A(pr, sol2_new, A_k1, sol2_new)
    u, sv, r = _split(x.reshape(B, rl * n1, n2 * rr), r_out)
    sol1_new = u.reshape(B, rl, n1, r)
    sol2_new = sv.reshape(B, r, n2, rr)
    return sol1_new, sol2_new, old_res, phi_fwd_A(pl, sol1_new, A_k, sol1_new)


def _min_half_sweep(A_p, st, caps, bwd: bool):
    xs, XAX = (list(t) for t in st)
    d = len(xs)
    res_vals = []
    for k in (range(d - 1, 0, -1) if bwd else range(d - 1)):
        i = k - 1 if bwd else k
        xs[i], xs[i + 1], res, p_upd = _min_window_step(
            XAX[i], A_p[i], A_p[i + 1], XAX[i + 2], xs[i], xs[i + 1], r_out=caps[i], bwd=bwd)
        XAX[i + 1] = p_upd
        res_vals.append(res)
    return (xs, XAX), torch.stack(res_vals).amax(dim=0)


def _min_finish_sweep(A_p, st, caps, bwd: bool):
    """The single-core finishing sweep (``bwd``: backward)."""
    xs, XAX = (list(t) for t in st)
    for k, split, nb, j in _finish_order(len(xs), bwd):
        B, rl, n, rr = xs[k].shape
        _, x = _smallest_eigpair(kernels.schur_assemble_batch([(XAX[k], A_p[k], XAX[k + 1])])[0])
        x = _unit(x)
        if not split:
            xs[k] = x.reshape(B, rl, n, rr)
        elif bwd:
            u, sv, r = _split(x.reshape(B, rl, n * rr).mT, caps[nb])
            xs[k] = u.mT.reshape(B, r, n, rr)
            xs[nb] = torch.einsum("zrdc,zcR->zrdR", xs[nb], sv.mT)
        else:
            u, sv, r = _split(x.reshape(B, rl * n, rr), caps[k])
            xs[k] = u.reshape(B, rl, n, r)
            xs[nb] = torch.einsum("zij,zjkl->zikl", sv, xs[nb])
        if split:
            XAX[j] = (phi_bck_A(XAX[k + 1], xs[k], A_p[k], xs[k]) if bwd
                      else phi_fwd_A(XAX[k], xs[k], A_p[k], xs[k]))
    return xs


def _res_stalled(prev_res, res, tol):
    """Device form of the single solver's residual stall test."""
    return (torch.isfinite(prev_res) & torch.isfinite(res) & (res <= 50 * tol)
            & (res >= 0.8 * prev_res))


def _min_active(carry, tol):
    sweep_res, stalled = carry[2], carry[4]
    return (sweep_res >= tol) & ~stalled


def _min_pair(A_p, carry, tol, caps):
    """One (backward, forward) half-sweep pair of the smallest-eigenvector
    program; the forward half always runs and is taken where it is still
    needed after the backward one (the JAX program's ``lax.cond``)."""
    st, res_f, sweep_res, prev_res, stalled, p, fwd = carry
    active = _min_active(carry, tol)
    st1, res_b = _min_half_sweep(A_p, st, caps, bwd=True)
    run_fwd = torch.maximum(res_b, res_f) >= tol
    st_f, res_ff = _min_half_sweep(A_p, st1, caps, bwd=False)
    st2 = _select(run_fwd, st_f, st1)
    res_f2 = torch.where(run_fwd, res_ff, res_b)
    new_res = torch.maximum(res_b, res_f2)
    new_stalled = (p >= 1) & _res_stalled(prev_res, new_res, tol)
    return (_select(active, st2, st),) + tuple(torch.where(active, a, b) for a, b in (
        (res_f2, res_f), (new_res, sweep_res), (new_res, prev_res), (new_stalled, stalled),
        (p + 1, p), (run_fwd, fwd)))


def _min_start(A_p, xs, tol, caps):
    """The lead-in of the smallest-eigenvector program: the sweep-0
    orthogonalisation and a forward half sweep; returns the loop's first
    carry and its test."""
    d = len(xs)
    B = xs[0].shape[0]
    ones3 = A_p[0].new_ones((B, 1, 1, 1))
    xs = list(xs)
    XAX = [ones3] * (d + 1)
    _orth_sweep((A_p,), xs, (XAX,), caps)
    st, res_f = _min_half_sweep(A_p, (xs, XAX), caps, bwd=False)
    inf = torch.full_like(res_f, float("inf"))
    carry = (st, res_f, inf, inf, torch.zeros(B, dtype=torch.bool, device=res_f.device),
             torch.zeros(B, dtype=torch.int64, device=res_f.device),
             torch.ones(B, dtype=torch.bool, device=res_f.device))
    return carry, _min_active(carry, tol)


def _min_end(A_p, carry, tol, caps):
    """The finishing sweep of each instance (``_finish_masks``; both
    directions run, each kept where the instance takes it); returns (the
    cores, the direction (B,))."""
    st, _, sweep_res, _, stalled, _, fwd = carry
    bwd_fin, fwd_fin, direction = _finish_masks(fwd, sweep_res, stalled, tol)
    xs = _select(bwd_fin, _min_finish_sweep(A_p, st, caps, bwd=True), st[0])
    xs = _select(fwd_fin, _min_finish_sweep(A_p, st, caps, bwd=False), xs)
    return xs, direction


def min_eig_program(A_p, xs, tol: float, caps, max_pairs: int):
    """The whole smallest-eigenvector solve of B operators of one structure
    (``_min_eig_program``): the sweep-0 orthogonalisation, a forward half
    sweep, (backward, forward) half-sweep pairs while fewer than
    ``max_pairs`` ran, the sweep residual is at or above ``tol`` and the
    residual has not stalled (``_res_stalled_dev``), then the single-core
    finishing sweep of ``_finish_masks``, as ``tt_min_eig_fused``'s host
    loop ends.  The lead-in, each pair and the finishing sweep are
    ``graphs.run`` steps (CUDA graphs on the card); the host reads the
    loop's test once a pair.  Returns (the eigenvector cores, the sweep
    residual (B,), the finishing direction (B,): -1, +1 or 0)."""
    from ttipm_tpu_torch.solvers import graphs

    key = (len(xs), tuple(caps), float(tol))

    def pair(args):
        A, c = args
        c = _min_pair(A, c, tol, caps)
        return c, _min_active(c, tol)

    carry, active = graphs.run(("min_eig_start",) + key,
                               lambda args: _min_start(*args, tol, caps), (A_p, xs))
    for _ in range(max_pairs):
        if not bool(active.any()):
            break
        carry, active = graphs.run(("min_eig_pair",) + key, pair, (A_p, carry))
    xs, direction = graphs.run(("min_eig_end",) + key,
                               lambda args: _min_end(*args, tol, caps), (A_p, carry))
    return xs, carry[2], direction
