"""Jacobi SVD and symmetric eigendecomposition: the port's dense
factorizations on the card.

Counterpart of ``ttipm_tpu/ops/jacobi.py``.  The JAX package sends every
f64 SVD and ``eigh`` of a TPU trace to one-sided Jacobi (``jacobi_svd``,
core ``_jacobi_orthogonalise`` ``:121``) and two-sided cyclic Jacobi
(``jacobi_eigh``, core ``_jacobi_eigh_core`` ``:370``), each one device
program; the CPU keeps LAPACK (``_use_jacobi`` ``:483-496``).  The port
does the same by device (``use_jacobi``): CUDA tensors take the Jacobi
pipelines here, whose cores are the hand-written kernels J1
(``kernels.jacobi_orthogonalise``, ``csrc/jacobi_svd.cu``) and J2
(``kernels.jacobi_eigh_core``, ``csrc/jacobi_eigh.cu``); CPU tensors keep
``torch.linalg`` (``ops/linalg.py``).  ``forced(True)`` sends CPU tensors
through the pipelines too (the cores' plain versions below: the tests),
``forced(False)`` sends CUDA tensors to cuSOLVER (comparisons only).  The
JAX package's ``safe_svd``, ``fast_split_svd`` and ``safe_eigh`` are
``ops/linalg.py``'s, which ask ``use_jacobi`` and call the pipelines here.

A factorization decides its convergence on the device and never raises:
an instance that is not finite, or whose off-diagonal mass is still above
the tolerance after ``MAX_SWEEPS`` sweeps, comes out as NaN (every factor),
and the solver's finiteness guards reject it; the other instances of a
batch are untouched.  Operands carry a leading batch axis (B, m, n); an
instance gets the same bits in any batch (one CTA, or one cluster, an
instance; short reductions taken an instance at a time on the card).

The plain versions run the JAX package's schedule (``_round_robin``), its
rotation rules (``_svd_rotations`` and the eigh rule of
``_jacobi_eigh_core``), its tolerance (``_tol_for``) and its stop test.
J1 and J2 have two regimes each by order (``kernels.j1_plan``,
``kernels.j2_plan``), each with its plain version: the element rule
(``orthogonalise_plain``, ``eigh_core_plain``) and, from
``kernels.J1_BLOCK_FROM`` / ``J2_BLOCK_FROM`` on, a two-level (block) Jacobi
whose inner sweeps apply the same rule to pairs of blocks of 16 indices
(``orthogonalise_block_plain`` on the slots' Gram matrices,
``eigh_block_plain``).
The deliberate deviations (ROADMAP "Deliberate deviations"):

* a rotation whose tau is exactly 0 turns by 45 degrees (t = 1, Golub and
  Van Loan's ``symSchur2``), where ``jnp.sign(0) = 0`` leaves the pair
  unrotated and the sweep cap reached;
* J2's rotation threshold scales (a_ij + a_ji) / 2 by max(sqrt(|a_ii
  a_jj|), 1e-2 max |a|) (``eigh_core_plain``), J1's scales <wi, wj> by
  max(|wi| |wj|, 1e-16 max_k |w_k|^2) (``orthogonalise_plain``), and both
  stop after a sweep without a rotation, where the JAX package measures
  the matrix after each sweep: with the JAX rules a null space, columns
  of rounding noise or a pair at the threshold kept sweeps going to the
  cap in the maxcut d10 solve, which here means NaN;
* the block regimes rotate a pair within a block once an outer step, and
  normalise the columns of each pair of blocks' U before the outer
  products (``orthogonalise_block_plain``, ``eigh_block_plain``); J1's
  inner sweep rotates the Gram matrix of the slot's columns, formed afresh
  each outer step; eigvalsh skips V;
* the f32 pre-rotation of the tall pipeline (``:172-181``, ``:190``) and
  ``jacobi_svd_fast`` (``:234-256``) exist because the TPU emulates f64;
  the port rotates r2^T, r2 from a second QR of r^T, instead of r
  (``_factor_tall``: the same SVD in fewer sweeps from the identity), and
  ``fast_split_svd`` keeps the exact
  ``jacobi_svd`` contract.  f32 operands are upcast to f64 by
  ``ops/linalg.py`` (``config.in_f64``), not sent to a Gram split.

Shape rules (by shape alone, counted in ``kernels.STATS[...].outside``):
an SVD whose even-padded small dimension exceeds ``kernels.J1_MAX_N``
goes whole to ``torch.linalg.svd``, an ``eigh`` of even-padded order above
``kernels.J2_MAX_N`` to ``torch.linalg.eigh``, and a QR of the tall
pipeline outside K3's envelope (512 x 128) to ``torch.linalg.qr``.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch

from ttipm_tpu_torch.ops import kernels

__all__ = ["TINY", "MAX_SWEEPS", "tol_for", "round_robin", "svd_rotations", "eigh_rotations",
           "orthogonalise_plain", "orthogonalise_block_plain", "eigh_core_plain",
           "eigh_block_plain", "sort_eigenpairs",
           "jacobi_svd", "jacobi_eigh", "force_jacobi", "forced", "use_jacobi", "settings"]

# The JAX package's guard for its f64 emulation (``ttipm_tpu/ops/jacobi.py:46``),
# kept: it sets the zero-column and zero-diagonal limits of the stop tests.
TINY = 1e-30
_JACOBI_TOL = 4e-14
MAX_SWEEPS = 26
# J2's floor of the scale an off-diagonal entry is measured against, as a
# fraction of max |a| of the input (``eigh_core_plain``).
EIGH_FLOOR = 1e-2
# J1's floor of the scale a column pair's inner product is measured
# against, as a fraction of the input's largest squared column norm
# (``orthogonalise_plain``).
SVD_FLOOR = 1e-16


def tol_for(n: int) -> float:
    """Relative off-diagonal target of an order-n (even) f64 core
    (``_tol_for``, ``:63``)."""
    return max(_JACOBI_TOL, n * 4e-16)


@functools.lru_cache(maxsize=64)
def round_robin(n: int):
    """(n-1, n/2) round-robin pairs (ii, jj) for even n (``_round_robin``,
    ``:70-82``): every unordered pair meets once a sweep, the pairs of a
    step are disjoint.  Position p of step k holds index
    ``1 + (p - 1 - k) mod (n - 1)`` (position 0 holds 0); the kernels use
    that closed form."""
    assert n % 2 == 0
    arr = list(range(n))
    ii, jj = [], []
    for _ in range(n - 1):
        ii.append(arr[: n // 2])
        jj.append(arr[n // 2:][::-1])
        arr = [arr[0]] + [arr[-1]] + arr[1:-1]
    return ii, jj


def _schedule(n, device):
    ii, jj = round_robin(n)
    return (torch.tensor(ii, dtype=torch.long, device=device),
            torch.tensor(jj, dtype=torch.long, device=device))


def _angle(tau):
    """(cos, sin) of the rotation with tangent t = sign(tau) / (|tau| +
    sqrt(1 + tau^2)), sign(0) = +1; a tau that overflows gives t = 0."""
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    cs = 1.0 / torch.sqrt(1.0 + t * t)
    return cs, cs * t


def svd_rotations(a, b, c, tol, floor):
    """One-sided rotation (cs, sn) of the column pairs with Gram entries
    a = <wi,wi>, b = <wj,wj>, c = <wi,wj> (``_svd_rotations``, ``:102-118``),
    taken where |c| > tol max(sqrt(|a b|), floor); and whether it is taken
    (|a b|: a Gram diagonal updated by rotations, as the block regime's
    inner sweep has it, may round below 0)."""
    rotate = torch.abs(c) > tol * torch.maximum(torch.sqrt(torch.abs(a * b)), floor)
    return (*_masked(rotate, (b - a) / (2.0 * torch.where(rotate, c, torch.ones_like(c)))),
            rotate)


def eigh_rotations(aii, ajj, bij, tol, floor):
    """Two-sided rotation (cs, sn) zeroing b_ij (``_jacobi_eigh_core``,
    ``:386-398``; Golub and Van Loan 8.4), taken where |b_ij| > tol
    max(sqrt(|a_ii a_jj|), floor, TINY); and whether it is taken."""
    scale = torch.clamp_min(torch.maximum(torch.sqrt(torch.abs(aii * ajj)), floor), TINY)
    rotate = torch.abs(bij) > tol * scale
    return (*_masked(rotate, (ajj - aii) / (2.0 * torch.where(rotate, bij, torch.ones_like(bij)))),
            rotate)


def _masked(rotate, tau):
    cs, sn = _angle(tau)
    return torch.where(rotate, cs, torch.ones_like(cs)), torch.where(rotate, sn, torch.zeros_like(sn))


def _rotate_columns(x, i, j, cs, sn):
    """x with columns i, j (index tensors of one step) replaced by
    cs x_i - sn x_j and sn x_i + cs x_j; cs, sn (..., h), x (..., rows,
    columns)."""
    xi, xj = x[..., i], x[..., j]
    cs, sn = cs[..., None, :], sn[..., None, :]
    out = x.clone()
    out[..., i] = cs * xi - sn * xj
    out[..., j] = sn * xi + cs * xj
    return out


def _sweeps(state, one_step, n):
    """Sweeps of ``one_step`` over the steps of the round robin of order n
    on every instance not yet converged, at most MAX_SWEEPS: an instance
    has converged after a sweep in which no pair was rotated (every pair
    below its threshold, judged on the numbers the rotations read; the
    matrix is then unchanged).  ``one_step(state, ii, jj)`` takes step k's
    pairs (ii[k], jj[k]) and returns the new state, which instances rotated
    a pair and which met a non-finite number.  Returns the state, whether
    each instance failed (a non-finite number in its last sweep, or
    rotations still in its MAX_SWEEPS-th) and its sweeps."""
    B = state[0].shape[0]
    dev = state[0].device
    ii, jj = _schedule(n, dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(MAX_SWEEPS):
        if not bool(active.any()):
            break
        new, rotated, bad = state, torch.zeros_like(active), torch.zeros_like(active)
        for k in range(n - 1):
            new, rot_k, bad_k = one_step(new, ii[k], jj[k])
            rotated, bad = rotated | rot_k, bad | bad_k
        keep = active.reshape(B, *([1] * (state[0].dim() - 1)))
        state = tuple(torch.where(keep, s_new, s) for s_new, s in zip(new, state))
        count += active.to(count.dtype)
        failed = torch.where(active, bad | rotated, failed)
        active = active & rotated & ~bad
    return state, failed, count


def _nan_where(bad, *tensors):
    return tuple(torch.where(bad.reshape(-1, *([1] * (t.dim() - 1))), float("nan"), t)
                 for t in tensors)


def orthogonalise_plain(w, sweeps=False):
    """Plain version of J1 (``_jacobi_orthogonalise``, ``:121-170``): the
    columns of each instance of ``w`` (B, n, n), n even, rotated to mutual
    orthogonality.  Returns (w @ v, v exactly orthonormal, the squared
    column norms of w @ v); NaN where an instance did not converge.  With
    ``sweeps``, each instance's sweeps too.

    A pair's inner product is measured against max(sqrt(<wi,wi> <wj,wj>),
    SVD_FLOOR s0), s0 the input's largest squared column norm, where the
    JAX package takes sqrt(<wi,wi> <wj,wj>) alone: columns of the rounding
    noise of a rank-deficient operand are nearly parallel, and rotating
    them against each other can keep their cosines near 1 past the sweep
    cap (NaN here; without the floor the maxcut d10 solve diverges on the
    card, ``tools/jacobi_census.py --svd-floor 0``), where their
    orthogonality moves no singular value by more than 1e-16 of the
    largest.  Pairs with sqrt(<wi,wi> <wj,wj>) above the floor keep the
    relative test.  The sweeps stop after one without a rotation (see
    ``_sweeps``), where the JAX package stops when the Gram matrix formed
    after a sweep passes the same test: the two computations of <wi, wj>
    round differently, and a pair within their difference of the threshold
    would be neither rotated nor passed, sweep after sweep."""
    B, _, n = w.shape
    tol = tol_for(n)
    v0 = torch.eye(n, dtype=w.dtype, device=w.device).expand(B, n, n)
    floor = SVD_FLOOR * (w * w).sum(1).amax(dim=1, keepdim=True)

    def one_step(state, i, j):
        w, v = state
        wi, wj = w[:, :, i], w[:, :, j]
        a, b, c = (wi * wi).sum(1), (wj * wj).sum(1), (wi * wj).sum(1)
        cs, sn, rotate = svd_rotations(a, b, c, tol, floor)
        bad = ~torch.isfinite(a + b + c).all(dim=1)
        return ((_rotate_columns(w, i, j, cs, sn), _rotate_columns(v, i, j, cs, sn)),
                rotate.any(dim=1), bad)

    (w, v), failed, count = _sweeps((w, v0), one_step, n)
    out = _nan_where(failed, w, v, (w * w).sum(1))
    return (*out, count) if sweeps else out


def _inner_sweep(s, rule):
    """One sweep of the element rule on each tile of s (B, slots, m, m),
    the block regimes' inner problem (csrc/jacobi.cuh::inner_sweep): the
    product U of its rotations, whether a pair rotated and whether one met a
    non-finite number, per slot.  ``rule(a_ii, a_jj, b_ij)`` gives (cs, sn,
    rotate) of a step's pairs, b_ij = (a_ij + a_ji) / 2.  A step's rotations
    (the pairs cover the tile) as one orthogonal G: S <- G^T S G, U <- U G."""
    m, dev = s.shape[-1], s.device
    ii, jj = _schedule(m, dev)
    u = torch.eye(m, dtype=s.dtype, device=dev).expand_as(s)
    rotated = torch.zeros(s.shape[:2], dtype=torch.bool, device=dev)
    bad = torch.zeros_like(rotated)
    for k in range(m - 1):
        i, j = ii[k], jj[k]
        aii, ajj, bij = s[..., i, i], s[..., j, j], 0.5 * (s[..., i, j] + s[..., j, i])
        cs, sn, rotate = rule(aii, ajj, bij)
        rotated = rotated | rotate.any(-1)
        bad = bad | ~torch.isfinite(aii + ajj + bij).all(-1)
        g = torch.zeros_like(s)
        g[..., i, i] = cs
        g[..., j, j] = cs
        g[..., i, j] = sn
        g[..., j, i] = -sn
        s = g.mT @ (s @ g)
        u = u @ g
    # a rotation whose t^2 is below half an ulp of 1 keeps c = 1 and so
    # lengthens its columns by t^2: the inner sweeps rotate an index some
    # 2n times a sweep, twice the element rule's, and V <- V U would add
    # those lengths up; unit columns leave rounding alone
    return u / torch.linalg.vector_norm(u, dim=-2, keepdim=True), rotated, bad


def _block_perm(bi, bj, block):
    """The indices of the slots of an outer step in order (slot s: block
    bi[s], then block bj[s])."""
    offsets = torch.arange(block, device=bi.device)
    return ((torch.stack([bi, bj], 1) * block)[:, :, None] + offsets).reshape(-1)


def orthogonalise_block_plain(w, sweeps=False):
    """Plain version of J1's block regime (``csrc/jacobi_svd.cu``, the
    orders ``kernels.j1_plan`` gives it): two-level one-sided Jacobi of each
    instance of ``w`` (B, n, n), n even, with blocks of ``kernels.J1_BLOCK``
    (16) columns.  Returns what ``orthogonalise_plain`` returns.

    The n columns are cut into nb = ceil(n / block) blocks, the last one
    ragged, and nb is rounded up to even with an empty block (here: W
    padded with zero columns, which never rotate).  An outer sweep runs the
    round robin of order nb over the blocks; its step pairs them into nb / 2
    slots (P, Q).  Each slot's Gram matrix G = [W_P W_Q]^T [W_P W_Q] gets one
    cyclic sweep of the element rule (the round robin of order 2 block,
    ``svd_rotations`` on a = g_ii, b = g_jj, c = (g_ij + g_ji) / 2 with
    tol_for(n) and the floor SVD_FLOOR times the input's largest squared
    column norm: J1's rule on the Gram entries), whose rotations multiply
    into an orthogonal U of the slot; then [W_P W_Q] <- [W_P W_Q] U and
    [V_P V_Q] <- [V_P V_Q] U (the kernel's products on the tensor cores).
    The outer sweeps stop after one in which no inner sweep rotated, at most
    MAX_SWEEPS (see ``_sweeps``); an instance that still rotated in the
    last, or met a non-finite number, comes out NaN.  After a sweep without
    a rotation every pair of columns has met, in some slot, on W as it now
    is, so the stop test is the element one on Gram entries formed afresh
    each outer step."""
    B, n, _ = w.shape
    block = kernels.J1_BLOCK
    nb = -(-n // block)
    nb += nb % 2
    m, npad, slots = 2 * block, nb * block, nb // 2
    dev = w.device
    tol = tol_for(n)
    floor = SVD_FLOOR * (w * w).sum(1).amax(dim=1)[:, None, None]
    w0 = torch.zeros((B, n, npad), dtype=w.dtype, device=dev)
    w0[:, :, :n] = w
    v0 = torch.eye(npad, dtype=w.dtype, device=dev).expand(B, npad, npad)

    def rule(a, b, c):
        return svd_rotations(a, b, c, tol, floor)

    def one_step(state, bi, bj):
        x, v = state
        perm = _block_perm(bi, bj, block)
        xp = x[:, :, perm].reshape(B, n, slots, m)
        u, rotated, bad = _inner_sweep(torch.einsum("bnsi,bnsj->bsij", xp, xp), rule)
        x = x.clone()
        x[:, :, perm] = torch.einsum("bnsk,bskl->bnsl", xp, u).reshape(B, n, npad)
        v = v.clone()
        v[:, :, perm] = torch.einsum("bnsk,bskl->bnsl",
                                     v[:, :, perm].reshape(B, npad, slots, m), u).reshape(B, npad, npad)
        return (x, v), rotated.any(1), bad.any(1)

    (x, v), failed, count = _sweeps((w0, v0), one_step, nb)
    x, v = x[:, :, :n], v[:, :n, :n]
    out = _nan_where(failed, x, v, (x * x).sum(1))
    return (*out, count) if sweeps else out


def eigh_core_plain(a, sweeps=False):
    """Plain version of J2 (``_jacobi_eigh_core``, ``:370-429``): cyclic
    two-sided Jacobi of each symmetric instance of ``a`` (B, n, n), n even.
    Returns (w ascending, v) with a = v diag(w) v^T; NaN where an instance
    did not converge.  With ``sweeps``, each instance's sweeps too.

    The rotation threshold measures b_ij = (a_ij + a_ji) / 2 against
    max(sqrt(|a_ii a_jj|), EIGH_FLOOR s0, TINY), s0 = max |a| of the input,
    where the JAX package takes a_ij and sqrt(|a_ii a_jj| + TINY): with a
    null space, the rounding noise (~eps s0) between two near-zero
    diagonals is far above tol sqrt(|a_ii a_jj|), so the JAX rule rotates
    it by large angles every sweep, which mixes back the couplings the
    other rotations remove, past the sweep cap for a matrix with a large
    null space.  The floor leaves noise below tol EIGH_FLOOR s0 = 4e-16 s0
    (at order 64 or less) unrotated; a floor of s0 itself (an absolute test
    at 4e-14 s0) leaves the maxcut d10 solve unconverged on the card
    (``tools/jacobi_census.py --eigh-floor 1``), as the eigen windows'
    step-size decisions read their smallest eigenvalue.  The symmetric part keeps the test one number for both
    triangles, which rounding keeps apart by ~eps ||A||.  The sweeps stop
    after one without a rotation (see ``_sweeps`` and
    ``orthogonalise_plain``)."""
    B, n, _ = a.shape
    tol = tol_for(n)
    v0 = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
    floor = EIGH_FLOOR * a.abs().amax(dim=(1, 2))[:, None]

    def one_step(state, i, j):
        a, v = state
        aii, ajj, bij = a[:, i, i], a[:, j, j], 0.5 * (a[:, i, j] + a[:, j, i])
        cs, sn, rotate = eigh_rotations(aii, ajj, bij, tol, floor)
        bad = ~torch.isfinite(aii + ajj + bij).all(dim=1)
        a = _rotate_columns(a, i, j, cs, sn)
        a = _rotate_columns(a.mT, i, j, cs, sn).mT  # the rows: pairs disjoint
        return (a, _rotate_columns(v, i, j, cs, sn)), rotate.any(dim=1), bad

    (a, v), failed, count = _sweeps((a, v0), one_step, n)
    out = sort_eigenpairs(*_nan_where(failed, torch.diagonal(a, dim1=1, dim2=2), v))
    return (*out, count) if sweeps else out


def eigh_block_plain(a, sweeps=False):
    """Plain version of J2's block regime (``csrc/jacobi_eigh.cu``, the
    orders ``kernels.j2_plan`` gives it): two-level cyclic Jacobi of each
    symmetric instance of ``a`` (B, n, n), n even, with blocks of
    ``kernels.J2_BLOCK`` (16) indices.  Returns what ``eigh_core_plain``
    returns.

    The n indices are cut into nb = ceil(n / block) blocks, the last one
    ragged, and nb is rounded up to even with an empty block (here: the
    matrix padded with zero rows and columns, which never rotate).  An
    outer sweep runs the round robin of order nb over the blocks; its step
    pairs them into nb / 2 slots (P, Q).  Each slot's 2 block x 2 block
    diagonal tile A[P u Q, P u Q] gets one cyclic sweep of the element rule
    (the round robin of order 2 block, ``eigh_rotations`` with tol_for(n)
    and the floor EIGH_FLOOR max |a|), whose rotations multiply into an
    orthogonal U of the slot; then A <- W^T A W and V <- V W, W the block
    diagonal of the slots' U (the kernel's products on the tensor cores).
    The outer sweeps stop after one in which no inner sweep rotated, at
    most MAX_SWEEPS (see ``_sweeps``); an instance that still rotated in the
    last, or met a non-finite number, comes out NaN.  The stop test is the
    element one: after a sweep without a rotation every pair of indices has
    met, in some slot, on the matrix as it now is."""
    B, n, _ = a.shape
    block = kernels.J2_BLOCK
    nb = -(-n // block)
    nb += nb % 2
    m, npad, slots = 2 * block, nb * block, nb // 2
    dev = a.device
    tol = tol_for(n)
    floor = EIGH_FLOOR * a.abs().amax(dim=(1, 2))[:, None, None]
    x0 = torch.zeros((B, npad, npad), dtype=a.dtype, device=dev)
    x0[:, :n, :n] = a
    v0 = torch.eye(npad, dtype=a.dtype, device=dev).expand(B, npad, npad)

    def rule(aii, ajj, bij):
        return eigh_rotations(aii, ajj, bij, tol, floor)

    def one_step(state, bi, bj):
        x, v = state
        perm = _block_perm(bi, bj, block)
        xp = x[:, perm][:, :, perm].reshape(B, slots, m, slots, m)
        u, rotated, bad = _inner_sweep(torch.diagonal(xp, dim1=1, dim2=3).permute(0, 3, 1, 2),
                                       rule)
        xp = torch.einsum("bsitk,btkl->bsitl", xp, u)  # the columns: A W
        xp = torch.einsum("bski,bsktl->bsitl", u, xp)  # the rows: W^T (A W)
        x = x.clone()
        x[:, perm[:, None], perm] = xp.reshape(B, npad, npad)
        v = v.clone()
        v[:, :, perm] = torch.einsum("bnsk,bskl->bnsl",
                                     v[:, :, perm].reshape(B, npad, slots, m), u).reshape(B, npad, npad)
        return (x, v), rotated.any(1), bad.any(1)

    (x, v), failed, count = _sweeps((x0, v0), one_step, nb)
    w = torch.diagonal(x, dim1=1, dim2=2)[:, :n]
    out = sort_eigenpairs(*_nan_where(failed, w, v[:, :n, :n]))
    return (*out, count) if sweeps else out


def sort_eigenpairs(w, v):
    """Eigenvalues ascending and their vectors, ties in index order."""
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(v, -1, order[:, None, :].expand_as(v)))


# ---------------------------------------------------------------------------
# The pipelines around the cores
# ---------------------------------------------------------------------------

def _each(fn, x):
    """``fn`` on each instance of ``x`` as a batch of one on the card
    (ATen's reductions sum an instance in another order at another batch
    size), on the whole batch on the CPU."""
    if x.shape[0] == 1 or not x.is_cuda:
        return fn(x)
    return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])


def _qr(x):
    """Reduced QR of each instance of ``x`` (B, m, n), m >= n: K3 inside
    its envelope, ``torch.linalg.qr`` outside it (counted)."""
    m, n = x.shape[1:]
    if m > kernels.K3_MAX_M or n > kernels.K3_MAX_N:
        kernels.STATS["panel_qr"].outside += 1
        return torch.linalg.qr(x, mode="reduced")
    if x.shape[0] == 1:
        q, r = kernels.panel_qr(x[0])
        return q[None], r[None]
    return kernels.panel_qr_batch(x)


def _scale(a):
    """max |a| of each instance, 1 where it is 0 or not finite."""
    s = a.abs().amax(dim=(1, 2))
    return torch.where(torch.isfinite(s) & (s > 0), s, torch.ones_like(s))


def _factor_tall(t):
    """The tall pipeline of each instance of ``t`` (B, m, n), m >= n, after
    ``_jacobi_factor_tall`` (``:183-205``): t / scale = q r (K3), r^T = q2
    r2 (K3), so t / scale = q r2^T q2^T; J1 rotates the columns of r2^T
    (padded to even order with a zero row and column, which no rotation
    touches and which sorts last): r2^T v = w, so t / scale = q w z^T with
    z = q2 v exactly orthonormal and w's columns orthogonal, ordered by
    descending norm.  Returns (q, z, w, the squared norms of w's columns,
    scale).  (The JAX package rotates r after an f32 pre-rotation.  The
    Gram matrix r2 r2^T of J1's operand is two QR steps past t^T t, so the
    cyclic sweeps start closer to their quadratic phase: graded operands of
    the f32 d8 solve that took past the cap on r converge within it.)"""
    B, m, n = t.shape
    scale = _scale(t)
    q, r = _qr(t / scale[:, None, None])
    q2, r2 = _qr(r.mT)
    x = r2.mT
    if n % 2:
        x = torch.nn.functional.pad(x, (0, 1, 0, 1))
    w, v, norms2 = kernels.jacobi_orthogonalise(x.contiguous())
    order = torch.argsort(-norms2, dim=-1, stable=True)[:, :n]
    w_s = torch.gather(w[:, :n], 2, order[:, None, :].expand(B, n, n))
    v_s = torch.gather(v[:, :n], 2, order[:, None, :].expand(B, n, n))
    return q, q2 @ v_s, w_s, torch.gather(norms2, 1, order), scale


def _batched(a):
    return a.reshape(-1, *a.shape[-2:])


def jacobi_svd(a):
    """``u, s, vt`` of each instance of ``a`` (..., m, n) (``jacobi_svd``,
    ``:208-231``): u @ (s[:, None] * vt) == a to arithmetic precision, u
    exactly orthonormal in both orientations (for a tall input the
    Householder completion of the rotated columns, K3; for a wide one the
    rotation product), s descending, vt rows unit-normalised and zero at s
    == 0 (not orthonormal completions).  Outside J1's envelope the whole
    SVD is ``torch.linalg.svd`` (counted)."""
    lead, (m, n) = a.shape[:-2], a.shape[-2:]
    k = min(m, n)
    if k == 0 or k + k % 2 > kernels.J1_MAX_N:
        kernels.STATS["jacobi_svd"].outside += 1
        return torch.linalg.svd(a, full_matrices=False)
    x = _batched(a)
    if m >= n:
        # a / scale = q w z^T = (q qw) (rw z^T)
        q, z, w, _, scale = _factor_tall(x)
        qw, rw = _qr(w)
        u = q @ qw
        s = _each(lambda t: torch.linalg.vector_norm(t, dim=2), rw)
        vt = (rw @ z.mT) / torch.clamp_min(s, TINY)[:, :, None]
    else:
        # a^T / scale = q w z^T, so a / scale = z (q w)^T
        q, z, w, norms2, scale = _factor_tall(x.mT)
        u = z
        s = torch.sqrt(norms2)
        vt = (q @ w).mT / torch.clamp_min(s, TINY)[:, :, None]
    s = s * scale[:, None]
    return u.reshape(*lead, m, k), s.reshape(*lead, k), vt.reshape(*lead, k, n)


def jacobi_eigh(a, vectors=True):
    """Eigenvalues ascending and eigenvectors of each symmetric instance of
    ``a`` (..., n, n) (``jacobi_eigh``, ``:431-452``); with ``vectors``
    false the eigenvalues alone (J2 without V: the same bits).  An odd
    order is padded with a decoupled zero row and column, and the
    eigenpair whose vector is e_n is dropped: that index never rotates, so
    its value is an exact zero, and the stable sort puts it after every
    other zero, where the values-only call finds it.  Outside J2's envelope
    ``torch.linalg.eigh`` (counted)."""
    lead, n = a.shape[:-2], a.shape[-1]
    if n == 0 or n + n % 2 > kernels.J2_MAX_N:
        kernels.STATS["jacobi_eigh"].outside += 1
        return torch.linalg.eigh(a) if vectors else (torch.linalg.eigh(a)[0], None)
    x = _batched(a)
    scale = _scale(x)
    an = x / scale[:, None, None]
    if n % 2:
        an = torch.nn.functional.pad(an, (0, 1, 0, 1))
        w, v = kernels.jacobi_eigh_core(an, vectors=vectors)
        index = torch.arange(n + 1, device=a.device)
        if vectors:
            pad_col = torch.argmax(torch.abs(v[:, n, :]), dim=-1, keepdim=True)
        else:  # the last zero; index n of a NaN instance
            last_zero = torch.where(w == 0, index, -1).amax(dim=1, keepdim=True)
            pad_col = torch.where(last_zero >= 0, last_zero, n)
        keep = index[None, :n]
        keep = keep + (keep >= pad_col).to(keep.dtype)
        w = torch.gather(w, 1, keep)
        if vectors:
            v = torch.gather(v[:, :n], 2, keep[:, None, :].expand(x.shape[0], n, n))
    else:
        w, v = kernels.jacobi_eigh_core(an, vectors=vectors)
    w = w * scale[:, None]
    return w.reshape(*lead, n), (v.reshape(*lead, n, n) if vectors else None)


# ---------------------------------------------------------------------------
# The dispatch (``_use_jacobi``, ``force_jacobi``, ``forced``: ``:468-510``)
# ---------------------------------------------------------------------------

_FORCE_JACOBI = None  # None: by device (CUDA -> Jacobi); True / False: override


def force_jacobi(flag) -> None:
    """Force (True) or forbid (False) the Jacobi pipelines; None restores
    the choice by device."""
    global _FORCE_JACOBI
    _FORCE_JACOBI = flag


@contextmanager
def forced(flag):
    """Scoped ``force_jacobi``."""
    global _FORCE_JACOBI
    old = _FORCE_JACOBI
    _FORCE_JACOBI = flag
    try:
        yield
    finally:
        _FORCE_JACOBI = old


def use_jacobi(a: torch.Tensor) -> bool:
    """Whether ``a``'s factorization takes the Jacobi pipeline: float64
    operands on the card, or wherever it is forced; other types keep
    ``torch.linalg`` (as the JAX package sends non-f64 operands to the
    native path)."""
    if a.dtype != torch.float64:
        return False
    if _FORCE_JACOBI is not None:
        return bool(_FORCE_JACOBI)
    return a.is_cuda


def settings() -> tuple:
    """What changes the pipelines' results at equal operands: the route
    override (``force_jacobi``) and the kernels' regime crossovers
    (``kernels.J1_BLOCK_FROM``, ``kernels.J2_BLOCK_FROM``)."""
    return (_FORCE_JACOBI, kernels.J1_BLOCK_FROM, kernels.J2_BLOCK_FROM)
