"""Fused fixed-rank block-AMEn solver for the IPM's KKT systems.

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

With ``config.set_fused_whole_solve(True)`` a solve of four or more sweeps
runs as ``solve_program``, the JAX package's whole-solve program
(``ttipm_tpu/solvers/fused.py:392-449``): the operators padded to bucketed
ranks as its device engine pads them, a warmup sweep, two peeled solving
sweeps, sweep pairs while the termination test holds (read once a pair)
and a finishing sweep, each sweep and pair a CUDA graph on the card
(``solvers/graphs.py``).

The sweep, the local solves and the split steps are those of
``solvers/fused_batch.py``, run on a batch of one.  Local KKT block
elimination: dZ is eliminated elementwise through the projected identity
diagonal, Lz is Cholesky-factored (K4, ``panel_cholesky``), and the Y
Schur system is LU-solved.  With inequality constraints (``ineq``) dX is
eliminated through L_Z as well and the coupled (dY, dT) system is solved by
a second Schur step over the T block D (LU, as the host engine factors it
where the JAX device engine takes a QR).  The projected blocks of a local
solve come from one K1 launch: four on the equality path, six with
inequalities.

Under the float32 profile the local solves are mixed-precision
(``config.mixed_local``, ``fused_host.py:177-254``): "f64" runs the
Schur chain in f64 on upcast operands (the kernels' f64 instances),
"refine" factors in f32 and adds two f64-residual corrections, "off" is
all f32.  The global residual and the refinement residuals are formed in
f64 in every mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ttipm_tpu_torch import config, trace
from ttipm_tpu_torch.ops.linalg import qr_econ, svd_econ
from ttipm_tpu_torch.solvers import fused_algebra as fa
from ttipm_tpu_torch.solvers import fused_batch as fb
from ttipm_tpu_torch.solvers.amen import (
    AmenRestartsExhausted,
    AmenToleranceReached,
    ladder_rank_cap,
)

__all__ = ["tt_block_amen_fused", "tt_restarted_block_amen_fused", "solve_program",
           "fused_residual_norm", "prep_operator", "prep_rhs"]

TINY = 1e-300
_KEY_MAP = {"00": (0, 0), "01": (0, 1), "12": (1, 2), "21": (2, 1), "22": (2, 2),
            "31": (3, 1), "33": (3, 3)}


# ---------------------------------------------------------------------------
# Global residual ||b - Ax|| by direct multi-train contraction:
# ||b-Ax||^2 = sum_i [ <b_i,b_i> - 2 sum_t <b_i, t> + sum_{t,t'} <t,t'> ]
# over the row terms t = A_ij x_j (no TT arithmetic, no rounding).
# ---------------------------------------------------------------------------

def _train_dot(tr1, tr2):
    """<tr1, tr2> accumulated in f64: the residual expansion subtracts
    near-equal O(|b|^2) terms, and in f32 it could not resolve a relative
    residual below ~sqrt(eps32) = 3e-4, where the ladder's acceptance
    thresholds are."""
    rho = tr1[0].new_ones((1, 1), dtype=torch.float64)
    for c1, c2 in zip(tr1, tr2):
        rho = torch.einsum("ab,amA,bmB->AB", rho, c1.double(), c2.double())
    return rho[0, 0]


def fused_residual_norm(A, b, x_cores, ineq: bool = False) -> float:
    with trace.span("kkt.residual"):
        block_pos = int(np.argmax([c.ndim for c in x_cores]))
        x_shared = [c for i, c in enumerate(x_cores) if i != block_pos]
        x_cols = []
        for j in range(fa.nrows(ineq)):
            cores = list(x_shared)
            cores.insert(block_pos, x_cores[block_pos][:, j])
            x_cols.append(cores)
        res_sq = x_cores[0].new_zeros((), dtype=torch.float64)
        for i, terms in enumerate(fa.row_terms(ineq)):
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


def _pad_train(cores, ranks):
    """Zero-pad a train's bond ranks to ``ranks`` (length d-1); exact."""
    d = len(cores)
    out = []
    for k, c in enumerate(cores):
        rl = 1 if k == 0 else ranks[k - 1]
        rr = 1 if k == d - 1 else ranks[k]
        pad = c.new_zeros((rl,) + tuple(c.shape[1:-1]) + (rr,))
        pad[:c.shape[0], ..., :c.shape[-1]] = c
        out.append(pad)
    return out


def _uniform_key_rank(cores) -> int:
    """One bucketed rank for every interior bond of a train."""
    if len(cores) <= 1:
        return 1
    return _bucket4(max(c.shape[-1] for c in cores[:-1]))


def prep_operator(block_A, ineq: bool = False, pad: bool = False) -> Dict[str, List[torch.Tensor]]:
    """Canonical operator keys; the ranks stay ragged.  ``pad``: every key
    but "12" zero-padded to one bucketed rank on all its bonds
    (``ttipm_tpu/solvers/fused.py:568-597``), so that structurally
    identical systems of a batch have equal shapes; "12", the identity
    block, stays rank 1 (its projected diagonal is inverted elementwise)."""
    out = {}
    for sk in fa.keys(ineq):
        cores = list(block_A[_KEY_MAP[sk]])
        if pad and sk != "12":
            cores = _pad_train(cores, [_uniform_key_rank(cores)] * (len(cores) - 1))
        out[sk] = cores
    return out


def prep_rhs(block_b, d: int, ref: torch.Tensor, ineq: bool = False,
             pad: bool = False) -> List[List[torch.Tensor]]:
    """Rows as a dense list; absent rows become rank-1 zero trains.
    ``pad``: every present row zero-padded to one bucketed rank
    (``ttipm_tpu/solvers/fused.py:600-618``)."""
    rows = []
    for i in range(fa.nrows(ineq)):
        row = block_b.get_row(i)
        if row is None:
            row = [ref.new_zeros((1, 4, 1)) for _ in range(d)]
        elif pad:
            row = _pad_train(list(row), [_uniform_key_rank(row)] * (d - 1))
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
        q, r = qr_econ(out[i].reshape(sh[0], -1).T)
        out[i] = q.T.reshape(-1, *sh[1:])
        prev = out[i - 1]
        out[i - 1] = (prev.reshape(-1, sh[0]) @ r.T).reshape(*prev.shape[:-1], -1)
    for k in range(d - 1):
        sh = out[k].shape
        u, s, vt = svd_econ(out[k].reshape(-1, sh[-1]))
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
            try:  # in f64, as the JAX package's (ttipm_tpu/solvers/fused.py:523,633)
                hi = config.cast_tree(list(x0), torch.float64)
                out = [c.to(ref.dtype) for c in _svd_retract(hi, caps)]
                # LAPACK raises where it fails; the card's Jacobi SVD gives NaN
                if all(bool(torch.isfinite(c).all()) for c in out):
                    return out
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
# Whole-solve program (``ttipm_tpu/solvers/fused.py:392-449``)
# ---------------------------------------------------------------------------

def _sweep_step(args, caps, kick: int, solve: bool, direction: int, ineq: bool):
    """One sweep of the state; returns the new state and the sweep's
    residual and update maxima, on the device."""
    A, b, st = args
    x, z, XAX, Xb, ZAX, Zb = (list(t) for t in st)
    res, dx = fb.sweep_dev(A, b, x, z, XAX, Xb, ZAX, Zb, caps, kick, solve, direction, ineq)
    return (x, z, XAX, Xb, ZAX, Zb), res, dx


def solve_program(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, term_tol: float, eps: float,
                  ineq: bool, caps_bck, caps_fwd, kick: int, dir0: int, max_pairs: int):
    """The whole fused AMEn solve of a batch of one, as the JAX package's
    ``_solve_program``: a warmup sweep at ``dir0`` (no solve), a solving
    sweep at -dir0 (which widens the bonds to caps + kick), one at dir0
    (which fixes the state's shapes), then sweep pairs (-dir0, dir0) while
    fewer than ``max_pairs`` ran and the pair's residual (the smaller of
    its two sweeps' maxima) is at or above ``term_tol`` and its update at or
    above ``eps``, then a finishing sweep at -dir0 (no solve).  Each sweep
    and each pair is a ``graphs.run`` step (a CUDA graph on the card); the
    host reads the loop's test once a pair.  Returns (x cores, res, dx,
    pairs run), res the loop's residual."""
    from ttipm_tpu_torch.solvers import graphs

    def caps(direction):
        return caps_bck if direction > 0 else caps_fwd

    key = (len(x_cores), tuple(caps_bck), tuple(caps_fwd), kick, ineq, dir0)

    def sweep(st, direction, solve):
        trace.count("kkt.sweeps")
        with trace.span("kkt.sweep"):
            return graphs.run(
                ("fused_sweep",) + key + (direction, solve),
                lambda args: _sweep_step(args, caps(direction), kick, solve, direction, ineq),
                (A, b, st))

    def pair(args):
        st, r1, d1 = _sweep_step(args, caps(-dir0), kick, True, -dir0, ineq)
        st, r2, d2 = _sweep_step((args[0], args[1], st), caps(dir0), kick, True, dir0, ineq)
        return st, torch.minimum(r1, r2), torch.minimum(d1, d2)

    st = tuple(list(t) for t in (x_cores, z_cores, XAX, Xb, ZAX, Zb))
    st, _, _ = sweep(st, dir0, False)    # warmup
    st, _, _ = sweep(st, -dir0, True)    # peel: widens the bonds to caps + kick
    st, res, dx = sweep(st, dir0, True)  # peel: the state's shapes are fixed from here
    # the termination test in the working dtype, as the device loop's
    tol_w, eps_w = (float(torch.tensor(v, dtype=config.dtype())) for v in (term_tol, eps))
    pairs = 0
    res_h, dx_h = torch.stack([res[0], dx[0]]).double().tolist()
    while pairs < max_pairs and res_h >= tol_w and dx_h >= eps_w:
        trace.count("kkt.sweeps", 2)
        with trace.span("kkt.sweep"):
            st, res, dx = graphs.run(("fused_pair",) + key, pair, (A, b, st))
            res_h, dx_h = torch.stack([res[0], dx[0]]).double().tolist()
        pairs += 1
    st, _, _ = sweep(st, -dir0, False)   # finisher: back to the caps
    return st[0], res_h, dx_h, pairs


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def tt_block_amen_fused(block_A, block_b, term_tol: float, R: int,
                        eps: float = 1e-12, nswp: int = 22, x0=None,
                        kick_rank: int = 2, verbose: bool = False, rng=None,
                        prepped=None, ineq: bool = False):
    """Fixed-rank fused block-AMEn solve of the IPM KKT system (with the dT
    row where ``ineq``); returns (x_cores, final_local_res).  ``rng``: numpy
    RandomState for the random starts (default numpy's global one)."""
    with trace.span("kkt.rung", R=R):
        rng = np.random if rng is None else rng
        bs = fa.nrows(ineq)
        first_row = next(iter(block_b.values()))
        d = len(first_row)
        ref = first_row[0]
        if prepped is not None:
            A, b = prepped
        else:
            # padded to bucketed ranks on the whole-solve path, as the JAX
            # package's device engine pads (``fused.py:790-795``)
            pad = config.fused_whole_solve()
            A = prep_operator(block_A, ineq, pad=pad)
            b = prep_rhs(block_b, d, ref, ineq, pad=pad)
        caps_bck = _bond_caps(d, R, bs, +1)
        caps_fwd = _bond_caps(d, R, bs, -1)
        direction = _x0_direction(x0, d, bs) or 1
        # the warm start is laid out as if the opposite sweep just finished
        x_cores = _prep_x0(x0, d, bs, caps_fwd if direction > 0 else caps_bck,
                           direction, rng, ref)
        block_pos = 0 if direction < 0 else d - 1
        z_cores = _prep_z0(d, bs, kick_rank, block_pos, rng, ref)

        # the sweep runs on a batch of one
        A, b, x_cores, z_cores = fb.batch_of_one((A, b, x_cores, z_cores))
        pA0, pz0, pb0 = fb.boundary_phis(ref, 1, ineq)
        XAX: List = [pA0] + [None] * (d - 1) + [dict(pA0)]
        Xb: List = [pb0] + [None] * (d - 1) + [list(pb0)]
        ZAX: List = [pz0] + [None] * (d - 1) + [dict(pz0)]
        Zb: List = [pb0] + [None] * (d - 1) + [list(pb0)]

        if config.fused_whole_solve() and nswp >= 4:
            x_cores, res, dx, pairs = solve_program(
                A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, term_tol, eps, ineq, caps_bck,
                caps_fwd, kick_rank, direction, max(0, (nswp - 4) // 2))
            if verbose:
                print(f"\t[fused R={R} whole] res {res:.3e} dx {dx:.3e} pairs {pairs}", flush=True)
            return [c[0] for c in x_cores], res

        last = False
        final_res = np.inf
        for swp in range(nswp + 1):
            solve = (swp > 0) and not last
            caps = caps_bck if direction > 0 else caps_fwd
            res_d, dx_d = (float(v[0]) for v in fb.sweep(
                A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps, kick_rank, solve, direction, ineq))
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
        return [c[0] for c in x_cores], final_res


def tt_restarted_block_amen_fused(block_A, block_b, rank_restriction: int,
                                  op_tol: float, termination_tol: float = 1e-3,
                                  eps: float = 1e-11, num_restarts: int = 3,
                                  inner_m: int = 10, x0=None,
                                  verbose: bool = False,
                                  refine_target: Optional[float] = None,
                                  rng=None, ineq: bool = False):
    """Restart ladder: the solve rank escalates per restart until a solve
    is accepted (strict: relative residual below ``termination_tol``;
    lenient: a tenfold reduction, taken once escalation stops paying).
    ``refine_target`` (absolute residual) enables residual-equation
    refinement of the accepted solution: solve ``A e = b - A x`` at the
    same rank and add ``e`` back while that clearly helps.  The residual
    ``b - A x`` is assembled and the correction added in f64 under the f32
    profile too; only the correction solve runs in the working dtype."""
    rng = np.random if rng is None else rng
    first_row = next(iter(block_b.values()))
    d = len(first_row)
    ref = first_row[0]
    bs = fa.nrows(ineq)
    pad = config.fused_whole_solve()
    with trace.span("kkt.prep"):
        A = prep_operator(block_A, ineq, pad=pad)
        b = prep_rhs(block_b, d, ref, ineq, pad=pad)

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
        from ttipm_tpu_torch.solvers.blocks import (
            cast_block_matrix, cast_block_vector, tt_block_train_add)

        with trace.span("kkt.refine"):
            rn = fused_residual_norm(A, b, x_cores, ineq)
            if not np.isfinite(rn) or rn <= refine_target:
                return x_cores, min(res, rn / max(rhs_norm0, 1e-300))
            prod_cache: dict = {}  # ALS warm starts across refine rounds
            prod_tol = max(0.01 * refine_target, config.clamp_eps(eps))
            work_dt = x_cores[0].dtype
            use_hi = work_dt != torch.float64
            A_hi = cast_block_matrix(block_A, torch.float64) if use_hi else block_A
            b_hi = cast_block_vector(block_b, torch.float64) if use_hi else block_b
            x_hi = config.cast_tree(x_cores, torch.float64)
            r_blk = b_hi - A_hi.block_product(x_hi, prod_tol, cache=prod_cache, rng=rng)
            rn = r_blk.norm
            for _ in range(2):
                if not np.isfinite(rn) or rn <= refine_target:
                    break
                r_work = cast_block_vector(r_blk, work_dt) if use_hi else r_blk
                try:
                    e_cores, _ = tt_block_amen_fused(
                        block_A, r_work, termination_tol, R, eps=eps, nswp=inner_m,
                        kick_rank=2, verbose=False, rng=rng,
                        prepped=(A, prep_rhs(r_work, d, ref, ineq, pad=pad)), ineq=ineq,
                    )
                    x_new = tt_block_train_add(
                        x_hi, config.cast_tree(e_cores, torch.float64), bs, eps)
                except (torch.linalg.LinAlgError, FloatingPointError):
                    break
                r_new = b_hi - A_hi.block_product(x_new, prod_tol, cache=prod_cache, rng=rng)
                rn_new = r_new.norm
                # keep only clear improvements
                if not np.isfinite(rn_new) or rn_new >= 0.5 * rn:
                    break
                if verbose:
                    print(f"\t[fused refine] res {rn:.3e} -> {rn_new:.3e}", flush=True)
                x_hi, rn, r_blk = x_new, rn_new, r_new
            return [c.to(work_dt) for c in x_hi], min(res, rn / max(rhs_norm0, 1e-300))

    x_cores, res = tt_block_amen_fused(
        block_A, block_b, termination_tol, R, eps=eps, nswp=inner_m, x0=x0,
        kick_rank=2, verbose=verbose, rng=rng, prepped=(A, b), ineq=ineq)
    if res < termination_tol:
        return refined(x_cores, res)
    rn = fused_residual_norm(A, b, x_cores, ineq)
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
            x0=x_cores, kick_rank=4, verbose=verbose, rng=rng, prepped=(A, b), ineq=ineq)
        rn_new = fused_residual_norm(A, b, x_new, ineq)
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
    trace.count("kkt.ladder_exhausted")
    raise AmenRestartsExhausted(
        f"restart budget exhausted, relative error {rn / rhs_norm0:.3e}; "
        "consider raising the rank ceiling")
