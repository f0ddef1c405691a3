"""Batched seeds on one GPU: the fused AMEn KKT solve, the step-size
eigensolves and the predictor-corrector Newton step for B structurally
identical instances in lockstep.

Counterpart of ``ttipm_tpu/parallel/fused_mesh.py``, which stacks the
instances on a leading axis and runs ``jax.vmap`` of the single-instance
sweep programs over it, sharded over a device mesh.  The port stacks them
the same way and runs the batched sweep (``solvers/fused_batch.py``, which
the single solve runs as a batch of one) and the batched whole-eigen
program (``solvers/fused_eigen_batch.py``) on one device: one kernel launch of K1,
K2 and K3 per step for the whole batch, K4 one launch up to order 512
(``ops/kernels.py``), so the host's cost of a wrapper is paid once per
batch.  Termination is lockstep: every instance sweeps until the worst one
converges.

Per instance the solve is the port's single engine (LU for the Schur
systems), where the JAX batch runs its padded device engine (QR for them);
the random starts are the JAX package's streams: one
``np.random.RandomState(seed)`` for all starts of a solve, instance by
instance (x then z), and numpy's global stream for the eigenvector starts.

``mesh``: the drivers take ``mesh=None`` only; a device mesh over
``torch.distributed`` is a later slice (``make_mesh`` comes with it).
``shard_kkt`` is accepted and has no effect without a mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.solvers import fused as _fused
from ttipm_tpu_torch.solvers import fused_algebra as fa
from ttipm_tpu_torch.solvers import fused_batch as fb
from ttipm_tpu_torch.solvers import fused_eigen as _fe
from ttipm_tpu_torch.solvers.fused_eigen_batch import gen_eigen_program

__all__ = ["tt_block_amen_fused_batch", "tt_step_sizes_batch", "tt_newton_step_batch"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet: parallel/mesh.py over torch.distributed is a "
            "later slice; pass mesh=None (one device, the batch in lockstep)")


def _stack(trains):
    """Per-instance lists of cores -> one list of (B, ...) cores."""
    return [torch.stack(cores) for cores in zip(*trains)]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def tt_block_amen_fused_batch(
    block_As: Sequence,
    block_bs: Sequence,
    R: int,
    ineq: bool,
    mesh=None,
    term_tol: float = 1e-3,
    eps: float = 1e-12,
    nswp: int = 22,
    kick_rank: int = 2,
    seed: Optional[int] = 0,
    shard_kkt: bool = True,
    verbose: bool = False,
    x0s: Optional[Sequence] = None,
) -> Tuple[List[list], np.ndarray]:
    """Solve a batch of structurally identical KKT systems in lockstep.

    Per instance the semantics of ``solvers/fused.py::tt_block_amen_fused``
    (fixed rank R, AMEn enrichment, the never-regress local guard) on the
    padded operator and rhs.  Systems whose padded shapes differ raise
    ``ValueError``.  Returns (per-instance x cores, per-instance final
    local residuals; inf where no solving sweep ended the solve)."""
    _no_mesh(mesh)
    if len(block_As) != len(block_bs) or not block_As:
        raise ValueError(f"{len(block_As)} operators and {len(block_bs)} right-hand sides: "
                         "one of each an instance, at least one instance")
    nb = len(block_As)
    bs = fa.nrows(ineq)
    first_row = next(iter(block_bs[0].values()))
    d = len(first_row)
    ref = first_row[0]
    rng = np.random.RandomState(seed)

    preps = [(_fused.prep_operator(A_blk, ineq, pad=True),
              _fused.prep_rhs(b_blk, d, ref, ineq, pad=True))
             for A_blk, b_blk in zip(block_As, block_bs)]
    shapes0 = _shapes(preps[0])
    if any(_shapes(p) != shapes0 for p in preps[1:]):
        raise ValueError("batched fused solve needs structurally identical systems "
                         "(same d, block ranks after bucketing); got a mismatch")

    caps_bck = _fused._bond_caps(d, R, bs, +1)
    caps_fwd = _fused._bond_caps(d, R, bs, -1)
    direction = 1
    xs, zs = [], []
    for i in range(nb):
        x0_i = x0s[i] if x0s is not None else None
        xs.append(_fused._prep_x0(x0_i, d, bs, caps_fwd, direction, rng, ref))
        zs.append(_fused._prep_z0(d, bs, kick_rank, d - 1, rng, ref))

    A = {k: _stack([p[0][k] for p in preps]) for k in fa.keys(ineq)}
    b = [_stack([p[1][i] for p in preps]) for i in range(bs)]
    x_cores, z_cores = _stack(xs), _stack(zs)
    pA0, pz0, pb0 = fb.boundary_phis(ref, nb, ineq)
    XAX = [pA0] + [None] * (d - 1) + [dict(pA0)]
    Xb = [pb0] + [None] * (d - 1) + [list(pb0)]
    ZAX = [pz0] + [None] * (d - 1) + [dict(pz0)]
    Zb = [pb0] + [None] * (d - 1) + [list(pb0)]

    last = False
    final_res = np.full(nb, np.inf)
    for swp in range(nswp + 1):
        solve = (swp > 0) and not last
        caps = caps_bck if direction > 0 else caps_fwd
        res, dx = fb.sweep(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps, kick_rank, solve,
                           direction, ineq)
        if last:
            break
        worst_res, worst_dx = (float(res.max()), float(dx.max())) if solve else (np.inf, np.inf)
        if worst_res < term_tol or worst_dx < eps or swp == nswp - 2:
            last = True
            final_res = res if solve else final_res
        if verbose:
            print(f"\t[fused-batch R={R}] sweep {swp}: worst res {worst_res:.3e}", flush=True)
        direction *= -1

    return [[c[i] for c in x_cores] for i in range(nb)], final_res


def tt_step_sizes_batch(
    pencils: Sequence[Tuple[list, list]],
    mesh=None,
    R: int = 8,
    tol: float = 1e-8,
    nswp: int = 10,
    x0s: Optional[Sequence] = None,
) -> Tuple[np.ndarray, List[list]]:
    """Largest ``alpha_i`` with ``A_i + alpha_i * Delta_i`` PSD for a batch
    of pencils of one structure (same d, n), with the single driver's
    unconverged-solve penalty per instance.  The operators of all instances
    are padded to the batch's common bucketed rank; fresh eigenvector
    starts come from numpy's global stream.  Returns (steps[nb], the
    normalised eigenvector trains)."""
    from ttipm_tpu_torch.ops.tt import tt_normalise

    _no_mesh(mesh)
    if not pencils:
        raise ValueError("no pencils")
    nb = len(pencils)
    d = len(pencils[0][0])
    n = pencils[0][0][0].shape[1]
    edt = config.eigen_dtype()

    def common_ra(trains):
        if d == 1:
            return 1
        return max(_fused._bucket4(max(c.shape[-1] for c in t[:-1])) for t in trains)

    ra_A = common_ra([p[0] for p in pencils])
    ra_D = common_ra([p[1] for p in pencils])
    A_b = _stack([_fe._prep_operator(p[0], ra=ra_A) for p in pencils])
    D_b = _stack([_fe._prep_operator(p[1], ra=ra_D) for p in pencils])
    caps = _fe._vec_caps(d, R, n)
    ref = pencils[0][0][0]
    x_b = _stack([_fe._prep_vec(x0s[i] if x0s is not None else None, d, n, caps, np.random, ref)
                  for i in range(nb)])
    alpha0 = torch.ones(nb, dtype=edt, device=ref.device)
    xs_out, alphas, res, scales = gen_eigen_program(A_b, D_b, x_b, alpha0, tol, caps,
                                                    max(nswp - 1, 1))
    alphas, res, scales = torch.stack([alphas, res, scales]).double().cpu().numpy()
    eps_dt = _fe._eps_floor()
    steps = np.zeros(nb)
    warm = []
    for i in range(nb):
        step = float(alphas[i])
        if not np.isfinite(step) or step < 0:
            step = 0.0
        tol_i = max(tol, 30.0 * eps_dt, 4.0 * eps_dt * float(scales[i]))
        if res[i] > tol_i and np.isfinite(res[i]) and res[i] > 0:
            step *= tol_i / res[i]
        steps[i] = step
        warm.append(tt_normalise([c[i] for c in xs_out]))
    return steps, warm


def tt_newton_step_batch(
    systems: Sequence[Tuple],
    X_tts: Sequence[list],
    Z_tts: Sequence[list],
    mesh=None,
    R: int = 16,
    R_eig: int = 8,
    term_tol: float = 1e-6,
    nswp: int = 12,
    eps: float = 1e-12,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple]]:
    """One predictor-corrector Newton step for ``nb`` independent equality
    SDP instances (``ttipm_tpu/parallel/fused_mesh.py:322-430``): the
    batched predictor solve, the step sizes of all 2 nb pencils in one
    eigen batch, Mehrotra's sigma and the corrector rhs per instance, the
    batched corrector solve warm-started by the predictor, the final step
    sizes and the backoff tau.  ``systems``: per-instance (lhs
    TTBlockMatrix, rhs TTBlockVector), assembled and equilibrated.
    Returns (x_steps, z_steps, [(dY, dX, dZ) per instance])."""
    from ttipm_tpu_torch.ipm import (
        _affine_gap_estimate, _mehrotra_sigma, _rhs_augment, _tt_symmetrise)
    from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
    from ttipm_tpu_torch.ops.tt import tt_add, tt_identity, tt_inner_prod, tt_reshape, tt_scale
    from ttipm_tpu_torch.solvers.blocks import TTBlockVector, tt_get_block

    _no_mesh(mesh)
    nb = len(systems)
    dim = len(X_tts[0])

    def extract(delta):
        dY = tt_rank_reduce(tt_get_block(0, delta), eps=eps)
        dX = _tt_symmetrise(tt_reshape(tt_get_block(1, delta), (2, 2)), eps)
        dZ = _tt_symmetrise(tt_reshape(tt_get_block(2, delta), (2, 2)), eps)
        return dY, dX, dZ

    def step_sizes(dirs):
        pencils = ([(X_tts[i], dirs[i][1]) for i in range(nb)]
                   + [(Z_tts[i], dirs[i][2]) for i in range(nb)])
        steps, _ = tt_step_sizes_batch(pencils, R=R_eig)
        return steps[:nb], steps[nb:]

    sols, _ = tt_block_amen_fused_batch(
        [s[0] for s in systems], [s[1] for s in systems], R=R, ineq=False,
        term_tol=term_tol, nswp=nswp, seed=seed)
    dirs = [extract(s) for s in sols]
    x_steps, z_steps = step_sizes(dirs)

    corr_systems = []
    for i in range(nb):
        lhs, rhs = systems[i]
        _, dX, dZ = dirs[i]
        ZX = float(tt_inner_prod(X_tts[i], Z_tts[i]))
        mu = ZX / 2**dim
        mu_aff = _affine_gap_estimate(ZX, X_tts[i], dX, Z_tts[i], dZ, float(x_steps[i]),
                                      float(z_steps[i]))
        sigma = _mehrotra_sigma(mu_aff, ZX, float(x_steps[i]), float(z_steps[i]))
        rhs_c = TTBlockVector()
        for row in rhs:
            rhs_c[row] = rhs.get_row(row)
        if sigma > 1e-4:
            ref = X_tts[i][0]
            eye = tt_reshape(tt_identity(dim, device=ref.device, dtype=ref.dtype), (4,))
            _rhs_augment(rhs_c, 2, [tt_scale(sigma * mu, eye)], 0.1 * max(mu, 1e-8))
        corr_systems.append((lhs, rhs_c))

    sols_c, _ = tt_block_amen_fused_batch(
        [s[0] for s in corr_systems], [s[1] for s in corr_systems], R=R, ineq=False,
        term_tol=term_tol, nswp=nswp, seed=seed, x0s=sols)
    out_dirs = []
    for i in range(nb):
        cY, cX, cZ = extract(sols_c[i])
        out_dirs.append(tuple(tt_rank_reduce(tt_add(a, c), eps=eps)
                              for a, c in zip(dirs[i], (cY, cX, cZ))))
    x_steps, z_steps = step_sizes(out_dirs)
    tau = 0.9 + 0.05 * np.minimum(x_steps, z_steps)
    return tau * x_steps, tau * z_steps, out_dirs

