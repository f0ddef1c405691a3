"""Batched seeds: the fused AMEn KKT solve, the step-size eigensolves and
the predictor-corrector Newton step for B structurally identical
instances in lockstep, on one device or over a (seeds x kkt) mesh.

Counterpart of ``ttipm_tpu/parallel/fused_mesh.py``, which stacks the
instances on a leading axis and runs ``jax.vmap`` of the single-instance
sweep programs over it, sharded over a device mesh.  The port stacks them
the same way and runs the batched sweep (``solvers/fused_batch.py``, which
the single solve runs as a batch of one) and the batched whole-eigen
program (``solvers/fused_eigen_batch.py``): one kernel launch of K1, K2
and K3 per step for the whole batch, K4 one launch up to order 512
(``ops/kernels.py``), so the host's cost of a wrapper is paid once per
batch.  Termination is lockstep: every instance sweeps until the worst one
converges.

Per instance the solve is the port's single engine (LU for the Schur
systems), where the JAX batch runs its padded device engine (QR for them);
the random starts are the JAX package's streams: one
``np.random.RandomState(seed)`` for all starts of a solve, instance by
instance (x then z), and numpy's global stream for the eigenvector starts.

``mesh`` (a ``parallel.mesh.Mesh``; every rank of its world makes the
same call):

* seeds: the batch is padded to a multiple of S by repeating its last
  instance, and each seeds row solves its contiguous shard.  Every rank
  draws the starts of all instances in order and keeps its own, so an
  instance's start does not depend on the mesh (a padded instance takes
  the last instance's start: the global stream advances as without a
  mesh).  The batch's stop decisions (the sweeps' worst residual and
  update, the eigen program's loop, forward half sweep and shrink rule)
  are reduced over the seeds axis, so every instance sweeps as often as
  it does on one device.  A seeds-only mesh therefore gives the bits of
  ``mesh=None`` wherever the library calls compute an instance the same
  way at the shard's batch size.
* kkt (``shard_kkt`` and K > 1): the local factorizations' Schur blocks
  and the eigen windows' pencil pairs, K1's sums over the operator bond
  ``s``, are split over ``s`` across the kkt row and summed by one
  ``all_reduce`` before the factor (``Mesh.partial_schur``); K2's
  products, the factors and the splits stay replicated in the row.  The
  JAX package annotates bond axes with a ``kkt`` sharding and lets XLA
  choose the partitioning; the port fixes this one.
* Returns: the same as without a mesh, every instance (padding dropped)
  on every rank, gathered by a ``broadcast`` from each seeds row's
  kkt-rank 0.  The host TT algebra of the Newton step between the
  batched programs (direction extraction, the corrector rhs) runs on
  every rank for every instance.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.parallel.mesh import Mesh
from ttipm_tpu_torch.solvers import fused as _fused
from ttipm_tpu_torch.solvers import fused_algebra as fa
from ttipm_tpu_torch.solvers import fused_batch as fb
from ttipm_tpu_torch.solvers import fused_eigen as _fe
from ttipm_tpu_torch.solvers.fused_eigen_batch import gen_eigen_program

__all__ = ["tt_block_amen_fused_batch", "tt_step_sizes_batch", "tt_newton_step_batch"]


def _shard(nb: int, mesh) -> List[int]:
    """The instances this rank solves: all of them without a mesh, else its
    seeds row's shard of the batch padded by repeating the last one."""
    if mesh is None:
        return list(range(nb))
    padded = list(range(nb)) + [nb - 1] * ((-nb) % mesh.seeds)
    return padded[mesh.seeds_shard(len(padded))]


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: a parallel.mesh.Mesh or None, got {type(mesh).__name__}")


def _stack(trains):
    """Per-instance lists of cores -> one list of (B, ...) cores."""
    return [torch.stack(cores) for cores in zip(*trains)]


def _instance(cores, i):
    """Instance ``i``'s cores as fresh contiguous allocations.  A view into
    the batch (or into a mesh's gathered rows) has the batch's strides and
    an offset that differ between a batch and a mesh's shard of it, and
    cuBLAS takes another kernel (another order of the same products) for a
    transposed operand or another alignment of the same values: the
    per-instance algebra after the solve (the warm starts' retraction, the
    directions) would give other bits."""
    return [c[i].clone(memory_format=torch.contiguous_format) for c in cores]


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
    _check_mesh(mesh)
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

    local = _shard(nb, mesh)
    A = {k: _stack([preps[i][0][k] for i in local]) for k in fa.keys(ineq)}
    b = [_stack([preps[i][1][r] for i in local]) for r in range(bs)]
    x_cores, z_cores = _stack([xs[i] for i in local]), _stack([zs[i] for i in local])
    pA0, pz0, pb0 = fb.boundary_phis(ref, len(local), ineq)
    XAX = [pA0] + [None] * (d - 1) + [dict(pA0)]
    Xb = [pb0] + [None] * (d - 1) + [list(pb0)]
    ZAX = [pz0] + [None] * (d - 1) + [dict(pz0)]
    Zb = [pb0] + [None] * (d - 1) + [list(pb0)]
    kkt_mesh = mesh if (shard_kkt and mesh is not None and mesh.kkt > 1) else None

    last = False
    final_res = np.full(len(local), np.inf)
    for swp in range(nswp + 1):
        solve = (swp > 0) and not last
        caps = caps_bck if direction > 0 else caps_fwd
        res, dx = fb.sweep(A, b, x_cores, z_cores, XAX, Xb, ZAX, Zb, caps, kick_rank, solve,
                           direction, ineq, mesh=kkt_mesh)
        if last:
            break
        worst_res, worst_dx = (float(res.max()), float(dx.max())) if solve else (np.inf, np.inf)
        if solve and mesh is not None:
            worst_res, worst_dx = mesh.reduce_values([worst_res, worst_dx], "max")
        if worst_res < term_tol or worst_dx < eps or swp == nswp - 2:
            last = True
            final_res = res if solve else final_res
        if verbose:
            print(f"\t[fused-batch R={R}] sweep {swp}: worst res {worst_res:.3e}", flush=True)
        direction *= -1

    if mesh is not None:
        *x_cores, res_t = mesh.gather_rows(
            x_cores + [torch.as_tensor(final_res, dtype=torch.float64, device=ref.device)])
        final_res = res_t[:nb].cpu().numpy()
    return [_instance(x_cores, i) for i in range(nb)], final_res


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

    _check_mesh(mesh)
    if not pencils:
        raise ValueError("no pencils")
    nb = len(pencils)
    d = len(pencils[0][0])
    n = pencils[0][0][0].shape[1]

    def common_ra(trains):
        if d == 1:
            return 1
        return max(_fused._bucket4(max(c.shape[-1] for c in t[:-1])) for t in trains)

    ra_A = common_ra([p[0] for p in pencils])
    ra_D = common_ra([p[1] for p in pencils])
    caps = _fe._vec_caps(d, R, n)
    ref = pencils[0][0][0]
    starts = [_fe._prep_vec(x0s[i] if x0s is not None else None, d, n, caps, np.random, ref)
              for i in range(nb)]
    local = _shard(nb, mesh)
    A_b = _stack([_fe._prep_operator(pencils[i][0], ra=ra_A) for i in local])
    D_b = _stack([_fe._prep_operator(pencils[i][1], ra=ra_D) for i in local])
    x_b = _stack([starts[i] for i in local])
    alpha0 = torch.ones(len(local), dtype=config.eigen_dtype(), device=ref.device)
    xs_out, alphas, res, scales, _ = gen_eigen_program(A_b, D_b, x_b, alpha0, tol, caps,
                                                    max(nswp - 1, 1), mesh=mesh)
    if mesh is not None:
        *xs_out, alphas, res, scales = mesh.gather_rows(list(xs_out) + [alphas, res, scales])
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
        warm.append(tt_normalise(_instance(xs_out, i)))
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

    _check_mesh(mesh)
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
        steps, _ = tt_step_sizes_batch(pencils, mesh=mesh, R=R_eig)
        return steps[:nb], steps[nb:]

    sols, _ = tt_block_amen_fused_batch(
        [s[0] for s in systems], [s[1] for s in systems], R=R, ineq=False, mesh=mesh,
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
        mesh=mesh, term_tol=term_tol, nswp=nswp, seed=seed, x0s=sols)
    out_dirs = []
    for i in range(nb):
        cY, cX, cZ = extract(sols_c[i])
        out_dirs.append(tuple(tt_rank_reduce(tt_add(a, c), eps=eps)
                              for a, c in zip(dirs[i], (cY, cX, cZ))))
    x_steps, z_steps = step_sizes(out_dirs)
    tau = 0.9 + 0.05 * np.minimum(x_steps, z_steps)
    return tau * x_steps, tau * z_steps, out_dirs

