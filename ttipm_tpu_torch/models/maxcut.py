"""MaxCut SDP in TT form.

max <L_G/4, X>  s.t.  diag(X) = 1, X PSD: the objective is the graph
Laplacian of a random TT graph, the constraint operator the Diag
embedding of the identity, the Lagrange-multiplier support map the
off-diagonal mask.  Counterpart of ``ttipm_tpu/models/maxcut.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.ops.products import tt_fast_matrix_vec_mul
from ttipm_tpu_torch.ops.random import tt_random_graph
from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
from ttipm_tpu_torch.ops.tt import (
    tt_diag,
    tt_diag_op,
    tt_identity,
    tt_normalise,
    tt_one_matrix,
    tt_reshape,
    tt_sub,
)

__all__ = ["create_problem", "build_problem", "tt_obj_matrix", "tt_diag_constraint_op"]


def tt_diag_constraint_op(dim: int, *, device, dtype=torch.float64):
    identity = tt_identity(dim, device=device, dtype=dtype)
    return tt_diag_op(identity), identity


def tt_obj_matrix(rank: int, dim: int, *, device, dtype=torch.float64, rng=None):
    graph_tt = tt_rank_reduce(
        tt_random_graph(dim, rank, device=device, dtype=dtype, rng=rng)
    )
    ones_vec = [torch.ones((1, 2, 1), device=device, dtype=dtype)] * dim
    degrees = tt_fast_matrix_vec_mul(graph_tt, ones_vec, 1e-12)
    return tt_sub(tt_diag(degrees), graph_tt)


def create_problem(dim: int, rank: int, *, device, dtype=torch.float64, rng=None):
    """Returns (obj_tt, L_tt, bias_tt, lag_y) on ``device``; the instance is
    drawn from the numpy RandomState ``rng`` (default numpy's global one).

    Another ``dtype`` than float64 gives the float64 instance rounded to
    it.  Built in float32 (``build_problem``), the rank decisions of the
    graph sampler's rounding fall on float32 noise: a graph of rank 1 keeps
    a second singular value of ~1e-7 |G| against the bond threshold 7.1e-8
    of the f32 eps floor, so which sample is taken depends on the last bits
    of the factorizations and products.  At d8 seed 319 the f32-built
    instance is another graph on the CPU than on an H100, and the JAX
    package's f32 instance a third (its 56th sample; its f64 instance the
    5th).  Built in f64 the instance is the one the seed means, on every
    backend; at d3 seed 319 it is also the JAX package's f32 instance."""
    if dtype != torch.float64:
        with config.profile(torch.float64):
            problem = build_problem(dim, rank, device=device, dtype=torch.float64, rng=rng)
        return config.cast_tree(problem, dtype)
    return build_problem(dim, rank, device=device, dtype=dtype, rng=rng)


def build_problem(dim: int, rank: int, *, device, dtype, rng=None):
    """The instance built in ``dtype`` under the active profile, as the
    JAX package builds it (``ttipm_tpu/models/maxcut.py:44``)."""
    scale = np.sqrt(dim)
    obj_tt = tt_obj_matrix(rank, dim, device=device, dtype=dtype, rng=rng)
    L_tt, bias_tt = tt_diag_constraint_op(dim, device=device, dtype=dtype)
    lag_y = tt_diag_op(tt_sub(tt_one_matrix(dim, device=device, dtype=dtype),
                              tt_identity(dim, device=device, dtype=dtype)))
    return (
        tt_reshape(tt_normalise(obj_tt, radius=scale), (4,)),
        L_tt,
        tt_reshape(tt_normalise(bias_tt, radius=scale), (4,)),
        lag_y,
    )
