"""Correlation-clustering SDP in TT form.

The objective is a similarity graph plus the Laplacian of the
dissimilarity graph, the constraints are diag(X) = 1, and the entries of X
on the graph's support are held above -beta by entrywise inequality
constraints (the IPM's ``ineq_mask``).  Counterpart of
``ttipm_tpu/models/corr_clust.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ttipm_tpu_torch.models.maxcut import tt_diag_constraint_op
from ttipm_tpu_torch.ops.products import tt_fast_hadamard, tt_fast_matrix_vec_mul
from ttipm_tpu_torch.ops.random import tt_random_graph
from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
from ttipm_tpu_torch.ops.tt import (
    tt_add,
    tt_diag,
    tt_diag_op,
    tt_identity,
    tt_normalise,
    tt_one_matrix,
    tt_reshape,
    tt_sub,
)

__all__ = ["create_problem", "tt_obj_matrix_and_ineq_mask"]


def tt_obj_matrix_and_ineq_mask(rank: int, dim: int, *, device, dtype=torch.float64,
                                rng=None):
    """(objective, graph): the graph is also the inequality mask."""
    graph = tt_rank_reduce(tt_random_graph(dim, rank, device=device, dtype=dtype, rng=rng),
                           1e-10)
    mask_graph = tt_rank_reduce(tt_random_graph(dim, 1, device=device, dtype=dtype, rng=rng),
                                1e-10)
    ones = tt_one_matrix(dim, device=device, dtype=dtype)
    sim_graph = tt_rank_reduce(tt_fast_hadamard(graph, mask_graph, 1e-12), 1e-10)
    disim_graph = tt_rank_reduce(
        tt_fast_hadamard(graph, tt_sub(ones, mask_graph), 1e-12), 1e-10)
    ones_vec = [torch.ones((1, 2, 1), device=device, dtype=dtype)] * dim
    disim_laplacian = tt_sub(
        tt_diag(tt_fast_matrix_vec_mul(disim_graph, ones_vec, 1e-12)), disim_graph)
    obj_tt = tt_rank_reduce(tt_add(sim_graph, disim_laplacian), 1e-10)
    return obj_tt, graph


def create_problem(dim: int, rank: int, *, device, dtype=torch.float64, rng=None):
    """Returns (obj_tt, L_tt, bias_tt, ineq_mask, {"y": lag_y, "t": lag_t})
    on ``device``; the instance is drawn from the numpy RandomState ``rng``
    (default numpy's global one)."""
    scale = np.sqrt(dim)
    obj_tt, ineq_mask = tt_obj_matrix_and_ineq_mask(rank, dim, device=device, dtype=dtype,
                                                    rng=rng)
    L_tt, bias_tt = tt_diag_constraint_op(dim, device=device, dtype=dtype)
    ones = tt_one_matrix(dim, device=device, dtype=dtype)
    lag_y = tt_sub(ones, tt_identity(dim, device=device, dtype=dtype))
    lag_t = tt_sub(ones, ineq_mask)
    return (
        tt_reshape(tt_normalise(obj_tt, radius=scale), (4,)),
        L_tt,
        tt_reshape(tt_normalise(bias_tt, radius=scale), (4,)),
        ineq_mask,
        {"y": tt_diag_op(lag_y), "t": tt_diag_op(lag_t)},
    )
