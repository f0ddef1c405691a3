"""Maximum-stable-set SDP in TT form (a Lovasz-theta relaxation).

The objective is the all-ones matrix; the constraints are trace(X) = 1 and
X = 0 on the edges of a random graph.  Counterpart of
``ttipm_tpu/models/max_stable_set.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ttipm_tpu_torch.ops.random import tt_random_graph
from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
from ttipm_tpu_torch.ops.tt import (
    E,
    tt_add,
    tt_diag_op,
    tt_identity,
    tt_normalise,
    tt_one_matrix,
    tt_reshape,
    tt_split_bonds,
    tt_sub,
)

__all__ = ["create_problem", "tt_G_entrywise_mask_op", "tt_tr_constraint"]


def tt_G_entrywise_mask_op(G):
    """Operator selecting the entries of X on the edge support of G: each
    split-bond core of G becomes a 2x2 diagonal selector core."""
    basis = []
    for g in tt_split_bonds(list(G)):
        core = g.new_zeros((g.shape[0], 2, 2, g.shape[-1]))
        core[:, 0, 0] = g[:, 0]
        core[:, 1, 1] = g[:, 1]
        basis.append(core)
    return tt_rank_reduce(tt_reshape(basis, (4, 4)))


def tt_tr_constraint(dim: int, *, device, dtype=torch.float64):
    """The trace as a TT map, and its rank-1 bias."""
    op = []
    for c in tt_split_bonds(tt_identity(dim, device=device, dtype=dtype)):
        core = c.new_zeros((c.shape[0], 2, 2, c.shape[-1]))
        core[:, 0] = c
        op.append(core)
    return (tt_rank_reduce(tt_reshape(op, (4, 4))),
            [E(0, 0, device=device, dtype=dtype)] * dim)


def create_problem(dim: int, rank: int, *, device, dtype=torch.float64, rng=None):
    """Returns (obj_tt, L_tt, bias_tt, lag_y) on ``device``; the graph is
    drawn from the numpy RandomState ``rng`` (default numpy's global one)."""
    scale = np.sqrt(dim)
    G = tt_rank_reduce(tt_random_graph(dim, rank, device=device, dtype=dtype, rng=rng))
    ones = tt_one_matrix(dim, device=device, dtype=dtype)
    L_tt, bias_tt = tt_tr_constraint(dim, device=device, dtype=dtype)
    L_tt = tt_rank_reduce(tt_add(L_tt, tt_G_entrywise_mask_op(G)))
    lag_y = tt_rank_reduce(tt_diag_op(tt_sub(ones, tt_add(G, bias_tt))))
    return (
        tt_reshape(tt_normalise(ones, radius=scale), (4,)),
        L_tt,
        tt_reshape(tt_normalise(bias_tt, radius=scale), (4,)),
        lag_y,
    )
