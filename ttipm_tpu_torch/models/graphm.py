"""Graph-matching QAP relaxation SDP in TT form.

The lifted variable has block structure [[Q, P, 0], [P^T, 1, 0], [0, 0, I]]
over ``2n+1`` TT cores; five constraint operators (partial trace,
partial-J-trace, diagonal block sums, Q-P coupling, padding; numbered IV-IX
as in the reference) are summed into a single TT operator, with an
inequality mask on the off-diagonal Q/P blocks and a hand-built Lagrange
complement map.  Counterpart of ``ttipm_tpu/models/graphm.py``: one numpy
seed gives the same instance in both packages.
"""

from __future__ import annotations

import torch

from ttipm_tpu_torch.ops.random import tt_random_graph
from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
from ttipm_tpu_torch.ops.tt import (
    E,
    tt_add,
    tt_diag,
    tt_diag_op,
    tt_identity,
    tt_normalise,
    tt_one_matrix,
    tt_reshape,
    tt_split_bonds,
    tt_sub,
    tt_sum,
    tt_tril_one_matrix,
    tt_triu_one_matrix,
)

__all__ = ["create_problem"]


class _Constructors:
    """The constructors of ``ops.tt`` bound to one device and dtype."""

    def __init__(self, device, dtype):
        self.kw = {"device": device, "dtype": dtype}

    def E(self, i, j):
        return E(i, j, **self.kw)

    def eye(self, dim):
        return tt_identity(dim, **self.kw)

    def ones(self, dim):
        return tt_one_matrix(dim, **self.kw)

    def tril(self, dim):
        return tt_tril_one_matrix(dim, **self.kw)

    def triu(self, dim):
        return tt_triu_one_matrix(dim, **self.kw)

    def q_prefix(self):
        return [self.E(0, 0), self.E(0, 0)]

    def in_row(self, c, i):
        """The split core ``c`` (r, 2, R) written into row ``i`` of a zero
        (r, 2, 2, R) matrix core."""
        core = c.new_zeros((c.shape[0], 2, 2, c.shape[-1]))
        core[:, i] = c
        return core


def tt_partial_trace_op(b: _Constructors, block_size: int, dim: int):
    """Constraint IV."""
    op_tt = tt_diag(tt_split_bonds(tt_sub(b.ones(dim - block_size), b.eye(dim - block_size))))
    block_op = tt_diag(tt_split_bonds(b.eye(block_size)))
    return tt_reshape(tt_rank_reduce(b.q_prefix() + op_tt + block_op), (4, 4))


def tt_partial_J_trace_op(b: _Constructors, block_size: int, dim: int):
    """Constraint V."""
    outer = dim - block_size
    matrix_tt = tt_sub(b.eye(outer), [b.E(0, 0)] * outer)
    block_op_0 = [b.in_row(c, 1) for c in tt_split_bonds(b.eye(block_size))]
    op_tt_0 = tt_diag(tt_split_bonds(matrix_tt)) + block_op_0

    matrix_tt = tt_sub(b.triu(outer), b.eye(outer))
    block_op_1 = [b.in_row(c, (i + 1) % 2)
                  for i, c in enumerate(tt_split_bonds(b.ones(block_size)))]
    op_tt_1 = tt_diag(tt_split_bonds(matrix_tt)) + block_op_1

    matrix_tt = tt_sub(b.tril(outer), b.eye(outer))
    block_op_2 = [b.in_row(c, i % 2) for i, c in enumerate(tt_split_bonds(b.ones(block_size)))]
    op_tt_2 = tt_diag(tt_split_bonds(matrix_tt)) + block_op_2

    return tt_reshape(tt_rank_reduce(b.q_prefix() + tt_sum(op_tt_0, op_tt_1, op_tt_2)), (4, 4))


def tt_diag_block_sum_linear_op(b: _Constructors, block_size: int, dim: int):
    """Constraint VI."""
    op_tt = [b.in_row(c, 0) for c in tt_split_bonds(b.eye(dim - block_size))]
    op_tt = op_tt + tt_diag(tt_split_bonds(b.eye(block_size)))
    op_tt_2 = tt_diag(tt_split_bonds(b.eye(dim - block_size)))
    op_tt_2 = op_tt_2 + tt_diag(
        tt_split_bonds(tt_sub(b.ones(block_size), b.eye(block_size))))
    return tt_reshape(tt_rank_reduce(b.q_prefix() + tt_add(op_tt, op_tt_2)), (4, 4))


def tt_Q_m_P_op(b: _Constructors, dim: int):
    """Constraint VII: couples Q-row sums with the P column."""
    def part(q_head, pair, p_head, p_core):
        q_part = list(q_head)
        for _ in range(dim):
            q_part.extend([torch.cat((b.E(0, 0), b.E(*pair[0])), dim=-1),
                           torch.cat((b.E(0, 0), b.E(*pair[1])), dim=0)])
        p_part = list(p_head) + tt_diag(tt_split_bonds([p_core] * dim))
        return tt_add(q_part, p_part)

    part_1 = part([b.E(0, 0), b.E(1, 0)], ((1, 1), (0, 1)),
                  [-b.E(0, 0), b.E(1, 1)], b.E(0, 0) + b.E(1, 0))
    part_2 = part([b.E(1, 0), b.E(0, 0)], ((0, 1), (1, 1)),
                  [-b.E(1, 1), b.E(0, 0)], b.E(0, 0) + b.E(0, 1))
    return tt_reshape(tt_add(part_2, part_1), (4, 4))


def tt_padding_op(b: _Constructors, dim: int):
    """Constraint IX: pins the identity padding block."""
    matrix_tt = [b.E(0, 1) + b.E(1, 0) + b.E(1, 1)] + b.ones(dim)
    matrix_tt = tt_sub(matrix_tt, [b.E(0, 1)] + [b.E(0, 0) + b.E(1, 0)] * dim)
    matrix_tt = tt_sub(matrix_tt, [b.E(1, 0)] + [b.E(0, 0) + b.E(0, 1)] * dim)
    return tt_reshape(tt_rank_reduce(tt_diag(tt_split_bonds(matrix_tt))), (4, 4))


def tt_obj_matrix(b: _Constructors, rank: int, dim: int, rng=None):
    # G_A is drawn first, as in the JAX package, and placed last
    G_A = tt_random_graph(dim, rank, rng=rng, **b.kw)
    G_B = tt_random_graph(dim, rank, rng=rng, **b.kw)
    return [b.E(0, 0)] + G_B + G_A


def create_problem(n: int, max_rank: int, *, device, dtype=torch.float64, rng=None):
    """Returns (C, L, bias, ineq_mask, {"y": lag_y, "t": lag_t}) for
    matching two graphs on 2^n nodes (2n+1 cores) on ``device``; the graphs
    are drawn from the numpy RandomState ``rng`` (default numpy's global
    one).  C and the bias are matrix trains, as in the JAX package."""
    b = _Constructors(device, dtype)
    E_ = b.E
    C_tt = tt_obj_matrix(b, max_rank, n, rng)

    # IV: partial trace
    L_op_tt = tt_partial_trace_op(b, n, 2 * n)

    # V: partial-J trace with its bias
    partial_tr_J_op = tt_partial_J_trace_op(b, n, 2 * n)
    bias_J = [E_(0, 0)] + tt_sub(b.tril(n), b.eye(n)) + [E_(0, 1)] * n
    bias_J = tt_add(bias_J, [E_(0, 0)] + tt_sub(b.triu(n), b.eye(n)) + [E_(1, 0)] * n)
    bias_J = tt_rank_reduce(
        tt_add(bias_J, [E_(0, 0)] + tt_sub(b.eye(n), [E_(0, 0)] * n) + [E_(1, 1)] * n))
    L_op_tt = tt_rank_reduce(tt_add(L_op_tt, partial_tr_J_op), 1e-12)
    eq_bias_tt = bias_J

    # VI: diagonal block sums
    diag_block_sum_op = tt_diag_block_sum_linear_op(b, n, 2 * n)
    diag_block_sum_bias = [E_(0, 0)] * (n + 1) + b.eye(n)
    L_op_tt = tt_rank_reduce(tt_add(L_op_tt, diag_block_sum_op), 1e-12)
    eq_bias_tt = tt_rank_reduce(tt_add(eq_bias_tt, diag_block_sum_bias))

    # VII: Q-P coupling
    L_op_tt = tt_rank_reduce(tt_add(L_op_tt, tt_Q_m_P_op(b, 2 * n)), 1e-12)

    # X: inequality mask on the off-diagonal Q/P blocks
    off_diag = tt_sub(b.ones(n), b.eye(n))
    ineq_mask = tt_rank_reduce([E_(0, 0)] + off_diag + off_diag)

    # Lagrange complement map for Y
    pad = [1 - E_(0, 0)] + b.ones(2 * n)
    pad = tt_sub(pad, [E_(0, 1)] + [E_(0, 0) + E_(1, 0)] * (2 * n))
    pad = tt_sub(pad, [E_(1, 0)] + [E_(0, 0) + E_(0, 1)] * (2 * n))
    lag_map_y = tt_sub(
        b.ones(2 * n + 1),
        tt_sum(
            pad,
            [E_(0, 1)] + [E_(0, 0) + E_(1, 0)] * (2 * n),
            [E_(1, 0)] + [E_(0, 0) + E_(0, 1)] * (2 * n),
            [E_(0, 0)] + [E_(0, 0)] * n + b.eye(n),
            [E_(0, 0)] + b.eye(n) + off_diag,
            bias_J,
            [E_(0, 0)] + off_diag + b.eye(n),
        ),
    )
    lag_map_t = tt_sub(b.ones(2 * n + 1), ineq_mask)
    lag_maps = {"y": tt_diag_op(lag_map_y), "t": tt_diag_op(lag_map_t)}

    scale = max(2 ** (2 * n + 1 - 7), 1)
    eq_bias_tt = tt_normalise(eq_bias_tt, radius=scale)

    # IX: padding operator and its bias
    padding_op = tt_padding_op(b, 2 * n)
    padding_bias = [E_(1, 1)] + b.eye(2 * n)
    L_op_tt = tt_rank_reduce(tt_add(L_op_tt, padding_op), 1e-12)
    eq_bias_tt = tt_rank_reduce(tt_add(eq_bias_tt, padding_bias))

    return tt_normalise(C_tt, radius=scale), L_op_tt, eq_bias_tt, ineq_mask, lag_maps
