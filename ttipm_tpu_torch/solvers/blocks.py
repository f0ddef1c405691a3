"""Sparse block containers for TT operator equations.

``TTBlockMatrix`` stores a dict of TT operators keyed by (row, col) with
two kinds of sharing: *aliases* (block (k,t) is the same TT as (i,j)) and
*transposes* (block (k,t) is the TT transpose of (i,j)).  ``TTBlockVector``
is the dict-of-rows right-hand side.  Counterpart of
``ttipm_tpu/solvers/blocks.py`` (the parts the fused solver uses).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
from ttipm_tpu_torch.ops.tt import TT, tt_add, tt_inner_prod, tt_sub, tt_transpose

__all__ = ["TTBlockVector", "TTBlockMatrix", "tt_get_block", "tt_block_train_add"]


def tt_get_block(i: int, block_train_tt: TT) -> TT:
    """Block ``i`` of a block TT solution (the core with the block axis is
    sliced)."""
    b = int(np.argmax([c.ndim for c in block_train_tt]))
    return list(block_train_tt[:b]) + [block_train_tt[b][:, i]] + list(block_train_tt[b + 1:])


def tt_block_train_add(x_cores: TT, e_cores: TT, num_blocks: int,
                       eps: float = 1e-12) -> TT:
    """``x + e`` for two block TT solutions whose block cores may sit at
    different positions: per-block sums, re-stacked block-diagonally at
    ``x``'s block position, then rounded."""
    d = len(x_cores)
    pos = int(np.argmax([c.ndim for c in x_cores]))
    n_phys = int(x_cores[pos].shape[2])
    sums = [
        tt_rank_reduce(
            tt_add(tt_get_block(i, list(x_cores)), tt_get_block(i, list(e_cores))),
            eps,
        )
        for i in range(num_blocks)
    ]
    out: TT = []
    for k in range(d):
        cs = [blk[k] for blk in sums]
        RL = sum(c.shape[0] for c in cs) if k > 0 else 1
        RR = sum(c.shape[-1] for c in cs) if k < d - 1 else 1
        if k == pos:
            core = cs[0].new_zeros((RL, num_blocks, n_phys, RR))
            ol = orr = 0
            for i, c in enumerate(cs):
                l0, l1 = (ol, ol + c.shape[0]) if k > 0 else (0, 1)
                r0, r1 = (orr, orr + c.shape[-1]) if k < d - 1 else (0, 1)
                core[l0:l1, i, :, r0:r1] = c.reshape(c.shape[0], n_phys, c.shape[-1])
                ol += c.shape[0]
                orr += c.shape[-1]
        elif k == 0:
            core = torch.cat(cs, dim=-1)
        elif k == d - 1:
            core = torch.cat(cs, dim=0)
        else:
            core = cs[0].new_zeros((RL,) + tuple(cs[0].shape[1:-1]) + (RR,))
            ol = orr = 0
            for c in cs:
                core[ol:ol + c.shape[0], ..., orr:orr + c.shape[-1]] = c
                ol += c.shape[0]
                orr += c.shape[-1]
        out.append(core)
    return tt_rank_reduce(out, eps)


class TTBlockVector:
    """Dict of row-index -> TT vector."""

    def __init__(self):
        self._data: Dict[int, TT] = {}

    def __setitem__(self, index: int, value: TT):
        if not isinstance(value, list):
            raise ValueError("each block row must be a TT (list of cores)")
        self._data[index] = value

    def get_row(self, index: int):
        return self._data.get(index, None)

    def __iter__(self):
        return iter(self._data)

    def __contains__(self, index: int):
        return index in self._data

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    @property
    def norm(self) -> float:
        return float(np.sqrt(sum(tt_inner_prod(v, v) for v in self._data.values())))

    def __sub__(self, other: "TTBlockVector") -> "TTBlockVector":
        out = TTBlockVector()
        for i in self._data:
            out[i] = tt_rank_reduce(tt_sub(self.get_row(i), other.get_row(i)), 1e-12)
        return out


class TTBlockMatrix:
    """Dict of (row, col) -> TT operator with alias/transpose sharing."""

    def __init__(self):
        self._data: Dict[Tuple[int, int], TT] = {}
        self._aliases: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._transposes: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def add_alias(self, key1, key2, is_transpose: bool = False):
        if is_transpose:
            self._transposes[key1] = key2
        else:
            self._aliases[key1] = key2

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            return self._data.setdefault(key, [])
        raise KeyError(f"invalid key {key!r}")

    def __setitem__(self, key, value):
        if not (isinstance(key, tuple) and len(key) == 2):
            raise KeyError(f"invalid key {key!r}")
        self._data[key] = value

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def block_product(self, x_cores: TT, op_tol: float, eps: float = 1e-12,
                      cache: dict = None, rng=None) -> TTBlockVector:
        """Full block operator applied to a block TT solution.  ``cache``
        carries each per-term ALS fit across calls as the next call's warm
        start (the IPM's refinement rounds)."""
        from ttipm_tpu_torch.ops.products import tt_mat_vec_mul

        result = TTBlockVector()

        def accumulate(row, op, col, slot):
            x0 = None if cache is None else cache.get(slot)
            term = tt_mat_vec_mul(op, tt_get_block(col, x_cores), op_tol, eps,
                                  x0=x0, rng=rng)
            if cache is not None:
                cache[slot] = term
            if row in result.keys():
                result[row] = tt_rank_reduce(tt_add(result.get_row(row), term), eps)
            else:
                result[row] = term

        for (i, j), op in self._data.items():
            accumulate(i, op, j, (i, j, "d"))
            if (i, j) in self._transposes:
                k, t = self._transposes[i, j]
                accumulate(k, tt_transpose(op), t, (i, j, "t"))
            if (i, j) in self._aliases:
                k, t = self._aliases[i, j]
                accumulate(k, op, t, (i, j, "a"))
        return result
