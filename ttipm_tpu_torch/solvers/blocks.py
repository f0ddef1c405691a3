"""Sparse block containers for TT operator equations.

``TTBlockMatrix`` stores a dict of TT operators keyed by (row, col) with
two kinds of sharing: *aliases* (block (k,t) is the same TT as (i,j)) and
*transposes* (block (k,t) is the TT transpose of (i,j)).  ``TTBlockVector``
is the dict-of-rows right-hand side.  Indexed by a core index, each gives
a view of all its blocks' cores there, with the local products of the
ragged AMEn sweeps; the block-operator ones go through one K2 launch
(``kernels.kkt_block_product``) per product, the aliases and transposes
included.  Counterpart of ``ttipm_tpu/solvers/blocks.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ttipm_tpu_torch.config import cast_tree
from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
from ttipm_tpu_torch.ops.tt import TT, tt_add, tt_inner_prod, tt_sub, tt_transpose
from ttipm_tpu_torch.solvers.fused_algebra import _flip, _t

__all__ = ["TTBlockVector", "TTBlockMatrix", "TTBlockVectorView", "TTBlockMatrixView",
           "tt_get_block", "tt_block_train_add", "cast_block_vector", "cast_block_matrix"]


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


def cast_block_vector(b: "TTBlockVector", dtype) -> "TTBlockVector":
    """Copy with every core cast to ``dtype``: the refinement residual
    b - A x of the f32 profile is formed in f64, or it carries the noise it
    is meant to remove (``ttipm_tpu/solvers/blocks.py:34-42``)."""
    out = TTBlockVector()
    out._data = cast_tree(b._data, dtype)
    return out


def cast_block_matrix(A: "TTBlockMatrix", dtype) -> "TTBlockMatrix":
    """Copy with every stored block's cores cast to ``dtype``, aliases and
    transposes kept."""
    out = TTBlockMatrix()
    out._data = cast_tree(A._data, dtype)
    out._aliases = dict(A._aliases)
    out._transposes = dict(A._transposes)
    return out


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

    def __getitem__(self, core_index: int) -> "TTBlockVectorView":
        return TTBlockVectorView(self._data, core_index)

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
        if isinstance(key, int):
            return TTBlockMatrixView(self._data, self._aliases, self._transposes, key)
        raise KeyError(f"invalid key {key!r}")

    def __setitem__(self, key, value):
        if not (isinstance(key, tuple) and len(key) == 2):
            raise KeyError(f"invalid key {key!r}")
        self._data[key] = value

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def tkeys(self):
        return self._data.keys() | set(self._transposes.values())

    def get_submatrix(self, row_index: int, col_index: int) -> "TTBlockMatrix":
        """The blocks (i, j) with i <= row_index and j <= col_index, and the
        aliases and transposes whose images lie there (the stored cores are
        shared, not copied)."""
        sub = TTBlockMatrix()
        sub._data = {k: v for k, v in self._data.items()
                     if k[0] <= row_index and k[1] <= col_index}
        sub._aliases = {k: v for k, v in self._aliases.items()
                        if v[0] <= row_index and v[1] <= col_index}
        sub._transposes = {k: v for k, v in self._transposes.items()
                           if v[0] <= row_index and v[1] <= col_index}
        return sub

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


class TTBlockVectorView:
    """All rows' cores at one core index."""

    def __init__(self, data: Dict[int, TT], core_index: int):
        self._data = data
        self._idx = core_index

    def __getitem__(self, row_index: int):
        return self._data[row_index][self._idx]

    def __iter__(self):
        return iter(self._data)

    def __contains__(self, row_index: int):
        return row_index in self._data

    def block_local_product(self, Xb_k, Xb_kp1, nrmsc, shape) -> torch.Tensor:
        """Every rhs row projected onto the local basis, stacked on axis 1
        of a core of ``shape`` (rows without data are zero)."""
        cols = {i: torch.einsum("br,bnB,BR->rnR", Xb_k[i], nrmsc * row[self._idx], Xb_kp1[i])
                for i, row in self._data.items()}
        ref = next(iter(cols.values()))
        zero = ref.new_zeros(tuple(shape[:1]) + tuple(shape[2:]))
        return torch.stack([cols.get(i, zero) for i in range(shape[1])], dim=1)


class TTBlockMatrixView:
    """All blocks' cores at one core index, with the local products of the
    AMEn sweeps.  Each product is
    ``y[:, row] = sum of phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R] x[r,n,R]``
    over the stored blocks, their transposes (operator and basis indices
    swapped) and their aliases."""

    def __init__(self, data, aliases, transposes, core_index):
        self._data = data
        self._aliases = aliases
        self._transposes = transposes
        self._idx = core_index

    def __getitem__(self, key):
        return self._data[key][self._idx]

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    @property
    def transposes(self):
        return self._transposes

    @property
    def aliases(self):
        return self._aliases

    def _terms(self, x_core, direct, transposed):
        """K2 terms of a product: ``direct(key)`` gives the (phi_l, phi_r)
        of block ``key`` and its aliases, ``transposed(key, image)`` those
        of its transpose image."""
        terms = []
        for (i, j), op in self._data.items():
            A_k = op[self._idx]
            pl, pr = direct((i, j))
            terms.append((pl, A_k, pr, x_core[:, j], i))
            if (i, j) in self._transposes:
                k, t = self._transposes[i, j]
                tl, tr = transposed((i, j), (k, t))
                terms.append((tl, _t(A_k), tr, x_core[:, t], k))
            if (i, j) in self._aliases:
                k, t = self._aliases[i, j]
                terms.append((pl, A_k, pr, x_core[:, t], k))
        return terms

    def block_local_product(self, XAX_k, XAX_kp1, x_core) -> torch.Tensor:
        """y[:, i] += K_ij x[:, j] in the local projected basis."""
        terms = self._terms(x_core, lambda key: (XAX_k[key], XAX_kp1[key]),
                            lambda key, img: (_flip(XAX_k[key]), _flip(XAX_kp1[key])))
        return kernels.kkt_block_product(terms, x_core.shape[1])

    def block_local_product_batched(self, XAX_k, XAX_kp1, x_cores_q) -> torch.Tensor:
        """``block_local_product`` over a leading axis q (all candidates
        of the rank backoff at once): (q, r, block, n, R) -> same."""
        cols = {}

        def acc(i, val):
            cols[i] = val if i not in cols else cols[i] + val

        for (i, j), op in self._data.items():
            A_k = op[self._idx]
            pl, pr = XAX_k[i, j], XAX_kp1[i, j]
            acc(i, torch.einsum("lsr,smnS,LSR,qrnR->qlmL", pl, A_k, pr, x_cores_q[:, :, j]))
            if (i, j) in self._transposes:
                k, t = self._transposes[i, j]
                acc(k, torch.einsum("lsr,smnS,LSR,qlmL->qrnR", pl, A_k, pr, x_cores_q[:, :, t]))
            if (i, j) in self._aliases:
                k, t = self._aliases[i, j]
                acc(k, torch.einsum("lsr,smnS,LSR,qrnR->qlmL", pl, A_k, pr, x_cores_q[:, :, t]))
        q, r = x_cores_q.shape[0], x_cores_q.shape[1]
        zero = x_cores_q.new_zeros((q, r, x_cores_q.shape[3], x_cores_q.shape[4]))
        return torch.stack([cols.get(i, zero) for i in range(x_cores_q.shape[2])], dim=2)

    def compressed_block_local_product(self, ZAX_k, ZAX_kp1, x_core, shape) -> torch.Tensor:
        """Residual projection with z bases on both sides; a transpose
        image has interfaces of its own."""
        terms = self._terms(x_core, lambda key: (ZAX_k[key], ZAX_kp1[key]),
                            lambda key, img: (ZAX_k[img], ZAX_kp1[img]))
        return kernels.kkt_block_product(terms, shape[1])

    def lcompressed_block_local_product(self, ZAX_k, XAX_kp1, x_core, shape) -> torch.Tensor:
        """z basis on the left, x basis on the right."""
        terms = self._terms(x_core, lambda key: (ZAX_k[key], XAX_kp1[key]),
                            lambda key, img: (ZAX_k[img], _flip(XAX_kp1[key])))
        return kernels.kkt_block_product(terms, shape[1])

    def rcompressed_block_local_product(self, XAX_k, ZAX_kp1, x_core, shape) -> torch.Tensor:
        """x basis on the left, z basis on the right."""
        terms = self._terms(x_core, lambda key: (XAX_k[key], ZAX_kp1[key]),
                            lambda key, img: (_flip(XAX_k[key]), ZAX_kp1[img]))
        return kernels.kkt_block_product(terms, shape[1])
