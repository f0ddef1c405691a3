"""Core Tensor-Train algebra on torch tensors.

A TT *vector* with ``d`` cores of shape ``(r_k, n, r_{k+1})`` represents an
``n^d`` vector; a TT *matrix* with cores ``(r_k, m, n, r_{k+1})`` represents
an ``m^d x n^d`` matrix.  Boundary ranks are 1.  A TT is a plain list of
tensors; every function follows the device and dtype of the cores it is
given, and constructors take them explicitly.  Cores are never modified in
place, so a list may hold the same tensor several times.

Counterpart of ``ttipm_tpu/ops/tt.py``.
"""

from __future__ import annotations

from functools import reduce
from typing import List, Sequence

import numpy as np
import torch

from ttipm_tpu_torch.ops.linalg import safe_svd

__all__ = [
    "TT", "E", "tt_identity", "tt_zero_matrix", "tt_one_matrix",
    "tt_transpose", "tt_ranks", "tt_scale", "tt_swap_all", "tt_copy", "tt_add",
    "tt_sub", "tt_sum", "tt_inner_prod", "tt_norm", "tt_l2_dist",
    "tt_normalise", "tt_trace", "tt_entrywise_sum", "tt_diag", "tt_diagonal",
    "tt_diag_op", "tt_reshape", "tt_merge_cores", "tt_split_bonds",
    "tt_merge_bonds", "tt_IkronM", "tt_MkronI", "tt_kron", "tt_tril_one_matrix",
    "tt_triu_one_matrix", "tt_entry",
    "tt_to_tensor", "tt_matrix_to_matrix", "tt_vec_to_vec", "tt_svd",
    "tt_matrix_svd", "symmetric_powers_of_two",
]

TT = List[torch.Tensor]


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def E(i: int, j: int, *, device, dtype=torch.float64) -> torch.Tensor:
    """Rank-1 core (1, 2, 2, 1) holding the 2x2 elementary matrix e_i e_j^T."""
    core = torch.zeros((1, 2, 2, 1), device=device, dtype=dtype)
    core[0, i, j, 0] = 1.0
    return core


def tt_identity(dim: int, n: int = 2, *, device, dtype=torch.float64) -> TT:
    core = torch.eye(n, device=device, dtype=dtype).reshape(1, n, n, 1)
    return [core] * dim


def tt_zero_matrix(dim: int, n: int = 2, *, device, dtype=torch.float64) -> TT:
    return [torch.zeros((1, n, n, 1), device=device, dtype=dtype)] * dim


def tt_one_matrix(dim: int, n: int = 2, *, device, dtype=torch.float64) -> TT:
    return [torch.ones((1, n, n, 1), device=device, dtype=dtype)] * dim


# ---------------------------------------------------------------------------
# Structure ops
# ---------------------------------------------------------------------------

def tt_transpose(matrix_tt: TT) -> TT:
    """Swap the two physical axes of every matrix core; for block trains
    the swap starts at the block core (the one with the most axes)."""
    split = int(np.argmax([c.ndim for c in matrix_tt]))
    return list(matrix_tt[:split]) + [c.transpose(1, 2) for c in matrix_tt[split:]]


def tt_ranks(train_tt: TT) -> List[int]:
    """Internal bond ranks (d-1 entries)."""
    return [int(c.shape[0]) for c in train_tt[1:]]


def tt_scale(alpha, train_tt: TT) -> TT:
    """Scale the represented tensor by ``alpha`` (scales core 0)."""
    return [train_tt[0] * alpha] + list(train_tt[1:])


def tt_swap_all(train_tt: TT) -> TT:
    """Reverse core order and flip every core's bond axes."""
    return [c.transpose(0, -1) for c in reversed(train_tt)]


def tt_copy(train_tt: TT) -> TT:
    """Shallow list copy (cores are never modified in place)."""
    return list(train_tt)


# ---------------------------------------------------------------------------
# Addition
# ---------------------------------------------------------------------------

def _block_diag_core(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    r1, R1 = c1.shape[0], c1.shape[-1]
    r2, R2 = c2.shape[0], c2.shape[-1]
    out = c1.new_zeros((r1 + r2,) + tuple(c1.shape[1:-1]) + (R1 + R2,))
    out[:r1, ..., :R1] = c1
    out[r1:, ..., R1:] = c2
    return out


def tt_add(train_1_tt: TT, train_2_tt: TT) -> TT:
    """Rank-additive TT addition."""
    if len(train_1_tt) != len(train_2_tt):
        raise ValueError(
            f"tt_add: train lengths differ "
            f"({len(train_1_tt)} vs {len(train_2_tt)})"
        )
    t1, t2 = train_1_tt, train_2_tt
    if len(t1) == 1:
        return [t1[0] + t2[0]]
    first = torch.cat((t1[0], t2[0]), dim=-1)
    last = torch.cat((t1[-1], t2[-1]), dim=0)
    mids = [_block_diag_core(c1, c2) for c1, c2 in zip(t1[1:-1], t2[1:-1])]
    return [first] + mids + [last]


def tt_sub(train_1_tt: TT, train_2_tt: TT) -> TT:
    if len(train_1_tt) != len(train_2_tt):
        raise ValueError(
            f"tt_sub: train lengths differ "
            f"({len(train_1_tt)} vs {len(train_2_tt)})"
        )
    return tt_add(train_1_tt, tt_scale(-1.0, train_2_tt))


def tt_sum(*args: TT, op_tol: float = 1e-18, rank_reduce: bool = True) -> TT:
    """Sum of several trains, rounded to ``op_tol`` after each addition
    unless ``rank_reduce`` is false."""
    from ttipm_tpu_torch.ops.rounding import tt_rank_reduce

    acc = args[0]
    for arg in args[1:]:
        acc = tt_add(acc, arg)
        if rank_reduce:
            acc = tt_rank_reduce(acc, op_tol)
    return acc


# ---------------------------------------------------------------------------
# Inner products and norms (host floats: the IPM branches on them)
# ---------------------------------------------------------------------------

def _inner_prod_tensor(train_1_tt: TT, train_2_tt: TT) -> torch.Tensor:
    """<A, B> accumulated in f64 whatever the cores' type, as the JAX
    package's host engine does (its f64 accumulator promotes f32 cores:
    ``ttipm_tpu/ops/tt.py:306``); the IPM branches on these scalars."""
    acc = train_1_tt[0].new_ones((1, 1), dtype=torch.float64)
    for c1, c2 in zip(train_1_tt, train_2_tt):
        if c1.ndim == 4:
            acc = torch.einsum("ab,aijc,bijd->cd", acc, c1.double(), c2.double())
        else:
            acc = torch.einsum("ab,aic,bid->cd", acc, c1.double(), c2.double())
    return acc[0, 0]


def tt_inner_prod(train_1_tt: TT, train_2_tt: TT) -> float:
    """<A, B> by a left-to-right two-train contraction, in f64."""
    return float(_inner_prod_tensor(train_1_tt, train_2_tt))


def tt_norm(train_tt: TT) -> float:
    val = tt_inner_prod(train_tt, train_tt)
    return float(np.sqrt(val)) if val > 0 else 0.0


def tt_l2_dist(train_1_tt: TT, train_2_tt: TT) -> float:
    return tt_norm(tt_sub(train_1_tt, train_2_tt))


def tt_normalise(train_tt: TT, radius: float = 1) -> TT:
    return tt_scale(radius / np.sqrt(tt_inner_prod(train_tt, train_tt)), train_tt)


def tt_trace(matrix_tt: TT) -> float:
    c = matrix_tt[0]
    return tt_inner_prod(
        matrix_tt,
        tt_identity(len(matrix_tt), n=c.shape[1], device=c.device, dtype=c.dtype),
    )


def tt_entrywise_sum(train_tt: TT) -> float:
    """Sum of all entries, accumulated in f64 (``ttipm_tpu/ops/tt.py:348``)."""
    acc = train_tt[0].new_ones((1,), dtype=torch.float64)
    for c in train_tt:
        if c.ndim == 4:
            acc = torch.einsum("a,aijb->b", acc, c.double())
        else:
            acc = torch.einsum("a,aib->b", acc, c.double())
    return float(acc.sum())


# ---------------------------------------------------------------------------
# Diagonal embed / extract / operator
# ---------------------------------------------------------------------------

def tt_diag(vec_tt: TT, eps: float = 1e-18) -> TT:
    """Diag-embed a TT vector into a TT matrix."""
    from ttipm_tpu_torch.ops.rounding import tt_rank_reduce

    c0 = vec_tt[0]
    eye = torch.eye(c0.shape[1], device=c0.device, dtype=c0.dtype)
    cores = [torch.einsum("ij,rjR->rijR", eye, c) for c in vec_tt]
    return tt_rank_reduce(cores, eps)


def tt_diagonal(matrix_tt: TT) -> TT:
    """Extract the diagonal as a TT vector."""
    return [
        torch.diagonal(c, dim1=1, dim2=2).permute(0, 2, 1).contiguous()
        for c in matrix_tt
    ]


def tt_diag_op(matrix_tt: TT, eps: float = 1e-18) -> TT:
    """Operator TT of ``Diag(vec(M))`` acting on vec'd matrices: each
    (r,m,n,R) core becomes an (r, m*n, m*n, R) diagonal operator core."""
    from ttipm_tpu_torch.ops.rounding import tt_rank_reduce

    c0 = matrix_tt[0]
    mn = c0.shape[1] * c0.shape[2]
    eye = torch.eye(mn, device=c0.device, dtype=c0.dtype)
    cores = [
        torch.einsum("ij,rjR->rijR", eye, c.reshape(c.shape[0], mn, c.shape[-1]))
        for c in matrix_tt
    ]
    return tt_rank_reduce(cores, eps)


# ---------------------------------------------------------------------------
# Reshapes between matrix-TT and vector-TT views
# ---------------------------------------------------------------------------

def tt_merge_cores(train_tt: TT) -> TT:
    """Contract adjacent core pairs (2k, 2k+1) into single cores."""
    if train_tt[0].ndim == 3:
        return [
            torch.einsum("kir,rsK->kisK", c1, c2)
            for c1, c2 in zip(train_tt[:-1:2], train_tt[1::2])
        ]
    return [
        torch.einsum("kijr,rsdK->kisjdK", c1, c2)
        for c1, c2 in zip(train_tt[:-1:2], train_tt[1::2])
    ]


def tt_reshape(train_tt: TT, shape: Sequence[int]) -> TT:
    """Reshape each core's physical axes to ``shape`` ((4,) flattens
    (r,2,2,R) matrix cores into vector cores, (2,2) is the inverse).  If
    the target physical volume exceeds a core's, adjacent cores are merged
    first."""
    shape = tuple(int(s) for s in shape)
    cores = train_tt
    if int(np.prod(shape)) > int(np.prod(cores[0].shape[1:-1])):
        cores = tt_merge_cores(cores)
    return [c.reshape((c.shape[0],) + shape + (c.shape[-1],)) for c in cores]


def _break_core_bond(core: torch.Tensor, err_bound: float = 1e-18):
    """SVD-split one core with 2k physical axes into two cores."""
    shape = core.shape
    k = len(shape) // 2
    mat = core.reshape(int(np.prod(shape[:k])), -1)
    u, s, v_t = safe_svd(mat)
    keep = torch.nonzero(s.abs() > err_bound).flatten()
    if keep.numel() == 0:
        keep = keep.new_zeros(1)
    r = int(keep.numel())
    u = u[:, keep]
    sv = s[keep][:, None] * v_t[keep, :]
    return [u.reshape(*shape[:k], r), sv.reshape(r, *shape[k:])]


def tt_split_bonds(matrix_tt: TT) -> TT:
    """Split every (r,m,n,R) matrix core into two vector cores."""
    out: TT = []
    for c in matrix_tt:
        out.extend(_break_core_bond(c))
    return out


def tt_merge_bonds(vec_tt: TT) -> TT:
    """Merge vector-core pairs into matrix cores."""
    return [
        torch.einsum("abc,cde->abde", c1, c2)
        for c1, c2 in zip(vec_tt[:-1:2], vec_tt[1::2])
    ]


# ---------------------------------------------------------------------------
# Kronecker lifts (KKT assembly building blocks)
# ---------------------------------------------------------------------------

def _kron_cores(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    out = torch.einsum("rmnR,lijL->rlminjRL", c1, c2)
    return out.reshape(
        c1.shape[0] * c2.shape[0], c1.shape[1] * c2.shape[1],
        c1.shape[2] * c2.shape[2], c1.shape[-1] * c2.shape[-1],
    )


def _eye_core(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(2, device=ref.device, dtype=ref.dtype).reshape(1, 2, 2, 1)


def tt_IkronM(matrix_tt: TT) -> TT:
    """Lift ``M -> I (x) M`` per core: (r,2,2,R) -> (r,4,4,R)."""
    eye = _eye_core(matrix_tt[0])
    return [_kron_cores(eye, c) for c in matrix_tt]


def tt_MkronI(matrix_tt: TT) -> TT:
    """Lift ``M -> M (x) I`` per core."""
    eye = _eye_core(matrix_tt[0])
    return [_kron_cores(c, eye) for c in matrix_tt]


def tt_kron(matrix_tt_1: TT, matrix_tt_2: TT) -> TT:
    """Core-wise Kronecker product."""
    return [_kron_cores(c1, c2) for c1, c2 in zip(matrix_tt_1, matrix_tt_2)]


# ---------------------------------------------------------------------------
# Triangular all-ones matrices (graphm constraint constructions)
# ---------------------------------------------------------------------------

def _triangular_one_matrix(strict_ij, dim: int, device, dtype) -> TT:
    """All-ones matrix on and on one side of the diagonal: a rank-2 train
    whose state is "the rows and columns were equal so far" (the diagonal
    cores) or "the strict side was taken" (all-ones cores after)."""
    strict = E(*strict_ij, device=device, dtype=dtype)
    if dim == 1:
        return [strict + E(0, 0, device=device, dtype=dtype) + E(1, 1, device=device,
                                                                  dtype=dtype)]
    one = torch.ones((1, 2, 2, 1), device=device, dtype=dtype)
    zero = torch.zeros((1, 2, 2, 1), device=device, dtype=dtype)
    diag = E(0, 0, device=device, dtype=dtype) + E(1, 1, device=device, dtype=dtype)
    first = torch.cat((strict, diag), dim=-1)
    mid = torch.cat((torch.cat((one, strict), dim=0), torch.cat((zero, diag), dim=0)), dim=-1)
    last = torch.cat((one, strict + diag), dim=0)
    return [first] + [mid] * (dim - 2) + [last]


def tt_tril_one_matrix(dim: int, *, device, dtype=torch.float64) -> TT:
    """TT of the lower-triangular all-ones 2^dim x 2^dim matrix."""
    return _triangular_one_matrix((1, 0), dim, device, dtype)


def tt_triu_one_matrix(dim: int, *, device, dtype=torch.float64) -> TT:
    """TT of the upper-triangular all-ones 2^dim x 2^dim matrix."""
    return _triangular_one_matrix((0, 1), dim, device, dtype)


# ---------------------------------------------------------------------------
# Dense converters (test oracles)
# ---------------------------------------------------------------------------

def tt_entry(train_tt: TT, indices: Sequence[int]) -> float:
    """Single entry of the represented tensor (one index per core; a matrix
    core takes the same index on both physical axes)."""
    mats = []
    for i, core in zip(indices, train_tt):
        mats.append(core[(slice(None),) + (i,) * (core.ndim - 2)])
    return float(reduce(torch.matmul, mats).sum())


def tt_to_tensor(train_tt: TT) -> torch.Tensor:
    tensor = train_tt[0]
    for core in train_tt[1:]:
        tensor = torch.tensordot(tensor, core, dims=([-1], [0]))
    return tensor.sum(dim=(0, -1))


def tt_matrix_to_matrix(matrix_tt: TT) -> torch.Tensor:
    """Densify a TT matrix to a full 2^d x 2^d matrix."""
    if len(matrix_tt) == 1:
        return matrix_tt[0][0, :, :, 0]
    tensor = tt_to_tensor(matrix_tt)
    n = tensor.ndim
    axes = list(range(0, n - 1, 2)) + list(range(1, n, 2))
    tensor = tensor.permute(axes)
    rows = int(np.prod(tensor.shape[: n // 2]))
    return tensor.reshape(rows, -1)


def tt_vec_to_vec(vec_tt: TT) -> torch.Tensor:
    return tt_to_tensor(vec_tt).reshape(-1, 1)


def tt_svd(tensor: torch.Tensor, err_bound: float = 1e-18) -> TT:
    """Dense tensor -> TT via sequential truncated SVDs."""
    shape = tensor.shape
    total = float(torch.sum(tensor * tensor))
    bound = err_bound * np.sqrt(total / max(len(shape) - 1, 1))
    rank = 1
    cores: TT = []
    for i in range(len(shape) - 1):
        mat = tensor.reshape(rank * shape[i], -1)
        u, s, v_t = safe_svd(mat)
        s_max = float(s.max()) if s.numel() else 0.0
        keep = torch.nonzero(s >= min(s_max, bound)).flatten()
        if keep.numel() == 0:
            keep = keep.new_zeros(1)
        next_rank = int(keep.numel())
        cores.append(u[:, keep].reshape(rank, shape[i], next_rank))
        tensor = s[keep][:, None] * v_t[keep, :]
        rank = next_rank
    cores.append(tensor.reshape(rank, shape[-1], 1))
    return cores


def tt_matrix_svd(matrix: torch.Tensor, err_bound: float = 1e-18) -> TT:
    """Dense 2^d x 2^d matrix -> TT matrix."""
    d2 = int(np.log2(matrix.shape[0] * matrix.shape[1]))
    tensor = matrix.reshape([2] * d2)
    n = tensor.ndim
    axes = [a for pair in zip(range(n // 2), range(n // 2, n)) for a in pair]
    return tt_merge_bonds(tt_svd(tensor.permute(axes), err_bound))


# ---------------------------------------------------------------------------
# Rank schedules
# ---------------------------------------------------------------------------

def symmetric_powers_of_two(length: int) -> np.ndarray:
    """Max-rank profile [2,4,8,...,8,4,2]."""
    if length <= 0:
        return np.array([], dtype=np.int64)
    half = length // 2
    out = np.empty(length, dtype=np.int64)
    for i in range(half):
        out[i] = 1 << (i + 1)
    if length % 2 != 0:
        out[half] = 1 << (half + 1)
    for i in range(half):
        out[length - 1 - i] = out[i]
    return out
