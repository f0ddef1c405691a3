"""Plain NumPy tensor trains of 2^d x 2^d matrices.

A matrix train has cores of shape (r, 2, 2, R): core k holds bit k of the
row index and bit k of the column index, the first core the most
significant bits.  A vector train of the same matrix has cores (r, 4, R),
its physical index 2 * row bit + column bit.  A diagonal operator train
(r, 4, 4, R) acts on a vectorised matrix as an entrywise mask.

Written for the benchmark alone: it imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["dense_matrix", "matrix_train", "round_train", "vector_cores", "diag_op_cores"]


def dense_matrix(cores: List[np.ndarray]) -> np.ndarray:
    """The 2^d x 2^d matrix of a matrix or vector train."""
    acc = np.ones((1, 1, 1))
    for core in cores:
        core = np.asarray(core, dtype=np.float64)
        core = core.reshape(core.shape[0], 2, 2, core.shape[-1])
        rows, cols = acc.shape[0], acc.shape[1]
        acc = np.einsum("abr,rijR->aibjR", acc, core).reshape(2 * rows, 2 * cols,
                                                              core.shape[-1])
    return acc[:, :, 0]


def _interleaved(matrix: np.ndarray) -> np.ndarray:
    """``matrix`` as a tensor of d axes of size 4, axis k holding (row bit
    k, column bit k)."""
    d = int(round(np.log2(matrix.shape[0])))
    if matrix.shape != (2**d, 2**d):
        raise ValueError(f"a 2^d x 2^d matrix is expected, got {matrix.shape}")
    t = matrix.reshape([2] * (2 * d))
    t = t.transpose([a for k in range(d) for a in (k, d + k)])
    return t.reshape([4] * d)


def _keep(s: np.ndarray, bond_tol: float) -> int:
    """Singular values kept at one bond: the fewest whose discarded tail
    has energy below ``bond_tol``^2, at least one."""
    tail = np.cumsum(s[::-1] ** 2)[::-1]
    hits = np.nonzero(tail < bond_tol**2)[0]
    return max(int(hits[0]) if hits.size else int(s.size), 1)


def matrix_train(matrix: np.ndarray, tol: float = 1e-12) -> List[np.ndarray]:
    """Train of ``matrix`` by sequential SVDs; each of the d - 1 bonds
    discards at most (tol / sqrt(d - 1))^2 of energy, the rule the
    program's rounding applies to the same absolute ``tol``."""
    t = _interleaved(np.asarray(matrix, dtype=np.float64))
    d = t.ndim
    bond_tol = tol / np.sqrt(max(d - 1, 1))
    cores, rank, rest = [], 1, t.reshape(1, -1)
    for _ in range(d - 1):
        u, s, vt = np.linalg.svd(rest.reshape(rank * 4, -1), full_matrices=False)
        k = _keep(s, bond_tol)
        cores.append(u[:, :k].reshape(rank, 2, 2, k))
        rest, rank = s[:k, None] * vt[:k], k
    cores.append(rest.reshape(rank, 2, 2, 1))
    return cores


def round_train(cores: List[np.ndarray], tol: float) -> List[np.ndarray]:
    """The program's rounding of a train: a right-to-left QR sweep, then
    left-to-right truncated SVDs, each bond discarding at most
    (tol / sqrt(d - 1))^2 of energy."""
    out = [np.asarray(c, dtype=np.float64) for c in cores]
    d = len(out)
    if d == 1 or all(c.shape[0] == 1 for c in out[1:]):
        return out
    for i in range(d - 1, 0, -1):
        core, prev = out[i], out[i - 1]
        r = core.shape[0]
        q, rm = np.linalg.qr(core.reshape(r, -1).T)
        k = q.shape[1]
        out[i] = q.T.reshape((k,) + core.shape[1:])
        out[i - 1] = (prev.reshape(-1, r) @ rm.T).reshape(prev.shape[:-1] + (k,))
    bond_tol = tol / np.sqrt(d - 1)
    for i in range(d - 1):
        shape = out[i].shape
        u, s, vt = np.linalg.svd(out[i].reshape(-1, shape[-1]), full_matrices=False)
        k = _keep(s, bond_tol)
        nxt = out[i + 1]
        out[i + 1] = ((s[:k, None] * vt[:k]) @ nxt.reshape(nxt.shape[0], -1)).reshape(
            (k,) + nxt.shape[1:])
        out[i] = u[:, :k].reshape(shape[:-1] + (k,))
    return out


def vector_cores(cores: List[np.ndarray]) -> List[np.ndarray]:
    """Matrix train -> vector train of the same matrix."""
    return [c.reshape(c.shape[0], 4, c.shape[-1]) for c in cores]


def diag_op_cores(cores: List[np.ndarray]) -> List[np.ndarray]:
    """Matrix train of a mask M -> operator train of X -> M * X on the
    vectorised X."""
    eye = np.eye(4)
    return [np.einsum("ij,rjR->rijR", eye, c.reshape(c.shape[0], 4, c.shape[-1]))
            for c in cores]
