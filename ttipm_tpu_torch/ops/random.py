"""Random TT constructions: Gaussian trains and the random symmetric
binary-graph sampler behind the MaxCut instances.

Counterpart of ``ttipm_tpu/ops/random.py``.  Every draw is numpy, from the
RandomState ``rng`` (default numpy's global one), in the JAX package's
order, so one seed gives the same instance in both packages; the cores
then move to the requested device.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np
import torch

from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
from ttipm_tpu_torch.ops.tt import TT, tt_norm, tt_normalise, tt_ranks, tt_reshape

__all__ = [
    "tt_random_gaussian", "tt_random_graph", "tt_random_binary_sym",
    "skewed_probabilities",
]


def tt_random_gaussian(target_ranks: List[int], shape: Tuple[int, ...] = (2,), *,
                       device, dtype=torch.float64, rng=None) -> TT:
    """Normalised Gaussian TT of given internal ranks."""
    rng = np.random if rng is None else rng
    ranks = [1] + [int(r) for r in target_ranks] + [1]
    cores = [
        torch.as_tensor(
            rng.randn(rl, *shape, rr) / (rl * int(np.prod(shape)) * rr),
            dtype=dtype, device=device,
        )
        for rl, rr in zip(ranks[:-1], ranks[1:])
    ]
    return tt_normalise(cores)


def skewed_probabilities(n: int, skew: float = 0.0) -> np.ndarray:
    """Exponentially skewed categorical distribution."""
    weights = np.exp(-skew * np.linspace(0, 1, n))
    return weights / weights.sum()


def _random_projector(basis_vectors: np.ndarray, probabilities, rng) -> np.ndarray:
    """Identity plus random rank-1 basis couplings."""
    dimension = len(basis_vectors)
    if dimension == 0:
        return np.array([[]])
    num_couplings = rng.randint(dimension)
    src = rng.choice(dimension, size=num_couplings, replace=False)
    tgt = rng.choice(dimension, size=num_couplings, replace=True, p=probabilities)
    projector = np.eye(dimension - 1)
    for i, j in zip(src, tgt):
        projector += np.outer(basis_vectors[i], basis_vectors[j] - basis_vectors[i])
    return projector


def _diag_projector(basis_vectors: np.ndarray, discarded_indices: Set[int],
                    probabilities, rng, limit: int = 2):
    """Paired diagonal projectors tracking which basis directions remain
    available for the terminal core."""
    dimension = len(basis_vectors)
    num_couplings = rng.randint(dimension) if dimension > 0 else 0
    src = rng.choice(dimension, size=num_couplings, replace=False)
    tgt1 = rng.choice(dimension, size=num_couplings, replace=True, p=probabilities)
    tgt2 = rng.choice(dimension, size=num_couplings, replace=True, p=probabilities)

    projector_1 = np.eye(dimension - 1)
    projector_2 = np.eye(dimension - 1)
    updated = set(discarded_indices)
    for i, j1, j2 in zip(src, tgt1, tgt2):
        if i in discarded_indices and j1 != 0 and j2 != 0:
            if (len(updated) <= limit or (j1 in discarded_indices)
                    or (j2 in discarded_indices)):
                projector_1 += np.outer(basis_vectors[i], basis_vectors[j1] - basis_vectors[i])
                projector_2 += np.outer(basis_vectors[i], basis_vectors[j2] - basis_vectors[i])
                updated.discard(i)
                updated.add(j1)
                updated.add(j2)
        else:
            projector_1 += np.outer(basis_vectors[i], basis_vectors[j1] - basis_vectors[i])
            projector_2 += np.outer(basis_vectors[i], basis_vectors[j2] - basis_vectors[i])
    return projector_1, projector_2, updated


def tt_random_binary_sym(dim: int, rank: int, skew: float = 5.0,
                         rng=None) -> List[np.ndarray]:
    """Random symmetric binary matrix as a (1,4,r)/(r,4,r) vector train of
    numpy cores."""
    rng = np.random if rng is None else rng
    if rank <= 0:
        return []
    q_matrix, _ = np.linalg.qr(rng.randn(rank, rank), mode="reduced")
    basis_vectors = np.vstack((np.zeros(rank), q_matrix.T))
    probabilities = skewed_probabilities(rank + 1, skew)
    basis_size = rank + 1

    initial_indices = rng.choice(basis_size, size=3, replace=True, p=probabilities)
    initial_core = np.zeros((1, 4, rank))
    initial_core[:, [0, 1, 2, 3], :] = basis_vectors[
        [initial_indices[0], initial_indices[1], initial_indices[1], initial_indices[2]]
    ]
    discarded: Set[int] = set()
    if initial_indices[0] != 0:
        discarded.add(int(initial_indices[0]))
    if initial_indices[2] != 0:
        discarded.add(int(initial_indices[2]))
    cores = [initial_core]
    if dim <= 1:
        return cores

    for _ in range(dim - 2):
        core = np.empty((rank, 4, rank))
        off_diag = _random_projector(basis_vectors, probabilities, rng)
        core[:, 1, :] = off_diag
        core[:, 0, :], core[:, 3, :], discarded = _diag_projector(
            basis_vectors, discarded, probabilities, rng, limit=rank
        )
        core[:, 2, :] = off_diag
        cores.append(core)

    available = sorted(set(range(basis_size)) - discarded)
    terminal_core = np.zeros((rank, 4, 1))
    probs_avail = probabilities[available] / probabilities[available].sum()
    ortho = rng.choice(available, size=2, replace=True, p=probs_avail)
    term = rng.choice(basis_size, size=1, replace=True, p=probabilities)
    final_indices = [ortho[0], term[0], term[0], ortho[1]]
    terminal_core[:, :, 0] = basis_vectors[final_indices].T
    cores.append(terminal_core)
    return cores


def tt_random_graph(dim: int, r: int, skew: float = -1.0, eps: float = 1e-12, *,
                    device, dtype=torch.float64, rng=None) -> TT:
    """Rejection-sample a random graph TT until the target rank is hit."""
    rng = np.random if rng is None else rng
    current_rank = 0
    current_graph_tt = None
    for _ in range(1, 1000):
        raw = tt_random_binary_sym(dim, 2 * r, skew=skew, rng=rng)
        graph = [torch.as_tensor(c, dtype=dtype, device=device) for c in raw]
        if tt_norm(graph) > 1e-12:
            graph = tt_rank_reduce(tt_reshape(graph, (2, 2)), 1e-12)
            max_rank = int(np.max(tt_ranks(graph))) if tt_ranks(graph) else 1
            if current_rank <= max_rank <= r:
                current_rank = max_rank
                current_graph_tt = graph
            if current_rank == r:
                break
    if current_graph_tt is None:
        edge = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=dtype,
                            device=device).reshape(1, 2, 2, 1)
        current_graph_tt = [edge] * dim
    return current_graph_tt
