"""The random symmetric binary graphs behind the instances, in plain NumPy.

A frozen copy of the program's sampler (``tt_random_binary_sym`` and
``tt_random_graph`` of its ``ops/random.py``): the same draws from a numpy
``RandomState`` in the same order, so one seed gives the program's graph.
The rejection test rounds the sampled train as the program does
(``tt.round_train``, with the same absolute tolerance) and reads its
ranks; the graph is the rounded train's matrix.

One departure: a sample is taken only if it has an edge (a norm of at
least 1; the test here is > 0.5).  The program tests its train's norm
against 1e-12, and the norm of an empty sample, contracted core by core,
reads anywhere from 0 to some 1e-8 by rounding, so the program sometimes
takes an empty graph and scales its noise into the objective (corr_clust
d6 seed 325 of the upstream configuration is such an instance there).
Where the program takes a non-empty graph, the two agree.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from portbench.reference.tt import dense_matrix, round_train

__all__ = ["random_graph"]


def _skewed_probabilities(n: int, skew: float) -> np.ndarray:
    weights = np.exp(-skew * np.linspace(0, 1, n))
    return weights / weights.sum()


def _random_projector(basis, probabilities, rng) -> np.ndarray:
    dimension = len(basis)
    if dimension == 0:
        return np.array([[]])
    num = rng.randint(dimension)
    src = rng.choice(dimension, size=num, replace=False)
    tgt = rng.choice(dimension, size=num, replace=True, p=probabilities)
    projector = np.eye(dimension - 1)
    for i, j in zip(src, tgt):
        projector += np.outer(basis[i], basis[j] - basis[i])
    return projector


def _diag_projector(basis, discarded: Set[int], probabilities, rng, limit: int):
    dimension = len(basis)
    num = rng.randint(dimension) if dimension > 0 else 0
    src = rng.choice(dimension, size=num, replace=False)
    tgt1 = rng.choice(dimension, size=num, replace=True, p=probabilities)
    tgt2 = rng.choice(dimension, size=num, replace=True, p=probabilities)
    p1, p2 = np.eye(dimension - 1), np.eye(dimension - 1)
    updated = set(discarded)
    for i, j1, j2 in zip(src, tgt1, tgt2):
        if i in discarded and j1 != 0 and j2 != 0:
            if len(updated) <= limit or j1 in discarded or j2 in discarded:
                p1 += np.outer(basis[i], basis[j1] - basis[i])
                p2 += np.outer(basis[i], basis[j2] - basis[i])
                updated.discard(i)
                updated.add(j1)
                updated.add(j2)
        else:
            p1 += np.outer(basis[i], basis[j1] - basis[i])
            p2 += np.outer(basis[i], basis[j2] - basis[i])
    return p1, p2, updated


def _binary_sym_cores(dim: int, rank: int, skew: float, rng) -> List[np.ndarray]:
    """Vector cores (r, 4, R) of a random symmetric binary matrix."""
    q, _ = np.linalg.qr(rng.randn(rank, rank), mode="reduced")
    basis = np.vstack((np.zeros(rank), q.T))
    probabilities = _skewed_probabilities(rank + 1, skew)
    size = rank + 1
    first = rng.choice(size, size=3, replace=True, p=probabilities)
    core = np.zeros((1, 4, rank))
    core[:, [0, 1, 2, 3], :] = basis[[first[0], first[1], first[1], first[2]]]
    discarded: Set[int] = set()
    if first[0] != 0:
        discarded.add(int(first[0]))
    if first[2] != 0:
        discarded.add(int(first[2]))
    cores = [core]
    if dim <= 1:
        return cores
    for _ in range(dim - 2):
        core = np.empty((rank, 4, rank))
        off_diag = _random_projector(basis, probabilities, rng)
        core[:, 1, :] = off_diag
        core[:, 0, :], core[:, 3, :], discarded = _diag_projector(
            basis, discarded, probabilities, rng, limit=rank)
        core[:, 2, :] = off_diag
        cores.append(core)
    available = sorted(set(range(size)) - discarded)
    last = np.zeros((rank, 4, 1))
    p_avail = probabilities[available] / probabilities[available].sum()
    ortho = rng.choice(available, size=2, replace=True, p=p_avail)
    term = rng.choice(size, size=1, replace=True, p=probabilities)
    last[:, :, 0] = basis[[ortho[0], term[0], term[0], ortho[1]]].T
    cores.append(last)
    return cores


def random_graph(dim: int, rank: int, rng, skew: float = -1.0) -> np.ndarray:
    """Dense 2^dim x 2^dim graph whose train has bond ranks at most
    ``rank``, by the program's rejection sampling (999 draws at most, then
    the fixed fallback graph)."""
    current_rank, graph = 0, None
    for _ in range(1, 1000):
        cores = [c.reshape(c.shape[0], 2, 2, c.shape[-1])
                 for c in _binary_sym_cores(dim, 2 * rank, skew, rng)]
        if np.linalg.norm(dense_matrix(cores)) > 0.5:
            cores = round_train(cores, 1e-12)
            max_rank = max((c.shape[0] for c in cores[1:]), default=1)
            if current_rank <= max_rank <= rank:
                current_rank, graph = max_rank, dense_matrix(cores)
            if current_rank == rank:
                break
    if graph is None:
        edge = np.array([[0.0, 1.0], [1.0, 0.0]])
        graph = np.ones((1, 1))
        for _ in range(dim):
            graph = np.kron(graph, edge)
    return graph
