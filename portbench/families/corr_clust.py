"""Correlation-clustering instances: a frozen copy of the program's
``models/corr_clust.py``.

A graph G of train rank ``graph_rank`` and a mask graph M of rank 1
(``reference/graph.py``, drawn in that order) give the similarity graph
G * M and the dissimilarity graph G * (1 - M).  The objective is the
similarity graph plus the Laplacian of the dissimilarity graph, scaled to
norm sqrt(d); the constraints are MaxCut's diagonal ones and X_ij >= -beta
on G's support (``ineq_beta``, the program's inequality boundary).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.graph import random_graph
from portbench.reference.sdp import Problem


def problem(config: dict, rng: np.random.RandomState) -> Problem:
    """The instance drawn from ``rng``, as the program's generator draws it
    (the program's runner seeds numpy's stream with the seed and goes on
    with the same stream in the solve)."""
    dim = int(config["dim"])
    graph = random_graph(dim, int(config["graph_rank"]), rng)
    mask = random_graph(dim, 1, rng)
    dissimilar = graph * (1.0 - mask)
    objective = graph * mask + np.diag(dissimilar.sum(axis=1)) - dissimilar
    eye = np.eye(2**dim)
    scale = np.sqrt(dim)
    return Problem(C=objective * scale / np.linalg.norm(objective),
                   B=eye * scale / np.linalg.norm(eye),
                   eq_mask=eye, lag={"y": 1.0 - eye, "t": 1.0 - graph},
                   ineq_mask=graph, beta=float(config["ineq_beta"]))
