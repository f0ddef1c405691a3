"""MaxCut instances: a frozen copy of the program's ``models/maxcut.py``.

maximise <L / ||L||, X> sqrt(d) subject to diag(X) = sqrt(d) / 2^(d/2),
X psd, where L is the Laplacian of a random graph of train rank
``graph_rank`` (``reference/graph.py``).  The multiplier Y lives on the
diagonal: its support map masks the off-diagonal entries.
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
    laplacian = np.diag(graph.sum(axis=1)) - graph
    eye = np.eye(2**dim)
    scale = np.sqrt(dim)
    return Problem(C=laplacian * scale / np.linalg.norm(laplacian),
                   B=eye * scale / np.linalg.norm(eye),
                   eq_mask=eye, lag={"y": 1.0 - eye})
