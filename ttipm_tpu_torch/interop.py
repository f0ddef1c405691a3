"""Carry trains and block systems between numpy and the port.

A TT given as a list of array-likes (numpy arrays, or anything
``np.asarray`` accepts, such as the JAX package's cores) becomes a list of
torch cores on a given device and dtype, and back.  Block systems are
carried the same way: a block matrix is a dict of trains keyed by (row,
col) with its alias and transpose maps, a block vector a dict of trains
keyed by row.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ttipm_tpu_torch.solvers.blocks import TTBlockMatrix, TTBlockVector

__all__ = [
    "tt_to_torch", "tt_to_numpy", "block_matrix_to_torch",
    "block_vector_to_torch", "block_matrix_to_numpy", "block_vector_to_numpy",
]


def tt_to_torch(train, *, device, dtype=torch.float64) -> List[torch.Tensor]:
    return [torch.tensor(np.asarray(c), dtype=dtype, device=device) for c in train]


def tt_to_numpy(train) -> List[np.ndarray]:
    return [c.detach().cpu().numpy() if torch.is_tensor(c) else np.asarray(c)
            for c in train]


def block_matrix_to_torch(data: Dict, aliases: Dict = None, transposes: Dict = None,
                          *, device, dtype=torch.float64) -> TTBlockMatrix:
    """``data``: {(row, col): train}; ``aliases`` / ``transposes``: {(i, j):
    (k, t)} as in ``TTBlockMatrix.add_alias``."""
    out = TTBlockMatrix()
    for key, train in data.items():
        out[tuple(key)] = tt_to_torch(train, device=device, dtype=dtype)
    for key, val in (aliases or {}).items():
        out.add_alias(tuple(key), tuple(val))
    for key, val in (transposes or {}).items():
        out.add_alias(tuple(key), tuple(val), is_transpose=True)
    return out


def block_vector_to_torch(rows: Dict, *, device, dtype=torch.float64) -> TTBlockVector:
    out = TTBlockVector()
    for i, train in rows.items():
        out[int(i)] = tt_to_torch(train, device=device, dtype=dtype)
    return out


def block_matrix_to_numpy(mat: TTBlockMatrix):
    """Returns (data, aliases, transposes) with numpy trains."""
    data = {k: tt_to_numpy(v) for k, v in mat._data.items()}
    return data, dict(mat._aliases), dict(mat._transposes)


def block_vector_to_numpy(vec: TTBlockVector) -> Dict[int, List[np.ndarray]]:
    return {i: tt_to_numpy(v) for i, v in vec.items()}
