"""Checkpoint/resume for TT-IPM runs.

A checkpoint is one ``.npz`` holding the cores of the iterates X, Y, Z and
T (arrays ``X_0``, ``X_1``, ... in core order; T absent without
inequalities) and ``__meta__``, the UTF-8 bytes of a JSON object
``{"iteration": k, "scalars": {...}}``.  This is the file layout of
``ttipm_tpu/utils/checkpoint.py``, so a checkpoint written by either
package loads in the other.

Usage:
    save_ipm_checkpoint(path, X, Y, Z, T, iteration=k, scalars={"eta": ...})
    state = load_ipm_checkpoint(path, device="cuda")  # trains + scalars

``tt_ipm(..., checkpoint_path=..., checkpoint_every=N)`` writes one every
N iterations; ``resume_from=path`` restarts from the stored iterates.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["save_ipm_checkpoint", "load_ipm_checkpoint"]

_TRAIN_KEYS = ("X", "Y", "Z", "T")


def _pack_train(arrays: Dict[str, np.ndarray], name: str, train) -> None:
    if train is None:
        return
    for i, core in enumerate(train):
        arrays[f"{name}_{i}"] = (core.detach().cpu().numpy() if torch.is_tensor(core)
                                 else np.asarray(core))


def _unpack_train(data, name: str, device, dtype) -> Optional[List[torch.Tensor]]:
    cores = []
    while f"{name}_{len(cores)}" in data:
        cores.append(torch.as_tensor(data[f"{name}_{len(cores)}"], dtype=dtype, device=device))
    return cores or None


def save_ipm_checkpoint(path: str, X, Y, Z, T=None, iteration: int = 0,
                        scalars: Optional[dict] = None) -> None:
    """Atomically write the iterates and the scalar state to ``path``:
    the file is written beside it under a temporary name, then renamed."""
    arrays: Dict[str, np.ndarray] = {}
    for name, train in zip(_TRAIN_KEYS, (X, Y, Z, T)):
        _pack_train(arrays, name, train)
    meta = {"iteration": int(iteration), "scalars": scalars or {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_ipm_checkpoint(path: str, *, device, dtype=torch.float64) -> dict:
    """{'X', 'Y', 'Z', 'T', 'iteration', 'scalars'}; the trains on
    ``device`` in ``dtype`` (a missing train is None)."""
    with np.load(path) as data:
        out = {name: _unpack_train(data, name, device, dtype) for name in _TRAIN_KEYS}
        meta = json.loads(bytes(data["__meta__"]).decode())
    out["iteration"] = meta["iteration"]
    out["scalars"] = meta["scalars"]
    return out
