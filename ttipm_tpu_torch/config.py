"""Numeric configuration of the PyTorch port.

Holds only the switches that the MaxCut main path reads
(``ttipm_tpu/config.py:20-60,170,273-330``): the rank bucket and
Newton-residual refinement.  The float64 profile and the fused KKT solver
are the only ones ported, so their setters accept nothing else.  The
device is not a setting: every function follows the device of the tensors
it is given.
"""

from __future__ import annotations

import torch

_RANK_BUCKET = 4
_NEWTON_REFINE = True


def set_dtype(dtype) -> None:
    """Select the TT dtype.  Only float64 is ported so far."""
    if dtype != torch.float64:
        raise NotImplementedError(
            f"dtype {dtype}: the port covers the float64 profile only"
        )


def set_rank_bucket(bucket: int) -> None:
    global _RANK_BUCKET
    _RANK_BUCKET = max(int(bucket), 1)


def rank_bucket() -> int:
    return _RANK_BUCKET


def bucket_rank(r: int) -> int:
    """Smallest padded rank >= r: ranks 1 and 2 stay exact, larger ranks
    round up to a multiple of the bucket (bucket 1 disables padding)."""
    r = int(r)
    if _RANK_BUCKET <= 1 or r <= 2:
        return r
    b = _RANK_BUCKET
    return ((r + b - 1) // b) * b


def set_fused_kkt(flag: bool) -> None:
    """The fused fixed-rank KKT solver is the only Newton solver ported."""
    if not flag:
        raise NotImplementedError(
            "the ragged AMEn solver is not ported; fused_kkt stays on"
        )


def set_newton_refine(flag: bool) -> None:
    global _NEWTON_REFINE
    _NEWTON_REFINE = bool(flag)


def newton_refine() -> bool:
    return _NEWTON_REFINE
