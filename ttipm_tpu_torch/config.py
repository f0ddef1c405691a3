"""Numeric configuration of the PyTorch port.

Holds only the switches that the MaxCut main path reads
(``ttipm_tpu/config.py:20-60,170,273-330``): the rank bucket, the choice of
the fused or the ragged (reference-faithful) KKT solver and eigensolver,
and Newton-residual refinement.  The float64 profile is the only one
ported, so its setter accepts nothing else.  The device is not a setting:
every function follows the device of the tensors it is given.
"""

from __future__ import annotations

import torch

_RANK_BUCKET = 4
_NEWTON_REFINE = True
_FUSED_KKT = True


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
    """On (the default): the IPM solves its Newton systems with the fused
    fixed-rank ladder, falling back to the ragged AMEn when the ladder
    exhausts, and takes its step sizes from the fused eigensolver.  Off:
    the ragged AMEn and the ragged eigensolver throughout."""
    global _FUSED_KKT
    _FUSED_KKT = bool(flag)


def fused_kkt() -> bool:
    return _FUSED_KKT


def set_newton_refine(flag: bool) -> None:
    global _NEWTON_REFINE
    _NEWTON_REFINE = bool(flag)


def newton_refine() -> bool:
    return _NEWTON_REFINE
