"""Exceptions of the AMEn solvers and the rank cap of the fused ladder.

Only these pieces of ``ttipm_tpu/solvers/amen.py`` are on the main path;
the ragged AMEn solver itself is not ported yet.
"""

from __future__ import annotations

__all__ = ["AmenToleranceReached", "AmenRestartsExhausted", "ladder_rank_cap"]


class AmenToleranceReached(RuntimeError):
    """The right-hand side is already below the absolute tolerance; callers
    treat this as convergence."""


class AmenRestartsExhausted(RuntimeError):
    """The restart budget is exhausted."""


def ladder_rank_cap(rank_restriction: int, d: int) -> int:
    """Largest solve rank the fused restart ladder may reach: the caller's
    restriction, the structural width 4^ceil(d/2), and the ceiling 32 of the
    dense local factorizations.  (The JAX package spells this formula out
    twice, ``solvers/fused.py:954`` and ``ipm.py:829``.)"""
    return int(min(rank_restriction, 4 ** ((d + 1) // 2), 32))
