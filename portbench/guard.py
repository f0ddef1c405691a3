"""The run's check that neither JAX nor the JAX package was loaded."""

from __future__ import annotations

import sys
from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_modules"]

# Top-level names that no process of the benchmark may hold.  The port,
# ``ttipm_tpu_torch``, begins with the JAX package's name, so names are
# compared whole, up to the first dot.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ttipm_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
