"""The dense semidefinite program of an instance, and the plain judgement of
an answer to it.

An instance is

    maximise <C, X>  subject to  E * X = B,  X psd,
                                 X_ij + beta >= 0 where G_ij = 1,

with E the mask of the equality constraints (the identity for the
diagonal constraints), ``*`` the entrywise product and G the optional
mask of the inequality constraints.  Its Lagrangian dual asks for Y on
E's support, T >= 0 on G's and Z = E * Y - C - T psd.  Weak duality
makes the primal objective of a feasible X at most the dual objective
<B, Y> + beta * sum(T) of a feasible (Y, Z, T); their difference is
<X, Z> + <X + beta G, T>.

``judge`` measures an answer (X, Y, Z, T) against these conditions, in
float64, from the dense matrices alone.  It imports nothing of the
program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

__all__ = ["Problem", "judge"]


@dataclass
class Problem:
    """One instance, dense (see the module docstring).  ``lag`` holds the
    masks of the multipliers' support maps the program takes with the
    instance: where Y's (and T's) entries are held at zero."""

    C: np.ndarray
    B: np.ndarray
    eq_mask: np.ndarray
    lag: Dict[str, np.ndarray] = field(default_factory=dict)
    ineq_mask: Optional[np.ndarray] = None
    beta: float = 0.0


def _sym(m: np.ndarray) -> np.ndarray:
    return 0.5 * (m + m.T)


def _fro(m: np.ndarray) -> float:
    return float(np.linalg.norm(m))


def judge(p: Problem, X, Y, Z, T=None) -> Dict[str, float]:
    """The numbers of the answer (X, Y, Z, T), each the larger the worse:

    - ``primal``: ||E * X - B|| / (1 + ||B||);
    - ``dual``: ||E * Y - Z - C - T|| / (1 + ||C||);
    - ``slack``: |<X, Z>| + |<X + beta G, T>|, the duality gap of a
      feasible pair;
    - ``kkt``: the largest of the three, the measure the configuration's
      ``abs_tol`` bounds;
    - ``gap``: |<C, X> - <B, Y> - beta sum(T)| / (1 + |<C, X>|), primal
      against dual objective;
    - ``psd_x``, ``psd_z``: how far X and Z leave the cone, -lambda_min
      over 1 + ||B|| and over 1 + ||C|| (0 inside; Z itself goes to 0
      where T carries the dual);
    - ``ineq``: how far X + beta and T fall below 0 on G's support, over
      ||X||_max and ||T||_max (0 without inequalities);
    - ``asym``: ||X - X^T|| / ||X||, the worse of X and Z.
    """
    X, Y, Z = (np.asarray(a, dtype=np.float64) for a in (X, Y, Z))
    ineq = p.ineq_mask is not None
    T = np.zeros_like(X) if T is None or not ineq else np.asarray(T, dtype=np.float64)
    G = p.ineq_mask if ineq else np.zeros_like(X)

    primal = _fro(p.eq_mask * X - p.B) / (1 + _fro(p.B))
    dual = _fro(p.eq_mask * Y - Z - p.C - T) / (1 + _fro(p.C))
    slack = abs(float(np.sum(X * Z))) + abs(float(np.sum((X + p.beta * G) * T)))
    obj = float(np.sum(p.C * X))
    dual_obj = float(np.sum(p.B * Y)) + p.beta * float(np.sum(G * T))
    psd = [max(-float(np.linalg.eigvalsh(_sym(m))[0]), 0.0) / (1 + _fro(scale))
           for m, scale in ((X, p.B), (Z, p.C))]
    viol = 0.0
    if ineq:
        on = G > 0.5
        viol = max(0.0, -float(np.min((X + p.beta)[on])) / max(float(np.max(np.abs(X))), 1e-300),
                   -float(np.min(T[on])) / max(float(np.max(np.abs(T))), 1e-300))
    asym = max(_fro(m - m.T) / max(_fro(m), 1e-300) for m in (X, Z))
    return {
        "kkt": max(primal, dual, slack),
        "primal": primal,
        "dual": dual,
        "slack": slack,
        "gap": abs(obj - dual_obj) / (1 + abs(obj)),
        "psd_x": psd[0],
        "psd_z": psd[1],
        "ineq": viol,
        "asym": asym,
    }
