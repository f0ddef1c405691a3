"""The program's side of a run: ``ttipm_tpu_torch`` set to the cell's
profile, the instances handed to it as trains, the warm-up and the closed
loop of solves whose walls the window measures.

The program is driven through its entry point ``ipm.tt_ipm`` with the
settings its runner gives a configuration (``utils/runner.py``'s
``ipm_kwargs``).  What comes back is taken to the host after the window,
for the reference to judge.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, ContextManager, List, Optional

import numpy as np
import torch

from portbench.reference.sdp import Problem
from portbench.reference.tt import diag_op_cores, matrix_train, vector_cores

__all__ = ["Solve", "Instance", "set_profile", "build", "instance", "settings", "warm_up",
           "closed_loop", "answers"]


@dataclass
class Solve:
    instance_seed: int
    start_ns: int
    end_ns: int
    iters: int = 0
    ineq_status: str = ""
    error: Optional[str] = None
    result: tuple = field(default=None, repr=False)   # (X, Y, Z, T) trains on the device

    @property
    def wall_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def set_profile(precision: str, whole_solve: bool) -> torch.dtype:
    """The program's dtype profile: "float64", or "float32" as the
    program's own f32 profile sets it (f32 trains, eigensolves in f32,
    local KKT chains in f64).  Returns the trains' dtype."""
    from ttipm_tpu_torch import config

    if precision == "float64":
        config.set_dtype(torch.float64)
    elif precision == "float32":
        config.set_dtype(torch.float32)
        config.set_eigen_dtype("native")
        config.set_mixed_local("f64")
    else:
        raise ValueError(f"precision {precision!r}: float64 or float32")
    config.set_fused_whole_solve(bool(whole_solve))
    return config.dtype()


def build(device: torch.device) -> None:
    """Build the kernels where this checkout has none yet, and load them."""
    if device.type == "cuda":
        from ttipm_tpu_torch.ops import kernels

        kernels._lib()


@dataclass
class Instance:
    """One instance as the program takes it: the arguments of ``tt_ipm`` and
    the state of numpy's stream after the draw, which each of its solves
    goes on with."""

    seed: int
    args: dict
    stream: tuple

    def rng(self) -> np.random.RandomState:
        rng = np.random.RandomState()
        rng.set_state(self.stream)
        return rng


def instance(family, config: dict, seed: int, device, dtype) -> Instance:
    """Instance ``seed`` of ``family`` (a module of ``families/``), drawn
    from numpy's ``RandomState(seed)`` as the program's runner draws it."""
    rng = np.random.RandomState(seed)
    p = family.problem(config, rng)
    return Instance(seed, port_problem(p, device, dtype), rng.get_state())


def port_problem(p: Problem, device, dtype) -> dict:
    """The arguments of ``tt_ipm`` for instance ``p``: the same matrices as
    trains, on ``device`` in ``dtype``."""
    def put(cores):
        return [torch.as_tensor(c, dtype=dtype, device=device) for c in cores]

    args = {
        "lag_maps": {k: put(diag_op_cores(matrix_train(m))) for k, m in p.lag.items()},
        "obj_tt": put(vector_cores(matrix_train(p.C))),
        "lin_op_tt": put(diag_op_cores(matrix_train(p.eq_mask))),
        "bias_tt": put(vector_cores(matrix_train(p.B))),
    }
    if p.ineq_mask is not None:
        args["ineq_mask"] = put(matrix_train(p.ineq_mask))
    return args


def settings(config: dict) -> dict:
    """The keyword settings of ``tt_ipm`` for ``config``, as the program's
    runner makes them, with its log off."""
    from ttipm_tpu_torch.utils.runner import ipm_kwargs

    return {**ipm_kwargs(config), "verbose": False}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(inst: Instance, kwargs: dict, max_iter: int, device) -> None:
    """The first ``max_iter`` - 1 iterations of one instance (the solve is
    cut at ``max_iter`` with no finishing steps left), so that the window
    meets every library and kernel already loaded."""
    from ttipm_tpu_torch.ipm import tt_ipm

    tt_ipm(**inst.args, **{**kwargs, "max_iter": max_iter, "max_refinement": 1},
           rng=inst.rng())
    _sync(device)


def closed_loop(instances: List[Instance], kwargs: dict, seconds: float, device,
                around: Callable[[Instance], ContextManager] = None) -> List[Solve]:
    """Rounds of solves of ``instances``, in their order, each solve
    started when the last has ended, until ``seconds`` have passed; the
    round in flight runs to its end.  A solve that raises is recorded with
    its error and the loop goes on.  ``around(instance)``, where given, is
    entered around each solve, outside its wall."""
    from ttipm_tpu_torch.ipm import tt_ipm

    solves: List[Solve] = []
    end = time.monotonic_ns() + int(seconds * 1e9)
    while True:
        for inst in instances:
            with around(inst) if around else contextlib.nullcontext():
                _solve(tt_ipm, inst, kwargs, device, solves)
        if time.monotonic_ns() >= end:
            return solves


def _solve(tt_ipm, inst: Instance, kwargs: dict, device, solves: List[Solve]) -> None:
    t0 = time.monotonic_ns()
    try:
        X, Y, T, Z, info = tt_ipm(**inst.args, **kwargs, rng=inst.rng())
        _sync(device)
        solves.append(Solve(inst.seed, t0, time.monotonic_ns(),
                            int(info["num_iters"]), str(info["status"].ineq_status),
                            result=(X, Y, Z, T)))
    except Exception as e:  # a solve that raises is a failed solve, not a failed run
        _sync(device)
        solves.append(Solve(inst.seed, t0, time.monotonic_ns(),
                            error=f"{type(e).__name__}: {e}"[:300]))


def answers(solves: List[Solve]) -> None:
    """Move every solve's (X, Y, Z, T) to the host as float64 numpy cores."""
    for s in solves:
        if s.result is not None:
            s.result = tuple(None if t is None else
                             [c.detach().to("cpu", torch.float64).numpy() for c in t]
                             for t in s.result)
