"""Numeric configuration of the PyTorch port.

Holds the switches that the solver reads (``ttipm_tpu/config.py:18-51,
138-157,170,234-244,273-330``): the TT dtype profile and its eps floor,
the mixed-precision local solves and the precision of the step-size
eigensolves under the float32 profile, the rank bucket, the choice of the
fused or the ragged (reference-faithful) KKT solver and eigensolver, and
Newton-residual refinement.  The device is not a setting: every function
follows the device of the tensors it is given.

The float32 profile is the JAX package's ``bench.py`` offload-f32 numerics
(``scripts/f32_repro.py:21-26``)::

    config.set_dtype(torch.float32)    # eps floor 1e-7, no TF32
    config.set_eigen_dtype("native")   # f32 eigen pencils
    config.set_mixed_local("f64")      # the default: f64 local solves

The problem trains are then made in float32
(``create_problem(..., dtype=torch.float32)``) and ``tt_ipm`` follows them.
The whole-solve switch (``set_fused_whole_solve``) runs the fused AMEn
solve and the two fused eigensolves as whole programs: eager on CPU
tensors, CUDA graphs of their fixed-shape steps on the card
(``solvers/graphs.py``).  What exists only for the TPU (offload, the
persistent compile cache, the map guard) has no counterpart here.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_RANK_BUCKET = 4
_NEWTON_REFINE = True
_FUSED_KKT = True

# Active TT dtype, and the smallest rounding threshold that means anything
# in it: in f32, thresholds below ~1e-7 act like 0 and let rounding noise
# inflate TT ranks, so ``clamp_eps`` lifts them to the floor.
_DTYPE = torch.float64
_EPS_FLOOR = 0.0


def set_dtype(dtype) -> None:
    """Select the TT dtype profile: ``torch.float64`` (parity with the
    reference) or ``torch.float32`` (eps floor 1e-7).  The f32 profile also
    keeps float32 matrix products in full float32 on the card: TF32 (about
    three decimal digits, the Hopper counterpart of the TPU's bf16 matmul
    passes, with which the JAX package's Schur chain gave NaNs) is switched
    off for matmuls and convolutions."""
    global _DTYPE, _EPS_FLOOR
    if dtype == torch.float64:
        _DTYPE, _EPS_FLOOR = torch.float64, 0.0
    elif dtype == torch.float32:
        _DTYPE, _EPS_FLOOR = torch.float32, 1e-7
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    else:
        raise ValueError(f"unsupported TT dtype {dtype}: float64 or float32")


def dtype() -> torch.dtype:
    return _DTYPE


def clamp_eps(eps: float) -> float:
    """Clamp a rounding / tolerance threshold to the active dtype's floor."""
    return max(float(eps), _EPS_FLOOR)


@contextlib.contextmanager
def profile(dtype):
    """Run a block under another dtype profile (its dtype and eps floor),
    then restore the active one."""
    global _DTYPE, _EPS_FLOOR
    saved = _DTYPE, _EPS_FLOOR
    set_dtype(dtype)
    try:
        yield
    finally:
        _DTYPE, _EPS_FLOOR = saved


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor in its nested dicts,
    lists and tuples; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def cast_tree(tree, dtype):
    """``tree`` with every tensor cast to ``dtype``."""
    return tree_map(lambda t: t.to(dtype), tree)


def first_dtype(tree):
    """The dtype of the first tensor in ``tree`` (None without one)."""
    if isinstance(tree, torch.Tensor):
        return tree.dtype
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next((d for d in map(first_dtype, tree) if d is not None), None)
    return None


def in_f64(fn):
    """``fn`` computed in float64 when its first tensor operand is float32:
    every tensor argument upcast, every tensor of the result rounded back
    to float32 (the port's f32 factorizations and ALS fits; see
    ``ops/linalg.py``).  Other operands go to ``fn`` as they are."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if first_dtype(args) != torch.float32:
            return fn(*args, **kw)
        hi = cast_tree((args, kw), torch.float64)
        return cast_tree(fn(*hi[0], **hi[1]), torch.float32)
    return wrapped


def tf32_off() -> bool:
    """True when no float32 matrix product may run in TF32."""
    return (not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


# Mixed-precision local solves of the f32 profile (``fused_batch.solve_local``):
# an all-f32 fused Newton solve stalls (maxcut d3 at slackness ~1e-2 in the
# JAX package), so by default the dense Schur chain of each local solve runs
# in f64 on upcast operands.

_MIXED_LOCAL = "f64"


def set_mixed_local(mode) -> None:
    """'f64' (default): the local solve chain in f64 on upcast operands;
    'refine' (or True): an f32 factorization and two f64-residual
    corrections; 'off' (or False, None): all f32.  Splits, interface
    updates and sweep state stay in the working dtype in every mode."""
    global _MIXED_LOCAL
    if mode in (False, None, "off"):
        _MIXED_LOCAL = "off"
    elif mode in (True, "refine"):
        _MIXED_LOCAL = "refine"
    elif mode == "f64":
        _MIXED_LOCAL = "f64"
    else:
        raise ValueError(f"mixed local mode {mode!r}: 'f64', 'refine' or 'off'")


def mixed_local() -> str:
    return _MIXED_LOCAL


# Precision of the step-size eigensolves: "f64" (default) keeps the pencils
# in f64 under the f32 profile; "native" runs them in the profile's dtype.

_EIGEN_DTYPE = "f64"


def set_eigen_dtype(mode: str) -> None:
    if mode not in ("f64", "native"):
        raise ValueError(f"eigen dtype {mode!r}: 'f64' or 'native'")
    global _EIGEN_DTYPE
    _EIGEN_DTYPE = mode


def eigen_dtype() -> torch.dtype:
    return torch.float64 if _EIGEN_DTYPE == "f64" else _DTYPE


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


# Whole-solve programs (``solvers/fused.py::solve_program``,
# ``solvers/fused_eigen_batch.py::gen_eigen_single`` / ``min_eig_program``):
# the fused AMEn solve runs as a warmup sweep, two peeled solving sweeps,
# sweep pairs while the termination test holds and a finishing sweep, and
# the step-size eigensolves as half-sweep pairs, the test read once a pair
# (``ttipm_tpu/config.py:246-262``).  None = auto, True / False force it.

_FUSED_WHOLE_SOLVE = None


def set_fused_whole_solve(flag) -> None:
    global _FUSED_WHOLE_SOLVE
    _FUSED_WHOLE_SOLVE = None if flag is None else bool(flag)


def fused_whole_solve() -> bool:
    """True when the whole-solve programs run.  Auto (None) means off: the
    JAX package turns them on exactly when it offloads to an accelerator,
    and the port has no offload."""
    return bool(_FUSED_WHOLE_SOLVE)


def set_newton_refine(flag: bool) -> None:
    global _NEWTON_REFINE
    _NEWTON_REFINE = bool(flag)


def newton_refine() -> bool:
    return _NEWTON_REFINE
