"""One IPM iteration resumed from a checkpoint, and what its Newton solver did.

    python -m ttipm_tpu_torch.tools.replay_step --checkpoint DIR_OR_FILE --dim 9 --seed 9313
        [--device cpu] [--jacobi lapack|forced] [--j1-from N] [--j2-from N] [--profile f32]

Builds maxcut d<dim> seed <seed> as the runner does (configs/maxcut_<dim>.yaml,
the problem drawn from numpy's global RandomState seeded with the seed),
resumes ``tt_ipm`` from the checkpoint (``utils/checkpoint.py``'s ``.npz``
layout, which either package writes and reads) and stops after the first
Newton step.  ``--checkpoint`` names a file, or a directory that
``tools/jacobi_census.py --checkpoints`` filled: then the checkpoint the
fused ladder's first exhaustion started from (``ladder.json``).  The
resumed solve starts without the warm starts of the uninterrupted one
(the previous Newton direction, the eigenvectors, the ladder's sticky
state: not in the file), with numpy's global stream where the problem's
draws leave it.

``record_solver`` takes either package's ``ipm`` module (and the module
that holds its fused ladder), so ``tests/test_torch_replay.py`` runs the
JAX package through it on the CPU.  The record:

* ``ladder``: each call of the fused ladder (``tt_restarted_block_amen_fused``):
  its relative residual, or ``exhausted`` and the text of its
  ``AmenRestartsExhausted``;
* ``ragged``: each call of the ragged AMEn (``tt_restarted_block_amen``,
  which the ladder falls back to): its relative residual, or the text of
  the exception it raised, ``basis_limited`` where that is the basis-limited
  break (``ttipm_tpu/solvers/amen.py:788-801``: the first solve's relative
  error above 0.9) and the relative error it names;
* ``step``: what the Newton step returned: x_step, z_step and whether its
  directions are None (the finishing branch: the outer loop then enters
  its finishing phase).

``--device`` defaults to the card; on the CPU ``--jacobi lapack`` (the
default) keeps ``torch.linalg``, ``--jacobi forced`` runs the plain Jacobi
(``jacobi.forced(True)``: the plain version of each order's regime);
``--j1-from`` / ``--j2-from`` move ``kernels.J1_BLOCK_FROM`` /
``J2_BLOCK_FROM`` for the run.  ``--profile f32`` builds and resumes the
instance as ``tools/jacobi_census.py --profile f32`` solves it
(``chip_smoke.py`` phase 9's float32 profile: ``config.set_dtype(float32)``,
native eigen pencils, f64 local solves, rank bucket 4, ``F32_SETTINGS``
over the config's; the instance is the f64 one rounded).  Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from contextlib import contextmanager

import torch

# The f32 profile's solver settings, which chip_smoke.py's phase 9 and
# tools/jacobi_census.py take too: configs/maxcut_8.yaml's with max_iter 22.
F32_SETTINGS = {"max_iter": 22, "gap_tol": 3e-4, "op_tol": 1e-4, "abs_tol": 1e-3,
                "warm_up": 3, "mals_restarts": 2, "max_refinement": 5, "lambdaStar": 1.0}

_REL = re.compile(r"relative error ([0-9.eE+-]+)")


class StopReplay(BaseException):
    """Raised after the first Newton step (or the fused ladder's first
    call) to end the resumed solve; not an ``Exception``, so that the
    IPM's handler of a failed Newton step lets it through."""


def _rel_error(text):
    m = _REL.search(text)
    return float(m.group(1)) if m else None


@contextmanager
def record_solver(ipm, fused=None, rec=None, stop_after_step=True, stop_after_ladder=False):
    """Patch the Newton solvers of ``ipm`` (either package's module; its
    fused ladder taken from ``ipm`` where it imports it, else from
    ``fused``) to append their outcomes to ``rec`` (a dict with lists
    ``ladder`` and ``ragged``, each event tagged with ``rec["iteration"]``);
    with ``stop_after_step`` the first Newton step's result goes to
    ``rec["step"]`` and ``StopReplay`` ends the solve; with
    ``stop_after_ladder`` it ends after the fused ladder's first call,
    exhausted or not.  Yields ``rec``."""
    rec = {"ladder": [], "ragged": [], "step": None, "iteration": None} if rec is None else rec
    holder = ipm if hasattr(ipm, "tt_restarted_block_amen_fused") else fused
    saved = [(holder, "tt_restarted_block_amen_fused"), (ipm, "tt_restarted_block_amen"),
             (ipm, "_tt_ipm_newton_step")]
    originals = [getattr(m, name) for m, name in saved]

    def residual(out):
        try:
            return float(out[1])
        except (TypeError, ValueError, IndexError):
            return None

    def logged(key, fn):
        def wrapped(*a, **kw):
            event = {"iteration": rec["iteration"]}
            try:
                out = fn(*a, **kw)
            except Exception as e:
                text = str(e)
                event.update({"raised": type(e).__name__, "error": text,
                              "exhausted": type(e).__name__ == "AmenRestartsExhausted",
                              "basis_limited": text.startswith("basis-limited"),
                              "relative_error": _rel_error(text)})
                rec[key].append(event)
                if stop_after_ladder and key == "ladder":
                    raise StopReplay from e
                raise
            event["residual"] = residual(out)
            rec[key].append(event)
            if stop_after_ladder and key == "ladder":
                raise StopReplay
            return out
        return wrapped

    def step(*a, **kw):
        out = originals[2](*a, **kw)
        rec["step"] = {"x_step": float(out[0]), "z_step": float(out[1]),
                       "finishing_branch": out[2] is None and out[4] is None}
        if stop_after_step:
            raise StopReplay
        return out

    setattr(holder, saved[0][1], logged("ladder", originals[0]))
    setattr(ipm, saved[1][1], logged("ragged", originals[1]))
    setattr(ipm, saved[2][1], step)
    try:
        yield rec
    finally:
        for (m, name), fn in zip(saved, originals):
            setattr(m, name, fn)


def pick_checkpoint(path):
    """``path`` itself, or in a census directory the checkpoint that the
    first exhausted ladder started from (None where no ladder exhausted)."""
    if not os.path.isdir(path):
        return path
    with open(os.path.join(path, "ladder.json")) as fh:
        events = json.load(fh)
    first = next((e for e in events if e.get("exhausted")), None)
    if first is None:
        return None
    return os.path.join(path, f"iter_{first['iteration']:02d}.npz")


@contextmanager
def profile_config(profile):
    """The port's config in ``profile`` for the block: "f64" leaves it as
    it is; "f32" is the float32 profile at rank bucket 4 (see the module
    docstring), the f64 profile and the rank bucket restored after."""
    from ttipm_tpu_torch import config

    bucket = config.rank_bucket()
    if profile == "f32":
        config.set_dtype(torch.float32)
        config.set_eigen_dtype("native")
        config.set_mixed_local("f64")
        config.set_rank_bucket(4)
    try:
        yield
    finally:
        if profile == "f32":
            config.set_dtype(torch.float64)
            config.set_eigen_dtype("f64")
            config.set_mixed_local("f64")
            config.set_rank_bucket(bucket)


def profile_settings(dim, profile):
    """``tt_ipm``'s keywords for maxcut d<dim> in ``profile``: the config's,
    with ``F32_SETTINGS`` over them in f32, quiet."""
    from ttipm_tpu_torch.tools.bench import _load_config
    from ttipm_tpu_torch.utils.runner import ipm_kwargs

    cfg = _load_config(dim)
    if profile == "f32":
        cfg.update(F32_SETTINGS)
    return {**ipm_kwargs(cfg), "verbose": False}


def replay(checkpoint, dim, seed, device, jacobi_route="kernels", j1_from=None, j2_from=None,
           settings=None, profile="f64", ladder_only=False):
    """The record of one resumed iteration of the port (see the module
    docstring); ``settings``: ``tt_ipm``'s keywords, by default the
    config's in ``profile``; ``ladder_only``: stop after the fused
    ladder's first call (``step`` is then None)."""
    from ttipm_tpu_torch import ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import jacobi
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint
    from ttipm_tpu_torch.utils.runner import seeded_problem

    if settings is None:
        settings = profile_settings(dim, profile)
    saved = (K.J1_BLOCK_FROM, K.J2_BLOCK_FROM)
    K.J1_BLOCK_FROM = saved[0] if j1_from is None else j1_from
    K.J2_BLOCK_FROM = saved[1] if j2_from is None else j2_from
    K.j1_plan.cache_clear()
    K.j2_plan.cache_clear()
    forced = {"kernels": None, "lapack": None, "forced": True, "cusolver": False}[jacobi_route]
    try:
        with profile_config(profile):
            lag, obj, L, b, _ = seeded_problem(create_problem, dim, 1, seed, device)
            start = int(load_ipm_checkpoint(checkpoint, device="cpu")["iteration"])
            with jacobi.forced(forced), record_solver(
                    ipm, stop_after_ladder=ladder_only) as rec:
                rec["iteration"] = start
                try:
                    ipm.tt_ipm(lag, obj, L, b, resume_from=checkpoint, **settings)
                except StopReplay:
                    pass
    finally:
        K.J1_BLOCK_FROM, K.J2_BLOCK_FROM = saved
        K.j1_plan.cache_clear()
        K.j2_plan.cache_clear()
    return {"package": "ttipm_tpu_torch", "device": str(device), "jacobi": jacobi_route,
            "profile": profile,
            "j1_from": K.J1_BLOCK_FROM if j1_from is None else j1_from,
            "j2_from": K.J2_BLOCK_FROM if j2_from is None else j2_from,
            "checkpoint": checkpoint, "from_iteration": start,
            **{k: rec[k] for k in ("ladder", "ragged", "step")}}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dim", type=int, default=9)
    ap.add_argument("--seed", type=int, default=9313)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jacobi", default=None, choices=("kernels", "lapack", "forced", "cusolver"))
    ap.add_argument("--j1-from", type=int, default=None)
    ap.add_argument("--j2-from", type=int, default=None)
    ap.add_argument("--profile", default="f64", choices=("f64", "f32"))
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("replay_step: no CUDA device (--device cpu runs on the CPU)")
    path = pick_checkpoint(args.checkpoint)
    if path is None:
        print(json.dumps({"checkpoint": args.checkpoint, "ladder_exhausted": False}))
        return 0
    route = args.jacobi or ("kernels" if device.type == "cuda" else "lapack")
    out = replay(path, args.dim, args.seed, device, route, args.j1_from, args.j2_from,
                 profile=args.profile)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
