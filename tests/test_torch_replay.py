"""One IPM iteration resumed from a checkpoint in both packages, with the
Newton solvers' outcomes recorded (ttipm_tpu_torch/tools/replay_step.py).

The port's maxcut d2 seed 11 solve writes a checkpoint every iteration;
each package resumes its second and stops after the first Newton step:
the same solver calls in the same order (the fused ladder, no fallback),
and step sizes within 1e-6 of each other, relative.  A stop inside the
ragged AMEn is recorded with the relative error its basis-limited break
names.

The same in the float32 profile (``--profile f32``) on maxcut d3 seed
319: the JAX package resumes the port's instance, the f64 one rounded
(its own f32 instance is another graph of the seed).  And on the
committed f32 iterate of maxcut d8 seed 319
(``results/f32_d8_seed319/iter_09.npz``: the checkpoint the first
exhausted ladder started from, written on the H100 by ``python -m
ttipm_tpu_torch.tools.jacobi_census --cells 8:319 --profile f32 --j1-from
22 --checkpoints DIR``): both packages' fused ladders exhaust their
restarts on it, so the stall that J1's crossover at 22 steers the solve to
is the reference's.

Run as a script, the JAX package's side of a replay on the CPU (bucket 4,
as on the card; the port's side is the tool itself):

    python -m tests.test_torch_replay --checkpoint FILE_OR_DIR --dim 9 --seed 9313 [--profile f32]
"""

import argparse
import contextlib
import json
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import ttipm_tpu.ipm as ipm_j
import ttipm_tpu.solvers.fused as fused_j
from ttipm_tpu import config as jconfig
from ttipm_tpu.models.maxcut import create_problem as cp_j
from ttipm_tpu.ops import tt as J
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.tools import replay_step as R
from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint

F32_D8_ITERATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "results",
                              "f32_d8_seed319")
SETTINGS = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)


@contextlib.contextmanager
def jax_profile(profile):
    """The JAX package's config in ``profile`` ("f32": the port's
    ``replay_step.profile_config``'s float32 profile) for the block."""
    bucket = jconfig.rank_bucket()
    if profile == "f32":
        jconfig.set_dtype(jnp.float32)
        jconfig.set_eigen_dtype("native")
        jconfig.set_mixed_local("f64")
        jconfig.set_rank_bucket(4)
    try:
        yield
    finally:
        if profile == "f32":
            jconfig.set_dtype(jnp.float64)
            jconfig.set_eigen_dtype("f64")
            jconfig.set_mixed_local("f64")
            jconfig.set_rank_bucket(bucket)


def jax_replay(checkpoint, dim, seed, settings, profile="f64", ladder_only=False):
    """The JAX package's record of one iteration resumed from
    ``checkpoint`` (the problem drawn as its runner draws it; in f32 the
    f64 instance rounded, as the port builds it); ``ladder_only``: stop
    after the fused ladder's first call."""
    np.random.seed(seed)
    problem = cp_j(dim, 1)
    with jax_profile(profile):
        if profile == "f32":
            problem = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), problem)
        obj, L, b, lag = problem
        start = int(load_ipm_checkpoint(checkpoint, device="cpu")["iteration"])
        with R.record_solver(ipm_j, fused_j, stop_after_ladder=ladder_only) as rec:
            rec["iteration"] = start
            try:
                ipm_j.tt_ipm({"y": J.tt_reshape(lag, (4, 4))}, J.tt_reshape(obj, (4,)), L,
                             J.tt_reshape(b, (4,)), resume_from=checkpoint, **settings)
            except R.StopReplay:
                pass
    return {"package": "ttipm_tpu", "device": "cpu", "checkpoint": checkpoint,
            "profile": profile, "from_iteration": start,
            **{k: rec[k] for k in ("ladder", "ragged", "step")}}


@pytest.fixture
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def _per_iteration_checkpoints(tmp_path, dim, seed, profile="f64"):
    """The port's maxcut d<dim> seed <seed> solve in ``profile`` on the CPU
    with a checkpoint file an iteration, as tools/jacobi_census.py
    --checkpoints writes them; returns {iteration: path}."""
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    import ttipm_tpu_torch.utils.checkpoint as ck
    from ttipm_tpu_torch.utils.runner import seeded_problem

    save, files = ck.save_ipm_checkpoint, {}

    def per_iteration(path, *a, iteration=0, **kw):
        files[iteration] = str(tmp_path / f"iter_{iteration:02d}.npz")
        save(files[iteration], *a, iteration=iteration, **kw)

    ck.save_ipm_checkpoint = per_iteration
    try:
        with R.profile_config(profile):
            lag, obj, L, b, _ = seeded_problem(create_problem, dim, 1, seed, "cpu")
            tt_ipm(lag, obj, L, b, checkpoint_path=str(tmp_path / "last.npz"), **SETTINGS)
    finally:
        ck.save_ipm_checkpoint = save
    return files


def test_replay_records_the_same_step_in_both_packages(tmp_path, _bucket1):
    files = _per_iteration_checkpoints(tmp_path, 2, 11)
    with open(tmp_path / "ladder.json", "w") as fh:
        json.dump([{"iteration": 2, "exhausted": True}], fh)
    assert R.pick_checkpoint(str(tmp_path)) == files[2]

    port = R.replay(files[2], 2, 11, torch.device("cpu"), "lapack", settings=SETTINGS)
    ref = jax_replay(files[2], 2, 11, SETTINGS)
    assert port["from_iteration"] == ref["from_iteration"] == 2
    assert [e.get("exhausted", False) for e in port["ladder"]] == \
        [e.get("exhausted", False) for e in ref["ladder"]]
    assert port["ragged"] == ref["ragged"] == []
    assert not port["step"]["finishing_branch"] and not ref["step"]["finishing_branch"]
    for key in ("x_step", "z_step"):
        assert port["step"][key] == pytest.approx(ref["step"][key], rel=1e-6)


def test_f32_replay_records_the_same_step_in_both_packages(tmp_path):
    """The float32 profile (rank bucket 4): maxcut d3 seed 319's third
    iteration resumed in both packages from the port's f32 checkpoint, on
    the port's instance (the f64 one rounded): the same solver outcomes,
    and step sizes within 1e-4 of each other, relative (f32 pencils)."""
    files = _per_iteration_checkpoints(tmp_path, 3, 319, "f32")
    port = R.replay(files[2], 3, 319, torch.device("cpu"), "lapack", settings=SETTINGS,
                    profile="f32")
    ref = jax_replay(files[2], 3, 319, SETTINGS, profile="f32")
    assert tconfig.dtype() == torch.float64 and jconfig.dtype() == jnp.float64
    assert port["profile"] == ref["profile"] == "f32"
    assert port["from_iteration"] == ref["from_iteration"] == 2
    assert [e.get("exhausted", False) for e in port["ladder"]] == \
        [e.get("exhausted", False) for e in ref["ladder"]]
    assert [e.get("exhausted", False) for e in port["ragged"]] == \
        [e.get("exhausted", False) for e in ref["ragged"]]
    assert port["step"]["finishing_branch"] == ref["step"]["finishing_branch"]
    for key in ("x_step", "z_step"):
        assert port["step"][key] == pytest.approx(ref["step"][key], rel=1e-4)


def test_f32_d8_iterate_exhausts_the_ladder_in_both_packages():
    """The committed iterate resumed on the CPU in both packages (the port
    with LAPACK), stopped after the fused ladder's first call: each ladder
    exhausts its restarts (its relative error follows last bits: 1.3-2.5
    on the five routes PERF.md records)."""
    path = R.pick_checkpoint(F32_D8_ITERATE)
    assert os.path.basename(path) == "iter_09.npz"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: one thread each under xdist
    try:
        with threadpool_limits(1):
            port = R.replay(path, 8, 319, torch.device("cpu"), "lapack", profile="f32",
                            ladder_only=True)
            ref = jax_replay(path, 8, 319, R.profile_settings(8, "f32"), profile="f32",
                             ladder_only=True)
    finally:
        torch.set_num_threads(threads)
    for rec in (port, ref):
        assert rec["from_iteration"] == 9 and rec["step"] is None and rec["ragged"] == []
        assert [e["exhausted"] for e in rec["ladder"]] == [True]
        assert not rec["ladder"][0]["basis_limited"]
    assert tconfig.dtype() == torch.float64 and jconfig.dtype() == jnp.float64


@pytest.mark.parametrize("argv,profile", [
    ([], "f64"), (["--profile", "f32"], "f32"), (["--profile", "f64"], "f64"),
    (["--profile=f32"], "f32")])
def test_replay_parses_the_profile(argv, profile):
    args = R.parser().parse_args(["--checkpoint", "x.npz", "--device", "cpu"] + argv)
    assert args.profile == profile and args.checkpoint == "x.npz"


def test_replay_refuses_an_unknown_profile():
    with pytest.raises(SystemExit):
        R.parser().parse_args(["--checkpoint", "x.npz", "--profile", "bf16"])


def test_replay_parses_the_basis_limited_break():
    """The ragged AMEn's basis-limited break, as each package raises it,
    recorded with the relative error it names; the exception still reaches
    the caller."""
    from ttipm_tpu_torch import ipm as ipm_t
    from ttipm_tpu_torch.solvers.amen import AmenRestartsExhausted

    saved = ipm_t.tt_restarted_block_amen

    def stalled(*a, **kw):
        raise AmenRestartsExhausted("basis-limited: first solve stalled at relative error "
                                    "2.204e+02; skipping restarts")

    ipm_t.tt_restarted_block_amen = stalled
    try:
        with R.record_solver(ipm_t, stop_after_step=False) as rec:
            rec["iteration"] = 7
            with pytest.raises(AmenRestartsExhausted):
                ipm_t.tt_restarted_block_amen(None, None)
    finally:
        ipm_t.tt_restarted_block_amen = saved
    assert ipm_t.tt_restarted_block_amen is saved
    (event,) = rec["ragged"]
    assert event["iteration"] == 7 and event["exhausted"] and event["basis_limited"]
    assert event["relative_error"] == 220.4


def main(argv=None):
    ap = argparse.ArgumentParser(description="the JAX package's side of a replay (CPU)")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dim", type=int, default=9)
    ap.add_argument("--seed", type=int, default=9313)
    ap.add_argument("--profile", default="f64", choices=("f64", "f32"))
    args = ap.parse_args(argv)
    path = R.pick_checkpoint(args.checkpoint)
    if path is None:
        print(json.dumps({"checkpoint": args.checkpoint, "ladder_exhausted": False}))
        return
    jconfig.set_rank_bucket(4)
    settings = R.profile_settings(args.dim, args.profile)
    print(json.dumps(jax_replay(os.path.abspath(path), args.dim, args.seed, settings,
                                args.profile)), flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
