"""One IPM iteration resumed from a checkpoint in both packages, with the
Newton solvers' outcomes recorded (ttipm_tpu_torch/tools/replay_step.py).

The port's maxcut d2 seed 11 solve writes a checkpoint every iteration;
each package resumes its second and stops after the first Newton step:
the same solver calls in the same order (the fused ladder, no fallback),
and step sizes within 1e-6 of each other, relative.  A stop inside the
ragged AMEn is recorded with the relative error its basis-limited break
names.

Run as a script, the JAX package's side of a replay on the CPU (bucket 4,
as on the card; the port's side is the tool itself):

    python -m tests.test_torch_replay --checkpoint FILE_OR_DIR --dim 9 --seed 9313
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import ttipm_tpu.ipm as ipm_j
import ttipm_tpu.solvers.fused as fused_j
from ttipm_tpu import config as jconfig
from ttipm_tpu.models.maxcut import create_problem as cp_j
from ttipm_tpu.ops import tt as J
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.tools import replay_step as R
from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint

SETTINGS = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)


def jax_replay(checkpoint, dim, seed, settings):
    """The JAX package's record of one iteration resumed from
    ``checkpoint`` (the problem drawn as its runner draws it)."""
    np.random.seed(seed)
    obj, L, b, lag = cp_j(dim, 1)
    start = int(load_ipm_checkpoint(checkpoint, device="cpu")["iteration"])
    with R.record_solver(ipm_j, fused_j) as rec:
        rec["iteration"] = start
        try:
            ipm_j.tt_ipm({"y": J.tt_reshape(lag, (4, 4))}, J.tt_reshape(obj, (4,)), L,
                         J.tt_reshape(b, (4,)), resume_from=checkpoint, **settings)
        except R.StopReplay:
            pass
    return {"package": "ttipm_tpu", "device": "cpu", "checkpoint": checkpoint,
            "from_iteration": start, **{k: rec[k] for k in ("ladder", "ragged", "step")}}


@pytest.fixture
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def test_replay_records_the_same_step_in_both_packages(tmp_path, _bucket1):
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    import ttipm_tpu_torch.utils.checkpoint as ck
    from ttipm_tpu_torch.ops import tt as T

    # per-iteration files, as tools/jacobi_census.py --checkpoints writes them
    save, files = ck.save_ipm_checkpoint, {}

    def per_iteration(path, *a, iteration=0, **kw):
        files[iteration] = str(tmp_path / f"iter_{iteration:02d}.npz")
        save(files[iteration], *a, iteration=iteration, **kw)

    ck.save_ipm_checkpoint = per_iteration
    try:
        np.random.seed(11)
        obj, L, b, lag = create_problem(2, 1, device="cpu")
        tt_ipm({"y": T.tt_reshape(lag, (4, 4))}, T.tt_reshape(obj, (4,)), L,
               T.tt_reshape(b, (4,)), checkpoint_path=str(tmp_path / "last.npz"), **SETTINGS)
    finally:
        ck.save_ipm_checkpoint = save
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
    args = ap.parse_args(argv)
    path = R.pick_checkpoint(args.checkpoint)
    if path is None:
        print(json.dumps({"checkpoint": args.checkpoint, "ladder_exhausted": False}))
        return
    from ttipm_tpu_torch.tools.bench import _load_config
    from ttipm_tpu_torch.utils.runner import ipm_kwargs

    jconfig.set_rank_bucket(4)
    settings = {**ipm_kwargs(_load_config(args.dim)), "verbose": False}
    print(json.dumps(jax_replay(os.path.abspath(path), args.dim, args.seed, settings)),
          flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
