"""Checkpoint/resume of the port, and checkpoints carried between the port
and the JAX package (one ``.npz`` layout for both).

* The two cases of tests/test_checkpoint.py through the port: a round trip
  is bitwise and keeps the iteration and the scalars (T absent stays
  None); a second write replaces the first and leaves no temporary file.
* maxcut d3 seed 319 (tests/test_ipm_e2e.py:41): the JAX package's solve
  writes a checkpoint at iteration 3; both packages resume from it: the
  same final iteration count and X / Z ranks, <C, X> equal to 1e-6
  relative.
* The reverse direction: the port's maxcut d2 seed 11 solve writes a
  checkpoint every iteration; the JAX package's ``load_ipm_checkpoint``
  reads the port's final iterates from it to 1e-15 (the cores are stored
  as they are, so bitwise), with the iteration count.
"""

import os

import numpy as np
import pytest
import torch

import ttipm_tpu.utils.checkpoint as JC
from ttipm_tpu.ipm import tt_ipm as ipm_j
from ttipm_tpu.models.maxcut import create_problem as cp_j
from ttipm_tpu.ops import tt as J
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.ipm import tt_ipm as ipm_t
from ttipm_tpu_torch.models.maxcut import create_problem as cp_t
from ttipm_tpu_torch.ops import tt as T
from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint, save_ipm_checkpoint

SETTINGS = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def random_train(rng, ranks, phys):
    ranks = [1] + list(ranks) + [1]
    return [torch.as_tensor(rng.standard_normal((ranks[k],) + phys + (ranks[k + 1],)))
            for k in range(len(ranks) - 1)]


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    X = random_train(rng, [3, 2], (2, 2))
    Y = random_train(rng, [2, 2], (4,))
    Z = random_train(rng, [3, 3], (2, 2))
    path = os.path.join(tmp_path, "ck.npz")
    save_ipm_checkpoint(path, X, Y, Z, None, iteration=7, scalars={"eta": 1e-3, "mu": 0.5})
    state = load_ipm_checkpoint(path, device="cpu")
    assert state["iteration"] == 7
    assert state["scalars"] == {"eta": 1e-3, "mu": 0.5}
    assert state["T"] is None
    for name, train in (("X", X), ("Y", Y), ("Z", Z)):
        assert len(state[name]) == len(train)
        for a, b in zip(state[name], train):
            assert a.dtype == torch.float64 and a.device.type == "cpu"
            assert torch.equal(a, b)


def test_checkpoint_overwrite_atomic(tmp_path):
    rng = np.random.RandomState(1)
    X = random_train(rng, [2], (2, 2))
    Y = random_train(rng, [2], (4,))
    Z = random_train(rng, [2], (2, 2))
    path = os.path.join(tmp_path, "ck.npz")
    save_ipm_checkpoint(path, X, Y, Z, iteration=1)
    save_ipm_checkpoint(path, X, Y, Z, iteration=2)
    assert load_ipm_checkpoint(path, device="cpu")["iteration"] == 2
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_jax_checkpoint_resumes_in_both(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote at iteration 3 of maxcut d3 seed
    319, resumed by each package from the same numpy state."""
    path = str(tmp_path / "d3_it3.npz")
    save = JC.save_ipm_checkpoint

    def third_only(p, *args, iteration=0, **kw):
        if iteration == 3:
            save(p, *args, iteration=iteration, **kw)

    monkeypatch.setattr(JC, "save_ipm_checkpoint", third_only)
    np.random.seed(319)
    obj, L, b, lag = cp_j(3, 1)
    ipm_j({"y": J.tt_reshape(lag, (4, 4))}, obj, L, b, checkpoint_path=path, **SETTINGS)
    monkeypatch.undo()
    assert JC.load_ipm_checkpoint(path)["iteration"] == 3

    np.random.seed(319)
    obj_j, L_j, b_j, lag_j = cp_j(3, 1)
    X_j, _, _, _, info_j = ipm_j({"y": J.tt_reshape(lag_j, (4, 4))}, obj_j, L_j, b_j,
                                 resume_from=path, **SETTINGS)
    np.random.seed(319)
    obj_t, L_t, b_t, lag_t = cp_t(3, 1, device="cpu")
    X_t, _, _, _, info_t = ipm_t({"y": T.tt_reshape(lag_t, (4, 4))}, obj_t, L_t, b_t,
                                 resume_from=path, **SETTINGS)
    assert info_t["num_iters"] == info_j["num_iters"] > 3
    assert info_t["ranksX"] == info_j["ranksX"]
    assert info_t["ranksZ"] == info_j["ranksZ"]
    cx_j = J.tt_inner_prod(J.tt_reshape(obj_j, (2, 2)), X_j)
    cx_t = T.tt_inner_prod(T.tt_reshape(obj_t, (2, 2)), X_t)
    assert cx_t == pytest.approx(cx_j, rel=1e-6)


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "d2.npz")
    np.random.seed(11)
    obj, L, b, lag = cp_t(2, 1, device="cpu")
    X, Y, _, Z, info = ipm_t({"y": T.tt_reshape(lag, (4, 4))}, obj, L, b,
                             checkpoint_path=path, checkpoint_every=1, **SETTINGS)
    state = JC.load_ipm_checkpoint(path)
    assert state["iteration"] == info["num_iters"]
    assert state["T"] is None
    assert set(state["scalars"]) == {"eta", "mu", "primal_error", "dual_error"}
    for name, train in (("X", X), ("Y", Y), ("Z", Z)):
        assert len(state[name]) == len(train)
        for a, c in zip(state[name], train):
            a = np.asarray(a)
            assert a.shape == tuple(c.shape)
            assert np.abs(a - c.numpy()).max() <= 1e-15 * max(np.abs(a).max(), 1.0)
