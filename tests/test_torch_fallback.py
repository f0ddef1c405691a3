"""The port's ragged AMEn in the IPM, against the JAX package.

* Forced exhaustion (the pattern of tests/test_fallback.py): maxcut d3 seed
  5 with the fused ladder patched to raise ``AmenRestartsExhausted`` in
  both packages, so that the ragged AMEn carries the Newton solves after
  the sticky / un-stick fallback.
* The fully ragged path: ``set_fused_kkt(False)`` at maxcut d2 seed 11 (the
  ragged KKT solver and the ragged eigensolver throughout).

Checks: the same iteration count, the same final X / Z ranks, the same
number of fused attempts (1 to 3), <C, X> to 1e-6 relative, and
slackness, primal and dual feasibility of the port's solve below 1e-3.

The ragged restart loop can never run in either package: the acceptance
test of ``tt_restarted_block_amen`` (``ttipm_tpu/solvers/amen.py:788-801``)
accepts or raises on the first solve.  The port mirrors that defect so that
the trajectories agree (ROADMAP Queue 3).
"""

import numpy as np
import pytest

import ttipm_tpu.solvers.fused as jfused
from ttipm_tpu import config as jconfig
from ttipm_tpu.ipm import tt_ipm as ipm_j
from ttipm_tpu.models.maxcut import create_problem as cp_j
from ttipm_tpu.ops import tt as J
from ttipm_tpu.solvers.amen import AmenRestartsExhausted as ExhaustedJ
import ttipm_tpu_torch.ipm as tipm
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.checks import solve_metrics
from ttipm_tpu_torch.models.maxcut import create_problem as cp_t
from ttipm_tpu_torch.ops import tt as T
from ttipm_tpu_torch.solvers.amen import AmenRestartsExhausted as ExhaustedT

EXHAUSTION = dict(max_iter=8, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                  aho_direction=False, mals_restarts=2, max_refinement=3, lambdaStar=1.0)
RAGGED = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
              aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)


@pytest.fixture(autouse=True)
def _settings():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)
    tconfig.set_fused_kkt(True)
    jconfig.set_fused_kkt(True)


def _solve_both(dim, seed, settings):
    np.random.seed(seed)
    obj_j, L_j, b_j, lag_j = cp_j(dim, 1)
    X_j, _, _, Z_j, info_j = ipm_j({"y": J.tt_reshape(lag_j, (4, 4))}, obj_j, L_j, b_j,
                                   **settings)
    np.random.seed(seed)
    obj_t, L_t, b_t, lag_t = cp_t(dim, 1, device="cpu")
    X_t, Y_t, _, Z_t, info_t = tipm.tt_ipm({"y": T.tt_reshape(lag_t, (4, 4))}, obj_t, L_t, b_t,
                                           **settings)
    assert info_t["num_iters"] == info_j["num_iters"]
    assert info_t["ranksX"] == info_j["ranksX"]
    assert info_t["ranksZ"] == info_j["ranksZ"]
    cx_j = J.tt_inner_prod(J.tt_reshape(obj_j, (2, 2)), X_j)
    cx_t = T.tt_inner_prod(T.tt_reshape(obj_t, (2, 2)), X_t)
    assert cx_t == pytest.approx(cx_j, rel=1e-6)
    slack, primal, dual = solve_metrics(X_t, Y_t, Z_t, obj_t, L_t, b_t)
    assert slack < 1e-3 and primal < 1e-3 and dual < 1e-3


def test_forced_exhaustion_matches_jax(monkeypatch):
    calls = {"jax": 0, "port": 0, "ragged": 0}

    def exhausted_j(*a, **k):
        calls["jax"] += 1
        raise ExhaustedJ("synthetic exhaustion")

    def exhausted_t(*a, **k):
        calls["port"] += 1
        raise ExhaustedT("synthetic exhaustion")

    ragged = tipm.tt_restarted_block_amen

    def counted_ragged(*a, **k):
        calls["ragged"] += 1
        return ragged(*a, **k)

    monkeypatch.setattr(jfused, "tt_restarted_block_amen_fused", exhausted_j)
    monkeypatch.setattr(tipm, "tt_restarted_block_amen_fused", exhausted_t)
    monkeypatch.setattr(tipm, "tt_restarted_block_amen", counted_ragged)
    _solve_both(3, 5, EXHAUSTION)
    assert 1 <= calls["port"] <= 3
    assert calls["port"] == calls["jax"]
    assert calls["ragged"] >= calls["port"]


def test_fully_ragged_matches_jax(monkeypatch):
    def no_fused(*a, **k):
        raise AssertionError("the fused solver ran with fused_kkt off")

    monkeypatch.setattr(tipm, "tt_restarted_block_amen_fused", no_fused)
    monkeypatch.setattr(tipm, "tt_max_generalised_eigen_fused", no_fused)
    jconfig.set_fused_kkt(False)
    tconfig.set_fused_kkt(False)
    _solve_both(2, 11, RAGGED)
