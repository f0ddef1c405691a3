"""End-to-end parity of the port's IPM with the JAX package on MaxCut.

maxcut d2 (seed 11, tests/test_ipm_e2e.py:153) and d3 (seed 319,
tests/test_ipm_e2e.py:41) run through both packages from the same numpy
seed, the port on the CPU.  Checks: the same iteration count, the same
final TT ranks of X and Z, <C, X> agreeing to 1e-6 relative, and
slackness, primal and dual feasibility each < 1e-3 (the metrics of
tests/test_ipm_e2e.py::solve_metrics, computed with the port's ops by
ttipm_tpu_torch.checks.solve_metrics).
"""

import os

import numpy as np
import pytest
import torch

from ttipm_tpu.ipm import tt_ipm as ipm_j
from ttipm_tpu.models.maxcut import create_problem as cp_j
from ttipm_tpu.ops import tt as J
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.checks import solve_metrics
from ttipm_tpu_torch.ipm import tt_ipm as ipm_t
from ttipm_tpu_torch.models.maxcut import create_problem as cp_t
from ttipm_tpu_torch.ops import kernels as K
from ttipm_tpu_torch.ops import tt as T
from ttipm_tpu_torch.utils.runner import run_experiment

SETTINGS = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def run_both(dim, seed):
    np.random.seed(seed)
    obj_j, L_j, b_j, lag_j = cp_j(dim, 1)
    X_j, Y_j, _, Z_j, info_j = ipm_j({"y": J.tt_reshape(lag_j, (4, 4))}, obj_j, L_j, b_j,
                                     **SETTINGS)
    np.random.seed(seed)
    obj_t, L_t, b_t, lag_t = cp_t(dim, 1, device="cpu")
    X_t, Y_t, T_t, Z_t, info_t = ipm_t({"y": T.tt_reshape(lag_t, (4, 4))}, obj_t, L_t, b_t,
                                       **SETTINGS)
    return (obj_j, X_j, info_j), (obj_t, L_t, b_t, X_t, Y_t, T_t, Z_t, info_t)


@pytest.mark.parametrize("dim,seed", [(2, 11), (3, 319)])
def test_maxcut_matches_jax(dim, seed):
    (obj_j, X_j, info_j), (obj_t, L_t, b_t, X_t, Y_t, T_t, Z_t, info_t) = run_both(dim, seed)
    assert T_t is None
    assert info_t["num_iters"] == info_j["num_iters"]
    assert info_t["ranksX"] == info_j["ranksX"]
    assert info_t["ranksZ"] == info_j["ranksZ"]
    cx_j = J.tt_inner_prod(J.tt_reshape(obj_j, (2, 2)), X_j)
    cx_t = T.tt_inner_prod(T.tt_reshape(obj_t, (2, 2)), X_t)
    assert cx_t == pytest.approx(cx_j, rel=1e-6)
    slack, feas, dfeas = solve_metrics(X_t, Y_t, Z_t, obj_t, L_t, b_t)
    assert slack < 1e-3 and feas < 1e-3 and dfeas < 1e-3


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError):
        tconfig.set_dtype(torch.float32)
    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "maxcut_3.yaml")
    for argv in (["--problem", "maxcut", "--solver", "sdpa"],
                 ["--problem", "maxcut", "--solver", "cgal"]):
        with pytest.raises(NotImplementedError):
            run_experiment(argv=argv + ["--config", config, "--device", "cpu"])


def test_checkpoint_path_writes_a_file(tmp_path):
    """``checkpoint_path`` (a refusal until the port had checkpoints)
    writes the final iterates, which ``resume_from`` takes back."""
    from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint

    path = str(tmp_path / "d2.npz")
    np.random.seed(11)
    obj, L, b, lag = cp_t(2, 1, device="cpu")
    lag_maps = {"y": T.tt_reshape(lag, (4, 4))}
    X, _, _, _, info = ipm_t(lag_maps, obj, L, b, checkpoint_path=path, **SETTINGS)
    assert os.path.exists(path)
    state = load_ipm_checkpoint(path, device="cpu")
    assert state["iteration"] == info["num_iters"]
    assert all(torch.equal(a, c) for a, c in zip(state["X"], X))
    _, _, _, _, again = ipm_t(lag_maps, obj, L, b, resume_from=path, **SETTINGS)
    assert again["num_iters"] >= info["num_iters"]


@pytest.mark.parametrize("name", ["kkt_block_matvec", "panel_cholesky"])
def test_kernel_errors_are_not_recovered(monkeypatch, name):
    """A kernel that fails to build or launch stops the solve: the Newton
    step's recovery (which turns numerical failures into a zero step)
    re-raises KernelError."""
    def broken(*args):
        raise K.KernelError(f"{name}: CUDA error 1 (invalid argument)")

    monkeypatch.setattr(K, name, broken)
    np.random.seed(11)
    obj, L, b, lag = cp_t(2, 1, device="cpu")
    with pytest.raises(K.KernelError, match=name):
        ipm_t({"y": T.tt_reshape(lag, (4, 4))}, obj, L, b, **SETTINGS)
