"""The port's experiment runner and its config reader.

* The runner with ``--device cpu`` on a one-seed config written to
  ``tmp_path`` with ``configs/maxcut_3.yaml``'s settings, run with the
  working directory at ``tmp_path``: its results JSON has the keys of the
  JAX runner's ``save_results_summary``, and its iterations and ranks equal
  those of a direct JAX ``tt_ipm`` on that seed.
* The same for corr_clust d3 (``configs/corr_clust_3.yaml``, seed 291, the
  inequality path) and max_stable_set d3 (``configs/max_stable_set_2.yaml``'s
  settings at dim 3, seed 3), against the JAX runner's ``run_and_record``:
  iterations and the X and T ranks.
* The YAML reader returns what ``yaml.safe_load`` returns on every config
  of ``configs/``.
* graphm: ``load_problem("graphm")`` returns the port's ``create_problem``, and the
  runner on graphm n=2 (configs/graphm_2.yaml, its Newton steps replaced by
  empty ones so that the IPM stops at its initial point) writes results
  whose rank arrays have the runner's 2n bonds.  The whole solve is
  ``tests/test_torch_graphm.py``'s (slow) and ``chip_smoke.py``'s.
* The refusals: the dense baselines, and ``--device cuda`` without a CUDA
  device.
"""

import argparse
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from ttipm_tpu.ipm import tt_ipm as ipm_j
from ttipm_tpu.models.maxcut import create_problem as cp_j
from ttipm_tpu.ops import tt as J
from ttipm_tpu.utils.runner import load_problem as load_problem_j
from ttipm_tpu.utils.runner import run_and_record as run_and_record_j
from ttipm_tpu.utils.runner import save_results_summary as save_j
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.utils import runner
from ttipm_tpu_torch.utils.memtrack import PeakMemoryTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def _one_seed_config(tmp_path, seed, name="maxcut_3", dim=None):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", f"{name}.yaml")))
    cfg["seeds"] = [seed]
    cfg["verbose"] = False
    if dim is not None:
        cfg["dim"] = dim
    path = tmp_path / f"{name}_one_seed.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def test_runner_matches_jax(tmp_path, monkeypatch):
    seed = 1015
    cfg, path = _one_seed_config(tmp_path, seed)
    monkeypatch.chdir(tmp_path)
    rec = runner.run_experiment(argv=["--problem", "maxcut", "--config", path, "--device", "cpu",
                                      "--track_mem"])
    out = glob.glob(str(tmp_path / "results" / "*.json"))
    assert len(out) == 1
    data = json.load(open(out[0]))

    rec_j = runner.new_record(1, cfg["dim"] - 1)
    args_j = argparse.Namespace(config=path, track_mem=True, rank=1)
    save_j(cfg, args_j, rec_j, filename=str(tmp_path / "jax_keys.json"))
    assert set(data) == set(json.load(open(tmp_path / "jax_keys.json")))

    np.random.seed(seed)
    obj, L, b, lag = cp_j(cfg["dim"], 1)
    _, _, _, _, info = ipm_j(
        {"y": J.tt_reshape(lag, (4, 4))}, J.tt_reshape(obj, (4,)), L, J.tt_reshape(b, (4,)),
        max_iter=cfg["max_iter"], gap_tol=float(cfg["gap_tol"]), op_tol=float(cfg["op_tol"]),
        warm_up=cfg["warm_up"], abs_tol=float(cfg["abs_tol"]), aho_direction=False,
        mals_restarts=cfg["mals_restarts"], max_refinement=cfg["max_refinement"],
        lambdaStar=float(cfg["lambdaStar"]))
    assert data["num_iters"] == [[float(info["num_iters"])]]
    assert data["ranksX"] == [[[float(r) for r in info["ranksX"]]]]
    assert data["ranksZ"] == [[[float(r) for r in info["ranksZ"]]]]
    assert rec["complementary_slackness"][0] < 1e-3
    assert rec["feasibility_errors"][0] < 1e-3 and rec["dual_feasibility_errors"][0] < 1e-3
    assert rec["memory"][0] >= 0.0


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_reader_matches_pyyaml(path):
    want = yaml.safe_load(open(path))
    got = runner.load_yaml(path)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


def test_config_reader_scalars(tmp_path):
    text = ("a: !!int 10\nb: !!float 3e-4\nc: 1e-3\nd: 0.5  # note\ne: yes\nf:\ng: ~\n"
            "h: 'x: y'\nlist:\n- 1\n#- 2\n- 2.0 \n")
    path = tmp_path / "c.yaml"
    path.write_text(text)
    assert runner.load_yaml(str(path)) == yaml.safe_load(text)


@pytest.mark.parametrize("problem,config,dim,seed", [
    ("corr_clust", "corr_clust_3", None, 291),
    ("max_stable_set", "max_stable_set_2", 3, 3),
])
def test_runner_ineq_problems_match_jax(tmp_path, monkeypatch, problem, config, dim, seed):
    cfg, path = _one_seed_config(tmp_path, seed, config, dim)
    monkeypatch.chdir(tmp_path)
    rec = runner.run_experiment(argv=["--problem", problem, "--config", path, "--device", "cpu"])
    out = glob.glob(str(tmp_path / "results" / "*.json"))
    assert len(out) == 1
    data = json.load(open(out[0]))
    rec_j = runner.new_record(1, cfg["dim"] - 1)
    args_j = argparse.Namespace(config=path, track_mem=False, rank=1)
    save_j(cfg, args_j, rec_j, filename=str(tmp_path / "jax_keys.json"))
    assert set(data) == set(json.load(open(tmp_path / "jax_keys.json")))

    run_and_record_j(seed, 0, 1, cfg, args_j, load_problem_j(problem), rec_j)
    assert data["num_iters"] == [rec_j["num_iters"].tolist()]
    assert data["ranksX"] == [rec_j["ranksX"].tolist()]
    assert data["ranksT"] == [rec_j["ranksT"].tolist()]
    assert rec["complementary_slackness"][0] < 1e-3
    assert rec["feasibility_errors"][0] < 1e-3 and rec["dual_feasibility_errors"][0] < 1e-3


@pytest.mark.parametrize("argv,error", [
    (["--problem", "maxcut", "--solver", "sdpa"], NotImplementedError),
    (["--problem", "maxcut", "--solver", "scs"], NotImplementedError),
])
def test_runner_refuses_unported(argv, error):
    path = os.path.join(REPO, "configs", "maxcut_3.yaml")
    with pytest.raises(error):
        runner.run_experiment(argv=argv + ["--config", path, "--device", "cpu"])


def test_runner_graphm(tmp_path, monkeypatch):
    import ttipm_tpu_torch.ipm as tipm
    from ttipm_tpu_torch.models.graphm import create_problem

    assert runner.load_problem("graphm") is create_problem
    steps = []

    def no_step(*args):
        steps.append(args[-3])  # the IPM status
        return 0.0, 0.0, None, None, None, None, args[-3]

    monkeypatch.setattr(tipm, "_tt_ipm_newton_step", no_step)
    _, path = _one_seed_config(tmp_path, 256, "graphm_2")
    monkeypatch.chdir(tmp_path)
    rec = runner.run_experiment(argv=["--problem", "graphm", "--config", path, "--device",
                                      "cpu", "--no_resample"])
    data = json.load(open(glob.glob(str(tmp_path / "results" / "*.json"))[0]))
    assert len(steps) == 2 and rec["num_iters"][0] == 2
    assert steps[0].ineq_status.name == "ACTIVE"
    for key in ("ranksX", "ranksY", "ranksZ", "ranksT"):
        assert np.shape(data[key]) == (1, 1, 4), key
    # the initial point: X = I shifted along the mask, Z = I, T on the mask
    assert data["ranksZ"] == [[[1.0] * 4]]
    assert data["ranksT"] == [[[1.0, 2.0, 1.0, 2.0]]]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_runner_refuses_cpu_fallback():
    path = os.path.join(REPO, "configs", "maxcut_3.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_experiment(argv=["--problem", "maxcut", "--config", path])


def test_memtrack_cpu():
    with PeakMemoryTracker("cpu") as tracker:
        block = np.ones(4_000_000)
        block[::4096] = 2.0
    assert tracker.peak_mb >= 0.0
