"""The port's drivers (``ttipm_tpu_torch/tools``) on the CPU at d3, against
the repository's drivers of the JAX package where one computes the same.

* ``tools/bench.py`` with ``BENCH_PLATFORM=cpu BENCH_GRID=3:1``: the
  device line, one solve line with the protocol's keys, converged, the
  summary line last; its iterations equal ``bench.py::_solve_once``'s on
  the same seed (both at their default rank bucket 4).
* ``tools/long_run.py`` stopped by SIGKILL once the checkpoint of
  iteration 3 is on disk, then run again: it resumes from iteration 3 and
  ends with the iterations and ranks of an uninterrupted run; a third run
  does nothing.
* ``tools/aggregate_grid.py`` writes the same SUMMARY.json as
  ``scripts/aggregate_grid.py`` on the same synthetic grid.
* ``tools/scaling_bench.py`` at d3, B = 1, 2: the rows' structure, and the
  B = 1 step bit-equal to a single ``tt_newton_step_batch`` of instance 0.
* ``tools/jacobi_census.py`` at d3 on the plain Jacobi: the solve
  converges in the JAX package's 7 iterations (tests/test_torch_ipm.py),
  every factorization is recorded with its sweeps, none fails, every
  eigh holds LAPACK's eigenvalues (``--check``); the cuSOLVER route
  (LAPACK here) records none.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(module, *args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", f"ttipm_tpu_torch.tools.{module}", *args],
                          cwd=REPO, env={**os.environ, **(env or {})}, capture_output=True,
                          text=True, timeout=timeout)


def test_bench_protocol_on_the_cpu(monkeypatch):
    proc = _tool("bench", env={"BENCH_PLATFORM": "cpu", "BENCH_GRID": "3:1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    solve, summary = rows[0], rows[-1]
    assert len(rows) == 2
    assert solve["metric"] == "maxcut_d3_seed1015_solve_seconds" and solve["unit"] == "s"
    for key in ("value", "slackness", "iters", "converged", "platform", "vs_baseline"):
        assert key in solve
    assert solve["converged"] and solve["platform"] == "cpu" and solve["value"] > 0
    assert solve["plain_calls"]["panel_qr"] > 0 and solve["kernels"]["panel_qr"] == 0
    assert summary["metric"] == "maxcut_grid_geomean_seconds"
    assert summary["converged_all"] and summary["skipped"] == []
    assert [g["dim"] for g in summary["grid"]] == [3]
    assert summary["vs_baseline"] == pytest.approx(summary["grid"][0]["ref_mean"]
                                                   / summary["value"])

    monkeypatch.setenv("TTIPM_NO_REEXEC", "1")  # bench.py re-executes itself otherwise
    monkeypatch.syspath_prepend(REPO)
    import bench

    from ttipm_tpu import config as jconfig

    jconfig.set_rank_bucket(4)  # bench.py runs at the JAX package's default
    _, slack, iters = bench._solve_once(3, 1015, bench._load_config(3))
    assert iters == solve["iters"]
    assert slack < 1e-3


def test_long_run_resumes_after_a_kill(tmp_path):
    args = ("--problem", "maxcut", "--dim", "3", "--device", "cpu")
    whole = subprocess.Popen([sys.executable, "-m", "ttipm_tpu_torch.tools.long_run", *args,
                              "--out", str(tmp_path / "whole")], cwd=REPO,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    killed = _tool("long_run", *args, "--out", str(tmp_path / "cut"), "--kill-after", "3")
    assert killed.returncode == -9, killed.stderr[-2000:]
    work = tmp_path / "cut" / "maxcut_3_s0"
    assert not (work / "result.json").exists()
    from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint

    assert load_ipm_checkpoint(str(work / "ckpt.npz"), device="cpu")["iteration"] == 3
    resumed = _tool("long_run", *args, "--out", str(tmp_path / "cut"))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "resuming" in resumed.stdout
    assert whole.wait(timeout=300) == 0, whole.stderr.read()[-2000:]
    got = json.loads((work / "result.json").read_text())
    want = json.loads((tmp_path / "whole" / "maxcut_3_s0" / "result.json").read_text())
    assert [a["from_iteration"] for a in got["attempts"]] == [0, 3]
    assert not got["attempts"][0]["ended"] and got["attempts"][1]["ended"]
    assert got["converged"] and got["num_iters"] == want["num_iters"]
    for key in ("ranksX", "ranksY", "ranksZ"):
        assert got[key] == want[key], key
    runner_json = json.loads((work / "results" / "runner.json").read_text())
    assert runner_json["num_iters"] == [[float(got["num_iters"])]]
    again = _tool("long_run", *args, "--out", str(tmp_path / "cut"))
    assert again.returncode == 0 and "nothing to do" in again.stdout


def _runner_json(rng, seeds):
    """One seed's record in the runner's schema (the fields the summary reads)."""
    t = float(rng.uniform(1, 100))
    return {"runtimes": [[t]], "complementary_slackness": [[float(rng.uniform(1e-5, 2e-3))]],
            "num_iters": [[float(rng.randint(5, 20))]], "seeds": seeds,
            "feasibility_errors": [[1e-6]], "dual_feasibility_errors": [[1e-6]]}


def test_aggregate_grid_matches_the_jax_script(tmp_path):
    rng = np.random.RandomState(4)
    grid = tmp_path / "grid"
    for cell in ("maxcut_8", "maxcut_10", "corr_clust_6", "graphm_2"):
        for idx in range(int(rng.randint(1, 5))):
            res = grid / f"{cell}_s{idx}" / "results"
            res.mkdir(parents=True)
            (res / "seed.json").write_text(json.dumps(_runner_json(rng, [idx])))
    (grid / "notes.txt").write_text("not a cell")
    ref = tmp_path / "ref"
    shutil.copytree(grid, ref)
    from ttipm_tpu_torch.tools import aggregate_grid

    assert aggregate_grid.main([str(grid)]) == 0
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "aggregate_grid.py"),
                           str(ref)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads((grid / "SUMMARY.json").read_text())
    want = json.loads((ref / "SUMMARY.json").read_text())
    assert got == want and set(got) == {"maxcut", "corr_clust", "graphm"}


def test_scaling_bench_rows_at_d3(tmp_path):
    from ttipm_tpu_torch.parallel.fused_mesh import tt_newton_step_batch
    from ttipm_tpu_torch.tools import scaling_bench

    out = tmp_path / "scaling.json"
    assert scaling_bench.main(["--dim", "3", "--batches", "1,2", "--device", "cpu",
                               "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["settings"] == scaling_bench.SYNTHETIC
    assert [r["B"] for r in rec["rows"]] == [1, 2] and rec["mesh_rows"] == []
    for r in rec["rows"]:
        assert len(r["x_steps"]) == len(r["singles_s"]) == r["B"]
        assert r["batch_wall_s"] > 0 and r["s_per_instance"] == r["batch_wall_s"] / r["B"]
        assert sum(r["plain_calls"].values()) > 0 and not any(r["launches"].values())
        assert all(0 < x <= 1 for x in r["x_steps"] + r["z_steps"])
    systems, Xs, Zs, settings = scaling_bench.make_instances(3, 1, torch.device("cpu"))
    np.random.seed(settings["seed"])
    xs, zs, _ = tt_newton_step_batch(systems, Xs, Zs, **settings)
    assert rec["rows"][0]["x_steps"] == [float(xs[0])]
    assert rec["rows"][0]["z_steps"] == [float(zs[0])]


def test_jacobi_census_at_d3(tmp_path):
    from ttipm_tpu_torch.tools.jacobi_census import census

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain Jacobi's tiny ops (tests/test_torch_jacobi.py)
    try:
        rec = census(3, 319, torch.device("cpu"), out_dir=str(tmp_path), check=True)
        lapack = census(3, 319, torch.device("cpu"), route="cusolver", out_dir=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    assert rec["iters"] == lapack["iters"] == 7 and rec["slackness"] < 1e-3
    for core in ("svd", "eigh"):
        c = rec[core]
        assert c["instances"] > 0 and c["nan_finite_operand"] == 0, c
        assert sum(n for _, n in c["sweeps"]) == c["instances"]
        assert max(s for s, _ in c["sweeps"]) < 26
    for order in rec["eigh"]["by_order"].values():  # --check: every call held to LAPACK's
        assert order["check"]["values"] <= 1e-12 and order["check"]["orth"] <= 1e-13, order
    assert "svd" not in lapack and "eigh" not in lapack
    assert not os.listdir(tmp_path)
