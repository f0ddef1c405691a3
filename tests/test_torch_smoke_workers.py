"""chip_smoke.py's worker processes, on the CPU.

The smoke runs the phases that only solve and check (fallback, ineq,
graphm, f32, run_batch, tools, corr_clust on the whole-solve path) as
worker processes on the card, while the parent runs parity and the mesh
(``chip_smoke.Workers``).  Here the workers are small Python commands in
place of ``python3 chip_smoke.py --worker JOB``: the scheduling under a
concurrency limit, the order of the printed outputs, a failing job, a job
past its time limit, and the processes left when the block is left.  Also
the job table and the worker's refusal without a card.
"""

import os
import pickle
import sys
import time

import pytest

import chip_smoke as S

# A job: sleeps, prints its name, writes its result (its start and end
# times) as worker_main does, and exits with the code it is given.
_JOB = """
import pickle, sys, time
job, d, sleep, code = sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
t0 = time.time()
time.sleep(sleep)
print("out of", job)
print("err of", job, file=sys.stderr)
if code == 0:
    with open(f"{d}/{job}.pkl", "wb") as fh:
        pickle.dump({"result": {"job": job, "span": (t0, time.time())}, "wall_s": 0.0}, fh)
sys.exit(code)
"""


def _command(sleep=0.3, codes=None):
    codes = codes or {}

    def command(job, worker_dir):
        return [sys.executable, "-c", _JOB, job, worker_dir, str(sleep), str(codes.get(job, 0))]
    return command


def test_jobs_run_at_most_limit_at_a_time_and_print_in_order(capsys):
    jobs = ["a", "b", "c", "d"]
    with S.Workers(jobs, {"x": 1}, 2, _command()) as workers:
        assert os.path.exists(os.path.join(workers.dir, "inputs.pkl"))
        results = workers.join()
        walls = dict(workers.walls)
    out = capsys.readouterr()
    assert [line for line in out.out.splitlines() if line.startswith("out of")] == \
        [f"out of {j}" for j in jobs]
    assert "err of d" in out.err
    assert sorted(results) == jobs and set(walls) == set(jobs)
    spans = [results[j]["result"]["span"] for j in jobs]
    for t in (s for span in spans for s in span):
        assert sum(a <= t < b for a, b in spans) <= 2
    assert not os.path.exists(workers.dir)


def test_a_failing_job_fails_the_run(capsys):
    with S.Workers(["ok", "bad"], {}, 2, _command(codes={"bad": 3})) as workers:
        with pytest.raises(AssertionError, match="bad.*exit 3.*err of bad"):
            workers.join()
    out = capsys.readouterr().out
    assert "out of ok" in out and "out of bad" in out


def test_a_job_past_its_time_limit_is_killed():
    t0 = time.perf_counter()
    with S.Workers(["slow"], {}, 1, _command(sleep=60), timeout_s=1) as workers:
        with pytest.raises(AssertionError, match="killed after 1 s"):
            workers.join()
    assert time.perf_counter() - t0 < 30


def test_leaving_the_block_kills_the_jobs_still_running():
    with pytest.raises(RuntimeError):
        with S.Workers(["slow"], {}, 1, _command(sleep=60)) as workers:
            while "slow" not in workers.procs:
                time.sleep(0.05)
            raise RuntimeError("the parent's phase failed")
    assert workers.procs["slow"].poll() is not None
    assert not os.path.exists(workers.dir)


def test_every_job_belongs_to_a_phase():
    assert {S.JOB_PHASE.get(job, job) for job in S.JOBS} <= set(S.PHASES)
    # the parent's phases, and those it times alone
    assert not {"kernels", "slice", "parity", "mesh", "baselines"} & set(S.JOBS)
    command = S.worker_command(["--j1-from", "22"])("f32", "/w")
    assert command[1:] == [os.path.abspath(S.__file__), "--worker", "f32", "--worker-dir", "/w",
                           "--j1-from", "22"]


def test_portable_record_keeps_shapes_not_operands():
    calls = {("fused", "panel_qr", ("spec",)): 3}
    bounds = {("panel_qr", ("spec",)): 0.1}
    largest = {"panel_qr": (0.1, ("spec",), ("an operand",), {"transposed": True})}
    out = S.portable_record((calls, bounds, largest))
    assert out == (calls, bounds, {"panel_qr": (0.1, ("spec",), None, {"transposed": True})})
    pickle.dumps(out)


def test_worker_refuses_without_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        S.worker_main("fallback", str(tmp_path))
