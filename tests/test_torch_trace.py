"""The port's trace (``ttipm_tpu_torch/trace.py``): spans and counters off
by default and free there, their nesting and self times when on, a
maxcut d3 solve that gives the same bits traced and untraced with the
spans of every layer the equality path reaches, the ladder's exhaustions
counted, host syncs counted by span; on the card (marked ``cuda``) the
sync hook against a plain count of the same warnings and the spans of
CUDA-graph captures and replays.

This file imports no JAX, so the card's tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import os
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from ttipm_tpu_torch import checks, config, ipm, trace
from ttipm_tpu_torch.models.maxcut import create_problem
from ttipm_tpu_torch.ops.tt import tt_reshape
from ttipm_tpu_torch.solvers.amen import AmenRestartsExhausted
from ttipm_tpu_torch.solvers.fused import tt_restarted_block_amen_fused
from ttipm_tpu_torch.solvers.local_kkt import ipm_local_solver
from ttipm_tpu_torch.utils.runner import load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)
SYNC = "called a synchronizing CUDA operation (Triggered internally at x.cpp:1.)"

# every span the equality path of a maxcut d3 solve reaches on the CPU
EQUALITY_PATH = {"ipm.solve", "ipm.iteration", "ipm.newton_system", "ipm.kkt_solve",
                 "kkt.prep", "kkt.rung", "kkt.sweep", "kkt.local_solve", "kkt.split",
                 "kkt.residual", "kkt.refine", "kkt.warm_round", "ipm.step_size",
                 "eigen.solve", "eigen.sweep", "ipm.corrector_rhs", "ipm.update"}


@pytest.fixture(autouse=True)
def _off():
    trace.disable()
    yield
    trace.disable()


class FakeClock:
    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return 1000 * self.calls


def _layers(n):
    for i in range(n):
        with trace.span("outer"):
            with trace.span("inner", i=i):
                trace.count("c")
        with trace.solve():
            trace.count("c", 2)


def test_off_records_nothing_allocates_nothing_and_reads_no_clock(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(trace, "_clock", clock)
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b") is trace.solve()
    _layers(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        _layers(2000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, trace.__file__)]
    grown = after.filter_traces(here).compare_to(before.filter_traces(here), "filename")
    assert sum(d.size_diff for d in grown) == 0
    assert sum(d.count_diff for d in grown) == 0
    assert clock.calls == 0
    assert trace.take() == {"spans": [], "counters": {}, "syncs_by_line": {}}


def test_nesting_parents_solve_ids_and_self_time(monkeypatch):
    monkeypatch.setattr(trace, "_clock", FakeClock())
    trace.enable()
    with trace.span("setup.kernel_load"):                     # 1000 .. 2000
        pass
    with trace.solve(tag="a"):                                # 3000 .. 12000
        with trace.span("ipm.iteration", iteration=1):        # 4000 .. 11000
            with trace.span("ipm.kkt_solve", role="predictor"):   # 5000 .. 8000
                with trace.span("kkt.sweep"):                     # 6000 .. 7000
                    trace.count("kkt.sweeps")
            with trace.span("ipm.step_size"):                 # 9000 .. 10000
                pass
    with trace.solve():                                       # 13000 .. 14000
        pass
    rec = trace.take()
    spans = rec["spans"]
    assert [s["name"] for s in spans] == ["setup.kernel_load", "ipm.solve", "ipm.iteration",
                                          "ipm.kkt_solve", "kkt.sweep", "ipm.step_size",
                                          "ipm.solve"]
    assert [s["parent"] for s in spans] == [-1, -1, 1, 2, 3, 2, -1]
    assert [s["solve"] for s in spans] == [0, 1, 1, 1, 1, 1, 2]
    assert spans[1]["attrs"] == {"tag": "a"} and spans[3]["attrs"] == {"role": "predictor"}
    assert [(s["start_ns"], s["end_ns"]) for s in spans] == [
        (1000, 2000), (3000, 12000), (4000, 11000), (5000, 8000), (6000, 7000),
        (9000, 10000), (13000, 14000)]
    # self time: the length less the children's
    assert trace.self_ns(spans) == [1000, 2000, 3000, 2000, 1000, 1000, 1000]
    assert rec["counters"] == {"kkt.sweeps": 1}


def test_take_clears_the_record():
    trace.enable()
    with trace.solve():
        trace.count("kkt.sweeps", 3)
    first = trace.take()
    assert len(first["spans"]) == 1 and first["counters"] == {"kkt.sweeps": 3}
    assert trace.take() == {"spans": [], "counters": {}, "syncs_by_line": {}}
    with trace.span("x"):
        pass
    again = trace.take()
    assert [s["name"] for s in again["spans"]] == ["x"] and again["spans"][0]["parent"] == -1
    trace.disable()
    assert not trace.enabled() and trace.take()["spans"] == []


def test_syncs_counted_by_innermost_span_and_passed_on():
    """The hook's mechanics, on warnings of the sync debug mode's text: each
    is counted against the innermost open span and by its line, every time
    (not once a line), and reaches the handler installed before."""
    with warnings.catch_warnings(record=True) as caught:
        trace.enable(syncs=True)
        for _ in range(3):
            with trace.solve():
                warnings.warn(SYNC)
                with trace.span("ipm.kkt_solve"):
                    for _ in range(2):
                        warnings.warn(SYNC)
                    with trace.span("kkt.sweep"):
                        warnings.warn(SYNC)
                warnings.warn("not a sync")
        warnings.warn(SYNC)   # outside every span: by line only
        rec = trace.take()
        trace.disable()
    spans = rec["spans"]
    assert [s["syncs"] for s in spans[:3]] == [1, 2, 1]
    assert trace.inclusive_syncs(spans)[:3] == [4, 3, 1]
    assert sum(trace.inclusive_syncs(spans)[i] for i, s in enumerate(spans)
               if s["parent"] < 0) == 12
    assert sum(rec["syncs_by_line"].values()) == 13
    assert all(k.startswith(os.path.join("tests", "test_torch_trace.py:"))
               for k in rec["syncs_by_line"])
    assert sum(str(w.message).startswith("called a synchronizing") for w in caught) == 13
    assert any(str(w.message) == "not a sync" for w in caught)
    assert not getattr(warnings.showwarning, "_ttipm_trace", False)   # taken out again


def test_default_printer_shows_a_line_once():
    """Where nothing records the warnings, Python's printer gets each
    line's first sync warning only (in a fresh interpreter: pytest records
    warnings), while the trace counts every one."""
    import subprocess
    import sys

    code = ("import io, sys, warnings\n"
            "from ttipm_tpu_torch import trace\n"
            "err = io.StringIO()\n"
            "real, sys.stderr = sys.stderr, err\n"
            "trace.enable(syncs=True)\n"
            "with trace.solve():\n"
            "    for _ in range(5):\n"
            f"        warnings.warn({SYNC!r})\n"
            f"        warnings.warn({SYNC!r})\n"
            "syncs = trace.take()['spans'][0]['syncs']\n"
            "trace.disable()\n"
            "sys.stderr = real\n"
            "print(err.getvalue().count('synchronizing'), syncs)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["2", "10"]


def _maxcut_d3():
    rng = np.random.RandomState(319)
    obj, L, b, lag = create_problem(3, 1, device="cpu", rng=rng)
    X, Y, T, Z, info = ipm.tt_ipm({"y": tt_reshape(lag, (4, 4))}, obj, L, b, rng=rng,
                                  **SETTINGS)
    return (X, Y, Z), info["num_iters"], rng.get_state()


@pytest.fixture(params=[False, True], ids=["eager", "whole_solve"])
def whole_solve(request):
    config.set_fused_whole_solve(request.param)
    yield request.param
    config.set_fused_whole_solve(None)


def test_traced_solve_gives_the_untraced_bits(whole_solve):
    iterates0, iters0, stream0 = _maxcut_d3()
    trace.enable(syncs=True)
    iterates1, iters1, stream1 = _maxcut_d3()
    rec = trace.take()
    trace.disable()

    assert iters1 == iters0 == 7
    for a, b in zip(iterates0, iterates1):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert stream1[0] == stream0[0] and np.array_equal(stream1[1], stream0[1])
    assert stream1[2:] == stream0[2:]

    spans = rec["spans"]
    names = [s["name"] for s in spans]
    assert EQUALITY_PATH <= set(names)
    assert names[0] == "ipm.solve" and names.count("ipm.solve") == 1
    assert all(s["solve"] == 1 for s in spans)
    assert names.count("ipm.iteration") == iters1 + 1   # the last one finds convergence
    assert [s["attrs"]["iteration"] for s in spans if s["name"] == "ipm.iteration"] == list(
        range(1, iters1 + 2))
    roles = [s["attrs"]["role"] for s in spans if s["name"] == "ipm.kkt_solve"]
    assert set(roles) == {"predictor", "corrector"}
    assert roles.count("predictor") == iters1
    for s in spans:   # each span lies inside its parent
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    assert all(v >= 0 for v in trace.self_ns(spans))
    sweeps = names.count("kkt.sweep")
    if whole_solve:   # a pair of the graphed program is one span, two sweeps
        assert sweeps <= rec["counters"]["kkt.sweeps"] <= 2 * sweeps
    else:
        assert rec["counters"]["kkt.sweeps"] == sweeps
    assert rec["counters"]["eigen.sweeps"] > 0
    assert "kkt.ladder_exhausted" not in rec["counters"]
    assert "kkt.fallback" not in names


@pytest.fixture(scope="module")
def newton_system():
    cfg = load_yaml(os.path.join(REPO, "configs", "maxcut_3.yaml"))
    lhs, rhs, _, _ = checks.first_newton_system("maxcut", cfg, 319, "cpu")
    return lhs, rhs


def test_ladder_exhaustion_counted(newton_system):
    """Rank 1 and one restart: the ladder cannot accept a solve of the
    first maxcut d3 system, raises, and counts it; through the IPM's solver
    the ragged AMEn then takes the solve, inside ``kkt.fallback``."""
    lhs, rhs = newton_system
    trace.enable()
    raised = 0
    for _ in range(2):
        try:
            tt_restarted_block_amen_fused(lhs, rhs, rank_restriction=1, op_tol=1e-4,
                                          termination_tol=1e-12, num_restarts=1, inner_m=4,
                                          rng=np.random.RandomState(0))
        except AmenRestartsExhausted:
            raised += 1
    assert raised == 2
    assert trace.take()["counters"]["kkt.ladder_exhausted"] == raised

    solver = ipm._make_solver(3, 1e-4, 1, False, np.random.RandomState(0), ipm_local_solver,
                              False)
    solver(lhs, rhs, None, 4, 1, 1e-12)
    rec = trace.take()
    names = [s["name"] for s in rec["spans"]]
    assert rec["counters"]["kkt.ladder_exhausted"] == 1
    assert names.count("kkt.fallback") == 1
    fallback = names.index("kkt.fallback")
    assert rec["spans"][fallback]["parent"] == -1 and names.index("kkt.rung") < fallback


def test_untraced_benchmark_run_leaves_the_trace_off():
    """A ``--trace 0`` run of the benchmark (a d3 cell on the CPU, in a
    fresh interpreter) runs the program with its trace off: no clock read
    by the trace, nothing recorded, and none of the benchmark's tracing
    code loaded."""
    import json
    import subprocess
    import sys

    code = ("import sys, json; sys.path.insert(0, 'portbench/tests')\n"
            "from ttipm_tpu_torch import trace\n"
            "calls = []\n"
            "trace._clock = lambda: calls.append(1) or 0\n"
            "from helpers import cpu_run, small_cell\n"
            "res = cpu_run(small_cell('maxcut_d8', seeds=(7,)))\n"
            "bench = sorted(n for n in sys.modules if n.split('.')[0] == 'portbench')\n"
            "print(json.dumps([res['correct'], trace.enabled(), len(calls), trace.take(), "
            "bench]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, on, clock_calls, record, bench = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and not on and clock_calls == 0
    assert record == {"spans": [], "counters": {}, "syncs_by_line": {}}
    assert "portbench.trace" not in bench and "portbench.roofline" not in bench
    assert not any(n.startswith("portbench.metrics.") and n.split(".")[-1]
                   not in ("solve_s", "setup_s") for n in bench)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (host syncs and CUDA graphs exist only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_sync_hook_matches_a_plain_count(cuda):
    """The hook's per-span counts, summed over the root spans, are the sync
    warnings that a plain ``catch_warnings`` count sees during the solve,
    and its count by line the same, the port's files among them."""
    rng = np.random.RandomState(319)
    obj, L, b, lag = create_problem(3, 1, device=cuda, rng=rng)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trace.enable(syncs=True)
        try:
            ipm.tt_ipm({"y": tt_reshape(lag, (4, 4))}, obj, L, b, rng=rng, **SETTINGS)
            rec = trace.take()
        finally:
            trace.disable()
    torch.cuda.synchronize()
    # a sync's own text (torch's one-time notice that the debug mode is a
    # prototype also says "synchronizing")
    syncs = [w for w in caught if str(w.message).startswith("called a synchronizing")]
    port = sum(1 for w in syncs
               if os.path.abspath(w.filename).startswith(os.path.join(REPO, "ttipm_tpu_torch")))
    spans = rec["spans"]
    inclusive = trace.inclusive_syncs(spans)
    by_root = sum(inclusive[i] for i, s in enumerate(spans) if s["parent"] < 0)
    assert port > 0
    assert by_root == len(syncs) == sum(rec["syncs_by_line"].values())
    assert sum(v for k, v in rec["syncs_by_line"].items()
               if k.startswith("ttipm_tpu_torch")) == port
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_card_capture_records_nothing_and_replays_record(cuda):
    from ttipm_tpu_torch.solvers import graphs

    def step(args):
        with trace.span("inside"):
            trace.count("inside")
            return (args[0] * 2 + 1,)

    graphs.reset()
    x = torch.arange(8.0, device=cuda)
    trace.enable()
    try:
        with trace.span("outside"):
            outs = [graphs.run(("trace_test",), step, (x + i,))[0] for i in range(3)]
        rec = trace.take()
    finally:
        trace.disable()
        graphs.reset()
    for i, out in enumerate(outs):
        assert torch.equal(out, (x + i) * 2 + 1)
    names = [s["name"] for s in rec["spans"]]
    # the first call: its eager run records, its capture does not; then two replays
    assert names == ["outside", "graph.capture", "inside", "graph.replay", "graph.replay"]
    assert rec["spans"][1]["attrs"] == {"step": "trace_test"}
    assert rec["counters"] == {"inside": 1}
