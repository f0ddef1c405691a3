"""The run's last line, its refusal without a card, its traced metrics,
and the check that no process of the benchmark holds JAX or the JAX
package."""

import json
import os
import subprocess
import sys

import pytest

from helpers import cpu_run, small_cell
from portbench import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_the_guard_compares_whole_top_level_names():
    names = ["jax.x", "jax", "jaxlib.xla", "flax.core", "ttipm_tpu.y", "ttipm_tpu",
             "ttipm_tpu_torch.z", "ttipm_tpu_torch", "jaxtyping", "numpy"]
    assert guard.forbidden_modules(names) == ["flax.core", "jax", "jax.x", "jaxlib.xla",
                                              "ttipm_tpu", "ttipm_tpu.y"]


def _fresh(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, 'portbench/tests')\n"
            "import portbench.reference.sdp, portbench.reference.tt, portbench.reference.graph\n"
            "import portbench.families.maxcut, portbench.families.corr_clust\n"
            "ref = sorted(n for n in sys.modules if n.split('.')[0].startswith('ttipm'))\n"
            "from helpers import cpu_run, small_cell\n"
            "from portbench import guard\n"
            "res = cpu_run(small_cell('maxcut_d8', seeds=(7,)))\n"
            "print(json.dumps([ref, guard.forbidden_modules(), res['correct']]))")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr[-2000:]
    ref, forbidden, correct = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref == [] and forbidden == [] and correct


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "maxcut_d8.seeds5",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_unknown_cell_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nonesuch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_traced_run_reports_the_host_side_layers():
    res = cpu_run(small_cell("corr_clust_d6", seeds=(7,)), trace=True)
    m = res["metrics"]
    assert {"iters_per_solve", "iter_s", "newton_system_pct", "kkt_solve_pct",
            "fallbacks_per_solve", "step_size_pct"} <= set(m)
    assert 0 < m["newton_system_pct"]["value"] + m["kkt_solve_pct"]["value"] \
        + m["step_size_pct"]["value"] <= 100
    # the device's metrics come only from a card's trace
    assert not any(k.endswith("_roofline") or k == "device_idle_pct" for k in m)
    assert list(res)[-1] == "checks"
