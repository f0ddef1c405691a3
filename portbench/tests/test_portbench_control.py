"""On the card: the comparison's control, the program's float32 profile
(``--control``), comes out not correct in every cell, at the cell's own
size; the configuration's own precision comes out correct.  One round of
the cell each (a float32 maxcut d8 round takes some minutes).

    python -m pytest portbench/tests/test_portbench_control.py
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["maxcut_d8.seeds5"]


def _run(cell: str, seed: int, control: bool) -> dict:
    cmd = [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", "1", "--trace", "0"] + (["--control"] if control else [])
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(cuda, cell):
    res = _run(cell, 2**31 + 101, control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_configured_precision_is_correct(cuda, cell):
    res = _run(cell, 2**31 + 102, control=False)
    assert res["correct"], res["checks"]
