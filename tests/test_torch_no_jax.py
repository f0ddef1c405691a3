"""The port imports no JAX.  Checked in a fresh interpreter, since the test
session itself has imported jax (tests/conftest.py)."""

import subprocess
import sys

MODULES = [
    "ttipm_tpu_torch",
    "ttipm_tpu_torch.checks",
    "ttipm_tpu_torch.config",
    "ttipm_tpu_torch.interop",
    "ttipm_tpu_torch.ipm",
    "ttipm_tpu_torch.models.baselines",
    "ttipm_tpu_torch.models.conic",
    "ttipm_tpu_torch.models.corr_clust",
    "ttipm_tpu_torch.models.graphm",
    "ttipm_tpu_torch.models.max_stable_set",
    "ttipm_tpu_torch.models.maxcut",
    "ttipm_tpu_torch.models.riemannian",
    "ttipm_tpu_torch.ops._build",
    "ttipm_tpu_torch.ops.jacobi",
    "ttipm_tpu_torch.ops.kernels",
    "ttipm_tpu_torch.ops.linalg",
    "ttipm_tpu_torch.ops.products",
    "ttipm_tpu_torch.ops.random",
    "ttipm_tpu_torch.ops.randomized",
    "ttipm_tpu_torch.ops.rounding",
    "ttipm_tpu_torch.ops.tt",
    "ttipm_tpu_torch.parallel.batch",
    "ttipm_tpu_torch.parallel.fused_mesh",
    "ttipm_tpu_torch.parallel.mesh",
    "ttipm_tpu_torch.solvers.amen",
    "ttipm_tpu_torch.solvers.blocks",
    "ttipm_tpu_torch.solvers.eigen",
    "ttipm_tpu_torch.solvers.fused",
    "ttipm_tpu_torch.solvers.fused_algebra",
    "ttipm_tpu_torch.solvers.fused_batch",
    "ttipm_tpu_torch.solvers.fused_eigen",
    "ttipm_tpu_torch.solvers.fused_eigen_batch",
    "ttipm_tpu_torch.solvers.graphs",
    "ttipm_tpu_torch.solvers.lgmres",
    "ttipm_tpu_torch.solvers.local_kkt",
    "ttipm_tpu_torch.tools.aggregate_grid",
    "ttipm_tpu_torch.tools.bench",
    "ttipm_tpu_torch.tools.compare_kernels",
    "ttipm_tpu_torch.tools.compare_solves",
    "ttipm_tpu_torch.tools.dryrun_mesh",
    "ttipm_tpu_torch.tools.f32_repairs",
    "ttipm_tpu_torch.tools.jacobi_census",
    "ttipm_tpu_torch.tools.long_run",
    "ttipm_tpu_torch.tools.scaling_bench",
    "ttipm_tpu_torch.tools.svd_repeat",
    "ttipm_tpu_torch.tools.sync_count",
    "ttipm_tpu_torch.utils.baseline_runner",
    "ttipm_tpu_torch.utils.checkpoint",
    "ttipm_tpu_torch.utils.memtrack",
    "ttipm_tpu_torch.utils.reporting",
    "ttipm_tpu_torch.utils.runner",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'ttipm_tpu.')) or m == 'ttipm_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
