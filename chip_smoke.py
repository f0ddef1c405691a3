"""Smoke test of the PyTorch port (ttipm_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--dim D --seed S]

Layout.  The parent process runs, alone on the card, every phase whose
times PERF.md's tables take: device, build, kernels (3), slice (5), batch
(10, but for ``run_batch``) and whole (14, the d8 cell).  Then the
phases that only solve and check run as worker processes on the same
card (``Workers``: ``python3 chip_smoke.py --worker JOB``, at most
os.cpu_count() - 1 at a time, longest first): fallback (6), ineq (7),
graphm (8) and f32 (9) without their timings, ``run_batch`` (10), tools
(13) and phase 14's corr_clust solve; meanwhile the parent runs parity (4)
and the mesh (11).  Each worker loads the library phase 2 built (it never
builds), gets phase 5's iterations and final X, prints into a file that
the parent prints after they have all joined, in job order, and returns
its counts and call records (pickled).  Once they have joined, the parent
times phases 6-9's heaviest shapes (on random operands of the recorded
shapes) and runs the baselines (12), alone again.  So the walls, layer
seconds and host syncs that phases 4, 6-9, 11 and 13 print were taken
while other phases ran; the ``concurrent`` line names the jobs and the
parent's overlapped phases, and ``phase_s`` gives each job's wall
(``worker_*``), the block's and each alone phase's.  A worker that fails
or runs past WORKER_TIMEOUT_S fails the run; every worker still running
is killed when the parent leaves.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: compiles the six CUDA kernels from ttipm_tpu_torch/csrc (one
   nvcc per source, all started together): K1-K4, the ports of the four
   Pallas kernels, and J1 / J2, the Jacobi SVD and eigh cores, which
   replace no Pallas kernel but the JAX package's jnp Jacobi programs
   (ttipm_tpu/ops/jacobi.py:121, :370) under every dense SVD and eigh of
   the port on the card.
3. kernels: each kernel against its plain PyTorch version on the card,
   at the fused solve's shapes (bond rank R in {8, 16, 32}, operator ranks
   in {1, 4, 9}, the panels of K3_PANELS, which span K3's regimes up to
   its envelope 512 x 128, one of them also as a transposed view and with
   the transposed output, SPD matrices of the orders in K4_ORDERS, which
   span both regimes of K4, and one indefinite one, J1 on the r2^T of the
   d8 and d10 solves' SVDs and at its regimes' bounds (JACOBI_SVD_ORDERS:
   the element rule below kernels.J1_BLOCK_FROM, the block algorithm from
   there, and at the block orders to 118 also the element regime forced,
   timed in turns beside it) and J2 on pencils of the
   eigen windows' orders (JACOBI_EIGH_ORDERS: both of J2's regimes, the
   element rule below kernels.J2_BLOCK_FROM and the block algorithm from
   there), and J2 without eigenvectors at each order),
   with median times of kernel, plain version and the one library call
   that computes the same function, taken in turns (plain, library,
   kernel, kernel, library, plain), beside the roofline bound of the call.
   The grouped entries of K1 and K2 (several blocks, a whole block
   product, one launch) run at the same R and s with transposed and
   flipped (non-contiguous) operands and unequal operator ranks in a
   group.  The time of an empty kernel launched through the same wrapper
   path is printed: that, not the roofline, is the floor of a small call.
4. parity: MaxCut d3 (seed 319, configs/maxcut_3.yaml settings) solved by
   the port on the CPU (plain versions) and on the GPU (kernels): equal
   iteration counts and <C, X> equal to 1e-6 relative.
5. slice: MaxCut d8 (seed 24, configs/maxcut_8.yaml settings) on the GPU:
   converged (slackness and feasibility below abs_tol), every kernel
   launched, no plain version run on a CUDA tensor, and every kernel
   within the tolerances of phase 3 at each distinct shape the solve gave
   it (checked on the first call of that shape; the grouped entries
   included); every kernel and its plain version are then timed on the
   first operands of each of their shapes, and the totals weighted by the
   solve's call counts are printed (slice_k12_times, slice_k3_times,
   slice_k4_times, slice_jacobi_times); the factorizations that the
   Jacobi pipelines' shape rules sent to torch.linalg are counted and
   printed (``outside``), in every phase that drives a solve.  The
   Newton and step-size solves' walls and host syncs (the checks left
   out) are printed too (``layers``), phase 14's switch-off run.
6. fallback: MaxCut d10 (seed 41, configs/maxcut_10.yaml settings, quiet)
   on the GPU through the runner's run_and_record: the fused ladder, the
   ragged AMEn where the ladder exhausts its restarts, the fused
   eigensolver.  Converged, at least one Newton solve through the ragged
   AMEn, every kernel launched, no plain version run on a CUDA tensor, and
   every kernel within phase 3's tolerances on the first call of up to 48
   distinct shapes a kernel, the largest of each entry point included.
   Printed: wall and iterations beside the JAX package's CPU run, the
   solve counts and seconds of the three solver layers, the host syncs by
   file, the peak device memory, the launches, the largest K1 block and K4
   order, and (by the parent, once the workers have joined) the kernels
   timed at the solve's heaviest shapes.
7. ineq: corr_clust d6 (seed 764, the first of configs/corr_clust_6.yaml,
   its settings, quiet) on the GPU through run_and_record: the inequality
   path (the IneqStatus machine, the fused ladder's nine-term four-row
   products and six-block Schur groups, the smallest-eigenvector step
   sizes, the ragged inequality local solver where the ladder exhausts).
   Converged, ineq_status left NOT_IN_USE, at least one nine-term K2
   product and one six-block K1 group, every kernel launched, no plain
   version on a CUDA tensor, kernels checked as in phase 6.  Printed as in
   phase 6, with the final ineq_status and T ranks, the local solves and
   the K2 / K1 launches by terms and blocks; also timed: the heaviest
   nine-term product, six-block group and ragged L_Z.  If no ragged
   inequality local solve ran, corr_clust d3 seed 291 is solved with the
   fused ladder made to exhaust at once, so that it runs on the card.

8. graphm: graphm n=2 seed 256 (configs/graphm_2.yaml with GRAPHM_SETTINGS,
   those of the JAX package's graphm test; quiet) on the GPU through
   run_and_record: the lifted QAP relaxation (5 cores, four bonds), whose
   Newton systems need TT ranks near 52, past the fused ladder's cap of 32,
   so that they go through the ragged AMEn with the inequality local
   solver (LGMRES at the large local sizes).
   Checked as phase 7 (converged, the inequalities in use, every kernel
   launched, no plain version on a CUDA tensor, kernels held to phase 3's
   tolerances), and the solve writes a checkpoint every iteration into a
   temporary directory: the last one, loaded back onto the card, holds the
   final iterates bit for bit.  Printed as phase 7, beside the JAX
   package's CPU record, with the ranks of Y, the largest ragged local
   system and the kernels at the solve's heaviest shapes (the ladder's
   largest L_Z and six-block group, the ragged LGMRES product).

9. f32: the float32 profile (``config.set_dtype(float32)``,
   ``set_eigen_dtype("native")``, mixed-precision local solves "f64") on
   maxcut d8 seed 319 at rank bucket 4 through run_and_record, with
   scripts/f32_repro.py's settings (``tools/replay_step.py``'s
   ``F32_SETTINGS`` and ``profile_config``), full width: the sweeps'
   block products and split QRs in f32 (the f32 instances of K2 and K3),
   the step-size pencils in f32 (K1 and K4 f32), the local Schur chains in
   f64 on upcast operands (K1, K2 and K4 f64).  Checked as phase 6, every
   f32 shape also against the plain version in f64 on the upcast operands;
   it fails unless the solve converged, TF32 is off, no plain version ran
   on a CUDA tensor and every f32 instance launched in the solve or in the
   capture run: the solve's first Newton system, captured, solved again by
   the fused ladder with the local solves in "refine" and in "off" (K1, K2
   and K4 f32 in the Schur chains); the three modes' residuals are printed
   side by side.  Printed as phase 6 with the launches by dtype, beside
   the JAX package's record of its f32 run, and the f32 instances timed at
   the solve's heaviest shapes.

10. batch: batched seeds on the card (``ttipm_tpu_torch.parallel``).  The
   batched entries of K1-K4 at the batch's shapes (K2's six terms and K1's
   four blocks at R = 16 for 5 instances, K3's (64, 18) panels and a
   cluster-regime (300, 20) one, K4's L_Z of order 1024, blocked and
   launched once per instance, and the eigen windows' order 256 for 10
   pencils), f64 and f32: every instance within phase 3's tolerances of its
   plain version and equal bit for bit to a single launch on it, a batch
   of one equal to the single launch; timed in f64 beside the plain
   version, the batched library call (``linalg.qr``, ``cholesky_ex`` on
   (B, ...)) and the B single launches.  Then the first Newton systems of
   the five seeds of configs/maxcut_10.yaml through
   ``tt_newton_step_batch`` in one batch (BATCH_STEP): finite directions,
   steps in (0, 1], instance 0's steps a batch of one's (1e-5), every
   predictor residual within 10x of the single ``tt_block_amen_fused``
   solve's, every kernel launched through its batched entry, no plain
   version on a CUDA tensor, the batched entries held to phase 3's
   tolerances on the first call of each shape.  Printed: the walls of the
   batch and of five batches of one, of the predictor solve batched and
   five single solves, the host syncs, the device busy share of the
   batched step (torch.profiler), the peak memory, launches and instances.
   Last (a job of the workers), ``run_batch`` on the five seeds of
   configs/maxcut_8.yaml with five worker processes on the card: every
   seed converged, seed 24 in phase 5's iterations.

11. mesh: the (seeds x kkt) mesh over ``torch.distributed``
   (``ttipm_tpu_torch.parallel.mesh``): two ranks sharing cuda:0 over gloo
   (and, where the machine has more cards, nccl on min(4, count) of them)
   run the dry run's three parts (``tools/dryrun_mesh.py``) on a kkt-only
   mesh, then phase 10's five d10 systems through ``tt_newton_step_batch``
   on a seeds-only mesh (S = ranks) and a kkt-only one (K = ranks).
   Checked: the seeds-only steps and directions bit-equal to phase 10's
   ``mesh=None`` step, or the steps within STEP_BOUND and the directions
   within DIRECTION_BOUND with the first op that computes an instance
   differently named (``traced_step``); on the kkt-only mesh each rank's
   partial Schur blocks and their sums over the row within K1's tolerance
   of the plain versions at the cancelling scale and the predictor
   residuals within tests/test_parallel.py:101's bound of phase 10's;
   every kernel launched on every rank, no plain version on a CUDA tensor.
   Printed per rank: walls beside ``mesh=None``'s, collectives and bytes,
   launches and instances, peak memory.
12. baselines: the native dense baselines at the runner's settings on
   BASELINE_CELLS (splitting, cgal, scgal, manopt on maxcut d8 seed 24;
   manopt on d10 seed 41): each ends by its own stop test, its objective
   within 1e-3 of the TT-IPM's final X of phases 5 and 6 on the same
   instance; SketchyCGAL on d10 timed for BASELINE_PROBES' iterations.
   Printed: wall, iterations, objective, feasibility, peak memory.
13. tools: the port's drivers (``ttipm_tpu_torch/tools``), each in a
   subprocess on the card: ``bench`` on TOOLS_BENCH_GRID (every solve
   converged with every kernel launched and no plain version on a CUDA
   tensor, the summary line last with converged_all, d8 seed 24 in phase
   5's iterations); ``long_run`` on maxcut d8 seed 24 killed by SIGKILL once
   its third checkpoint is on disk and run again (it resumes at iteration
   3 and converges; iterations and ranks beside phase 5's, and whether the
   final X is bit-equal to phase 5's), then ``aggregate_grid`` over its
   output; ``scaling_bench`` at d10, B = 1 and 2 (every kernel launched,
   the B = 1 step within STEP_BOUND of the same step made in this
   process).  Printed: each driver's lines and walls.
14. whole: the whole-solve path (``config.set_fused_whole_solve(True)``):
   maxcut d8 seed 24 (phase 5's cell, settings and driver) with the switch
   on (the programs' steps as CUDA graphs, ``solvers/graphs.py``), beside
   phase 5's solve of the cell with the switch off (its kernel checks left
   out of the walls and syncs; solved here if phase 5 ran another cell or
   did not run).  Checked: the
   switch-on solve converged, every sweep solve of four or more sweeps
   through ``solve_program``, every step-size solve through the
   generalised program, captures > 0 and replays > captures, no plain
   version on a CUDA tensor; the first Newton system (nswp = 12, all four
   pairs) and the first pencil give the same bits run eagerly
   (``graphs.eager()``), captured and replayed (the three runs timed);
   then (a job of the workers) corr_clust d6 seed 764 (phase 7's cell)
   with the switch on converged through ``min_eig_program``.  Printed side
   by side: iterations, wall, Newton and step-size solves with their wall
   and host syncs a solve, peak memory, captures, replays and the
   signatures sent to eager runs by step, and the launches by kernel
   (replayed launches included); for both switch-on solves the eigen
   programs' finishing sweeps by direction (``whole_finish``: backward
   after a forward half sweep, forward after a pair that skipped its
   forward half, none after a stall above tol or a zero step) beside the
   iterations, d8's beside phase 5's.  Convergence is required, not an
   iteration count.

The seconds of each phase are printed on a line of their own
(``phase_s``) before the kernels line.

The line before the last is a JSON object with the per-kernel record
(launches on the d8, d10, corr_clust d6 and graphm paths; the f32
instances as entries of their own: ``launches`` those of phase 9's solve,
``launches_capture`` those of its capture run; ``launches_batch`` and
``instances_batch`` those of phase 10's batched step, ``batch`` the timed
row of the kernel's heaviest batched shape, ``launches_mesh`` phase 11's
launches on each rank); J1 and J2 have no float32 instance (f32 factorizations are upcast);
the last line
is {"ok": true, "device": {...}}.  ``--phases`` runs a subset (device and
build always, a chosen worker phase as a worker) and then prints neither;
nor does ``--j1-from N``, which moves J1's regime crossover
(kernels.J1_BLOCK_FROM) for the run, the workers' included.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "schur_assemble": ("ttipm_tpu_torch/csrc/schur_assemble.cu", "ttipm_tpu/ops/kernels.py:132"),
    "kkt_block_matvec": ("ttipm_tpu_torch/csrc/kkt_matvec.cu", "ttipm_tpu/ops/kernels.py:82"),
    "panel_qr": ("ttipm_tpu_torch/csrc/panel_qr.cu", "ttipm_tpu/ops/kernels.py:210"),
    "panel_cholesky": ("ttipm_tpu_torch/csrc/panel_cholesky.cu", "ttipm_tpu/ops/kernels.py:313"),
    # no Pallas kernel: the jnp Jacobi programs the JAX package runs on its accelerator
    "jacobi_svd": ("ttipm_tpu_torch/csrc/jacobi_svd.cu", "ttipm_tpu/ops/jacobi.py:121"),
    "jacobi_eigh": ("ttipm_tpu_torch/csrc/jacobi_eigh.cu", "ttipm_tpu/ops/jacobi.py:370"),
}
# The kernels with a float32 instance (the Jacobi cores take f64 only).
F32_KERNELS = ("schur_assemble", "kkt_block_matvec", "panel_qr", "panel_cholesky")
# The entry point each kernel's phase-3 row is timed through.
MAIN_ENTRY = {"jacobi_svd": "jacobi_orthogonalise", "jacobi_eigh": "jacobi_eigh_core"}
# The Jacobi kernels' launches by regime in phase 5's solve (the kernels line).
SLICE_REGIME_LAUNCHES = {}


def jacobi_regimes(name):
    """The orders each regime of a Jacobi kernel takes (kernels.j1_plan,
    j2_plan) and its launches in phase 5's solve; {} for the others."""
    from ttipm_tpu_torch.ops import kernels as K

    if name not in MAIN_ENTRY:
        return {}
    first, last, element_max = ((K.J1_BLOCK_FROM, K.J1_MAX_N, K.J1_ELEMENT_MAX_N)
                                if name == "jacobi_svd" else (K.J2_BLOCK_FROM, K.J2_MAX_N, K.J2_MAX_N))
    first = min(first, element_max + 2)
    return {"regimes": {"element": [2, first - 2], "block": [first, last]},
            "launches_by_regime": SLICE_REGIME_LAUNCHES.get(name)}


# Peak rates of the roofline bounds (NVIDIA H100 SXM data sheet): device
# memory, float64 through the tensor cores, and float32 on the SIMT cores
# (the f32 instances use no tensor core: TF32 is ruled out).
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float64": 67e12, "float32": 67e12}


# Orders at which K4 is timed against torch.linalg.cholesky_ex: the d8
# solve's common orders, the resident bound 512 and one past it, and the
# blocked regime up to 4 * 36^2.
K4_ORDERS = (16, 64, 144, 256, 400, 512, 513, 1024, 4096, 5184)

# Panels at which K3 is timed against torch.linalg.qr: the largest a cluster
# of CTAs factors (the envelope) and a tall one CTA holds, the (4R, R + 2)
# of bond ranks 36, 32, 16 and 8, and the d8 solve's smallest and largest
# (the last is the one the kernels line reports).
K3_PANELS = ((512, 128), (512, 32), (144, 36), (128, 34), (64, 18), (32, 10), (24, 6), (40, 10))

# Orders at which J1 is timed against torch.linalg.svd (the r2^T of the
# solves' SVDs: 8 x 4, 64 x 6, 32 x 16, 192 x 42 of maxcut d8, 80 x 60 of
# d10; the element regime's bound 118 and J1's 128; the kernels line
# reports the last; at the block regime's orders also the element regime
# forced, to 118) and J2 against
# torch.linalg.eigh (the eigen windows' orders 4, 16, 64, 128 and 256;
# the kernels line reports 256, the d8 solve's largest; 4 and 16 run the
# element regime, 64-256 the block regime).  Batches: phase 10; J2's regime
# and cluster bounds: tests/test_torch_cuda.py.
JACOBI_SVD_ORDERS = (4, 6, 16, 118, 128, 42, 60)
JACOBI_EIGH_ORDERS = (4, 16, 64, 128, 256)


def config_path(dim: int, problem: str = "maxcut") -> str:
    return os.path.join(REPO, "configs", f"{problem}_{dim}.yaml")


def load_config(dim: int, problem: str = "maxcut") -> dict:
    """configs/<problem>_<dim>.yaml, read by the port runner's YAML reader."""
    from ttipm_tpu_torch.utils.runner import load_yaml

    return load_yaml(config_path(dim, problem))


def ipm_settings(cfg: dict) -> dict:
    return dict(
        max_iter=int(cfg.get("max_iter", 22)), gap_tol=float(cfg.get("gap_tol", 3e-4)),
        op_tol=float(cfg.get("op_tol", 1e-4)), abs_tol=float(cfg.get("abs_tol", 1e-3)),
        warm_up=int(cfg.get("warm_up", 3)), aho_direction=False,
        mals_restarts=int(cfg.get("mals_restarts", 2)),
        max_refinement=int(cfg.get("max_refinement", 5)),
        lambdaStar=float(cfg.get("lambdaStar", 1.0)),
    )


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device: {name}", flush=True)
    return name


def phase_build():
    from ttipm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build_library()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({os.path.relpath(path, REPO)})",
          flush=True)


def _times_ms(fn, runs=10, warmup=3):
    """CUDA-event times of single calls (each synchronised), in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def _turns_ms(fns, runs=10, warmup=3):
    """Median ms of each function, timed in turns: the list forward, then
    backward (plain, kernel, kernel, plain), so that drift hits all alike."""
    times = [_times_ms(fn, runs, warmup) for fn in fns]
    for fn, ts in zip(reversed(fns), reversed(times)):
        ts += _times_ms(fn, runs, warmup)
    return [float(np.median(ts)) for ts in times]


def _plain_first_ms(name, fns, runs=10, warmup=3):
    """``_turns_ms`` of ``fns`` (the plain version first), except that the
    plain Jacobi (a Python loop over the steps: seconds a call at order
    256) is timed by one call, after the others' turns."""
    if name not in MAIN_ENTRY.values():
        return _turns_ms(fns, runs, warmup)
    rest = _turns_ms(fns[1:], runs, warmup)
    return [_times_ms(fns[0], runs=1, warmup=0)[0]] + rest


def _tensors(arg):
    import torch

    if isinstance(arg, torch.Tensor):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [t for a in arg for t in _tensors(a)]
    return []


def bound_ms(name, args):
    """Roofline bound of one call of entry point ``name`` on ``args``: the
    larger of its bytes (every distinct input read once, the output
    written once, at the operands' element size) over the device memory
    rate and its operations over the peak of their type; returns (ms,
    "bytes" or "operations")."""
    seen, bytes_in = set(), 0
    tensors = _tensors(args)
    esize = tensors[0].element_size()
    for t in tensors:
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            bytes_in += esize * t.numel()

    def dims(term):
        (l, s, r), (_, m, n, S), (L, _, R) = (tuple(t.shape) for t in term[:3])
        return l, s, r, m, n, S, L, R

    if name in ("kkt_block_matvec", "kkt_block_product"):
        terms, nrows = ([args], 1) if name == "kkt_block_matvec" else args
        l, _, _, m, _, _, L, _ = dims(terms[0])
        bytes_out = esize * l * nrows * m * L
        flops = sum(2 * (l * s * r * n * R + m * S * s * n * l * R + l * m * S * R * L)
                    for l, s, r, m, n, S, L, R in map(dims, terms))
    elif name in ("schur_assemble", "schur_assemble_group"):
        blocks = [args] if name == "schur_assemble" else args[0]
        bytes_out = flops = 0
        for l, s, r, m, n, S, L, R in map(dims, blocks):
            bytes_out += esize * l * m * L * r * n * R
            flops += 2 * l * m * r * n * S * (s + L * R)
    elif name == "panel_qr":
        m, n = args[0].shape
        bytes_out = esize * (m * n + n * n)
        flops = 4 * m * n * n - 4 * n**3 // 3  # Householder R, then Q formed
    elif name == "panel_cholesky":
        n = args[0].shape[0]
        bytes_out = esize * n * n + 4
        flops = n**3 // 3
    elif name in MAIN_ENTRY.values():
        # the sweeps this run's data needs (csrc/jacobi_svd.cu, jacobi_eigh.cu:
        # "Bound"); both regimes of each by the element schedule's work for
        # the sweeps the plain element rule needs on the operand
        from ttipm_tpu_torch.ops import jacobi

        B, n, _ = args[0].shape
        if name == "jacobi_orthogonalise":
            sweeps = int(jacobi.orthogonalise_plain(args[0], sweeps=True)[-1].sum())
            bytes_out = esize * B * (2 * n * n + n)
            flops = sweeps * (9 * n * n * (n - 1) + n**3)
        else:
            sweeps = int(jacobi.eigh_core_plain(args[0], sweeps=True)[-1].sum())
            bytes_out = esize * B * (n * n + n)
            flops = sweeps * (9 * n * n * (n - 1) + 3 * n * n)
    else:
        raise KeyError(name)
    by_bytes = 1e3 * (bytes_in + bytes_out) / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / FLOP_PER_S[str(tensors[0].dtype).split(".")[-1]]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def library_calls():
    """The one PyTorch call that computes the same function as each
    single-call entry point; timed beside the kernels, used nowhere in the
    port."""
    import torch

    return {
        "kkt_block_matvec": lambda pl, A, pr, x: torch.einsum(
            "lsr,smnS,LSR,rnR->lmL", pl, A, pr, x),
        "schur_assemble": lambda pl, A, pr: torch.einsum("lsr,smnS,LSR->lmLrnR", pl, A, pr),
        "panel_qr": lambda a: torch.linalg.qr(a, mode="reduced"),
        "panel_cholesky": torch.linalg.cholesky_ex,
        "jacobi_orthogonalise": lambda w: torch.linalg.svd(w),
        "jacobi_eigh_core": torch.linalg.eigh,
    }


def grouped_operands(t, R, s):
    """Operands of a grouped K2 and a grouped K1 call at bond rank R and
    operator rank about s, as the fused algebra builds them: the (1,0)
    term on flipped interfaces and a transposed core (non-contiguous
    views), x as strided columns of one block core, unequal operator
    ranks within the group."""
    x = t(R, 3, 4, R)
    ranks = {"00": (s, s), "01": (s + 1, s), "12": (1, 1), "21": (s, s + 2), "22": (2, s)}
    op = {k: (t(R, a, R), t(a, 4, 4, b), t(R, b, R)) for k, (a, b) in ranks.items()}
    pl, A, pr = op["01"]
    t10 = (pl.permute(2, 1, 0), A.transpose(1, 2), pr.permute(2, 1, 0))
    terms = [(*op["00"], x[:, 0], 0), (*op["01"], x[:, 1], 0), (*t10, x[:, 0], 1),
             (*op["12"], x[:, 2], 1), (*op["21"], x[:, 1], 2), (*op["22"], x[:, 2], 2)]
    blocks = [op["21"], t10, op["22"], op["00"]]
    return terms, blocks


def phase_kernels():
    """Every entry point against its plain version on the card; returns per
    kernel the max_abs_err over all shapes and, at the largest shape of its
    single-call entry, ms, plain_ms, library_ms and the roofline bound."""
    import torch

    from ttipm_tpu_torch.checks import KERNEL_OF, PLAIN, check_kernel, shape_key
    from ttipm_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    library = library_calls()
    summary = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), device=dev)

    floor = float(np.median(_times_ms(lambda: K.empty_launch(dev), runs=50)))
    print(json.dumps({"empty_launch_ms": floor}), flush=True)

    def run(name, *args, **kw):
        fn, plain, lib = getattr(K, name), PLAIN[name], library.get(name)
        out = fn(*args, **kw)
        if kw.get("transposed"):  # K3 handing back q^T: hold q to the contract
            if tuple(out[0].shape) != args[0].shape[::-1] or not out[0].is_contiguous():
                raise AssertionError(f"{name}: transposed output of shape {out[0].shape}")
            out = (out[0].T, out[1])
        errs = check_kernel(name, args, out)
        s = summary[KERNEL_OF[name]]
        s["max_abs_err"] = max(s["max_abs_err"], errs.get("max_abs_err", 0.0))
        fns = [lambda: plain(*args), lambda: fn(*args, **kw)]
        if lib is not None:
            fns.insert(1, lambda: lib(*args))
        ms = _plain_first_ms(name, fns)
        row = {"ms": ms[-1], "plain_ms": ms[0], "library_ms": ms[1] if lib else None}
        row["bound_ms"], row["bound_by"] = bound_ms(name, args)
        if name in KERNELS or name in MAIN_ENTRY.values():
            s.update(row)
        print(json.dumps({"kernel": name, "shape": shape_key(args), **kw, **errs, **row,
                          "ratio": row["ms"] / row["plain_ms"]}), flush=True)

    for R in (8, 16, 32):
        for s in (1, 4, 9):
            pl, A, pr, x = t(R, s, R), t(s, 4, 4, s), t(R, s, R), t(R, 4, R)
            run("kkt_block_matvec", pl, A, pr, x)
            run("schur_assemble", pl, A, pr)
            terms, blocks = grouped_operands(t, R, s)
            run("kkt_block_product", terms, 3)
            run("schur_assemble_group", blocks)
    run("panel_qr", t(34, 128).T)                     # a non-contiguous operand
    run("panel_qr", t(128, 34), transposed=True)      # q^T as the backward split takes it
    for m, n in K3_PANELS:
        run("panel_qr", t(m, n))
    for n in K4_ORDERS:
        Bm = t(n, n)
        S = Bm @ Bm.T + n * torch.eye(n, dtype=Bm.dtype, device=dev)
        run("panel_cholesky", S)
    S[n // 3, n // 3] = -1.0
    errs = check_kernel("panel_cholesky", (S,), K.panel_cholesky(S))
    if errs["info"] == 0:
        raise AssertionError(f"panel_cholesky: indefinite n={n} reported as SPD")
    print(json.dumps({"kernel": "panel_cholesky", "indefinite_n": n, **errs}), flush=True)
    for n in JACOBI_SVD_ORDERS:  # one instance, as the single solve's calls
        x = jacobi_operand("jacobi_orthogonalise", 1, n, rng, dev)
        run("jacobi_orthogonalise", x)
        j1_regimes("phase 3", x)
    for n in JACOBI_EIGH_ORDERS:
        x = jacobi_operand("jacobi_eigh_core", 1, n, rng, dev)
        run("jacobi_eigh_core", x)
        out = K.jacobi_eigh_core(x, vectors=False)  # eigvalsh: the values alone, the same bits
        errs = check_kernel("jacobi_eigh_core", (x,), out)
        if not torch.equal(out[0], K.jacobi_eigh_core(x)[0]):
            raise AssertionError(f"jacobi_eigh_core n={n}: the values alone differ from eigh's")
        print(json.dumps({"kernel": "jacobi_eigh_core", "shape": shape_key((x,)),
                          "vectors": False, "plan": list(K.j2_plan(n)), **errs}), flush=True)
    return summary


def j1_regimes(label, x, runs=10):
    """J1 at the block regime's orders (to the element regime's bound):
    the element regime forced on the same operand, held to the plain
    version's invariants and timed in turns with the order's own regime and
    torch.linalg.svd; printed as one line (nothing at the element regime's
    orders).  Returns the element regime's ms, or None."""
    import torch

    from ttipm_tpu_torch.checks import check_kernel, shape_key
    from ttipm_tpu_torch.ops import kernels as K

    n = x.shape[-1]
    plan = K.j1_plan(n)
    if not plan[0] or n > K.J1_ELEMENT_MAX_N:
        return None
    element = K.j1_plan(n, element=True)
    errs = check_kernel("jacobi_orthogonalise", (x,), K._j1_launch(x, plan=element))
    lib, element_ms, ms = _turns_ms([lambda: torch.linalg.svd(x),
                                     lambda: K._j1_launch(x, plan=element),
                                     lambda: K._j1_launch(x)], runs=runs, warmup=2)
    print(json.dumps({"j1_regimes": label, "shape": shape_key((x,)), "plan": list(plan),
                      "ms": ms, "element_ms": element_ms, "library_ms": lib,
                      "element_errors": errs}), flush=True)
    return element_ms


def jacobi_operand(entry, B, n, rng, dev):
    """B operands of order n as the pipelines hand them to J1 (the r2^T of a
    tall matrix with singular values from 1 down to 1e-12, r^T = q2 r2) or J2 (a
    symmetric pencil scaled to max |a| = 1 with a cluster of small
    eigenvalues)."""
    import torch

    out = []
    for _ in range(B):
        q, _ = np.linalg.qr(rng.randn(2 * n, n))
        p, _ = np.linalg.qr(rng.randn(n, n))
        if entry == "jacobi_orthogonalise":
            a = (q * np.logspace(0, -12, n)) @ p.T
            x = np.linalg.qr(np.linalg.qr(a / np.abs(a).max())[1].T)[1].T
        else:
            spec = np.r_[np.linspace(-1, 4, n - n // 4), 1e-6 * rng.randn(n // 4)]
            x = (p * spec) @ p.T
            x = 0.5 * (x + x.T) / np.abs(x).max()
        out.append(x)
    return torch.as_tensor(np.stack(out), device=dev).contiguous()


def solve(dim, seed, device, settings, keep=None):
    import torch

    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import tt as T

    rng = np.random.RandomState(seed)
    obj, L, b, lag = create_problem(dim, 1, device=device, rng=rng)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, Y, _, Z, info = tt_ipm({"y": T.tt_reshape(lag, (4, 4))}, obj, L, b, rng=rng, **settings)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for c in X + Y + Z:
        if not bool(torch.isfinite(c).all()):
            raise AssertionError(f"d{dim}: non-finite iterate")
    if len(X) != dim or any(tuple(c.shape[1:3]) != (2, 2) for c in X + Z):
        raise AssertionError(f"d{dim}: unexpected iterate cores")
    slack, primal, dual = solve_metrics(X, Y, Z, obj, L, b)
    if keep is not None:
        keep["X"] = X
    return {
        "dim": dim, "seed": seed, "device": device.type, "iters": info["num_iters"],
        "slack": slack, "primal_feas": primal, "dual_feas": dual,
        "cx": T.tt_inner_prod(T.tt_reshape(obj, (2, 2)), X),
        "ranksX": info["ranksX"], "ranksZ": info["ranksZ"], "wall_s": wall,
    }


def phase_parity():
    import torch

    settings = ipm_settings(load_config(3))
    cpu = solve(3, 319, torch.device("cpu"), settings)
    gpu = solve(3, 319, torch.device("cuda"), settings)
    print(json.dumps({"parity": [cpu, gpu]}), flush=True)
    if cpu["iters"] != gpu["iters"]:
        raise AssertionError(f"d3 iterations differ: cpu {cpu['iters']} cuda {gpu['iters']}")
    if abs(gpu["cx"] - cpu["cx"]) > 1e-6 * abs(cpu["cx"]):
        raise AssertionError(f"d3 <C,X> differ: cpu {cpu['cx']} cuda {gpu['cx']}")


def report_checks(label, checked, where):
    """Print the worst error of each kernel's checks ({kernel: {shape:
    errors}}) on one line, and raise if a check was outside tolerance."""
    worst = {}
    for name, by_shape in checked.items():
        w = {"shapes": len(by_shape)}
        for errs in by_shape.values():
            for k, v in errs.items():
                if k in ("rel", "rel_terms", "rel_f64", "fact", "orth", "below_diagonal",
                         "max_abs_err"):
                    w[k] = max(w.get(k, 0.0), v)
        w["failed_info"] = sum(1 for e in by_shape.values() if e.get("info", 0) != 0)
        w["nonfinite_operands"] = sum(1 for e in by_shape.values() if e.get("nonfinite"))
        worst[name] = w
    print(json.dumps({label: worst}), flush=True)
    bad = [(name, key, errs) for name, by_shape in checked.items()
           for key, errs in by_shape.items() if not errs["ok"]]
    if bad:
        raise AssertionError(f"kernels outside tolerance on {where}: {bad[:8]}")


def phase_slice(dim, seed):
    """The solve on the card.  On the first call of each distinct operand
    shape, each entry point's output is also held against its plain version
    (called directly, so the counters do not move; K1/K2 errors relative to
    the scale of their terms, since the solver's operands cancel, see
    ttipm_tpu_torch.checks); the seconds these checks take are reported
    apart from the solve's wall.  The solve runs inside a ``LayerProbe``
    (the checks excluded), whose record phase 14 takes as the switch-off
    run of its cell.  Returns (per kernel (launches, plain calls, launches
    through the grouped entry), the iterations, the final X, the probe's
    record)."""
    import torch

    from ttipm_tpu_torch.checks import KERNEL_OF, kernel_errors, shape_key
    from ttipm_tpu_torch.ops import kernels as K

    cfg = load_config(dim)
    settings = ipm_settings(cfg)
    shapes = {name: Counter() for name in KERNEL_OF}
    checked = {name: {} for name in KERNEL_OF}
    first = {name: {} for name in KERNEL_OF}  # first operands of each shape, timed later
    check_s = [0.0]
    originals = {name: getattr(K, name) for name in KERNEL_OF}

    def recorder(name):
        fn = originals[name]

        def wrapped(*args, **kw):
            key = shape_key(args) + (f" {kw}" if kw else "")
            shapes[name][key] += 1
            out = fn(*args, **kw)
            if key not in checked[name]:
                with probe.excluded():
                    t0 = time.perf_counter()
                    held = (out[0].T, out[1]) if kw.get("transposed") else out
                    checked[name][key] = kernel_errors(name, args, held, cancelling=True)
                    first[name][key] = ((args[0].clone(),) if name == "panel_cholesky" else args,
                                        kw)
                    check_s[0] += time.perf_counter() - t0
            return out
        return wrapped

    for name in KERNEL_OF:
        setattr(K, name, recorder(name))
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    kept = {}
    probe = LayerProbe()
    try:
        with probe:
            res = solve(dim, seed, torch.device("cuda"), settings, keep=kept)
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)
    layers = {"problem": "maxcut", "dim": dim, "seed": seed, "whole": False,
              **probe.record(res, res["wall_s"])}
    counts = {name: (s.launches, s.plain_calls, s.grouped) for name, s in K.STATS.items()}
    res["outside"] = {name: s.outside for name, s in K.STATS.items()}
    SLICE_REGIME_LAUNCHES.update({name: dict(K.STATS[name].by_regime) for name in MAIN_ENTRY})
    res["launches_by_regime"] = SLICE_REGIME_LAUNCHES
    res["check_s"] = check_s[0]
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["counts"] = {n: {"launches": c[0], "plain_calls": c[1], "grouped": c[2]}
                     for n, c in counts.items()}
    res["entry_calls"] = {n: sum(c.values()) for n, c in shapes.items()}
    print(json.dumps({"slice": res}), flush=True)
    print(json.dumps({"slice_layers": layers}), flush=True)
    print(json.dumps({"shape_histogram": {n: c.most_common(6) for n, c in shapes.items()}}),
          flush=True)
    report_checks("slice_checks", checked, "the slice's shapes")
    phase_slice_times("slice_k12_times", shapes, first,
                      ("kkt_block_product", "kkt_block_matvec", "schur_assemble_group",
                       "schur_assemble"))
    phase_slice_times("slice_k3_times", shapes, first, ("panel_qr",))
    phase_slice_times("slice_k4_times", shapes, first, ("panel_cholesky",))
    phase_slice_jacobi_times(shapes, first)
    abs_tol = settings["abs_tol"]
    if not (res["slack"] < abs_tol and res["primal_feas"] < abs_tol
            and res["dual_feas"] < abs_tol):
        raise AssertionError(f"d{dim} seed {seed} did not converge: {res}")
    for name, (launches, plain, grouped) in counts.items():
        if launches <= 0:
            raise AssertionError(f"{name}: not launched on the main path")
        if plain != 0:
            raise AssertionError(f"{name}: plain version ran {plain} times on CUDA tensors")
        if name in ("schur_assemble", "kkt_block_matvec") and grouped <= 0:
            raise AssertionError(f"{name}: its grouped entry was not launched on the main path")
    return counts, res["iters"], kept["X"], layers


def phase_slice_times(label, shapes, first, names):
    """The entry points ``names`` and their plain versions (einsum,
    linalg.qr, cholesky_ex, the plain Jacobi) timed on the first operands of each of their shapes in the
    solve; the totals weight each shape by its call count (the time the
    solve would spend in single calls of either)."""
    from ttipm_tpu_torch.checks import PLAIN
    from ttipm_tpu_torch.ops import kernels as K

    report = {}
    for name in names:
        fn, plain = getattr(K, name), PLAIN[name]
        rows, total, plain_total = [], 0.0, 0.0
        for key, (args, kw) in first[name].items():
            plain_ms, ms = _turns_ms([lambda: plain(*args), lambda: fn(*args, **kw)], runs=3,
                                     warmup=1)
            count = shapes[name][key]
            rows.append({"shape": key, "count": count, "ms": ms, "plain_ms": plain_ms})
            total += count * ms
            plain_total += count * plain_ms
        rows.sort(key=lambda r: -r["count"] * r["ms"])
        report[name] = {"distinct_shapes": len(rows), "calls": sum(r["count"] for r in rows),
                        "weighted_ms": total, "plain_weighted_ms": plain_total,
                        "ratio": total / plain_total if plain_total else None,
                        "heaviest_shapes": rows[:4]}
    print(json.dumps({label: report}), flush=True)


def phase_slice_jacobi_times(shapes, first):
    """J1 and J2 and the library call on the same operand (torch.linalg.svd,
    eigh or eigvalsh: cuSOLVER) timed on the first operands of each of their
    shapes in the solve, weighted by the solve's calls (the plain versions
    are timed in phase 3: a Python loop over the steps, seconds a call).
    J1's and J2's rows also time the element regime on the same operand
    where the order takes the block regime (``element_ms``: the kernel each
    was before its block regime), and name the regime (``plan``); J1's are
    also given by order (``by_order``: calls, ms, library ms and regime of
    every order the solve factored)."""
    import torch

    from ttipm_tpu_torch.ops import kernels as K

    library = library_calls()
    report = {}
    for name in ("jacobi_orthogonalise", "jacobi_eigh_core"):
        fn = getattr(K, name)
        rows, total, lib_total, element_total = [], 0.0, 0.0, 0.0
        for key, (args, kw) in first[name].items():
            lib = library[name]
            if kw.get("vectors") is False:
                lib = torch.linalg.eigvalsh
            fns = [lambda: lib(*args), lambda: fn(*args, **kw)]
            n = args[0].shape[-1]
            if name == "jacobi_eigh_core":
                plan = K.j2_plan(n)
                element = K.j2_plan(n, element=True)
                launch = functools.partial(K._j2_launch, vectors=kw.get("vectors", True))
            else:
                plan = K.j1_plan(n)
                element = K.j1_plan(n, element=True) if n <= K.J1_ELEMENT_MAX_N else None
                launch = K._j1_launch
            if plan[0] and element is not None:
                fns.insert(1, lambda: launch(args[0], plan=element))
            ms = _turns_ms(fns, runs=3, warmup=1)
            count = shapes[name][key]
            row = {"shape": key, "count": count, "ms": ms[-1], "library_ms": ms[0],
                   "plan": list(plan), "element_ms": ms[1] if len(ms) == 3 else
                   (ms[-1] if not plan[0] else None)}
            element_total += count * (row["element_ms"] or 0.0)
            rows.append(row)
            total += count * ms[-1]
            lib_total += count * ms[0]
        rows.sort(key=lambda r: -r["count"] * r["ms"])
        report[name] = {"distinct_shapes": len(rows), "calls": sum(r["count"] for r in rows),
                        "weighted_ms": total, "library_weighted_ms": lib_total,
                        "element_weighted_ms": element_total, "heaviest_shapes": rows[:6]}
        if name == "jacobi_orthogonalise":
            by_order = {}
            for r in rows:
                order = by_order.setdefault(int(r["shape"].split(",")[-1].strip(" ]")),
                                            {"calls": 0, "ms": 0.0, "library_ms": 0.0})
                order["calls"] += r["count"]
                order["ms"] += r["count"] * r["ms"]
                order["library_ms"] += r["count"] * r["library_ms"]
                order["regime"] = "block" if r["plan"][0] else "element"
            report[name]["by_order"] = dict(sorted(by_order.items()))
    print(json.dumps({"slice_jacobi_times": report}), flush=True)


# The fallback cell (maxcut d10 seed 41) and the JAX package's run of it on
# the CPU (BENCH_r05.json): converged in 11 iterations, 410.6 s.
FALLBACK_CELL = ("maxcut", 10, 41)
JAX_CPU_D10 = {"iters": 11, "wall_s": 410.6, "source": "BENCH_r05.json (CPU run)"}
# The inequality cell (corr_clust d6 seed 764, the first seed of
# configs/corr_clust_6.yaml) and the JAX package's run of it on the CPU.
INEQ_CELL = ("corr_clust", 6, 764)
JAX_CPU_CC6 = {"iters": 11, "wall_s": 110.9, "slack": 4.175e-05,
               "ranksX": [5, 13, 9, 5, 3], "ranksT": [5, 5, 3, 3, 3],
               "source": "results/grid_r5_clean/grid_log.jsonl (CPU run)"}
# A corr_clust solve whose fused ladder is made to exhaust at every Newton
# step, so that the ragged inequality local solver runs on the card.
EXHAUST_CELL = ("corr_clust", 3, 291)
FALLBACK_CHECKS = 48  # kernel checks per kernel in phases 6 and 7


def shape_spec(arg):
    """The nested shapes of an entry point's arguments, hashable (a tensor
    becomes "T", its type and its shape; other values stay)."""
    import torch

    if isinstance(arg, torch.Tensor):
        return ("T", str(arg.dtype).split(".")[-1]) + tuple(arg.shape)
    if isinstance(arg, (list, tuple)):
        return tuple(shape_spec(a) for a in arg)
    return arg


def random_operands(name, spec, rng, dev):
    """Random operands of the shapes and types ``spec`` (an SPD matrix for
    K4)."""
    import torch

    def build(sp):
        if isinstance(sp, tuple) and sp[:1] == ("T",):
            return torch.as_tensor(rng.randn(*sp[2:]), device=dev).to(getattr(torch, sp[1]))
        if isinstance(sp, tuple):
            return type(sp)(build(x) for x in sp)
        return sp

    args = build(spec)
    if name == "panel_cholesky":
        n = args[0].shape[0]
        args = (args[0] @ args[0].T + n * torch.eye(n, dtype=args[0].dtype, device=dev),)
    if name == "jacobi_eigh_core":
        args = (0.5 * (args[0] + args[0].mT),)
    if name in ("schur_assemble_group", "kkt_block_product"):
        args = (list(args[0]),) + tuple(args[1:])
    return args


def drive(problem, dim, seed, label, jax_cpu=None, exhaust=False, must_launch=tuple(KERNELS),
          settings=None, ipm_kw=None, keep=None):
    """<problem> d<dim> seed <seed> through the runner's ``run_and_record``
    with configs/<problem>_<dim>.yaml's settings (quiet; ``settings``
    replaces some of them), on the card, ``tt_ipm`` also given ``ipm_kw``
    (its final iterates X, Y, T, Z go to ``keep["iterates"]``).  The
    fused ladder, the ragged AMEn, the fused generalised eigensolver and the
    fused smallest-eigenvector sweep (the inequality step sizes) are timed
    (synchronised) and counted, and so are the ragged local KKT solves;
    host syncs are counted by the file that made them
    (``torch.cuda.set_sync_debug_mode``).  With ``exhaust`` the fused ladder
    raises AmenRestartsExhausted at once, so every Newton solve takes the
    ragged AMEn.  Each kernel is held to phase 3's tolerances (those of
    its operands' type) on the first call of a shape, for the first 46
    distinct shapes of a kernel and type and, at the end, for the largest
    shape of each entry point if it was not among them; the seconds of
    these checks are reported apart.  Prints one JSON line under ``label``;
    raises unless the solve converged, each kernel of ``must_launch``
    launched and no plain version ran on a CUDA tensor.  Returns (result,
    per kernel (launches, plain calls, grouped launches, launches by
    dtype), the call record for ``solve_times``)."""
    import argparse
    import warnings

    import torch

    import ttipm_tpu_torch.ipm as ipm
    from ttipm_tpu_torch.checks import KERNEL_OF, kernel_errors, shape_key
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.solvers.amen import AmenRestartsExhausted
    from ttipm_tpu_torch.utils import runner

    config = load_config(dim, problem)
    config.update(settings or {}, verbose=False)
    args = argparse.Namespace(device="cuda", track_mem=True, rank=1,
                              config=config_path(dim, problem))
    rec = runner.new_record(1, runner.bond_count(problem, dim))
    first_checks = FALLBACK_CHECKS - 2  # two kernels have two entry points

    layer = [None]
    layers = {k: {"calls": 0, "s": 0.0, "check_s": 0.0}
              for k in ("fused", "ragged", "eigen", "min_eig")}
    exhausted = [0]
    local = Counter()   # ragged local KKT solves: (solver, dense) -> count
    local_largest = {}  # solver -> shape of its largest local unknown
    info = {}
    calls = {}          # (layer, name, spec) -> count
    bounds = {}         # (name, spec) -> bound_ms of its first call
    largest = {}        # name -> (size, spec, args, kw) of its largest call
    products, groups = Counter(), Counter()  # K2 (terms, rows), K1 blocks per launch
    checked = {name: {} for name in K.STATS}
    checks_by_dtype = Counter()  # (kernel, dtype) -> shapes checked
    check_s = [0.0]
    originals = {name: getattr(K, name) for name in KERNEL_OF}
    solvers = {"fused": "tt_restarted_block_amen_fused", "ragged": "tt_restarted_block_amen",
               "eigen": "tt_max_generalised_eigen_fused", "min_eig": "tt_min_eig_fused"}
    solver_fns = {k: getattr(ipm, v) for k, v in solvers.items()}
    saved = {name: getattr(ipm, name)
             for name in ("tt_ipm", "ipm_local_solver", "ipm_local_solver_ineq")}

    def check(name, spec, a, kw, out):
        t0 = time.perf_counter()
        held = (out[0].T, out[1]) if kw.get("transposed") else out
        checked[KERNEL_OF[name]][(name, spec)] = kernel_errors(name, a, held, cancelling=True)
        dt = time.perf_counter() - t0
        check_s[0] += dt
        if layer[0]:
            layers[layer[0]]["check_s"] += dt

    def recorder(name):
        fn = originals[name]

        def wrapped(*a, **kw):
            spec = shape_spec(a) + (tuple(sorted(kw.items())),)
            key = (layer[0], name, spec)
            calls[key] = calls.get(key, 0) + 1
            if name == "kkt_block_product":
                products[(len(a[0]), a[1])] += 1
            elif name == "schur_assemble_group":
                groups[len(a[0])] += 1
            out = fn(*a, **kw)
            if (name, spec) not in bounds:
                size = bounds[(name, spec)] = bound_ms(name, a)[0]
                if name not in largest or size > largest[name][0]:
                    kept = (a[0].clone(),) if name == "panel_cholesky" else a
                    largest[name] = (size, spec, kept, kw)
                budget = (KERNEL_OF[name], _tensors(a)[0].dtype)
                if checks_by_dtype[budget] < first_checks:
                    checks_by_dtype[budget] += 1
                    check(name, spec, a, kw, out)
            return out
        return wrapped

    def exhausted_ladder(*a, **kw):
        raise AmenRestartsExhausted("fused ladder skipped (forced exhaustion)")

    def timed(kind):
        fn = exhausted_ladder if exhaust and kind == "fused" else solver_fns[kind]

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            outer, layer[0] = layer[0], kind
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            except AmenRestartsExhausted:
                if kind == "fused":
                    exhausted[0] += 1
                raise
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                layers[kind]["calls"] += 1
                layers[kind]["s"] += dt
                layer[0] = outer
                if kind in ("fused", "ragged"):
                    print(json.dumps({f"{label}_solve": kind, "s": dt}), file=sys.stderr,
                          flush=True)
        return wrapped

    def counted(name):
        fn = saved[name]

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            local[(name, not out[-1])] += 1  # out[-1]: the direct solve failed or was not tried
            if a[6].numel() > int(np.prod(local_largest.get(name, [0]))):
                local_largest[name] = list(a[6].shape)  # (r, blocks, n, R)
            return out
        return wrapped

    def kept_info(*a, **kw):
        out = saved["tt_ipm"](*a, **kw, **(ipm_kw or {}))
        info.update(out[-1])
        if keep is not None:
            keep["iterates"] = out[:4]
        return out

    for name in KERNEL_OF:
        setattr(K, name, recorder(name))
    for kind, attr in solvers.items():
        setattr(ipm, attr, timed(kind))
    ipm.tt_ipm = kept_info
    for name in ("ipm_local_solver", "ipm_local_solver_ineq"):
        setattr(ipm, name, counted(name))
    K.reset_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                runner.run_and_record(seed, 0, 1, config, args,
                                      runner.load_problem(problem), rec)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)
        for kind, attr in solvers.items():
            setattr(ipm, attr, solver_fns[kind])
        for name, fn in saved.items():
            setattr(ipm, name, fn)
    counts = {name: (s.launches, s.plain_calls, s.grouped, dict(s.by_dtype))
              for name, s in K.STATS.items()}
    outside = {name: s.outside for name, s in K.STATS.items()}
    syncs = Counter(os.path.relpath(w.filename, REPO) for w in caught
                    if "synchroniz" in str(w.message))
    solve_syncs = {f: c for f, c in syncs.items()
                   if f.startswith("ttipm_tpu_torch") and not f.endswith("checks.py")}
    for name, (_, spec, a, kw) in largest.items():
        if (name, spec) not in checked[KERNEL_OF[name]]:
            check(name, spec, a, kw, getattr(K, name)(*a, **kw))

    status = info["status"]
    res = {
        "problem": problem, "dim": dim, "seed": seed, "iters": int(rec["num_iters"][0]),
        "slack": float(rec["complementary_slackness"][0]),
        "primal_feas": float(rec["feasibility_errors"][0]),
        "dual_feas": float(rec["dual_feasibility_errors"][0]),
        "ineq_status": status.ineq_status.name,
        "ranksX": info["ranksX"], "ranksY": info["ranksY"], "ranksZ": info["ranksZ"],
        "ranksT": info["ranksT"],
        "wall_s": float(rec["runtimes"][0]), "check_s": check_s[0],
        "wall_less_checks_s": float(rec["runtimes"][0]) - check_s[0],
        "jax_cpu": jax_cpu,
        "solves": {k: v["calls"] for k, v in layers.items()},
        "fused_exhausted": exhausted[0],
        "local_solves": {f"{n}{'_dense' if d else '_lgmres'}": c for (n, d), c in local.items()},
        "largest_local": local_largest,
        "layer_s_less_checks": {k: v["s"] - v["check_s"] for k, v in layers.items()},
        "host_syncs": sum(solve_syncs.values()),
        "host_syncs_by_file": dict(sorted(solve_syncs.items(), key=lambda kv: -kv[1])),
        "max_memory_allocated": int(rec["memory"][0] * 1e6),
        "counts": {n: {"launches": c[0], "plain_calls": c[1], "grouped": c[2],
                       "by_dtype": c[3]} for n, c in counts.items()},
        "outside": outside,
        "entry_calls": {n: sum(c for (_, nm, _), c in calls.items() if nm == n)
                        for n in KERNEL_OF},
        "k2_products_by_terms_rows": {f"{t}x{r}": c for (t, r), c in sorted(products.items())},
        "k1_groups_by_blocks": {str(b): c for b, c in sorted(groups.items())},
        "largest": {n: shape_key(v[2]) for n, v in largest.items()},
        "max_abs_err_f32": {n: max([e.get("max_abs_err", 0.0) for (_, sp), e in by.items()
                                    if "float32" in str(sp)], default=0.0)
                            for n, by in checked.items()},
    }
    print(json.dumps({label: res}), flush=True)
    report_checks(f"{label}_checks", checked, f"the {problem} d{dim} shapes")
    abs_tol = float(config["abs_tol"])
    if not (res["slack"] < abs_tol and res["primal_feas"] < abs_tol
            and res["dual_feas"] < abs_tol):
        raise AssertionError(f"{problem} d{dim} seed {seed} did not converge: {res}")
    for name, (launches, plain, _, _) in counts.items():
        if launches <= 0 and name in must_launch:
            raise AssertionError(f"{name}: not launched in the {problem} d{dim} solve")
        if plain != 0:
            raise AssertionError(f"{name}: plain version ran {plain} times on CUDA tensors")
    return res, counts, (calls, bounds, largest)


def portable_record(record):
    """``drive``'s call record without its kept operands (``solve_times``
    times random operands of the recorded shapes), for a worker's result."""
    calls, bounds, largest = record
    return calls, bounds, {n: (size, spec, None, kw) for n, (size, spec, _, kw) in largest.items()}


def phase_fallback(problem, dim, seed):
    """Phase 6 (a worker): the fused ladder, the ragged AMEn where the
    ladder exhausts its restarts (at least one solve), the fused
    eigensolver.  Returns the counts, the final X (on the CPU) and the call
    record, which the parent times at the solve's heaviest shapes
    (``fallback_time``) once the workers have joined."""
    kept = {}
    res, counts, record = drive(problem, dim, seed, "fallback", JAX_CPU_D10, keep=kept)
    if res["solves"]["ragged"] < 1:
        raise AssertionError(f"d{dim} seed {seed}: no Newton solve went through the ragged AMEn")
    return {"counts": counts, "X": [c.cpu() for c in kept["iterates"][0]],
            "record": portable_record(record), "times": ("fallback_time", (), "heaviest_ineq")}


def phase_ineq(problem, dim, seed):
    """Phase 7 (a worker): the inequality path.  Converged, the
    inequalities in use at some point (ineq_status left NOT_IN_USE), at
    least one nine-term K2 product and one six-block K1 group; the parent
    times the solve's heaviest shapes and its heaviest nine-term product,
    six-block group and ragged L_Z.  If no ragged inequality local solve
    ran, a forced-exhaustion solve of EXHAUST_CELL runs them on the card."""
    res, counts, record = drive(problem, dim, seed, "ineq", JAX_CPU_CC6)
    if res["ineq_status"] == "NOT_IN_USE":
        raise AssertionError(f"{problem} d{dim} seed {seed}: the inequalities were never used")
    if not res["k2_products_by_terms_rows"].get("9x4"):
        raise AssertionError("no nine-term K2 product ran")
    if not res["k1_groups_by_blocks"].get("6"):
        raise AssertionError("no six-block K1 group ran")
    extra = (heaviest(record, "kkt_block_product", lambda lay, sp: len(sp[0]) == 9)
             + heaviest(record, "schur_assemble_group", lambda lay, sp: len(sp[0]) == 6)
             + heaviest(record, "panel_cholesky", lambda lay, sp: lay == "ragged"))
    if not any(k.startswith("ipm_local_solver_ineq") for k in res["local_solves"]):
        # no fused ladder there, so no K3 (its split steps)
        ex, _, _ = drive(*EXHAUST_CELL, "ineq_exhausted", exhaust=True,
                         must_launch=("schur_assemble", "kkt_block_matvec", "panel_cholesky"))
        if not any(k.startswith("ipm_local_solver_ineq") for k in ex["local_solves"]):
            raise AssertionError("the ragged inequality local solver did not run")
    return {"counts": counts, "record": portable_record(record),
            "times": ("ineq_time", extra, "heaviest_ineq")}


def heaviest(record, name, pred):
    """[(name, spec)] of the entry point's shape with the most calls times
    bound among the calls (layer, spec) that ``pred`` admits."""
    calls, bounds = record[0], record[1]
    items = Counter()
    for (lay, nm, spec), c in calls.items():
        if nm == name and pred(lay, spec):
            items[spec] += c * bounds[(nm, spec)]
    return [(name, spec) for spec, _ in items.most_common(1)]


# The graphm cell (graphm n=2 seed 256) and the JAX package's run of it on
# the CPU (BASELINE.md, round 1).  At configs/graphm_2.yaml's settings
# neither package reaches abs_tol on this seed (both end at slackness
# 1.54e-3); the phase takes the two settings of the JAX package's own
# graphm test (tests/test_ipm_e2e.py:206) that differ from the config's.
GRAPHM_CELL = ("graphm", 2, 256)
JAX_CPU_GM2 = {"iters": 8, "wall_s": 1048.6, "slack": 2.0e-4,
               "source": "BASELINE.md:65 (CPU run, round 1)"}
GRAPHM_SETTINGS = {"lambdaStar": 2.0, "max_refinement": 10}


def phase_graphm(problem, dim, seed):
    """Phase 8 (a worker): graphm through the ragged inequality path, with
    a checkpoint written every iteration and read back onto the card
    against the final iterates; the parent times the solve's heaviest
    shapes."""
    import torch

    from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint

    keep = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graphm.npz")
        res, counts, record = drive(problem, dim, seed, "graphm", JAX_CPU_GM2,
                                    settings=GRAPHM_SETTINGS,
                                    ipm_kw={"checkpoint_path": path, "checkpoint_every": 1},
                                    keep=keep)
        state = load_ipm_checkpoint(path, device="cuda")
    X, Y, T, Z = keep["iterates"]
    same = {name: (state[name] is None and train is None) or (
        len(state[name]) == len(train)
        and all(torch.equal(a, b) for a, b in zip(state[name], train)))
        for name, train in zip("XYZT", (X, Y, Z, T))}
    print(json.dumps({"graphm_checkpoint": {"iteration": state["iteration"],
                                            "iterates_equal": same,
                                            "scalars": state["scalars"]}}), flush=True)
    if not all(same.values()) or state["iteration"] != res["iters"]:
        raise AssertionError(f"graphm: the last checkpoint is not the final iterates: {same}")
    if res["ineq_status"] == "NOT_IN_USE":
        raise AssertionError(f"{problem} n={dim} seed {seed}: the inequalities were never used")
    extra = (heaviest(record, "kkt_block_product", lambda lay, sp: lay == "ragged")
             + heaviest(record, "schur_assemble_group", lambda lay, sp: len(sp[0]) == 6)
             + heaviest(record, "panel_cholesky", lambda lay, sp: lay == "fused")
             + heaviest(record, "panel_cholesky", lambda lay, sp: lay == "ragged"))
    return {"counts": counts, "record": portable_record(record),
            "times": ("graphm_time", extra, "heaviest")}


def timed_heaviest(out):
    """The parent's part of phases 6-8: ``solve_times`` on a worker's
    record, alone on the card."""
    label, extra, tag = out["times"]
    return solve_times(label, *out["record"], extra=extra, tag=tag)


def solve_times(label, calls, bounds, largest, extra=(), tag="heaviest_ineq"):
    """Kernel, plain version, library call and bound at the heaviest shapes
    of a solve: per entry point and solver layer the two with the most calls
    times bound, per entry point the largest, and the (name, spec) pairs of
    ``extra``; timed on random operands of those shapes (K4 on an SPD
    matrix); per entry point, layer and operand type where the solve mixes
    types.  Returns the rows."""
    import torch

    rng = np.random.RandomState(7)
    dev = torch.device("cuda")
    totals = Counter()
    by_entry = {}
    for (lay, name, spec), count in calls.items():
        totals[(name, spec)] += count
        dtype = "float32" in str(spec)
        by_entry.setdefault((lay, name, dtype), []).append(
            (count * bounds[(name, spec)], spec, count))
    picks = {}
    for (lay, name, _), items in by_entry.items():
        for _, spec, count in sorted(items, key=lambda x: -x[0])[:2]:
            picks.setdefault((name, spec), []).append([lay, count])
    for name, (_, spec, _, _) in largest.items():
        picks.setdefault((name, spec), []).append(["largest", totals[(name, spec)]])
    for name, spec in extra:
        picks.setdefault((name, spec), []).append([tag, totals[(name, spec)]])
    rows = [dict(time_spec(name, spec, rng, dev), tags=tags, calls=totals[(name, spec)])
            for (name, spec), tags in picks.items()]
    for row in sorted(rows, key=lambda r: (r["kernel"], -r["calls"])):
        print(json.dumps({label: {k: v for k, v in row.items() if k != "spec"}}), flush=True)
    return rows


def time_spec(name, spec, rng, dev):
    """Kernel, plain version, library call and bound of entry point
    ``name`` on random operands of the shapes and types ``spec`` (the
    recorder's: operand specs, then the keywords)."""
    from ttipm_tpu_torch.checks import PLAIN, shape_key
    from ttipm_tpu_torch.ops import kernels as K

    a = random_operands(name, spec[:-1], rng, dev)
    kw = dict(spec[-1])
    fn, plain, lib = getattr(K, name), PLAIN[name], library_calls().get(name)
    fns = [lambda: plain(*a), lambda: fn(*a, **kw)]
    if lib is not None:
        fns.insert(1, lambda: lib(*a))
    ms = _plain_first_ms(name, fns, runs=3, warmup=1)
    b, by = bound_ms(name, a)
    return {"kernel": name, "shape": shape_key(a), "dtype": str(_tensors(a)[0].dtype)[6:],
            "kw": kw or None, "ms": ms[-1], "plain_ms": ms[0],
            "library_ms": ms[1] if lib is not None else None, "bound_ms": b, "bound_by": by,
            "spec": spec}


# The f32 cell: maxcut d8 seed 319 in the float32 profile at rank bucket 4
# (``tools/replay_step.py``'s ``profile_config("f32")``), with
# scripts/f32_repro.py's settings (configs/maxcut_8.yaml's but max_iter 22:
# ``replay_step.F32_SETTINGS``), and the JAX package's record of its f32
# run on the CPU.
# The JAX package builds the f32 instance in f32, where its graph
# sampler's rank decisions fall on f32 SVD noise (it takes its 56th sample
# at this seed, its f64 instance the 5th); the port builds it in f64 and
# rounds it (models/maxcut.py), so the record is of another graph of the
# same seed.
F32_CELL = ("maxcut", 8, 319)
JAX_CPU_F32_D8 = {"iters": 11, "slack": 1.131e-4, "wall_s": 660.2, "rank_bucket": 4,
                  "source": "results/f32_d78.out:3914 (CPU run, its own f32 instance)"}


def capture_first(kind_attr, box):
    """Wrap ``ipm.<kind_attr>`` so that its first call's arguments land in
    ``box``; returns the function to restore."""
    import ttipm_tpu_torch.ipm as ipm

    fn = getattr(ipm, kind_attr)

    def grab(*a, **kw):
        if "args" not in box:
            box["args"], box["kw"] = a, dict(kw)
        return fn(*a, **kw)

    setattr(ipm, kind_attr, grab)
    return fn


def phase_f32(problem, dim, seed):
    """Phase 9 (a worker): the float32 profile on the card.  Returns the
    solve's call record, the f32 instances' launches in the solve and in
    the capture run, and each kernel's worst f32 error; ``f32_times`` (the
    parent) times the heaviest f32 shapes."""
    import torch

    import ttipm_tpu_torch.ipm as ipm
    from ttipm_tpu_torch import config as tconfig
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.solvers import fused as TF
    from ttipm_tpu_torch.tools.replay_step import F32_SETTINGS, profile_config

    box = {}
    with profile_config("f32"):
        original = capture_first("tt_restarted_block_amen_fused", box)
        try:
            res, counts, record = drive(problem, dim, seed, "f32", JAX_CPU_F32_D8,
                                        settings=F32_SETTINGS)
        finally:
            ipm.tt_restarted_block_amen_fused = original
        if not tconfig.tf32_off():
            raise AssertionError("f32: TF32 was switched on during the solve")
        # the first Newton system, solved again in each local-solve mode
        lhs, rhs = box["args"][:2]
        ref = next(iter(rhs.values()))[0]
        d = len(next(iter(rhs.values())))
        modes = {}
        capture = {n: dict.fromkeys(K.DTYPES.values(), 0) for n in K.STATS}
        for mode in ("f64", "refine", "off"):
            tconfig.set_mixed_local(mode)
            kw = dict(box["kw"], rng=np.random.RandomState(seed))
            K.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, res_local = original(lhs, rhs, *box["args"][2:], **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rn = TF.fused_residual_norm(TF.prep_operator(lhs), TF.prep_rhs(rhs, d, ref), x)
            modes[mode] = {"rel_residual": rn / rhs.norm, "local_res": res_local, "s": wall,
                           "dtype": str(x[0].dtype).split(".")[-1],
                           "launches_by_dtype": {n: dict(st.by_dtype) for n, st in K.STATS.items()},
                           "plain_calls": sum(st.plain_calls for st in K.STATS.values())}
            for n, st in K.STATS.items():
                for tag, c in st.by_dtype.items():
                    capture[n][tag] += c
            if modes[mode]["plain_calls"]:
                raise AssertionError(f"f32 capture ({mode}): a plain version ran on CUDA tensors")
            if not np.isfinite(rn):
                raise AssertionError(f"f32 capture ({mode}): non-finite residual")
        tconfig.set_mixed_local("f64")
        print(json.dumps({"f32_capture_modes": modes}), flush=True)
    launches = {n: counts[n][3]["f32"] for n in F32_KERNELS}  # the solve's, counted from 0
    launches_capture = {n: capture[n]["f32"] for n in F32_KERNELS}
    print(json.dumps({"f32_launches": {"solve": {n: counts[n][3] for n in KERNELS},
                                       "capture": capture}}), flush=True)
    missing = [n for n in F32_KERNELS if launches[n] + launches_capture[n] <= 0]
    if missing:
        raise AssertionError(f"f32: the f32 instances of {missing} never launched")
    return {"record": portable_record(record), "launches": launches,
            "launches_capture": launches_capture, "max_abs_err_f32": res["max_abs_err_f32"]}


def f32_times(out):
    """The parent's part of phase 9, alone on the card: the solve's
    heaviest shapes timed (``f32_time``); returns per kernel the f32
    instance's launches in the solve and, apart, in the capture run, its
    worst error and its times at the solve's heaviest f32 shape."""
    import torch

    from ttipm_tpu_torch.checks import KERNEL_OF

    rows = solve_times("f32_time", *out["record"])
    summary = {}
    rng = np.random.RandomState(8)
    for n in F32_KERNELS:
        mine = [r for r in rows if KERNEL_OF[r["kernel"]] == n]
        f32 = [r for r in mine if r["dtype"] == "float32"]
        if not f32:  # launched in f32 only by the capture run: its heaviest shape in f32
            base = max(mine, key=lambda r: r["calls"] * r["bound_ms"])
            f32 = [dict(time_spec(base["kernel"], as_f32(base["spec"]), rng,
                                  torch.device("cuda")), calls=0)]
            print(json.dumps({"f32_time": {k: v for k, v in f32[0].items() if k != "spec"}}),
                  flush=True)
        best = max(f32, key=lambda r: r["calls"] * r["bound_ms"])
        summary[n] = {"launches": out["launches"][n],
                      "launches_capture": out["launches_capture"][n],
                      "max_abs_err": out["max_abs_err_f32"].get(n, 0.0),
                      **{k: best[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by")},
                      "timed_entry": best["kernel"], "timed_shape": best["shape"]}
    return summary


def as_f32(spec):
    """A recorder's spec with every float64 operand made float32."""
    if isinstance(spec, tuple) and spec[:2] == ("T", "float64"):
        return ("T", "float32") + spec[2:]
    if isinstance(spec, tuple):
        return tuple(as_f32(x) for x in spec)
    return spec


# The batch cell: the first Newton systems of the five seeds of
# configs/maxcut_10.yaml in one lockstep batch, at tt_newton_step_batch's
# JAX defaults (R = 16, R_eig = 8, nswp = 12) and seed 5; then the five
# seeds of configs/maxcut_8.yaml as worker processes on the card.
BATCH_CELL = ("maxcut", 10)
BATCH_STEP = {"R": 16, "R_eig": 8, "nswp": 12, "seed": 5}
RUN_BATCH_CELL = ("maxcut", 8)
SLICE_ITERS_D8_SEED24 = 8  # phase 5's iterations on d8 seed 24, used when phase 5 does not run


def batch_operands(dev, dtype, rng):
    """The batched entries' operands at the batch cell's shapes: K2's six
    terms and K1's four blocks at R = 16 and operator rank 4 for 5
    instances (flipped / transposed views, x strided columns of a block
    core, as the batched algebra hands them over), K3's (64, 18) panels of
    the R = 16 splits and a cluster-regime (300, 20) one, K4's L_Z of
    order 1024 (blocked, once per instance) and the eigen windows' order
    256 for the 10 pencils of a step-size batch.  {label: (entry, args,
    kw)}."""
    import torch

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), device=dev).to(dtype)

    def spd(B, n):
        a = t(B, n, n)
        return a @ a.mT + n * torch.eye(n, dtype=dtype, device=dev)

    B, R, s = 5, 16, 4
    x = t(B, R, 3, 4, R)
    ops = [(t(B, R, s, R), t(B, s, 4, 4, s), t(B, R, s, R)) for _ in range(5)]
    flipped = (t(B, R, s, R).permute(0, 3, 2, 1), t(B, s, 4, 4, s).transpose(2, 3),
               t(B, R, s, R).permute(0, 3, 2, 1))
    terms = [(*ops[0], x[:, :, 0], 0), (*ops[1], x[:, :, 1], 0), (*flipped, x[:, :, 0], 1),
             (*ops[2], x[:, :, 2], 1), (*ops[3], x[:, :, 1], 2), (*ops[4], x[:, :, 2], 2)]
    return {
        "kkt_block_product_batch": ("kkt_block_product_batch", (terms, 3), {}),
        "kkt_block_product_batch_one_term": ("kkt_block_product_batch", ([terms[0]], 1), {}),
        "schur_assemble_batch": ("schur_assemble_batch", ([ops[3], flipped, ops[4], ops[0]],), {}),
        "schur_assemble_batch_one_block": ("schur_assemble_batch", ([ops[0]],), {}),
        "panel_qr_batch": ("panel_qr_batch", (t(B, 64, 18),), {"transposed": True}),
        "panel_qr_batch_cluster": ("panel_qr_batch", (t(B, 300, 20),), {}),
        "panel_cholesky_batch": ("panel_cholesky_batch", (spd(B, 1024),), {}),
        "panel_cholesky_batch_eigen": ("panel_cholesky_batch", (spd(2 * B, 256),), {}),
    }


def batch_library_call(name, args):
    """The one PyTorch call computing what a batched entry computes on its
    (B, ...) operands: batched ``einsum`` for a K2 product of one term and
    a K1 group of one block, ``linalg.qr`` and ``cholesky_ex``; None for
    the grouped K1 / K2 calls."""
    import torch

    if name == "panel_qr_batch":
        return lambda a, transposed=False: torch.linalg.qr(a, mode="reduced")
    if name == "panel_cholesky_batch":
        return torch.linalg.cholesky_ex
    if name == "kkt_block_product_batch" and len(args[0]) == 1:
        return lambda terms, nrows: torch.einsum("zlsr,zsmnS,zLSR,zrnR->zlmL", *terms[0][:4])
    if name == "schur_assemble_batch" and len(args[0]) == 1:
        return lambda blocks: torch.einsum("zlsr,zsmnS,zLSR->zlmLrnR", *blocks[0])
    return None


def phase_batch_kernels():
    """The batched entries of K1-K4 on the card at the batch cell's shapes,
    f64 and f32: every instance within phase 3's tolerances of its plain
    version, and equal bit for bit to a single launch on that instance (a
    batch of one equal to the single launch too).  Timed in f64 (in turns:
    plain, library, the B single launches, the batched launch, and back):
    returns per kernel the row of its heaviest batched shape."""
    import torch

    from ttipm_tpu_torch.checks import (SINGLE_OF, batch_instance, check_batch, check_kernel,
                                        shape_key)
    from ttipm_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.RandomState(2025)
    plain_batch = {"kkt_block_product_batch": K.kkt_block_product_batch_plain,
                   "schur_assemble_batch": K.schur_assemble_batch_plain,
                   "panel_qr_batch": K.panel_qr_batch_plain,
                   "panel_cholesky_batch": K.panel_cholesky_batch_plain}
    rows = {}
    for dtype in (torch.float64, torch.float32):
        for label, (name, args, kw) in batch_operands(dev, dtype, rng).items():
            fn = getattr(K, name)
            single = getattr(K, SINGLE_OF[name])
            out = fn(*args, **kw)
            errs = check_batch(name, args, out, kw)
            B = _tensors(args)[0].shape[0]
            for i in range(B):
                _, a_i, o_i = batch_instance(name, args, kw, out, i)
                want = single(*a_i, **kw)
                if name == "panel_qr_batch" and kw.get("transposed"):
                    want = (want[0].T, want[1])
                if not _same_bits(o_i, want):
                    raise AssertionError(f"{label} {dtype}: instance {i} differs from a single "
                                         "launch on it")
            one = _batch_args(args, slice(0, 1))
            _, a_0, o_0 = batch_instance(name, one, kw, fn(*one, **kw), 0)
            want = single(*a_0, **kw)
            if name == "panel_qr_batch" and kw.get("transposed"):
                want = (want[0].T, want[1])
            if not _same_bits(o_0, want):
                raise AssertionError(f"{label} {dtype}: a batch of one differs from the single "
                                     "launch")
            row = {"entry": name, "dtype": str(dtype).split(".")[-1], "B": B,
                   "shape": shape_key(args), **errs}
            if dtype == torch.float64:
                singles = [batch_instance(name, args, kw, out, i)[1] for i in range(B)]
                fns = [lambda: plain_batch[name](*args, **kw),
                       lambda: [single(*a, **kw) for a in singles], lambda: fn(*args, **kw)]
                lib = batch_library_call(name, args)
                if lib is not None:
                    fns.insert(1, lambda: lib(*args, **kw))
                ms = _turns_ms(fns, runs=5, warmup=2)
                one_bound, by = bound_ms(SINGLE_OF[name], singles[0])
                row.update({"ms": ms[-1], "singles_ms": ms[-2], "plain_ms": ms[0],
                            "library_ms": ms[1] if lib is not None else None,
                            "bound_ms": B * one_bound, "bound_by": by})
                kernel = KERNEL_NAME[name]
                if kernel not in rows or row["bound_ms"] > rows[kernel]["bound_ms"]:
                    rows[kernel] = row
            print(json.dumps({"batch_kernel": label, **row}), flush=True)
    # J1 and J2 take a batch always: the split factorizations of the five
    # instances (80 x 60 at d10: r2^T of order 60) and the eigen windows of
    # the ten pencils (order 256), against a batch of one on each instance
    library = library_calls()
    for entry, B, n in (("jacobi_orthogonalise", 5, 60), ("jacobi_eigh_core", 10, 256)):
        x = jacobi_operand(entry, B, n, rng, dev)
        fn, plain = getattr(K, entry), getattr(K, entry + "_plain")
        out = fn(x)
        errs = check_kernel(entry, (x,), out)
        singles = [x[i:i + 1] for i in range(B)]
        for i, xi in enumerate(singles):
            if not _same_bits([o[i:i + 1] for o in out], fn(xi)):
                raise AssertionError(f"{entry}: instance {i} of a batch of {B} differs from a "
                                     "batch of one")
        ms = _plain_first_ms(entry, [lambda: plain(x), lambda: library[entry](x),
                                     lambda: [fn(xi) for xi in singles], lambda: fn(x)],
                             runs=5, warmup=2)
        b, by = bound_ms(entry, (x,))
        row = {"entry": entry, "dtype": "float64", "B": B, "shape": shape_key((x,)), **errs,
               "ms": ms[-1], "singles_ms": ms[-2], "plain_ms": ms[0], "library_ms": ms[1],
               "bound_ms": b, "bound_by": by}
        rows[KERNEL_NAME[entry]] = row
        print(json.dumps({"batch_kernel": entry, **row}), flush=True)
        if entry == "jacobi_orthogonalise":
            j1_regimes("phase 10", x, runs=5)
    return rows


# The kernel (key of kernels.STATS) of each batched entry.
KERNEL_NAME = {"kkt_block_product_batch": "kkt_block_matvec",
               "schur_assemble_batch": "schur_assemble",
               "panel_qr_batch": "panel_qr", "panel_cholesky_batch": "panel_cholesky",
               "jacobi_orthogonalise": "jacobi_svd", "jacobi_eigh_core": "jacobi_eigh"}


def _batch_args(args, index):
    """``args`` with every tensor indexed along its batch axis."""
    import torch

    if isinstance(args, torch.Tensor):
        return args[index]
    if isinstance(args, (list, tuple)):
        return type(args)(_batch_args(a, index) for a in args)
    return args


def _same_bits(a, b):
    import torch

    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and bool(torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0)))
        for x, y in zip(ta, tb))


def _busy_share(fn):
    """Device busy share of one call of ``fn``: the union of the intervals
    of its device activities (kernels, copies) in a torch.profiler trace of
    the device alone, over the call's synchronised host wall (the
    profiler's own cost included), and the device time by kernel.  Read
    from the trace's raw events (parsing a trace of ~300,000 kernels into
    profiler events took two minutes).  None where the trace holds no
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation()]
        if events:
            busy, end = 0, -1
            by_name, calls = Counter(), Counter()
            for e in sorted(events, key=lambda e: e.start_ns()):
                a, b = e.start_ns(), e.start_ns() + e.duration_ns()
                if b > end:
                    busy += b - max(a, end)
                    end = b
                by_name[e.name()[:80]] += e.duration_ns() / 1e6
                calls[e.name()[:80]] += 1
            return {"busy_share": busy / 1e6 / wall_ms, "device_busy_ms": busy / 1e6,
                    "profiled_wall_ms": wall_ms, "device_activities": len(events),
                    "top_kernels_ms": [(n, ms, calls[n]) for n, ms in by_name.most_common(12)]}
        time.sleep(0.5)
    return None


def phase_batch():
    """Phase 10: the batched seeds on the card.  (1) the batched kernels
    (``phase_batch_kernels``); (2) the first Newton systems of the five
    seeds of configs/maxcut_10.yaml through ``tt_newton_step_batch`` in one
    batch (BATCH_STEP): finite directions, steps in (0, 1], instance 0's
    steps those of a batch of one (1e-5, tests/test_parallel.py:168), every
    instance's predictor residual at most 10x the single
    ``tt_block_amen_fused`` residual on its system or 1e-8
    (test_parallel.py:101, measured by ``checks.kkt_residual_norm``, which
    resolves that bound), every kernel launched through its batched entry and no plain version
    on a CUDA tensor; (3) walls: the batch of 5 against five batches of
    one, and the predictor solve batched against five single solves, the
    host syncs and the device busy share (torch.profiler) of the batched
    step, the peak device memory; (4) ``run_batch`` on the five seeds of
    configs/maxcut_8.yaml, five workers on the card, is a worker of its own
    (``phase_run_batch``).  Returns (per kernel the
    launches and instances of each type ("f64", "f32") in the counted
    batched step and the rows of ``phase_batch_kernels``; phase 11's
    reference: the systems, the counted step's steps and directions (numpy's
    global stream seeded with BATCH_STEP's seed before it), the batched
    step's wall and the predictor residuals)."""
    import warnings

    import torch

    from ttipm_tpu_torch.checks import (batch_errors, first_newton_system, kernel_errors,
                                        kkt_residual_norm, shape_key)
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.parallel.fused_mesh import (tt_block_amen_fused_batch,
                                                     tt_newton_step_batch)
    from ttipm_tpu_torch.solvers import fused as F

    t_phase = time.perf_counter()
    parts = {}
    rows = phase_batch_kernels()
    parts["kernels_s"] = time.perf_counter() - t_phase
    dev = torch.device("cuda")
    problem, dim = BATCH_CELL
    cfg = load_config(dim, problem)
    seeds = [int(s) for s in cfg["seeds"]]
    t0 = time.perf_counter()
    inst = [first_newton_system(problem, cfg, s, dev) for s in seeds]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    systems = [(i[0], i[1]) for i in inst]
    Xs, Zs = [i[2] for i in inst], [i[3] for i in inst]

    def step(k):
        return tt_newton_step_batch(systems[:k], Xs[:k], Zs[:k], **BATCH_STEP)

    # the counted run: launches, host syncs, peak memory, and every batched
    # entry held to phase 3's tolerances on the first call of each shape
    checked = {name: {} for name in K.STATS}
    originals = {name: getattr(K, name) for name in KERNEL_NAME}

    def recorder(name):
        fn = originals[name]

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            key = (name, shape_key(a), str(kw))
            if key not in checked[KERNEL_NAME[name]]:
                checked[KERNEL_NAME[name]][key] = (
                    kernel_errors(name, a, out) if name in MAIN_ENTRY.values()
                    else batch_errors(name, a, out, kw, cancelling=True))
            return out
        return wrapped

    t_part = time.perf_counter()
    for name in KERNEL_NAME:
        setattr(K, name, recorder(name))
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                np.random.seed(BATCH_STEP["seed"])  # the eigenvector starts (phase 11 redraws)
                xs, zs, dirs = step(len(seeds))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)
    peak = torch.cuda.max_memory_allocated()
    counts = {n: (s.launches, s.instances, s.batched, s.plain_calls)
              for n, s in K.STATS.items()}
    outside = {n: s.outside for n, s in K.STATS.items()}
    by_dtype = {n: {tag: (s.by_dtype[tag], s.instances_by_dtype[tag]) for tag in s.by_dtype}
                for n, s in K.STATS.items()}
    syncs = Counter(os.path.relpath(w.filename, REPO) for w in caught
                    if "synchroniz" in str(w.message))
    syncs = {f: c for f, c in syncs.items()
             if f.startswith("ttipm_tpu_torch") and not f.endswith("checks.py")}
    report_checks("batch_checks", checked, f"the {problem} d{dim} batch's shapes")
    parts["counted_step_with_checks_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(len(seeds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    for d_i in dirs:
        for t_tt in d_i:
            if not all(bool(torch.isfinite(c).all()) for c in t_tt):
                raise AssertionError("batch: a non-finite direction")
    if not (np.all(xs > 0) and np.all(xs <= 1) and np.all(zs > 0) and np.all(zs <= 1)):
        raise AssertionError(f"batch: steps outside (0, 1]: {xs} {zs}")
    for name, (launches, instances, batched, plain) in counts.items():
        if batched <= 0 or instances <= 0:
            raise AssertionError(f"{name}: no batched launch in the d{dim} batch")
        if plain != 0:
            raise AssertionError(f"{name}: plain version ran {plain} times on CUDA tensors")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs1, zs1, _ = step(1)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    if (abs(xs[0] - xs1[0]) >= 1e-5 * max(1.0, abs(xs1[0]))
            or abs(zs[0] - zs1[0]) >= 1e-5 * max(1.0, abs(zs1[0]))):
        raise AssertionError(f"batch: instance 0's steps {xs[0]}, {zs[0]} against a batch of "
                             f"one {xs1[0]}, {zs1[0]}")
    singles_s = [one_s]
    for k in range(1, len(seeds)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt_newton_step_batch([systems[k]], [Xs[k]], [Zs[k]], **BATCH_STEP)
        torch.cuda.synchronize()
        singles_s.append(time.perf_counter() - t0)

    parts["timed_steps_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # the predictor solve alone: batched against single solves
    kw = {"R": BATCH_STEP["R"], "term_tol": 1e-6, "nswp": BATCH_STEP["nswp"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols, _ = tt_block_amen_fused_batch([s[0] for s in systems], [s[1] for s in systems],
                                        ineq=False, seed=BATCH_STEP["seed"], **kw)
    torch.cuda.synchronize()
    solve_batch_s = time.perf_counter() - t0
    res_batch, res_single, solve_single_s = [], [], 0.0
    for (lhs, rhs), x_b in zip(systems, sols):
        d = len(x_b)
        A, b = F.prep_operator(lhs), F.prep_rhs(rhs, d, x_b[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_s, _ = F.tt_block_amen_fused(lhs, rhs, kw["term_tol"], kw["R"], nswp=kw["nswp"],
                                       rng=np.random.RandomState(BATCH_STEP["seed"]))
        torch.cuda.synchronize()
        solve_single_s += time.perf_counter() - t0
        res_batch.append(kkt_residual_norm(A, b, x_b) / rhs.norm)
        res_single.append(kkt_residual_norm(A, b, x_s) / rhs.norm)
    for rb, rs in zip(res_batch, res_single):
        if not rb < max(10 * rs, 1e-8):
            raise AssertionError(f"batch: predictor residual {rb} against the single solve's {rs}")

    parts["predictor_solves_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    busy = _busy_share(lambda: step(len(seeds)))
    parts["profiled_step_s"] = time.perf_counter() - t_part
    res = {
        "cell": f"{problem} d{dim} seeds {seeds}", **BATCH_STEP, "systems_build_s": build_s,
        "x_steps": list(map(float, xs)), "z_steps": list(map(float, zs)),
        "x_steps_batch_of_one": float(xs1[0]), "z_steps_batch_of_one": float(zs1[0]),
        "wall_batch_s": wall, "wall_singles_s": sum(singles_s), "singles_s": singles_s,
        "batch_over_singles": wall / sum(singles_s),
        "predictor_solve_batch_s": solve_batch_s, "predictor_solves_single_s": solve_single_s,
        "predictor_rel_res_batch": res_batch, "predictor_rel_res_single": res_single,
        "host_syncs": sum(syncs.values()),
        "host_syncs_by_file": dict(sorted(syncs.items(), key=lambda kv: -kv[1])),
        "device": busy if busy is not None else "not measured (no device events traced)",
        "max_memory_allocated": peak,
        "counts": {n: {"launches": c[0], "instances": c[1], "batched": c[2], "plain_calls": c[3]}
                   for n, c in counts.items()},
        "outside": outside,
        "parts_s": parts,
    }
    print(json.dumps({"batch": res}), flush=True)
    print(json.dumps({"batch_phase_s": time.perf_counter() - t_phase}), flush=True)
    ref = {"systems": inst, "steps": (xs, zs, dirs), "wall_s": wall,
           "predictor_rel_res": res_batch}
    return {n: {tag: {"launches_batch": c[0], "instances_batch": c[1]}
                for tag, c in by_dtype[n].items()} | {"batch": rows.get(n)}
            for n in counts}, ref


def phase_run_batch(slice_iters=None):
    """Phase 10's last part (a worker): ``run_batch`` on the five seeds of
    configs/maxcut_8.yaml, five worker processes on the card: every seed ok
    and converged, seed 24 in phase 5's iterations."""
    from ttipm_tpu_torch.parallel.batch import run_batch

    problem8, dim8 = RUN_BATCH_CELL
    cfg8 = load_config(dim8, problem8)
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log:  # the five solves' iteration logs
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(log.fileno(), 1)
        try:
            results = run_batch(problem8, config_path(dim8, problem8),
                                [int(s) for s in cfg8["seeds"]], workers=5, device="cuda")
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
    run_s = time.perf_counter() - t0
    print(json.dumps({"run_batch": {"config": f"{problem8}_{dim8}.yaml", "workers": 5,
                                    "wall_s": run_s, "results": results}}), flush=True)
    abs_tol = float(cfg8["abs_tol"])
    for r in results:
        if not r["ok"]:
            raise AssertionError(f"run_batch: seed {r['seed']} failed: {r.get('error')}")
        if not (r["slackness"] < abs_tol and r["feasibility_error"] < abs_tol
                and r["dual_feasibility_error"] < abs_tol):
            raise AssertionError(f"run_batch: seed {r['seed']} did not converge: {r}")
    want = slice_iters if slice_iters is not None else SLICE_ITERS_D8_SEED24
    got = {r["seed"]: int(r["num_iters"]) for r in results}
    if got.get(24) != want:
        raise AssertionError(f"run_batch: seed 24 took {got.get(24)} iterations, phase 5 {want}")


# ---------------------------------------------------------------------------
# Phase 11: the mesh on the card
# ---------------------------------------------------------------------------

STEP_BOUND = 2e-14  # phase 10's bound of a batch's steps against a batch of one
DIRECTION_BOUND = 2e-14  # the directions' bound where the steps are not bit-equal


def _numpy_tree(tree):
    import torch

    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(t) for t in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _tree_diff(a, b):
    """(bit-equal, largest absolute difference) of two nested lists of arrays."""
    if isinstance(a, (list, tuple)):
        parts = [_tree_diff(x, y) for x, y in zip(a, b)]
        return (len(a) == len(b) and all(p[0] for p in parts),
                max((p[1] for p in parts), default=0.0))
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False, float("inf")
    return bool(np.array_equal(a, b)), float(np.abs(a - b).max(initial=0.0))


def batch_reference():
    """Phase 10's reference where phase 10 does not run: the five systems,
    the mesh=None step with numpy's global stream seeded as phase 10 seeds
    it, the step's wall and the predictor residuals."""
    import torch

    from ttipm_tpu_torch.checks import first_newton_system, kkt_residual_norm
    from ttipm_tpu_torch.parallel.fused_mesh import tt_block_amen_fused_batch, tt_newton_step_batch
    from ttipm_tpu_torch.solvers import fused as F

    problem, dim = BATCH_CELL
    cfg = load_config(dim, problem)
    inst = [first_newton_system(problem, cfg, int(s), torch.device("cuda"))
            for s in cfg["seeds"]]
    systems, Xs, Zs = [i[:2] for i in inst], [i[2] for i in inst], [i[3] for i in inst]
    np.random.seed(BATCH_STEP["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = tt_newton_step_batch(systems, Xs, Zs, **BATCH_STEP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sols, _ = tt_block_amen_fused_batch([s[0] for s in systems], [s[1] for s in systems],
                                        R=BATCH_STEP["R"], ineq=False, term_tol=1e-6,
                                        nswp=BATCH_STEP["nswp"], seed=BATCH_STEP["seed"])
    res = [kkt_residual_norm(F.prep_operator(lhs), F.prep_rhs(rhs, len(x), x[0]), x) / rhs.norm
           for (lhs, rhs), x in zip(systems, sols)]
    return {"systems": inst, "steps": steps, "wall_s": wall, "predictor_rel_res": res}


_UNINITIALISED = ("aten.empty", "aten.new_empty", "aten.empty_like", "aten.empty_strided")


def _checksum(t, axis=None):
    """Device-side checksums of ``t``'s bits (no host transfer): of the
    whole, or of each index along ``axis``.  Each word is mixed (xor-shift,
    an odd multiplier) and weighted by an odd number of its position before
    the wrapping int64 sum, so that neither a permutation of the entries
    nor an even number of sign flips (2 x 2^63 wraps to 0 in a plain sum of
    the words: a row or a column of a core negated) leaves it unchanged."""
    import torch

    t = t.detach()
    t = (t.reshape(1, -1) if axis is None else t.movedim(axis, 0).reshape(t.shape[axis], -1))
    t = t.contiguous()
    if t.dtype == torch.float64:
        w = t.view(torch.int64)
    elif t.dtype == torch.float32:
        w = t.view(torch.int32).to(torch.int64)
    else:
        w = t.to(torch.int64)
    w = w ^ (w >> 31)
    w = w * -7046029254386353131  # 0x9E3779B97F4A7C15, wrapping
    w = w ^ (w >> 29)
    odd = 2 * torch.arange(w.shape[1], device=w.device, dtype=torch.int64) + 1
    out = (w * odd).sum(dim=1)
    return out[0] if axis is None else out


def _digests(tree, batch):
    """(shape, {axis: checksums of each index along it} for every axis of
    size ``batch``, checksum of the whole where there is none) of every
    CUDA tensor in ``tree``; the checksums stay on the device."""
    import torch

    out = []

    def walk(t):
        if isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif isinstance(t, dict):
            for x in t.values():
                walk(x)
        elif torch.is_tensor(t) and t.is_cuda:
            axes = {ax: _checksum(t, ax) for ax, n in enumerate(t.shape) if n == batch}
            out.append((tuple(t.shape), axes, None if axes else _checksum(t)))

    walk(tree)
    return out


_WHOLE = -1  # the trace's batch size inside per-instance code: tensors compared whole


def _same_instances(da, db, index):
    """Whether two ``_digests`` lists (checksums read back) agree on every
    instance of the first: instance j of ``da`` against instance
    ``index[j]`` of ``db``, per tensor with a batch axis in both, along an
    axis outside which the shapes agree.  Tensors without one (the batch's
    decisions, constants) are not compared: a difference that matters
    reaches a batched tensor.  Returns (the tensor's position, the
    instance) of the first difference, or None."""
    if len(da) != len(db):
        return -1, 0
    for pos, ((sa, aa, fa), (sb, ab, fb)) in enumerate(zip(da, db)):
        if index is None:  # per-instance code: every tensor whole
            if sa != sb or fa != fb:
                return pos, 0
            continue
        if not aa and not ab:
            continue
        axes = [ax for ax in set(aa) & set(ab) if len(sa) == len(sb)
                and all(x == y for i, (x, y) in enumerate(zip(sa, sb)) if i != ax)]
        if not axes:
            return pos, 0
        ax = axes[0]
        for j, g in enumerate(index):
            if aa[ax][j] != ab[ax][g]:
                return pos, j
    return None


_KERNEL_ENTRIES = ("kkt_block_product", "kkt_block_product_batch", "kkt_block_matvec",
                   "schur_assemble_group", "schur_assemble_batch", "panel_qr", "panel_qr_batch",
                   "panel_cholesky", "panel_cholesky_batch")


def traced_step(m, systems, Xs, Zs):
    """The batch cell's Newton step on mesh ``m`` (or None) with every
    aten op and kernel call inside the batched sweeps and eigen programs
    and the solves' warm-start preparation recorded: (name, batch size,
    digests of its inputs, of its outputs, the ops that wrote its inputs);
    batched tensors digested instance by instance, the warm starts' whole
    (ops that allocate without writing are left out).  The rest of the
    step (per-instance TT algebra, the mesh's reductions and gathers) is
    not traced."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.parallel import fused_mesh as FM
    from ttipm_tpu_torch.solvers import fused_batch as FB
    from ttipm_tpu_torch.solvers import fused_eigen_batch as FEB

    trace, batch = [], [None]

    producer = {}  # a tensor's (storage, offset, shape) -> the traced op that wrote it

    def key(t):
        return (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape))

    def cuda_tensors(tree):
        return [t for t in torch.utils._pytree.tree_leaves(tree)
                if torch.is_tensor(t) and t.is_cuda]

    class Tracer(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if batch[0] is not None and not name.startswith(_UNINITIALISED):
                made = [producer.get(key(t)) for t in cuda_tensors((args, kwargs))]
                trace.append((name, batch[0], _digests((args, kwargs), batch[0]),
                              _digests(out, batch[0]), made))
                for t in cuda_tensors(out):
                    producer[key(t)] = len(trace) - 1
            return out

    def scoped(fn, size=None, record=None):
        """``fn`` with the batch size set (``size`` given) or the tracing
        off inside it; ``record`` (a name, or a function of the arguments
        giving one): trace the call itself as one op."""
        def wrapped(*a, **kw):
            saved = batch[0]
            batch[0] = size(a) if size is not None else None
            try:
                out = fn(*a, **kw)
                if record and saved is not None:  # digested untraced
                    name = record(a) if callable(record) else record
                    made = [producer.get(key(t)) for t in cuda_tensors((a, kw))]
                    trace.append((name, saved, _digests((a, kw), saved), _digests(out, saved),
                                  made))
                    for t in cuda_tensors(out):
                        producer[key(t)] = len(trace) - 1
            finally:
                batch[0] = saved
            return out
        return wrapped

    patched = [(FB, "sweep", scoped(FB.sweep, size=lambda a: a[2][0].shape[0])),
               (FM._fused, "_prep_x0", scoped(FM._fused._prep_x0, size=lambda a: _WHOLE)),
               (FM, "gen_eigen_program", scoped(FM.gen_eigen_program, size=lambda a: a[3].shape[0]))]
    patched += [(K, n, scoped(getattr(K, n), record=f"kernel:{n}")) for n in _KERNEL_ENTRIES]
    # the calls taken an instance at a time: one op each, whatever the batch
    patched += [(FB, "_each", scoped(FB._each, record=lambda a: f"each:{a[0].__name__}"))]
    patched += [(FEB, n, scoped(getattr(FEB, n), record=f"each:{n}"))
                for n in ("_norm", "_solve_lower")]
    if m is not None:  # the mesh's own reductions of the stop decisions
        patched.append((m, "reduce_values", scoped(m.reduce_values)))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    for obj, name, fn in patched:
        setattr(obj, name, fn)
    try:
        np.random.seed(BATCH_STEP["seed"])
        with Tracer():
            FM.tt_newton_step_batch(systems, Xs, Zs, mesh=m, **BATCH_STEP)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        if m is not None:
            del m.reduce_values
    # read every checksum back in one transfer
    sums = [c.reshape(-1) for _, _, ins, outs, _ in trace for d in (ins, outs)
            for _, axes, full in d for c in list(axes.values()) + ([full] if full is not None else [])]
    values = iter(torch.cat(sums).tolist() if sums else [])

    def read(d):
        return [(shape, {ax: [next(values) for _ in range(len(c))] for ax, c in axes.items()},
                 next(values) if full is not None else None)
                for shape, axes, full in d]

    return [(name, b, read(ins), read(outs), made) for name, b, ins, outs, made in trace]


def first_divergent_op(a, b, row, seeds):
    """The first op of a seeds mesh's trace ``a`` (``traced_step`` on seeds
    row ``row`` of ``seeds``) and the mesh=None trace ``b`` at which one of
    the row's instances differs from the same instance in ``b`` while the
    op's inputs agree: the op that computes that instance differently at
    another batch size.  Where inputs differ first, the difference entered
    from code the trace does not see."""
    for k, ((name_a, b_a, in_a, out_a, made), (name_b, b_b, in_b, out_b, _)) in enumerate(
            zip(a, b)):
        if name_a != name_b:
            return {"op": k, "parted": [name_a, name_b]}
        if b_a == _WHOLE:
            index = None
        else:
            padded = list(range(b_b)) + [b_b - 1] * ((-b_b) % seeds)
            index = padded[row * b_a:(row + 1) * b_a]
        diff = _same_instances(in_a, in_b, index)
        if diff is not None:  # name the op that wrote the input, where the trace saw it
            pos, j = diff
            src = made[pos] if 0 <= pos < len(made) else None
            return {"op": k, "name": name_a, "inputs_differ": True,
                    "instance": index[j] if index else "per-instance code",
                    "input_shape": in_a[pos][0] if pos >= 0 else None,
                    "written_by": (src, a[src][0]) if src is not None else "outside the trace"}
        diff = _same_instances(out_a, out_b, index)
        if diff is not None:
            return {"op": k, "name": name_a,
                    "instance": index[diff[1]] if index else "per-instance code",
                    "shapes": [[d[0] for d in in_a], [d[0] for d in in_b]]}
    return {"ops": min(len(a), len(b)), "lengths": [len(a), len(b)], "none_differs": True}


def mesh_rank(mesh, payload):
    """Phase 11 on one rank of a world on the card.  ``mesh`` is the
    seeds-only mesh (S = ranks, K = 1); the rank also makes the kkt-only
    mesh (S = 1, K = ranks) of the same world.  (1) The dry run's three
    parts on the kkt-only mesh; (2) the batch cell's Newton step on the
    seeds-only mesh, held bit for bit against phase 10's mesh=None step;
    (3) the same step on the kkt-only mesh, on the first call of each
    shape this rank's partial Schur blocks (K1 over its slice of the
    operator bond) against their plain version and the blocks summed over
    the row against the full K1's, both to K1's tolerance at the
    cancelling scale, the predictor residuals against phase 10's
    (tests/test_parallel.py:101's bound).  Returns host data."""
    import torch

    from ttipm_tpu_torch.checks import batch_errors, kkt_residual_norm, shape_key
    from ttipm_tpu_torch.interop import block_matrix_to_torch, block_vector_to_torch, tt_to_torch
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.ops.tt import tt_l2_dist, tt_norm
    from ttipm_tpu_torch.parallel import fused_mesh as FM
    from ttipm_tpu_torch.parallel.mesh import make_mesh
    from ttipm_tpu_torch.solvers import fused as F
    from ttipm_tpu_torch.tools.dryrun_mesh import run_parts

    dev = mesh.device
    n = mesh.seeds * mesh.kkt
    kkt_mesh = make_mesh(n, n, device=payload["device"], backend=mesh.backend)
    out = {"rank": mesh.rank, "device": str(dev), "dryrun": run_parts(kkt_mesh)}
    systems, Xs, Zs = [], [], []
    for lhs, rhs, X, Z in payload["systems"]:
        systems.append((block_matrix_to_torch(*lhs, device=dev), block_vector_to_torch(rhs, device=dev)))
        Xs.append(tt_to_torch(X, device=dev))
        Zs.append(tt_to_torch(Z, device=dev))

    def run(m):
        before = m.stats.as_dict()
        K.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        np.random.seed(BATCH_STEP["seed"])
        t0 = time.perf_counter()
        steps = FM.tt_newton_step_batch(systems, Xs, Zs, mesh=m, **BATCH_STEP)
        torch.cuda.synchronize()
        rec = {"wall_s": time.perf_counter() - t0,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": {k: s.launches for k, s in K.STATS.items()},
               "instances": {k: s.instances for k, s in K.STATS.items()},
               "plain_calls": {k: s.plain_calls for k, s in K.STATS.items()},
               "collectives": {k: v - before[k] for k, v in m.stats.as_dict().items()}}
        xs, zs, dirs = steps
        rec["finite_cone_steps"] = bool(
            np.isfinite(xs).all() and np.isfinite(zs).all() and (xs > 0).all() and (xs <= 1).all()
            and (zs > 0).all() and (zs <= 1).all()
            and all(bool(torch.isfinite(c).all()) for d in dirs for t in d for c in t))
        # against mesh=None: the steps, and each direction train's distance
        # relative to its norm (invariant under the trains' gauge)
        want_x, want_z, want_dirs = payload["want"]
        rec["steps_max_abs_diff"] = float(max(np.abs(xs - want_x).max(),
                                              np.abs(zs - want_z).max()))
        rec["dirs_max_rel_dist"] = max(
            tt_l2_dist(t, tt_to_torch(w, device=dev)) / max(tt_norm(t), 1e-300)
            for d, wd in zip(dirs, want_dirs) for t, w in zip(d, wd))
        return _numpy_tree([xs, zs, [list(d) for d in dirs]]), rec

    got, seeds = run(mesh)
    seeds["bit_equal"], seeds["cores_max_abs_diff"] = _tree_diff(got, payload["want"])
    if not seeds["bit_equal"]:  # name the op that computes an instance differently
        trace = traced_step(mesh, systems, Xs, Zs)
        seeds["divergence"] = first_divergent_op(trace, traced_step(None, systems, Xs, Zs),
                                                 mesh.coords[0], mesh.seeds)
    out["seeds_only"] = seeds

    checked = {}
    full_k1 = kkt_mesh.partial_schur

    def checked_partial(blocks, assemble):
        def checked_assemble(part):  # this rank's partial blocks, against their plain version
            out = assemble(part)
            key = ("partial", shape_key(part))
            if key not in checked:
                checked[key] = batch_errors("schur_assemble_batch", (part,), torch.stack(out),
                                            cancelling=True)
            return out

        summed = full_k1(blocks, checked_assemble)
        key = ("summed", shape_key(blocks))
        if key not in checked:  # the sum over the row, against the full K1's plain version
            checked[key] = batch_errors("schur_assemble_batch", (blocks,), torch.stack(summed),
                                        cancelling=True)
        return summed

    solves = []
    fused_batch = FM.tt_block_amen_fused_batch

    def kept_solve(*a, **kw):
        res = fused_batch(*a, **kw)
        solves.append((a[0], a[1], res[0]))
        return res

    kkt_mesh.partial_schur = checked_partial
    FM.tt_block_amen_fused_batch = kept_solve
    try:
        got_k, rec_k = run(kkt_mesh)
    finally:
        FM.tt_block_amen_fused_batch = fused_batch
        del kkt_mesh.partial_schur
    lhs_b, rhs_b, sols = solves[0]  # the predictor solve
    rec_k["predictor_rel_res"] = [
        kkt_residual_norm(F.prep_operator(lhs), F.prep_rhs(rhs, len(x), x[0]), x) / rhs.norm
        for lhs, rhs, x in zip(lhs_b, rhs_b, sols)]
    rec_k["k1_checks"] = {
        kind: {"shapes": sum(1 for k in checked if k[0] == kind),
               "ok": all(e["ok"] for k, e in checked.items() if k[0] == kind),
               "rel_terms": max((e.get("rel_terms", 0.0) for k, e in checked.items()
                                 if k[0] == kind), default=0.0)}
        for kind in ("partial", "summed")}
    out["kkt_only"] = rec_k
    return out


def phase_mesh(ref):
    """Phase 11: the (seeds x kkt) mesh on the card.  Two ranks share
    cuda:0 (gloo); with more than one card also nccl on min(4, count)
    cards.  Each world runs ``mesh_rank`` on every rank.  Fails unless
    every rank ran; the seeds-only step equals phase 10's mesh=None step
    bit for bit (or within STEP_BOUND); the kkt-only mesh's summed Schur
    blocks are within K1's tolerance at the cancelling scale, its predictor
    residuals within 10x of phase 10's or 1e-8 (tests/test_parallel.py:101),
    its steps cone steps; every kernel launched on every rank and no plain
    version on a CUDA tensor.  Returns per kernel each run's launches per
    rank."""
    import torch

    from ttipm_tpu_torch.interop import block_matrix_to_numpy, block_vector_to_numpy, tt_to_numpy
    from ttipm_tpu_torch.parallel.mesh import spawn_mesh

    t_phase = time.perf_counter()
    payload = {
        "systems": [(block_matrix_to_numpy(lhs), block_vector_to_numpy(rhs), tt_to_numpy(X),
                     tt_to_numpy(Z)) for lhs, rhs, X, Z in ref["systems"]],
        "want": _numpy_tree([ref["steps"][0], ref["steps"][1],
                             [list(d) for d in ref["steps"][2]]]),
    }
    count = torch.cuda.device_count()
    worlds = [("gloo", 2, "cuda:0")] + ([("nccl", min(4, count), "cuda")] if count > 1 else [])
    launches = {}
    for backend, n, device in worlds:
        t0 = time.perf_counter()
        ranks = spawn_mesh(mesh_rank, n, 1, device, backend, args=({**payload, "device": device},),
                           timeout_s=400)
        label = f"{backend}_{n}"
        print(json.dumps({"mesh": {"world": label, "device": device, "ranks": ranks,
                                   "mesh_none_wall_s": ref["wall_s"],
                                   "mesh_none_predictor_rel_res": ref["predictor_rel_res"],
                                   "spawn_and_run_s": time.perf_counter() - t0}}), flush=True)
        for r in ranks:
            seeds, kkt = r["seeds_only"], r["kkt_only"]
            for run, rec in (("seeds_only", seeds), ("kkt_only", kkt)):
                if not rec["finite_cone_steps"]:
                    raise AssertionError(f"{label} rank {r['rank']} {run}: steps or directions "
                                         "not finite cone steps")
                for name in KERNELS:
                    if rec["launches"][name] <= 0 or rec["plain_calls"][name] != 0:
                        raise AssertionError(f"{label} rank {r['rank']} {run}: {name} launched "
                                             f"{rec['launches'][name]} times, plain "
                                             f"{rec['plain_calls'][name]}")
            if not seeds["bit_equal"] and not (seeds["steps_max_abs_diff"] <= STEP_BOUND
                                               and seeds["dirs_max_rel_dist"] <= DIRECTION_BOUND):
                raise AssertionError(f"{label} rank {r['rank']}: seeds-only step differs from "
                                     f"mesh=None beyond {STEP_BOUND} (steps) or "
                                     f"{DIRECTION_BOUND} (directions): {seeds}")
            if not all(c["ok"] and c["shapes"] for c in kkt["k1_checks"].values()):
                raise AssertionError(f"{label} rank {r['rank']}: a partial or summed Schur "
                                     f"block outside K1's tolerance: {kkt['k1_checks']}")
            for rk, rn in zip(kkt["predictor_rel_res"], ref["predictor_rel_res"]):
                if not rk < max(10 * rn, 1e-8):
                    raise AssertionError(f"{label} rank {r['rank']}: kkt-only predictor residual "
                                         f"{rk} against mesh=None {rn}")
        launches[label] = {name: {run: [r[run]["launches"][name] for r in ranks]
                                  for run in ("seeds_only", "kkt_only")} for name in KERNELS}
    print(json.dumps({"mesh_phase_s": time.perf_counter() - t_phase}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the dense baselines on the card
# ---------------------------------------------------------------------------

# (problem, dim, seed, native solvers): maxcut d8 seed 24 (phase 5's cell)
# with all four, maxcut d10 seed 41 (phase 6's) with manopt.
BASELINE_CELLS = (("maxcut", 8, 24, ("splitting", "cgal", "scgal", "manopt")),
                  ("maxcut", 10, 41, ("manopt",)))
# (problem, dim, seed, solver, iterations): timed for a fixed number of
# iterations, not to its stop test.  SketchyCGAL on d10 seed 41 is far from
# it (on the H100: gap 9.98e4 and ||A(X) - b||^2 396 at iteration 2,000,
# against 0.1 and 1e-6, at 227 ms an iteration) and would run to the
# runner's cap of 1000 * 2^10 iterations.
BASELINE_PROBES = (("maxcut", 10, 41, "scgal", 20),)
BASELINE_OBJ_TOL = 1e-3  # tests/test_conic.py:131: the splitting solver against the TT-IPM


def ipm_dense_objective(X, C):
    """<C, X> of the TT-IPM's final X in the dense problem's scaling: the
    IPM solves the sqrt(d)-normalised problem, so its dense iterate is
    divided by the mean of its diagonal first (tests/test_conic.py:162-163)."""
    from ttipm_tpu_torch.ops.tt import tt_matrix_to_matrix, tt_reshape

    Xd = tt_matrix_to_matrix(tt_reshape(X, (2, 2)))
    Xd = Xd / Xd.diagonal().mean()
    return float((Xd * Xd.new_tensor(C)).sum())


def _stopped(solver, sol, dim):
    """Whether a baseline ended by its own stop test (not its iteration
    cap): cgal / scgal below 1000 * 2^d - 1 iterations (the runner's cap),
    the splitting solver below its max_iter (20000; it has no converged
    flag), manopt on its gradient-norm test."""
    if solver in ("cgal", "scgal"):
        return sol["iterations"] < 1000 * 2 ** dim - 1
    if solver == "splitting":
        return sol["iterations"] < 20000
    return sol["stopping_reason"] == "gradient norm below tolerance"


def phase_baselines(ipm_X):
    """Phase 12: the native dense baselines (``utils/baseline_runner.py``
    with the runner's settings) on the card, on BASELINE_CELLS.  Each must
    end by its own stop test and reach the TT-IPM's objective on the same
    instance (phases 5 and 6: ``ipm_X`` {(dim, seed): final X}) within
    BASELINE_OBJ_TOL relative.  Printed: wall, iterations, objective,
    feasibility and peak device memory of each."""
    import torch

    from ttipm_tpu_torch.utils.baseline_runner import build_dense_problem, solve_baseline

    t_phase = time.perf_counter()
    rows = []
    for problem, dim, seed, solvers in BASELINE_CELLS:
        cfg = load_config(dim, problem)
        np.random.seed(seed)
        t0 = time.perf_counter()
        dense = build_dense_problem(problem, dim, 1)
        build_s = time.perf_counter() - t0
        obj_ipm = ipm_dense_objective(ipm_X[(dim, seed)], dense["C"])
        for solver in solvers:
            np.random.seed(seed)  # the sketch's draws, as the runner seeds them
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sol = solve_baseline(solver, problem, dense, cfg, seed=seed, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            X = sol["x_matrix"].cpu().numpy()
            eq = dense["conic"].eq_residual(X)
            row = {"cell": f"{problem} d{dim} seed {seed}", "solver": solver,
                   "wall_s": wall, "build_s": build_s, "iterations": int(sol["iterations"]),
                   "objective": sol["objective"], "ttipm_objective": obj_ipm,
                   "rel_to_ttipm": abs(sol["objective"] - obj_ipm) / abs(obj_ipm),
                   "feasibility_error": float(eq @ eq), "stopped": _stopped(solver, sol, dim),
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
            rows.append(row)
            print(json.dumps({"baseline": row}), flush=True)
    for problem, dim, seed, solver, iters in BASELINE_PROBES:
        rows.append(baseline_probe(problem, dim, seed, solver, iters))
        print(json.dumps({"baseline_probe": rows[-1]}), flush=True)
    print(json.dumps({"baselines_phase_s": time.perf_counter() - t_phase}), flush=True)
    bad = [r for r in rows if "probe_iterations" not in r
           and not (r["stopped"] and r["rel_to_ttipm"] <= BASELINE_OBJ_TOL)]
    if bad:
        raise AssertionError(f"baselines not ended by their stop test or off the TT-IPM's "
                             f"objective by more than {BASELINE_OBJ_TOL}: {bad}")
    return rows


def baseline_probe(problem, dim, seed, solver, iters):
    """``solver`` (cgal or scgal) at the runner's settings for ``iters``
    iterations on the card: the wall per iteration, the last gap estimate
    and ||A(X) - b||^2 of the iterate it returns, its peak memory.  Raises
    if the iterate is not finite."""
    import torch

    from ttipm_tpu_torch.models import baselines as BL
    from ttipm_tpu_torch.utils.baseline_runner import build_dense_problem

    np.random.seed(seed)
    dense = build_dense_problem(problem, dim, 1)
    C = dense["C"] * dense["trace_params"][1] / max(np.linalg.norm(dense["C"]), 1e-300)
    kw = {} if solver == "cgal" else {"R": 2 * int(np.ceil(np.sqrt(2 * (2 ** dim + 1))))}
    fn = BL.cgal if solver == "cgal" else BL.sketchy_cgal
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, gaps, info = fn(-C, dense["constraints"], dense["bias"], dense["trace_params"],
                       gap_tol=0.1, num_iter=iters + 1, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    X = X.cpu().numpy()
    if not np.isfinite(X).all():
        raise AssertionError(f"{solver} d{dim}: a non-finite iterate")
    eq = dense["conic"].eq_residual(X)
    return {"cell": f"{problem} d{dim} seed {seed}", "solver": solver,
            "probe_iterations": info["num_iters"], "wall_s": wall,
            "ms_per_iteration": 1e3 * wall / info["num_iters"],
            "last_gap": gaps[-1] if gaps else None, "feasibility_error": float(eq @ eq),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def ipm_reference(cells):
    """The final X of the TT-IPM on each (dim, seed) of ``cells`` where
    phases 5 and 6 did not run (configs/maxcut_<dim>.yaml's settings)."""
    import torch

    out = {}
    for dim, seed in cells:
        kept = {}
        solve(dim, seed, torch.device("cuda"), ipm_settings(load_config(dim)), keep=kept)
        out[(dim, seed)] = kept["X"]
    return out


# ---------------------------------------------------------------------------
# Phase 13: the port's drivers on the card
# ---------------------------------------------------------------------------

TOOLS_BENCH_GRID = "3:1,8:1,10:1"
LONG_RUN_CELL = ("maxcut", 8, 0)  # seed index 0: seed 24, phase 5's cell
LONG_RUN_KILL_AFTER = 3
TOOLS_SLICE_METRIC = "maxcut_d8_seed24_solve_seconds"  # phase 5's cell in the bench
TOOLS_SCALING = ("10", "1,2")  # dim, batches


def _tool(module, *args, env=None, timeout=600):
    """``python -m ttipm_tpu_torch.tools.<module> args`` from the checkout;
    (return code, stdout, stderr, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"ttipm_tpu_torch.tools.{module}", *args],
                          cwd=REPO, env={**os.environ, **(env or {})}, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0


def _launched_on_card(label, kernels, plain):
    """Every kernel launched, no plain version run on a CUDA tensor (the
    counters of phases 5-9, as the drivers report them)."""
    for name in KERNELS:
        if kernels[name] <= 0 or plain[name] != 0:
            raise AssertionError(f"{label}: {name} launched {kernels[name]} times, plain "
                                 f"version {plain[name]} times")


def phase_tools(slice_iters, slice_X, batch_ref):
    """Phase 13: each driver of ``ttipm_tpu_torch/tools`` in a subprocess on
    the card.  (1) ``bench`` on TOOLS_BENCH_GRID: every line parsed, every
    solve converged with every kernel launched and no plain version on
    a CUDA tensor, the summary line last with ``converged_all``, d8 seed 24
    in phase 5's iterations.  (2) ``long_run`` on LONG_RUN_CELL, killed by
    SIGKILL once the checkpoint of iteration LONG_RUN_KILL_AFTER is on disk
    and run again: it resumes there and converges; its iterations and final
    ranks beside phase 5's, and whether its final X (the last checkpoint's)
    is bit-equal to phase 5's; then ``aggregate_grid`` over its output.
    (3) ``scaling_bench`` at TOOLS_SCALING: rows for each B, every kernel
    launched, the B = 1 step within STEP_BOUND of the same step made here.
    Returns the phase's walls."""
    import torch

    from ttipm_tpu_torch.ops.tt import tt_ranks
    from ttipm_tpu_torch.parallel.fused_mesh import tt_newton_step_batch
    from ttipm_tpu_torch.utils.checkpoint import load_ipm_checkpoint

    t_phase = time.perf_counter()
    walls = {}
    rc, out, err, walls["bench_s"] = _tool("bench", env={"BENCH_GRID": TOOLS_BENCH_GRID,
                                                          "BENCH_PLATFORM": "cuda"})
    if rc != 0:
        raise AssertionError(f"tools/bench.py exited {rc}: {err[-3000:]}")
    lines = out.strip().splitlines()
    rows = [json.loads(line) for line in lines[1:]]
    solves, summary = rows[:-1], rows[-1]
    print(json.dumps({"tools_bench": {"device": lines[0], "solves": solves,
                                      "summary": summary}}), flush=True)
    if summary.get("metric") != "maxcut_grid_geomean_seconds" or not summary["converged_all"]:
        raise AssertionError(f"tools/bench.py: summary {summary}")
    if len(solves) != len(TOOLS_BENCH_GRID.split(",")):
        raise AssertionError(f"tools/bench.py: {len(solves)} solve lines")
    for row in solves:
        if not row["converged"]:
            raise AssertionError(f"tools/bench.py: {row['metric']} did not converge")
        _launched_on_card(f"tools/bench.py {row['metric']}", row["kernels"], row["plain_calls"])
    d8 = next(r for r in solves if r["metric"] == TOOLS_SLICE_METRIC)
    want_iters = slice_iters if slice_iters is not None else SLICE_ITERS_D8_SEED24
    if d8["iters"] != want_iters:
        raise AssertionError(f"tools/bench.py: d8 seed 24 took {d8['iters']} iterations, "
                             f"phase 5 {want_iters}")

    problem, dim, index = LONG_RUN_CELL
    with tempfile.TemporaryDirectory(prefix="ttipm_long_") as out_dir:
        args = ("--problem", problem, "--dim", str(dim), "--seed-index", str(index),
                "--out", out_dir)
        rc, _, err, walls["long_run_killed_s"] = _tool(
            "long_run", *args, "--kill-after", str(LONG_RUN_KILL_AFTER))
        work = os.path.join(out_dir, f"{problem}_{dim}_s{index}")
        if rc != -9:
            raise AssertionError(f"tools/long_run.py: exit {rc}, not SIGKILL: {err[-3000:]}")
        at = int(load_ipm_checkpoint(os.path.join(work, "ckpt.npz"), device="cpu")["iteration"])
        rc, out, err, walls["long_run_resumed_s"] = _tool("long_run", *args)
        if rc != 0:
            raise AssertionError(f"tools/long_run.py (resumed) exited {rc}: {err[-3000:]}")
        with open(os.path.join(work, "result.json")) as fh:
            result = json.load(fh)
        ref_X = slice_X if slice_X is not None else ipm_reference([(dim, 24)])[(dim, 24)]
        X = load_ipm_checkpoint(os.path.join(work, "ckpt.npz"), device=ref_X[0].device)["X"]
        bit_equal = len(X) == len(ref_X) and all(
            a.shape == b.shape and torch.equal(a, b.to(a.dtype)) for a, b in zip(X, ref_X))
        rc_a, summary_md, err_a, walls["aggregate_s"] = _tool("aggregate_grid", out_dir)
        with open(os.path.join(out_dir, "SUMMARY.json")) as fh:
            grid_summary = json.load(fh)
    print(json.dumps({"tools_long_run": {
        "killed_at_checkpoint": at, "attempts": result["attempts"],
        "iters": result["num_iters"], "phase5_iters": want_iters,
        "ranksX": result["ranksX"], "phase5_ranksX": tt_ranks(ref_X),
        "final_X_bit_equal_to_phase5": bit_equal, "converged": result["converged"],
        "slackness": result["complementary_slackness"],
        "primal_feas": result["feasibility_error"], "dual_feas": result["dual_feasibility_error"],
        "aggregate": grid_summary}}), flush=True)
    if at != LONG_RUN_KILL_AFTER or [a["from_iteration"] for a in result["attempts"]] != [0, at]:
        raise AssertionError(f"tools/long_run.py: killed at {at}, attempts {result['attempts']}")
    if not result["converged"]:
        raise AssertionError(f"tools/long_run.py: the resumed solve did not converge: {result}")
    if rc_a != 0 or grid_summary.get(problem, {}).get(str(dim), {}).get("seeds") != 1:
        raise AssertionError(f"tools/aggregate_grid.py: exit {rc_a}, {grid_summary}: "
                             f"{err_a[-2000:]}")

    with tempfile.TemporaryDirectory(prefix="ttipm_scaling_") as tmp:
        path = os.path.join(tmp, "scaling.json")
        rc, _, err, walls["scaling_s"] = _tool("scaling_bench", "--dim", TOOLS_SCALING[0],
                                               "--batches", TOOLS_SCALING[1], "--out", path)
        if rc != 0:
            raise AssertionError(f"tools/scaling_bench.py exited {rc}: {err[-3000:]}")
        with open(path) as fh:
            scaling = json.load(fh)
    print(json.dumps({"tools_scaling": scaling}), flush=True)
    if [r["B"] for r in scaling["rows"]] != [int(b) for b in TOOLS_SCALING[1].split(",")]:
        raise AssertionError(f"tools/scaling_bench.py: rows {scaling['rows']}")
    for r in scaling["rows"]:
        _launched_on_card(f"tools/scaling_bench.py B={r['B']}", r["launches"], r["plain_calls"])
    if batch_ref is not None:
        lhs, rhs, X0, Z0 = batch_ref["systems"][0]
    else:
        from ttipm_tpu_torch.checks import first_newton_system

        cfg = load_config(int(TOOLS_SCALING[0]))
        lhs, rhs, X0, Z0 = first_newton_system("maxcut", cfg, int(cfg["seeds"][0]),
                                               torch.device("cuda"))
    np.random.seed(BATCH_STEP["seed"])
    xs, zs, _ = tt_newton_step_batch([(lhs, rhs)], [X0], [Z0], **BATCH_STEP)
    row1 = scaling["rows"][0]
    diff = max(abs(row1["x_steps"][0] - float(xs[0])), abs(row1["z_steps"][0] - float(zs[0])))
    walls["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"tools_phase": {"scaling_b1_vs_here_max_abs_diff": diff, **walls}}),
          flush=True)
    if not diff <= STEP_BOUND:
        raise AssertionError(f"tools/scaling_bench.py: B = 1 steps {row1['x_steps'][0]}, "
                             f"{row1['z_steps'][0]} against {xs[0]}, {zs[0]} here")
    return walls


# Phase 14: the whole-solve path (config.set_fused_whole_solve) on phase 5's cell,
# and phase 7's inequality cell through the smallest-eigenvector program.
WHOLE_CELL = ("maxcut", 8, 24)


def _sync_files(caught, start=0):
    """The host syncs the port's files made among the warnings caught from
    index ``start`` on, by file."""
    return Counter(f for f in (os.path.relpath(w.filename, REPO) for w in caught[start:]
                               if "synchroniz" in str(w.message))
                   if f.startswith("ttipm_tpu_torch"))


def _sync_count(caught, start):
    return sum(_sync_files(caught, start).values())


class LayerProbe:
    """Within the block: the Newton solves (the fused ladder) and the
    step-size solves (both fused eigensolvers) of a solve on the card,
    timed (synchronised) with their host syncs
    (``torch.cuda.set_sync_debug_mode``), the sweep solves of four or more
    sweeps and the whole-solve programs that ran counted, and the peak
    device memory.  What runs inside ``excluded()`` (phase 5's kernel
    checks) is left out of the walls and the syncs.  ``first`` receives
    the first Newton system and the first pencil.  The whole-solve eigen
    programs' finishing directions are kept on the device and counted in
    ``record``, after the solve.  Phase 5 drives its switch-off solve
    inside one, phase 14 its switch-on solves."""

    def __init__(self, first=None):
        self.first = first
        self.layers = {k: {"calls": 0, "s": 0.0, "syncs": 0} for k in ("newton", "step")}
        self.programs = Counter()
        self.finishes = {}  # program -> its finishing directions (device tensors)
        self.caught = []
        self.excluded_s = 0.0
        self.peak_bytes = 0

    def __enter__(self):
        import warnings

        import torch

        import ttipm_tpu_torch.ipm as ipm
        from ttipm_tpu_torch.solvers import fused as TF
        from ttipm_tpu_torch.solvers import fused_eigen_batch as feb

        targets = {(ipm, "tt_restarted_block_amen_fused"): "newton",
                   (ipm, "tt_max_generalised_eigen_fused"): "step",
                   (ipm, "tt_min_eig_fused"): "step",
                   (TF, "tt_block_amen_fused"): "sweep_solves",
                   (TF, "solve_program"): "solve_program",
                   (feb, "gen_eigen_single"): "gen_eigen_single",
                   (feb, "min_eig_program"): "min_eig_program"}
        self._saved = {key: getattr(*key) for key in targets}
        for key, kind in targets.items():
            setattr(*key, self._wrap(self._saved[key], kind))
        self._warnings = warnings.catch_warnings(record=True)
        self.caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self.peak_bytes = torch.cuda.max_memory_allocated()
        self._warnings.__exit__(*exc)
        for key, fn in self._saved.items():
            setattr(*key, fn)
        return False

    def _wrap(self, fn, kind):
        import torch

        def layer(*a, **kw):
            if self.first is not None and kind not in self.first:
                self.first[kind] = (a[0], a[1])
            torch.cuda.synchronize()
            t0, n0, x0 = time.perf_counter(), len(self.caught), self.excluded_s
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.layers[kind]["calls"] += 1
                self.layers[kind]["s"] += time.perf_counter() - t0 - (self.excluded_s - x0)
                self.layers[kind]["syncs"] += _sync_count(self.caught, n0)

        def counted(*a, **kw):
            if kind != "sweep_solves" or kw.get("nswp", 22) >= 4:
                self.programs[kind] += 1
            out = fn(*a, **kw)
            if kind in ("gen_eigen_single", "min_eig_program"):
                self.finishes.setdefault(kind, []).append(out[-1])
            return out
        return layer if kind in self.layers else counted

    @contextlib.contextmanager
    def excluded(self):
        """A span left out of the walls and the syncs (its device work
        included: synchronised on both sides)."""
        import torch

        n0 = len(self.caught)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.excluded_s += time.perf_counter() - t0
            del self.caught[n0:]

    def finishing_sweeps(self):
        """Each whole-solve eigen program's finishing sweeps by direction."""
        import torch

        out = {}
        for kind, dirs in self.finishes.items():
            got = torch.cat(dirs).tolist()
            out[kind] = {name: got.count(code) for name, code in
                         (("backward", -1), ("forward", 1), ("none", 0))}
        return out

    def record(self, solve_res, wall_s):
        """The solve's record: ``solve_res``'s iterations and residuals, its
        wall ``wall_s`` less the excluded spans, and what the probe saw."""
        from ttipm_tpu_torch.ops import kernels as K
        from ttipm_tpu_torch.solvers import graphs

        return {
            **{k: solve_res[k] for k in ("iters", "slack", "primal_feas", "dual_feas")},
            "wall_s": wall_s - self.excluded_s, "excluded_s": self.excluded_s,
            "peak_mb": self.peak_bytes / 1e6,
            "host_syncs": _sync_count(self.caught, 0),
            "host_syncs_by_file": dict(_sync_files(self.caught).most_common(8)),
            **{f"{k}_solves": v["calls"] for k, v in self.layers.items()},
            **{f"{k}_s_per_solve": v["s"] / max(v["calls"], 1) for k, v in self.layers.items()},
            **{f"{k}_syncs_per_solve": v["syncs"] / max(v["calls"], 1)
               for k, v in self.layers.items()},
            "programs": dict(self.programs), "graph_steps": graphs.STATS.as_dict(),
            "finishing_sweeps": self.finishing_sweeps(),
            "launches": {n: s.launches for n, s in K.STATS.items()},
            "plain_calls": sum(s.plain_calls for s in K.STATS.values()),
            "outside": {n: s.outside for n, s in K.STATS.items() if s.outside},
        }


def whole_drive(problem, dim, seed, whole, first=None):
    """<problem> d<dim> seed <seed> on the card at configs/<problem>_<dim>.yaml's
    settings with the whole-solve switch ``whole``, inside a ``LayerProbe``
    (``first``: see there): maxcut through phase 5's ``solve``, the other
    problems through the runner's ``run_and_record`` (quiet).  Returns the
    probe's record; raises if the solve did not converge or a plain version
    ran on a CUDA tensor."""
    import torch

    from ttipm_tpu_torch import config as tconfig
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.solvers import graphs
    from ttipm_tpu_torch.utils import runner

    cfg = load_config(dim, problem)
    tconfig.set_fused_whole_solve(whole)
    graphs.reset()
    K.reset_counts()
    try:
        with LayerProbe(first) as probe:
            if problem == "maxcut":
                out = solve(dim, seed, torch.device("cuda"), ipm_settings(cfg))
                wall = out["wall_s"]
            else:
                cfg.update(verbose=False)
                args = argparse.Namespace(device="cuda", track_mem=False, rank=1,
                                          config=config_path(dim, problem))
                rec = runner.new_record(1, runner.bond_count(problem, dim))
                runner.run_and_record(seed, 0, 1, cfg, args, runner.load_problem(problem), rec)
                out = {"iters": int(rec["num_iters"][0]),
                       "slack": float(rec["complementary_slackness"][0]),
                       "primal_feas": float(rec["feasibility_errors"][0]),
                       "dual_feas": float(rec["dual_feasibility_errors"][0])}
                wall = float(rec["runtimes"][0])
    finally:
        tconfig.set_fused_whole_solve(None)
    res = {"problem": problem, "dim": dim, "seed": seed, "whole": whole,
           **probe.record(out, wall)}
    abs_tol = float(cfg["abs_tol"])
    if not (res["slack"] < abs_tol and res["primal_feas"] < abs_tol
            and res["dual_feas"] < abs_tol):
        raise AssertionError(f"whole-solve {problem} d{dim} seed {seed} did not converge: {res}")
    if res["plain_calls"]:
        raise AssertionError(f"a plain version ran on CUDA tensors: {res}")
    return res


def whole_bits(first):
    """The first Newton system (all four pairs of nswp = 12: term_tol and
    eps 0) and the first pencil of a whole-solve run, through the programs
    with their steps run eagerly, then captured (the warmups' results) and
    replayed, then replayed only: the same bits.  Returns {"newton": ...,
    "step": ...}: the three runs' walls (synchronised) and the graph
    counts."""
    import torch

    from ttipm_tpu_torch import config as tconfig
    from ttipm_tpu_torch.solvers import fused as TF
    from ttipm_tpu_torch.solvers import fused_eigen as TE
    from ttipm_tpu_torch.solvers import graphs

    def run(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve_once(kind)
        torch.cuda.synchronize()
        walls.setdefault(kind, []).append(time.perf_counter() - t0)
        return out

    def solve_once(kind):
        if kind == "newton":
            x, res = TF.tt_block_amen_fused(*first["newton"], 0.0, R=8, eps=0.0, nswp=12,
                                            rng=np.random.RandomState(0))
            return list(x) + [torch.tensor(res)]
        step, v = TE.tt_max_generalised_eigen_fused(*first["step"], tol=1e-8,
                                                    rng=np.random.RandomState(0))
        return list(v) + [torch.tensor(step)]

    tconfig.set_fused_whole_solve(True)
    out, walls = {}, {}
    try:
        for kind in ("newton", "step"):
            graphs.reset()
            with graphs.eager():
                ref = run(kind)
            got = run(kind)   # captures (the warmups' results) and replays
            again = run(kind)  # replays only
            same = all(torch.equal(a, b) for a, b in zip(ref, got)) and all(
                torch.equal(a, b) for a, b in zip(ref, again))
            out[kind] = {"bit_equal": same, "eager_s": walls[kind][0],
                         "capture_s": walls[kind][1], "replay_s": walls[kind][2],
                         **graphs.STATS.as_dict()}
            if not same:
                raise AssertionError(f"whole-solve {kind}: graphed and eager runs differ: {out}")
    finally:
        tconfig.set_fused_whole_solve(None)
        graphs.reset()
    return out


def phase_whole(slice_iters=None, eager_loop=None):
    """Phase 14: the whole-solve path.  maxcut d8 seed 24 with the switch on,
    beside the switch-off run ``eager_loop`` (phase 5's solve of the cell,
    its kernel checks left out; solved here when phase 5 ran another
    cell or did not run); the switch-on solve converged, every sweep solve
    of four or more sweeps through ``solve_program`` and every step-size
    solve through the generalised program, captures > 0 and replays >
    captures; the first Newton system and the first pencil bit-equal
    graphed and eager (and timed both ways).  Prints the runs side by
    side, and the switch-on solve's finishing sweeps by direction beside
    its iterations and phase 5's.  Corr_clust d6 is ``phase_whole_ineq``,
    a worker."""
    first = {}
    runs = {"eager_loop": eager_loop or whole_drive(*WHOLE_CELL, False),
            "whole": whole_drive(*WHOLE_CELL, True, first=first)}
    print(json.dumps({"whole": runs, "slice_iters": slice_iters}), flush=True)
    on = runs["whole"]
    print(json.dumps({"whole_finish": {
        "cell": "maxcut d8 seed 24", "finishing_sweeps": on["finishing_sweeps"],
        "iters": on["iters"], "eager_loop_iters": runs["eager_loop"]["iters"],
        "phase5_iters": slice_iters}}), flush=True)
    steps = on["graph_steps"]
    if on["programs"].get("solve_program", 0) != on["programs"].get("sweep_solves", 0):
        raise AssertionError(f"a sweep solve of four or more sweeps missed solve_program: {on}")
    if on["programs"].get("gen_eigen_single", 0) != on["step_solves"]:
        raise AssertionError(f"a step-size solve missed the generalised program: {on}")
    if not 0 < steps["captures"] < steps["replays"]:
        raise AssertionError(f"whole-solve graphs: captures {steps['captures']}, replays "
                             f"{steps['replays']}")
    bits = whole_bits(first)
    print(json.dumps({"whole_bits": bits}), flush=True)


def phase_whole_ineq():
    """Phase 14's second part (a worker): corr_clust d6 seed 764 (phase 7's
    cell) with the switch on, converged through ``min_eig_program``; its
    finishing sweeps by direction beside its iterations."""
    ineq = whole_drive(*INEQ_CELL, True)
    print(json.dumps({"whole_ineq": ineq}), flush=True)
    print(json.dumps({"whole_finish": {
        "cell": "corr_clust d6 seed 764", "finishing_sweeps": ineq["finishing_sweeps"],
        "iters": ineq["iters"]}}), flush=True)
    if not ineq["programs"].get("min_eig_program"):
        raise AssertionError(f"corr_clust d6: min_eig_program did not run: {ineq}")


PHASES = ("kernels", "parity", "slice", "fallback", "ineq", "graphm", "f32", "batch", "mesh",
          "baselines", "tools", "whole")

# The worker jobs, longest first: each runs in a process of its own on the
# card while the parent runs parity and the mesh; none times anything that
# PERF.md's tables take (the parent times phases 6-9's heaviest shapes
# after they have joined).  A job gets phase 5's iterations and final X.
JOBS = {
    "f32": lambda inp: phase_f32(*F32_CELL),
    "tools": lambda inp: phase_tools(inp["slice_iters"], inp["slice_X"], None),
    "fallback": lambda inp: phase_fallback(*FALLBACK_CELL),
    "graphm": lambda inp: phase_graphm(*GRAPHM_CELL),
    "run_batch": lambda inp: phase_run_batch(inp["slice_iters"]),
    "ineq": lambda inp: phase_ineq(*INEQ_CELL),
    "whole_ineq": lambda inp: phase_whole_ineq(),
}
# The phase each job belongs to (its name where it is the phase's).
JOB_PHASE = {"run_batch": "batch", "whole_ineq": "whole"}
WORKER_TIMEOUT_S = 900


def worker_command(argv=()):
    """The command of a job: ``python3 chip_smoke.py --worker JOB
    --worker-dir DIR`` and ``argv``."""
    def command(job, worker_dir):
        return [sys.executable, os.path.abspath(__file__), "--worker", job, "--worker-dir",
                worker_dir, *argv]
    return command


class Workers:
    """The jobs named ``jobs``, each the process ``command(job, dir)``
    (``worker_command``: ``worker_main``, which runs ``JOBS[job]`` on the
    card, loading the library phase 2 built; it never builds), at most
    ``limit`` at a time (a thread pool of ``limit`` threads, each waiting
    on its process), ``inputs`` pickled to ``dir/inputs.pkl``, a temporary
    directory where a job writes its result (``dir/JOB.pkl``: {"result":
    ..., "wall_s": ...}); its output and errors go to files there.
    ``join`` waits for all, prints each job's output and errors in
    ``jobs``' order, and raises if any exited non-zero or ran past
    ``timeout_s`` (then killed); leaving the block kills every job still
    running, starts no other and removes the directory."""

    def __init__(self, jobs, inputs, limit, command, timeout_s=WORKER_TIMEOUT_S):
        import pickle
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self.jobs, self.command, self.timeout_s = list(jobs), command, timeout_s
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_workers_")
        with open(os.path.join(self.dir, "inputs.pkl"), "wb") as fh:
            pickle.dump(inputs, fh)
        self.procs, self.walls = {}, {}
        self._lock, self._closing = threading.Lock(), False
        self._pool = ThreadPoolExecutor(max_workers=max(1, limit))

    def __enter__(self):
        self._failures = {job: self._pool.submit(self._run, job) for job in self.jobs}
        return self

    def _path(self, job, ext):
        return os.path.join(self.dir, f"{job}.{ext}")

    def _run(self, job):
        """Runs ``job`` to its end; returns why it failed, or None."""
        t0 = time.perf_counter()
        with self._lock:
            if self._closing:
                return "not started"
            with open(self._path(job, "out"), "w") as out, \
                    open(self._path(job, "err"), "w") as err:
                proc = self.procs[job] = subprocess.Popen(self.command(job, self.dir), cwd=REPO,
                                                          stdout=out, stderr=err)
        try:
            code = proc.wait(timeout=self.timeout_s)
            failure = f"exit {code}" if code else None
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failure = f"killed after {self.timeout_s} s"
        self.walls[job] = time.perf_counter() - t0
        return failure

    def join(self):
        """{job: its result}; prints each job's output and errors."""
        import pickle

        results, failed = {}, {}
        for job in self.jobs:
            failure = self._failures[job].result()
            with open(self._path(job, "out")) as fh:
                sys.stdout.write(fh.read())
            with open(self._path(job, "err")) as fh:
                err = fh.read()
            sys.stderr.write(err)
            sys.stdout.flush()
            if failure:
                failed[job] = f"{failure}: {err[-3000:]}"
                continue
            with open(self._path(job, "pkl"), "rb") as fh:
                results[job] = pickle.load(fh)
        if failed:
            raise AssertionError(f"worker jobs failed: {failed}")
        return results

    def __exit__(self, *exc):
        import shutil

        with self._lock:
            self._closing = True
            for proc in self.procs.values():
                if proc.poll() is None:
                    proc.kill()
        self._pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(self.dir, ignore_errors=True)
        return False


def worker_main(job, worker_dir):
    """A job of ``Workers`` (``--worker``): its result pickled to
    ``worker_dir``, with its wall."""
    import pickle

    import torch

    from ttipm_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke worker: no CUDA device")
    if not os.path.exists(_build.library_path()):
        raise SystemExit(f"chip_smoke worker {job}: no kernel library at "
                         f"{_build.library_path()} (phase 2 builds it)")
    _build.load_library()
    with open(os.path.join(worker_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    t0 = time.perf_counter()
    result = JOBS[job](inputs)
    with open(os.path.join(worker_dir, f"{job}.pkl"), "wb") as fh:
        pickle.dump({"result": result, "wall_s": time.perf_counter() - t0}, fh)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=24)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES) + " (device and "
                         "build always run); the result lines are printed only for all")
    ap.add_argument("--j1-from", type=int, default=None,
                    help="J1's regime crossover for the run (kernels.J1_BLOCK_FROM); the "
                         "result lines are printed only without it")
    ap.add_argument("--worker", choices=tuple(JOBS), default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    sys.path.insert(0, REPO)
    if args.j1_from is not None:
        from ttipm_tpu_torch.ops import kernels as K

        K.J1_BLOCK_FROM = args.j1_from
        K.j1_plan.cache_clear()
    if args.worker is not None:
        return worker_main(args.worker, args.worker_dir)

    phase_s = {}

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[label] = time.perf_counter() - t0

    # alone on the card: every time that PERF.md's tables take
    name = timed("device", phase_device)
    timed("build", phase_build)
    summary = timed("kernels", phase_kernels) if "kernels" in phases else None
    ipm_X = {}
    counts, slice_iters, slice_layers = None, None, None
    if "slice" in phases:
        counts, slice_iters, ipm_X[(args.dim, args.seed)], slice_layers = timed(
            "slice", phase_slice, args.dim, args.seed)
    summary_batch, batch_ref = (timed("batch", phase_batch) if "batch" in phases
                                else (None, None))
    if "whole" in phases:
        timed("whole", phase_whole, slice_iters,
              slice_layers if (args.dim, args.seed) == WHOLE_CELL[1:] else None)

    # the solves that only solve and check: worker processes, while the
    # parent runs parity and the mesh
    jobs = [job for job in JOBS if JOB_PHASE.get(job, job) in phases]
    slice_X = ipm_X.get((8, 24)) if (args.dim, args.seed) == (8, 24) else None
    inputs = {"slice_iters": slice_iters,
              "slice_X": None if slice_X is None else [c.cpu() for c in slice_X]}
    cpus = os.cpu_count() or 1
    limit = max(1, min(len(jobs), cpus - 1))
    print(json.dumps({"concurrent": {"cpu_count": cpus, "workers": limit, "jobs": jobs,
                                     "in_parent": [p for p in ("parity", "mesh")
                                                   if p in phases]}}), flush=True)
    t_block = time.perf_counter()
    launches_mesh = None
    argv_j1 = [] if args.j1_from is None else ["--j1-from", str(args.j1_from)]
    with Workers(jobs, inputs, limit, worker_command(argv_j1)) as workers:
        if "parity" in phases:
            timed("parity", phase_parity)
        if "mesh" in phases:
            launches_mesh = timed("mesh", phase_mesh,
                                  batch_ref if batch_ref is not None else batch_reference())
        del batch_ref
        results = workers.join()
        walls = dict(workers.walls)
    phase_s["concurrent_block"] = time.perf_counter() - t_block
    phase_s.update({f"worker_{job}": walls[job] for job in jobs})

    # alone again: the heaviest shapes of phases 6-9, the baselines
    out = {job: r["result"] for job, r in results.items()}
    counts_fb = counts_ineq = counts_gm = summary_f32 = None
    for job in ("fallback", "ineq", "graphm"):
        if job in out:
            timed(f"{job}_times", timed_heaviest, out[job])
    if "fallback" in out:
        counts_fb = out["fallback"]["counts"]
        ipm_X[FALLBACK_CELL[1:]] = [c.cuda() for c in out["fallback"]["X"]]
    counts_ineq = out["ineq"]["counts"] if "ineq" in out else None
    counts_gm = out["graphm"]["counts"] if "graphm" in out else None
    if "f32" in out:
        summary_f32 = timed("f32_times", f32_times, out["f32"])
    if "baselines" in phases:
        cells = [(dim, seed) for _, dim, seed, _ in BASELINE_CELLS]
        timed("baselines", lambda: phase_baselines(
            {**ipm_reference([c for c in cells if c not in ipm_X]), **ipm_X}))
    print(json.dumps({"phase_s": phase_s}), flush=True)
    if set(phases) != set(PHASES) or args.j1_from is not None:
        return 0

    record = [
        {"name": n, "dtype": "float64", "route": "cuda", "source": KERNELS[n][0],
         "replaces": KERNELS[n][1], "launches": counts[n][0], "launches_d10": counts_fb[n][0],
         "launches_ineq": counts_ineq[n][0], "launches_graphm": counts_gm[n][0], **summary[n],
         **summary_batch[n]["f64"], "batch": summary_batch[n]["batch"],
         "launches_mesh": {world: runs[n] for world, runs in launches_mesh.items()},
         **jacobi_regimes(n)}
        for n in KERNELS
    ] + [
        {"name": f"{n}_f32", "dtype": "float32", "route": "cuda", "source": KERNELS[n][0],
         "replaces": KERNELS[n][1], **summary_f32[n], **summary_batch[n]["f32"]}
        for n in F32_KERNELS
    ]
    import torch

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
