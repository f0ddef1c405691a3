"""Where the batch axis stops paying on one card: batched Newton steps at B
= 1, 2, 4, 8.

Counterpart of ``scripts/scaling_bench.py`` for the port.  For each B it
times one ``parallel.fused_mesh.tt_newton_step_batch`` of B instances
(``mesh=None``) against the same B instances as B batches of one, each
call synchronised and preceded by ``np.random.seed(seed)`` (the eigen
starts), and reports per B: both walls, the seconds per instance, the
host syncs of the batched step (``torch.cuda.set_sync_debug_mode``), its
peak device memory, each kernel's launches and the instances they
carried, and the step sizes.  The batched step is first run once
uncounted (a warm-up), then counted (launches, syncs, memory), then
timed.

Instances:

* ``--dim 3``: the JAX script's synthetic systems, instance i built from
  ``RandomState(100 + i)`` (the construction of
  tests/test_fused.py::_make_kkt_system, drawn from that RandomState here),
  X_i = (1 + 0.05 i) I, Z_i = 2 I; R = 12, seed 1 (the JAX script's
  settings).
* ``--dim`` 4 and above (10 by default): the first Newton systems of
  configs/maxcut_<dim>.yaml's seeds as ``tt_ipm`` builds them
  (``checks.first_newton_system``); instance i is seed i mod (the config's
  seed count), so at B = 8 the first three seeds come twice; R = 16,
  R_eig = 8, nswp = 12, seed 5 (chip_smoke.py's phase 10).

``--ranks S`` repeats every row on a seeds-only mesh of S ranks
(``parallel.mesh.spawn_mesh``; ranks sharing the card use gloo), each
rank reporting its wall, its collectives and their bytes (the mesh's own
counters), its peak memory and launches.  XLA's collective count of the
JAX script has no counterpart.

    python -m ttipm_tpu_torch.tools.scaling_bench [--dim 10] [--batches 1,2,4,8] [--ranks 2]
    python -m ttipm_tpu_torch.tools.scaling_bench --dim 3 --batches 1,2 --device cpu

Prints one JSON line a row and writes results/scaling_torch.json (``--out``).
``--device cuda`` (the default) raises where there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from collections import Counter

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SYNTHETIC = {"R": 12, "seed": 1}
FULL = {"R": 16, "R_eig": 8, "nswp": 12, "seed": 5}


def synthetic_system(d: int, rng, device):
    """An equality KKT block system of the fused solver's key layout: SPD-ish
    (0, 0), (2, 1), (2, 2) blocks (0.05 of a random symmetric operator plus
    the identity), a random symmetric (0, 1) block and its transpose, the
    identity at (1, 2), random rhs rows; every draw from ``rng``."""
    from ttipm_tpu_torch.ops.random import tt_random_gaussian
    from ttipm_tpu_torch.ops.rounding import tt_rank_reduce
    from ttipm_tpu_torch.ops.tt import tt_add, tt_identity, tt_reshape, tt_scale
    from ttipm_tpu_torch.solvers.blocks import TTBlockMatrix, TTBlockVector

    def sym(rank):
        cores = tt_random_gaussian([rank] * (d - 1), (4, 4), device=device, rng=rng)
        return tt_rank_reduce([0.5 * (c + c.transpose(1, 2)) for c in cores], 1e-12)

    eye = tt_reshape(tt_identity(2 * d, device=device), (4, 4))

    def psd():
        return tt_rank_reduce(tt_add(tt_scale(0.05, sym(2)), eye), 1e-12)

    lhs = TTBlockMatrix()
    lhs[0, 0] = psd()
    lhs[0, 1] = sym(2)
    lhs.add_alias((0, 1), (1, 0), is_transpose=True)
    lhs[1, 2] = eye
    lhs[2, 1] = psd()
    lhs[2, 2] = psd()
    rhs = TTBlockVector()
    for i in range(3):
        rhs[i] = tt_random_gaussian([2] * (d - 1), (4,), device=device, rng=rng)
    return lhs, rhs


def make_instances(dim: int, count: int, device):
    """(systems, Xs, Zs, step settings) of ``count`` instances (docstring)."""
    from ttipm_tpu_torch.ops.tt import tt_identity, tt_scale

    if dim == 3:
        systems, Xs, Zs = [], [], []
        for i in range(count):
            systems.append(synthetic_system(dim, np.random.RandomState(100 + i), device))
            Xs.append(tt_scale(1.0 + 0.05 * i, tt_identity(dim, device=device)))
            Zs.append(tt_scale(2.0, tt_identity(dim, device=device)))
        return systems, Xs, Zs, dict(SYNTHETIC)
    from ttipm_tpu_torch.checks import first_newton_system
    from ttipm_tpu_torch.utils.runner import load_yaml

    cfg = load_yaml(os.path.join(REPO, "configs", f"maxcut_{dim}.yaml"))
    seeds = [int(s) for s in cfg["seeds"]]
    built = {}
    for s in seeds[:min(count, len(seeds))]:
        built[s] = first_newton_system("maxcut", cfg, s, device)
    inst = [built[seeds[i % len(seeds)]] for i in range(count)]
    return ([i[:2] for i in inst], [i[2] for i in inst], [i[3] for i in inst], dict(FULL))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_step(systems, Xs, Zs, settings, device, mesh=None):
    """(wall s, (x steps, z steps, directions)) of one synchronised step."""
    from ttipm_tpu_torch.parallel.fused_mesh import tt_newton_step_batch

    _sync(device)
    np.random.seed(settings["seed"])
    t0 = time.perf_counter()
    out = tt_newton_step_batch(systems, Xs, Zs, mesh=mesh, **settings)
    _sync(device)
    return time.perf_counter() - t0, out


def counted_step(systems, Xs, Zs, settings, device, mesh=None) -> dict:
    """Launches, instances, plain calls, host syncs (on the card, counted
    in ``ttipm_tpu_torch``) and peak memory of one step."""
    from ttipm_tpu_torch.ops import kernels as K

    K.reset_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            timed_step(systems, Xs, Zs, settings, device, mesh)
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    syncs = Counter(os.path.relpath(w.filename, REPO) for w in caught
                    if "synchroniz" in str(w.message))
    return {
        "launches": {n: s.launches for n, s in K.STATS.items()},
        "instances": {n: s.instances for n, s in K.STATS.items()},
        "plain_calls": {n: s.plain_calls for n, s in K.STATS.items()},
        "host_syncs": sum(c for f, c in syncs.items() if f.startswith("ttipm_tpu_torch"))
        if device.type == "cuda" else None,
        "peak_mb": torch.cuda.max_memory_allocated(device) / 1e6
        if device.type == "cuda" else None,
    }


def row(b: int, systems, Xs, Zs, settings, device) -> dict:
    sub = (systems[:b], Xs[:b], Zs[:b])
    timed_step(*sub, settings, device)  # warm-up
    counts = counted_step(*sub, settings, device)
    wall, (xs, zs, _) = timed_step(*sub, settings, device)
    singles = [timed_step([systems[i]], [Xs[i]], [Zs[i]], settings, device)[0]
               for i in range(b)]
    return {"B": b, "batch_wall_s": wall, "singles_wall_s": float(sum(singles)),
            "singles_s": singles, "s_per_instance": wall / b,
            "speedup_vs_singles": float(sum(singles)) / wall,
            "x_steps": [float(v) for v in xs], "z_steps": [float(v) for v in zs], **counts}


def mesh_rank(mesh, payload):
    """A row on this rank of a seeds-only mesh: the instances rebuilt from
    numpy, one warm-up and one counted step, then a timed one."""
    from ttipm_tpu_torch.interop import block_matrix_to_torch, block_vector_to_torch, tt_to_torch

    dev = mesh.device
    systems = [(block_matrix_to_torch(*lhs, device=dev), block_vector_to_torch(rhs, device=dev))
               for lhs, rhs in payload["systems"]]
    Xs = [tt_to_torch(X, device=dev) for X in payload["Xs"]]
    Zs = [tt_to_torch(Z, device=dev) for Z in payload["Zs"]]
    settings = payload["settings"]
    timed_step(systems, Xs, Zs, settings, dev, mesh)
    counts = counted_step(systems, Xs, Zs, settings, dev, mesh)
    before = mesh.stats.as_dict()
    wall, (xs, zs, _) = timed_step(systems, Xs, Zs, settings, dev, mesh)
    return {"rank": mesh.rank, "wall_s": wall,
            "collectives": {k: v - before[k] for k, v in mesh.stats.as_dict().items()},
            "x_steps": [float(v) for v in xs], **counts}


def mesh_row(b: int, ranks: int, systems, Xs, Zs, settings, device) -> dict:
    from ttipm_tpu_torch.interop import block_matrix_to_numpy, block_vector_to_numpy, tt_to_numpy
    from ttipm_tpu_torch.parallel.mesh import spawn_mesh

    payload = {"systems": [(block_matrix_to_numpy(lhs), block_vector_to_numpy(rhs))
                           for lhs, rhs in systems[:b]],
               "Xs": [tt_to_numpy(X) for X in Xs[:b]], "Zs": [tt_to_numpy(Z) for Z in Zs[:b]],
               "settings": settings}
    where = "cuda:0" if device.type == "cuda" else "cpu"
    backend = "gloo"
    t0 = time.perf_counter()
    from ttipm_tpu_torch.tools import scaling_bench  # importable by name in the spawned ranks

    per_rank = spawn_mesh(scaling_bench.mesh_rank, ranks, 1, where, backend, args=(payload,))
    return {"B": b, "ranks": ranks, "backend": backend, "device": where,
            "spawn_and_run_s": time.perf_counter() - t0, "per_rank": per_rank}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--ranks", type=int, default=0,
                    help="also run every row on a seeds-only mesh of this many ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(REPO, "results", "scaling_torch.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling_bench: no CUDA device (pass --device cpu to run on the CPU)")
    batches = [int(b) for b in args.batches.split(",")]
    t0 = time.perf_counter()
    systems, Xs, Zs, settings = make_instances(args.dim, max(batches), device)
    build_s = time.perf_counter() - t0
    rows, mesh_rows = [], []
    for b in batches:
        rows.append(row(b, systems, Xs, Zs, settings, device))
        print(json.dumps(rows[-1]), flush=True)
        if args.ranks > 1:
            mesh_rows.append(mesh_row(b, args.ranks, systems, Xs, Zs, settings, device))
            print(json.dumps(mesh_rows[-1]), flush=True)
    out = {"dim": args.dim, "settings": settings, "build_s": build_s,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "rows": rows, "mesh_rows": mesh_rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"scaling": [{k: r[k] for k in ("B", "batch_wall_s", "singles_wall_s",
                                                      "s_per_instance", "speedup_vs_singles")}
                                  for r in rows], "out": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
