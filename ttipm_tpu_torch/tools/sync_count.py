"""Host synchronisations and dense factorizations of a MaxCut solve, with
the Jacobi kernels and with cuSOLVER.

Solves maxcut at each (dim, seed) of ``--cells`` on the card twice: with
the port's route (every SVD and eigh through J1 / J2, ``ops/jacobi.py``)
and with ``jacobi.forced(False)`` (every SVD and eigh through
``torch.linalg``: cuSOLVER, the route before the Jacobi kernels), in turns
(jacobi, cusolver, cusolver, jacobi).  Each solve runs with the port's
trace counting host syncs (``trace.enable(syncs=True)``: under
``torch.cuda.set_sync_debug_mode("warn")``; the problem is built before,
on the default route), and the host synchronisations the port's files
make are read from it by file and line.  One JSON line a
solve: mode, wall (synchronised; the warnings cost some of it), iterations,
slackness, syncs in all and the ten busiest lines, the factorizations
(J1 and J2 instances, and those a shape rule sent to ``torch.linalg``) and
the kernels' launches.  The first line is the card (nvidia-smi).

    python -m ttipm_tpu_torch.tools.sync_count --cells 8:24,10:41
"""

from __future__ import annotations

import argparse
import json
import time
import warnings
from collections import Counter

import torch

from ttipm_tpu_torch import trace
from ttipm_tpu_torch.tools.bench import _load_config, device_line


def solve_counted(dim: int, seed: int, cusolver: bool) -> dict:
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import jacobi
    from ttipm_tpu_torch.ops import kernels as K
    from ttipm_tpu_torch.ops.tt import tt_inner_prod
    from ttipm_tpu_torch.utils.runner import ipm_kwargs, seeded_problem

    cfg = _load_config(dim)
    device = torch.device("cuda")
    lag_maps, obj, L, bias, _ = seeded_problem(create_problem, dim, 1, seed, device)
    K.reset_counts()
    torch.cuda.synchronize()
    # the trace counts the syncs; the warnings it passes on are kept quiet here
    with jacobi.forced(False if cusolver else None), warnings.catch_warnings(record=True):
        trace.enable(syncs=True)
        try:
            t0 = time.perf_counter()
            X, _, _, Z, info = tt_ipm(lag_maps, obj, L, bias,
                                      **{**ipm_kwargs(cfg), "verbose": False})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by_line = trace.take()["syncs_by_line"]
        finally:
            trace.disable()
    lines = Counter({k: v for k, v in by_line.items() if k.startswith("ttipm_tpu_torch")})
    return {"dim": dim, "seed": seed, "mode": "cusolver" if cusolver else "jacobi",
            "wall_s": wall, "iters": int(info["num_iters"]),
            "slackness": abs(float(tt_inner_prod(X, Z))), "host_syncs": sum(lines.values()),
            "busiest_lines": lines.most_common(10),
            "svd_instances": K.STATS["jacobi_svd"].instances,
            "svd_outside": K.STATS["jacobi_svd"].outside,
            "eigh_instances": K.STATS["jacobi_eigh"].instances,
            "eigh_outside": K.STATS["jacobi_eigh"].outside,
            "qr_outside": K.STATS["panel_qr"].outside,
            "launches": {n: s.launches for n, s in K.STATS.items()},
            "plain_calls": sum(s.plain_calls for s in K.STATS.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="8:24,10:41", help="dim:seed,...")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sync_count: no CUDA device")
    print(device_line(torch.device("cuda")), flush=True)
    for cell in args.cells.split(","):
        dim, seed = (int(x) for x in cell.split(":"))
        for cusolver in (False, True, True, False):
            print(json.dumps(solve_counted(dim, seed, cusolver)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
