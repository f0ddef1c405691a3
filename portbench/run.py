#!/usr/bin/env python3
"""The benchmark of ttipm_tpu_torch, the PyTorch and CUDA port, on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix
(``catalog.py``).  Set-up builds the kernels where the checkout has none,
draws the configuration's instances (``families/``), hands them to the
program as trains, and warms up with the first iterations of one of them.
The window is a closed loop: the program solves the instances one after
another, in the order ``--seed`` gives (``traffic.py``), round after
round, until ``--seconds`` have passed; the round in flight runs to its
end.  Then the program's state is freed and the plain reference
(``reference/``) judges every answer the window produced.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (solves), ``failed`` (solves that raised or that the
reference finds unconverged), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones, each from
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit, also printed as the
last lines of standard error.

``--control`` runs the program's float32 profile in place of the
configuration's precision: the control that the comparison has to fail
(``tests/test_portbench_control.py``).  The exit code is 0 for a result
and not 0 without one: no card, too few cards, an unknown name, or JAX
or the JAX package loaded.
"""

from __future__ import annotations

import time

T_START_NS = time.monotonic_ns()  # the set-up is measured from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One host thread for the process's CPU libraries: the program is paced by
# its Python dispatch, and a pool of threads on shared cores only adds
# jitter (maxcut d8 on an H100's host: 29.8 s a solve with one thread,
# 31.7-33.6 s with eight).  Set before numpy and torch are imported.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import catalog, guard  # noqa: E402

__all__ = ["main", "run_cell"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program's float32 profile (the comparison's control)")
    return ap


def _judge(cell, solves) -> dict:
    """Every answer against the plain reference: the worst reading of each
    number over the answers, and the solves that did not converge."""
    import numpy as np

    from portbench.reference.sdp import judge
    from portbench.reference.tt import dense_matrix

    family = catalog.family(cell.config["family"])
    problems = {s.instance_seed: family.problem(cell.config,
                                                np.random.RandomState(s.instance_seed))
                for s in solves}
    worst, unconverged = {}, 0
    for s in solves:
        if s.result is None:
            continue
        X, Y, Z, T = (None if t is None else dense_matrix(t) for t in s.result)
        numbers = judge(problems[s.instance_seed], X, Y, Z, T)
        print(f"solve of instance {s.instance_seed}: {s.wall_s:.3f} s, {s.iters} iterations, "
              f"inequalities {s.ineq_status}, "
              + ", ".join(f"{k} {v:.3e}" for k, v in numbers.items()), file=sys.stderr)
        unconverged += numbers["kkt"] > float(cell.config["abs_tol"])
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return {"worst": worst, "unconverged": unconverged}


def run_cell(cell: catalog.Cell, seed: int, seconds: float, trace: bool, device: str,
             metric_entries, control: bool = False, t_start_ns: int = None) -> dict:
    """One run of ``cell``; returns the result object of the last line."""
    import torch

    from portbench import program
    from portbench.traffic import schedule

    t_start_ns = T_START_NS if t_start_ns is None else t_start_ns
    dev = torch.device(device)
    precision = "float32" if control else cell.config["dtype"]
    dtype = program.set_profile(precision, cell.traffic["whole_solve"])
    program.build(dev)

    family = catalog.family(cell.config["family"])
    instances = [program.instance(family, cell.config, s, dev, dtype)
                 for s in schedule(cell.config, cell.traffic, seed)]
    kwargs = program.settings(cell.config)
    program.warm_up(instances[0], kwargs, int(cell.traffic["warmup_max_iter"]), dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    from ttipm_tpu_torch.ops import kernels

    launches0 = sum(s.launches for s in kernels.STATS.values())
    window0 = time.monotonic_ns()
    setup_s = (window0 - t_start_ns) / 1e9

    tracer = None
    if trace:
        from portbench.trace import Tracer

        tracer = Tracer(dev)
        traced_seed = int(cell.config["seeds"][0])  # the instance whose solve the device trace covers
        with tracer:
            solves = program.closed_loop(
                instances, kwargs, seconds, dev,
                around=lambda inst: (tracer.device_trace() if inst.seed == traced_seed
                                     else contextlib.nullcontext()))
    else:
        solves = program.closed_loop(instances, kwargs, seconds, dev)
    window1 = solves[-1].end_ns  # the window ends with its last solve
    launches = sum(s.launches for s in kernels.STATS.values()) - launches0

    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    program.answers(solves)
    del instances
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = {"solves": solves, "setup_s": setup_s, "window_s": (window1 - window0) / 1e9,
           "launches": launches, "spans": {}, "counters": {}, "bound_s": {}, "device": None}
    if tracer is not None:
        t0 = time.monotonic()
        traced = next(s for s in solves if s.instance_seed == traced_seed)
        run.update(spans=dict(tracer.spans), counters=dict(tracer.counters),
                   bound_s=dict(tracer.bound_s),
                   device=tracer.device_summary((traced.start_ns, traced.end_ns),
                                                [(traced.start_ns, traced.end_ns)]))
        print(f"trace: the solve of instance {traced_seed}, {traced.wall_s:.1f} s, "
              f"{(run['device'] or {}).get('activities', 0)} device activities read in "
              f"{time.monotonic() - t0:.1f} s", file=sys.stderr)

    verdict = _judge(cell, solves)
    raised = sum(s.error is not None for s in solves)
    limits = cell.config["limits"]
    checks = {name: {"value": verdict["worst"].get(name), "limit": float(limit)}
              for name, limit in limits.items()}
    correct = (raised == 0 and verdict["unconverged"] == 0 and bool(solves)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    metrics = {}
    for entry in metric_entries:
        value = catalog.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(solves),
              "failed": raised + verdict["unconverged"], "metrics": metrics,
              "device": device_info}
    if tracer is not None:
        busy = run["device"]
        device_info["busy_s"] = busy["busy_s"] if busy else 0.0
        device_info["window_s"] = busy["window_s"] if busy else run["window_s"]
        if busy:
            result["breakdown"] = {"device_ops": [list(x) for x in busy["device_ops"]],
                                   "idle_gaps": [list(x) for x in busy["idle_gaps"]]}
    errors = [s.error for s in solves if s.error]
    if errors:
        print(f"solves that raised: {len(errors)}; the first: {errors[0]}", file=sys.stderr)
    result["checks"] = {**checks, "failed": {"value": result["failed"], "limit": 0}}
    return result


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        bench = catalog.benchmark()
        cell = catalog.cell(bench, args.workload)
    except (OSError, catalog.UnknownName) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    kind = "per_layer" if args.trace else "end_to_end"
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      catalog.metrics(bench, cell.name, kind), control=args.control)
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
