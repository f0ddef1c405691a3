"""A resumable solve of one (problem, dim, seed) on the card.

Counterpart of ``scripts/long_run.py`` for ``ttipm_tpu_torch``: for solves
too long for one uninterrupted run, it checkpoints every iteration and, run
again, resumes from the last checkpoint on disk, so it can be killed and
restarted freely.  The problem comes from the runner's problem factories
(``utils.runner.seeded_problem``: numpy's global stream seeded with the
config's seed) and solved by ``ipm.tt_ipm`` at the config's settings, with
``checkpoint_path=ckpt.npz, checkpoint_every=1, resume_from=ckpt.npz``
when the file exists.  Where ``result.json`` exists it does nothing.

    python -m ttipm_tpu_torch.tools.long_run --problem maxcut --dim 12 \\
        [--seed-index 0] [--rank 1] [--out results/long_torch] [--device cuda]

Writes <out>/<problem>_<dim>_s<idx>/:
    ckpt.npz     the iterates and scalar state, every iteration (the JAX
                 package's layout: either package resumes it)
    result.json  the final metrics: iterations, slackness, the squared
                 primal / dual feasibility errors, ranks, peak memory, the
                 wall of every attempt
    run.log      one JSON line an attempt's start, an iteration's
                 checkpoint (wall since the attempt started, peak memory)
                 and an attempt's end
    results/runner.json  the solve in the runner's results schema (the
                 attempts' summed wall as its runtime), so that
                 tools/aggregate_grid.py summarises a directory of long runs

``--kill-after N`` sends the process SIGKILL as soon as the checkpoint of
iteration N is on disk: an abrupt stop at a known iteration, to test the
resume.  ``--device cuda`` (the default) raises where there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(path: str, **fields) -> None:
    with open(path, "a") as fh:
        fh.write(json.dumps(fields) + "\n")


def attempts(log_path: str) -> list:
    """Per attempt of run.log: the iteration it started from and its wall up
    to its end or to its last checkpoint (a killed attempt)."""
    out = []
    if not os.path.exists(log_path):
        return out
    with open(log_path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["event"] == "start":
                out.append({"from_iteration": rec["from_iteration"], "solve_s": 0.0,
                            "last_iteration": rec["from_iteration"], "ended": False})
            elif rec["event"] == "checkpoint":
                out[-1].update(solve_s=rec["elapsed_s"], last_iteration=rec["iteration"])
            elif rec["event"] == "end":
                out[-1].update(solve_s=rec["solve_s"], ended=True)
    return out


def run(problem: str, dim: int, seed_index: int = 0, rank: int = 1, out: str = None,
        device: str = "cuda", kill_after: int = None) -> dict:
    """The solve of ``problem``/``dim``'s seed ``seed_index``, resumed where
    a checkpoint exists; returns the result (also written to result.json)."""
    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import IneqStatus, tt_ipm
    from ttipm_tpu_torch.utils import checkpoint
    from ttipm_tpu_torch.utils.memtrack import PeakMemoryTracker
    from ttipm_tpu_torch.utils.runner import ipm_kwargs, load_problem, load_yaml, seeded_problem

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("long_run: no CUDA device (pass --device cpu to run on the CPU)")
    config = load_yaml(os.path.join(REPO, "configs", f"{problem}_{dim}.yaml"))
    seed = int(config["seeds"][seed_index])
    name = f"{problem}_{dim}_s{seed_index}"
    workdir = os.path.join(out or os.path.join(REPO, "results", "long_torch"), name)
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "ckpt.npz")
    result_path = os.path.join(workdir, "result.json")
    log_path = os.path.join(workdir, "run.log")
    if os.path.exists(result_path):
        print(f"[long_run] {name}: result.json exists, nothing to do", flush=True)
        with open(result_path) as fh:
            return json.load(fh)

    t1 = time.perf_counter()
    lag_maps, obj, L, bias, mask = seeded_problem(load_problem(problem), config["dim"], rank,
                                                  seed, dev)
    creation_s = time.perf_counter() - t1
    resume = ckpt if os.path.exists(ckpt) else None
    start_iter = int(checkpoint.load_ipm_checkpoint(ckpt, device="cpu")["iteration"]) if resume else 0
    _log(log_path, event="start", from_iteration=start_iter, seed=seed, device=str(dev))
    if resume:
        print(f"[long_run] {name}: resuming from {ckpt} at iteration {start_iter}", flush=True)

    save = checkpoint.save_ipm_checkpoint
    t2 = time.perf_counter()

    def save_and_log(path, *args, iteration=0, **kw):
        save(path, *args, iteration=iteration, **kw)
        peak = torch.cuda.max_memory_allocated(dev) / 1e6 if dev.type == "cuda" else None
        _log(log_path, event="checkpoint", iteration=int(iteration),
             elapsed_s=time.perf_counter() - t2, peak_mb=peak)
        if kill_after is not None and iteration >= kill_after:
            os.kill(os.getpid(), signal.SIGKILL)

    checkpoint.save_ipm_checkpoint = save_and_log
    try:
        with PeakMemoryTracker(dev) as mem:
            X, Y, T, Z, info = tt_ipm(lag_maps, obj, L, bias, ineq_mask=mask,
                                      checkpoint_path=ckpt, checkpoint_every=1,
                                      resume_from=resume, **ipm_kwargs(config))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            solve_s = time.perf_counter() - t2
    finally:
        checkpoint.save_ipm_checkpoint = save
    _log(log_path, event="end", solve_s=solve_s, iterations=int(info["num_iters"]))

    active = info["status"].ineq_status is IneqStatus.ACTIVE
    slack, primal, dual = solve_metrics(X, Y, Z, obj, L, bias, T=T, ineq_active=active)
    tried = attempts(log_path)
    result = {
        "name": name, "problem": problem, "dim": dim, "seed": seed, "rank": rank,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "creation_s": creation_s, "solve_s_last_attempt": solve_s,
        "solve_s_total": sum(a["solve_s"] for a in tried), "attempts": tried,
        "num_iters": int(info["num_iters"]), "complementary_slackness": slack,
        "feasibility_error": primal, "dual_feasibility_error": dual,
        "converged": bool(slack < float(config["abs_tol"])),
        "ranksX": [int(r) for r in info["ranksX"]], "ranksY": [int(r) for r in info["ranksY"]],
        "ranksZ": [int(r) for r in info["ranksZ"]],
        "ranksT": [int(r) for r in info["ranksT"]], "peak_mb_last_attempt": mem.peak_mb,
    }
    _save_runner_json(workdir, {**config, "seeds": [seed]}, problem, dim, rank, info,
                      creation_s, tried, (slack, primal, dual), mem.peak_mb)
    with open(result_path, "w") as fh:
        json.dump(result, fh, indent=1)
    print(f"[long_run] {name}: {json.dumps(result)}", flush=True)
    return result


def _save_runner_json(workdir, config, problem, dim, rank, info, creation_s, tried, metrics,
                      peak_mb):
    """The solve as the runner records a seed (its results schema, under
    <workdir>/results/), so that tools/aggregate_grid.py summarises a
    directory of long runs; the runtime is the sum of the attempts'."""
    from types import SimpleNamespace

    from ttipm_tpu_torch.utils.runner import bond_count, new_record, save_results_summary

    rec = new_record(1, bond_count(problem, dim))
    rec["problem_creation_times"][0] = creation_s
    rec["runtimes"][0] = sum(a["solve_s"] for a in tried)
    rec["memory"][0] = peak_mb
    (rec["complementary_slackness"][0], rec["feasibility_errors"][0],
     rec["dual_feasibility_errors"][0]) = metrics
    rec["num_iters"][0] = info["num_iters"]
    for key in ("ranksX", "ranksY", "ranksZ", "ranksT"):
        rec[key][0, :] = info[key]
    args = SimpleNamespace(config=f"{problem}_{dim}.yaml", track_mem=True, rank=rank)
    os.makedirs(os.path.join(workdir, "results"), exist_ok=True)
    save_results_summary(config, args, rec, os.path.join(workdir, "results", "runner.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", required=True,
                    choices=("maxcut", "corr_clust", "max_stable_set", "graphm"))
    ap.add_argument("--dim", type=int, required=True)
    ap.add_argument("--seed-index", type=int, default=0)
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(REPO, "results", "long_torch"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kill-after", type=int, default=None,
                    help="SIGKILL this process once the checkpoint of this iteration is on disk")
    args = ap.parse_args(argv)
    run(args.problem, args.dim, args.seed_index, args.rank, args.out, args.device,
        args.kill_after)
    return 0


if __name__ == "__main__":
    sys.exit(main())
