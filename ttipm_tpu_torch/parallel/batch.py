"""A config's seeds as parallel worker processes.

Counterpart of ``ttipm_tpu/parallel/batch.py``: each seed of a config is
solved by ``utils/runner.py::run_and_record`` in a spawned worker process,
``workers`` at a time, and reports one JSON file; a worker that crashes or
exits without its file is a failed seed, never a hang.  ``device`` takes
the place of the JAX package's ``platform``: on "cuda" every worker has a
CUDA context of its own on the one card (the kernels are built once, in
the parent, before the workers start), and a worker that finds no card
reports ``ok: false`` (it never runs on the CPU).  Each worker's CPU
threads are capped at its share of the cores, so that the workers do not
starve each other's host dispatch.

Usage:
    python -m ttipm_tpu_torch.parallel.batch --problem maxcut \\
        --config configs/maxcut_8.yaml --workers 5 [--rank 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import tempfile
import time
from typing import List


def _worker(problem: str, config_path: str, seed: int, rank: int, device: str,
            threads: int, out_path: str) -> None:
    import torch

    torch.set_num_threads(threads)
    try:
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device in this worker")
        from ttipm_tpu_torch.utils import runner

        config = runner.load_yaml(config_path)
        config["seeds"] = [seed]
        rec = runner.new_record(1, runner.bond_count(problem, config["dim"]))

        args = argparse.Namespace(track_mem=False, device=device)
        feas, _ = runner.run_and_record(seed, 0, rank, config, args,
                                        runner.load_problem(problem), rec)
        result = {
            "seed": seed,
            "ok": True,
            "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "runtime": float(rec["runtimes"][0]),
            "num_iters": float(rec["num_iters"][0]),
            "slackness": float(rec["complementary_slackness"][0]),
            "feasibility_error": float(feas),
            "dual_feasibility_error": float(rec["dual_feasibility_errors"][0]),
        }
    except Exception as e:  # a crashed solve is a failed seed, not a failed batch
        result = {"seed": seed, "ok": False, "error": f"{type(e).__name__}: {e}"}
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(result, fh)
    os.replace(tmp, out_path)


def run_batch(problem: str, config_path: str, seeds: List[int], rank: int = 1,
              workers: int = 2, device: str = "cuda") -> List[dict]:
    """Solve ``seeds`` in parallel worker processes on ``device`` ("cuda",
    the default, or "cpu"); returns the per-seed result dicts in the order
    the workers ended.  "cuda" without a card raises."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device (pass device='cpu' to run on the CPU)")
        from ttipm_tpu_torch.ops import _build

        _build.build_library()  # once here, not once a worker
    threads = max(1, (os.cpu_count() or 1) // max(1, min(workers, len(seeds))))
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="ttipm_batch_")
    try:
        pending = list(seeds)
        running = []  # (process, seed, out_path)
        done = []
        while pending or running:
            while pending and len(running) < workers:
                seed = pending.pop(0)
                out_path = os.path.join(out_dir, f"seed_{seed}.json")
                p = ctx.Process(target=_worker, args=(problem, config_path, seed, rank, device,
                                                      threads, out_path))
                p.start()
                running.append((p, seed, out_path))
            time.sleep(0.2)
            still = []
            for p, seed, out_path in running:
                if p.is_alive():
                    still.append((p, seed, out_path))
                else:
                    p.join()
                    done.append((seed, out_path, p.exitcode))
            running = still
        results = []
        for seed, out_path, exitcode in done:
            if os.path.exists(out_path):
                with open(out_path) as fh:
                    results.append(json.load(fh))
            else:
                results.append({"seed": seed, "ok": False,
                                "error": f"worker exited with code {exitcode} and no result"})
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="parallel seed batch runner (PyTorch port)")
    parser.add_argument("--problem", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--rank", type=int, default=1)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    from ttipm_tpu_torch.utils.runner import load_yaml

    seeds = load_yaml(args.config)["seeds"]
    results = run_batch(args.problem, args.config, seeds, args.rank, args.workers, args.device)
    print(json.dumps(results, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
