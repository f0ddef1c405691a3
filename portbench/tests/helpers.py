"""Small cells of the benchmark for runs on the CPU."""

import time

from portbench import catalog, run


def small_cell(config: str, traffic: str = "seeds5", dim: int = 3, seeds=(0, 7)) -> catalog.Cell:
    """The cell of configuration ``config`` under ``traffic``, at order
    ``dim`` on ``seeds``."""
    cfg = catalog._json("configs", config)
    cfg.update(dim=dim, seeds=list(seeds))
    mix = catalog._json("traffic", traffic)
    mix.update(instances=len(seeds), warmup_max_iter=3)
    return catalog.Cell(f"{config}.{traffic}", 1, cfg, mix)


def cpu_run(cell: catalog.Cell, seed: int = 2**31 + 7, trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU, its window as short as a round, with
    every metric of BENCHMARK.json of the run's kind."""
    kind = "per_layer" if trace else "end_to_end"
    return run.run_cell(cell, seed, 0.01, trace, "cpu", catalog.benchmark()[kind],
                        t_start_ns=time.monotonic_ns())
