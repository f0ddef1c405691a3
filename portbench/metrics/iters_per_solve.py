"""iters_per_solve: IPM iterations of a solve (``info["num_iters"]``),
averaged over the solves that returned."""

from portbench.readings import iters


def read(run):
    done = [s for s in run["solves"] if s.error is None]
    return iters(run) / len(done) if done else None
