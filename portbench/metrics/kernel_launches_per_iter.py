"""kernel_launches_per_iter: launches of the six CUDA kernels in the window
(the ``STATS`` of the program's ``ops/kernels.py``) over the IPM
iterations."""

from portbench.readings import iters


def read(run):
    n = iters(run)
    return run["launches"] / n if n and run["launches"] else None
