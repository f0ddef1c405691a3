"""iter_s: the solves' summed walls over their summed IPM iterations."""

from portbench.readings import iters, wall_s


def read(run):
    n = iters(run)
    return wall_s(run) / n if n else None
