"""solve_s: the mean wall of a solve in the window, every solve counted,
unconverged and raised ones too (host clock, synchronised at its end)."""

from portbench.readings import wall_s


def read(run):
    return wall_s(run) / len(run["solves"]) if run["solves"] else None
