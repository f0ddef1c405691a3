"""step_size_pct: the step-size eigensolves (``ipm._tt_get_step_sizes``,
the inequalities' smallest-eigenvector steps within) as a share of the
solves' walls."""

from portbench.readings import span_pct


def read(run):
    return span_pct(run, "step_size")
