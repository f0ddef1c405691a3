"""newton_system_pct: the KKT assembly and rounding
(``ipm.tt_infeasible_newton_system``) as a share of the solves' walls."""

from portbench.readings import span_pct


def read(run):
    return span_pct(run, "newton_system")
