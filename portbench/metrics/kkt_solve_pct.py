"""kkt_solve_pct: the Newton (KKT) solves (``ipm._solve_kkt``: the fused
ladder, and the ragged AMEn where it falls back) as a share of the
solves' walls."""

from portbench.readings import span_pct


def read(run):
    return span_pct(run, "kkt_solve")
