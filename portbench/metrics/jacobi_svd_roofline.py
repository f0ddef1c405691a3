"""jacobi_svd_roofline: the roofline bounds of the window's launches of
jacobi_svd (``roofline.py``) over its device time in the trace, in percent."""

from portbench.readings import roofline_pct


def read(run):
    return roofline_pct(run, "jacobi_svd")
