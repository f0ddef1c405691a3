"""panel_cholesky_roofline: the roofline bounds of the window's launches of
panel_cholesky (``roofline.py``) over its device time in the trace, in percent."""

from portbench.readings import roofline_pct


def read(run):
    return roofline_pct(run, "panel_cholesky")
