"""kkt_block_matvec_roofline: the roofline bounds of the window's launches of
kkt_block_matvec (``roofline.py``) over its device time in the trace, in percent."""

from portbench.readings import roofline_pct


def read(run):
    return roofline_pct(run, "kkt_block_matvec")
