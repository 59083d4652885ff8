"""The whole window's share of the card's float32 peak, %: the operations
of the window's live solves (``roofline.solve_ops`` with the statistics,
from the shapes alone) over the traced window's span times the peak.  It
bounds every kernel's roofline share from above on the same work, so a
kernel taken off the path still leaves a number."""

from portbench import roofline


def read(run):
    if not run.trace.ops:
        return None
    ops = run.window.solves * roofline.solve_ops(run.cell.conf["mppi"], True)
    return 100.0 * ops / (run.trace.window_s * roofline.PEAK_OPS)
