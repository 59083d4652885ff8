"""K2's share of its roofline, %: the bound of one solve
(``roofline.solve_bound_s``, from the shapes alone) times the window's
live solves, over the device time of ``solve_tile_kernel``
(``csrc/solve_kernel.cu``).  Where the trace lost launches the port
counted, the bound is taken for the launches it kept."""

from portbench import roofline

KERNEL = "solve_tile_kernel"


def read(run):
    secs, seen = run.trace.kernel(KERNEL)
    launched = run.window.counters[KERNEL]
    if not seen or not launched:
        return None
    bound, _ = roofline.solve_bound_s(run.cell.conf["mppi"],
                                      run.window.solves)
    return 100.0 * bound * seen / launched / secs
