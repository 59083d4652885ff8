"""K1's share of its roofline, %: the bound of the window's live solves
(``roofline.loop_bound_s``, from the shapes and the live solves alone)
over the device time of ``sim_kernel`` (``csrc/sim_kernel.cu``).  Where
the trace lost launches the port counted, the bound is taken for the
launches it kept."""

from portbench import roofline

KERNEL = "sim_kernel"


def read(run):
    secs, seen = run.trace.kernel(KERNEL)
    launched = run.window.counters[KERNEL]
    if not seen or not launched:
        return None
    conf = run.cell.conf
    bound, _ = roofline.loop_bound_s(
        conf["mppi"], conf["path"]["waypoints"], run.window.solves, launched,
        conf.get("fleet", {}).get("scenarios", 1))
    return 100.0 * bound * seen / launched / secs
