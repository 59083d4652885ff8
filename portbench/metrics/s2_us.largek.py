"""Device µs of the step tail (S2, ``step_tail_kernel`` in
``csrc/step_kernel.cu``) a live solve: its device time over the launches
the trace kept, times the launches the port counted, over the window's
live solves.  At K = 65536 on the H100 the step loop splits the tail
(``ops/cuda_step.py::stats_branch``): ``step_tail_kernel`` is the control
warp alone, on the step's path between two solves, and this reads only
that; the statistics run as ``step_stats_kernel`` on a branch beside the
next solve, read by ``s2_stats_us.largek`` and
``s2_stats_overlap.largek``."""

KERNEL = "step_tail_kernel"


def read(run):
    secs, seen = run.trace.kernel(KERNEL)
    launched = run.window.counters.get(KERNEL)
    if not seen or not launched or not run.window.solves:
        return None
    return secs / seen * launched / run.window.solves * 1e6
