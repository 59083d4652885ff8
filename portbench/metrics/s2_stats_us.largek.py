"""Device µs of the step tail's statistics launched on their own
(``step_stats_kernel`` in ``csrc/step_kernel.cu``, on a branch of the
step loop's chunk beside the next solve; ``s2_us.largek`` reads the
control tail on the step's path) a live solve: their device time over the
launches the trace kept, times the launches the port counted, over the
window's live solves.  The launches in the window are the window's step
tails times the process's statistics launches a tail
(``ops/cuda_step.py::STATS_LAUNCHES`` over ``TAIL_LAUNCHES``, 1 wherever
the branch engages).  None where the program has no such launch."""

from portbench import program

KERNEL = "step_stats_kernel"


def read(run):
    secs, seen = run.trace.kernel(KERNEL)
    stats = getattr(program.cuda_step, "STATS_LAUNCHES", None)
    tails = program.cuda_step.TAIL_LAUNCHES
    window = run.window.counters.get("step_tail_kernel")
    if not seen or not stats or not tails or not window \
            or not run.window.solves:
        return None
    return secs / seen * stats / tails * window / run.window.solves * 1e6
