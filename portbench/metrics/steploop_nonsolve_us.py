"""Device-busy µs a step of the per-step loop outside the solve: the
union of the window's device intervals less the device time of
``solve_tile_kernel`` (K2), over the live solves.  What is left is the
step head (``step_head_kernel``), the step tail (``step_tail_kernel``)
and the chunks' copies."""

KERNEL = "solve_tile_kernel"


def read(run):
    secs, seen = run.trace.kernel(KERNEL)
    if not seen or not run.window.solves:
        return None
    return (run.trace.busy_s - secs) / run.window.solves * 1e6
