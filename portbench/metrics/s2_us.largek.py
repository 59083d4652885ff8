"""Device µs of the step tail (S2, ``step_tail_kernel`` in
``csrc/step_kernel.cu``) a live solve: its device time over the launches
the trace kept, times the launches the port counted, over the window's
live solves.  Above 1024 samples the tail's statistics run in the layout
that reads S again each pass (``ops/cuda_step.py::step_tail_layout``)."""

KERNEL = "step_tail_kernel"


def read(run):
    secs, seen = run.trace.kernel(KERNEL)
    launched = run.window.counters.get(KERNEL)
    if not seen or not launched or not run.window.solves:
        return None
    return secs / seen * launched / run.window.solves * 1e6
