"""µs a call in which the device was idle: the traced window's span less
the union of its device intervals, over the window's calls.  It is the
host's share of a call: the solve's Python and copies in and out
(``mppi/solver.py::_call``), the read of u0, and the caller's own plant
step."""


def read(run):
    if not run.window.calls or not run.trace.ops:
        return None
    return ((run.trace.window_s - run.trace.busy_s) / run.window.calls
            * 1e6)
