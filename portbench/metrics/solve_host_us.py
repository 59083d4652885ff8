"""µs a call the port's host code held the caller: the ``solve`` spans'
durations (``mppi/solver.py::solve``, the root span of each call, on the
profiler's clock) summed over the traced window, over the window's
calls.  The caller's own work between calls is not in it."""

from portbench import spans


def read(run):
    laid = spans.of_run(run)
    if laid is None or not run.window.calls:
        return None
    roots = [s for s in laid.spans if s.parent == -1 and s.name == "solve"]
    if not roots:
        return None
    return sum(s.end - s.start for s in roots) / run.window.calls * 1e-3
