"""KiB a call copied into the per-call graph's input buffers: the counts
of the ``graph.copy_in`` spans of ``solve`` calls
(``mppi/solver.py::_call``), summed over the traced window, over its
calls.  At ``arm_k1024_h50`` the path is 125 KiB of it."""

from portbench import spans


def read(run):
    laid = spans.of_run(run)
    if laid is None or not run.window.calls:
        return None
    copies = [s.n for s in spans.under(laid, "solve")
              if s.name == "graph.copy_in"]
    return sum(copies) / run.window.calls / 1024 if copies else None
