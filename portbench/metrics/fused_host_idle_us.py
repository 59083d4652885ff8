"""µs a chain the device sat idle while the fused loop's host code ran:
the traced window's idle gaps laid over the port's spans
(``portbench/spans.py``), the part that fell inside ``simulate_fused``
calls (``sim/loop.py``: the inputs, the launch, the records), over the
window's chains."""

from portbench import spans


def read(run):
    laid = spans.of_run(run)
    if laid is None or not run.window.calls or not spans.under(
            laid, "simulate_fused"):
        return None
    return (laid.idle_by_root.get("simulate_fused", 0) / run.window.calls
            * 1e-3)
