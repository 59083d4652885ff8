"""µs a live solve the device sat idle while the per-step loop's host code
ran: the traced window's idle gaps laid over the port's spans
(``portbench/spans.py``), the part that fell inside ``simulate`` calls
(``sim/loop.py``: each chunk's graph key, copies in, replay and rows
out), over the window's live solves."""

from portbench import spans


def read(run):
    laid = spans.of_run(run)
    if laid is None or not run.window.solves or not spans.under(
            laid, "simulate"):
        return None
    return laid.idle_by_root.get("simulate", 0) / run.window.solves * 1e-3
