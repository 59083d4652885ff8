"""µs a call the device sat idle while the port's host code ran: the
traced window's idle gaps laid over the port's spans
(``portbench/spans.py``), the part that fell inside ``solve`` calls, over
the window's calls.  ``host_us_per_call`` less this is the caller's."""

from portbench import spans


def read(run):
    laid = spans.of_run(run)
    if laid is None or not run.window.calls or not spans.under(laid,
                                                                "solve"):
        return None
    return laid.idle_by_root.get("solve", 0) / run.window.calls * 1e-3
