"""The device's idle share of the traced window, %: 1 - the union of the
device operations' intervals over the window's span, both from one
trace."""


def read(run):
    return 100.0 * run.trace.idle_share() if run.trace.ops else None
