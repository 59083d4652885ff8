"""Live MPPI solves completed over the whole window, per second: every
live scenario-step or call of every chain or episode, the last one
included, over the window's host-clock seconds.  A frozen or non-finite
step is not a solve."""

from portbench import stats


def read(run):
    w = run.window
    return stats.rate(w.solves, w.t0, w.t1)
