"""The 95th percentile, over every call of the window, of one control step
as the caller sees it: the state handed in, the solve returned and u0
back on the host (ms, host clock)."""

from portbench import stats


def read(run):
    lat = run.window.latencies
    return stats.percentile(lat, 95.0) * 1e3 if lat else None
