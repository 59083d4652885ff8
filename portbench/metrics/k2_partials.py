"""Tile partials the solve kernel's cross-tile combine folds a live solve,
from the window's own counts: its ``solve_partials`` (``program.counters``,
the port's ``ops/cuda_solve.py::PARTIALS``: n_tiles × B a launch, added
where a launch is counted and by each graph replay) over its live solves,
which is its partials a launch of ``solve_tile_kernel`` times its
launches a live solve.  None where the program has no such count or the
window launched no solve."""


def read(run):
    partials = run.window.counters.get("solve_partials")
    if not partials or not run.window.counters.get("solve_tile_kernel") \
            or not run.window.solves:
        return None
    return partials / run.window.solves
