"""Tile partials the solve kernel's cross-tile combine folds a live solve:
the program's count ``ops/cuda_solve.py::PARTIALS`` (n_tiles × B a
launch, added where a launch is counted and by each graph replay) over its
launch count, the partials a launch, which every launch of a cell shares,
times the window's launches of ``solve_tile_kernel`` over its live
solves.  None where the program has no such count."""

from portbench import program


def read(run):
    partials = getattr(program.cuda_solve, "PARTIALS", None)
    launches = program.cuda_solve.LAUNCHES
    window = run.window.counters.get("solve_tile_kernel")
    if partials is None or not launches or not window \
            or not run.window.solves:
        return None
    return partials / launches * window / run.window.solves
