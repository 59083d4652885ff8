"""Share of the step tail's statistics' device time (``step_stats_kernel``,
on a branch of the step loop's chunk) during which the solve kernel
(``solve_tile_kernel``) runs beside them, %: what of their time left the
step's path.  Each kernel's launches run on one stream, so neither
overlaps itself, and the overlap is their unions' lengths less the union
of both.  None where the trace holds no statistics launch."""

from portbench import stats

KERNEL, SOLVE = "step_stats_kernel", "solve_tile_kernel"


def read(run):
    mine = [(a, b) for n, a, b in run.trace.ops if n == KERNEL]
    solve = [(a, b) for n, a, b in run.trace.ops if n == SOLVE]
    total = stats.union_length(mine)
    if not total:
        return None
    both = total + stats.union_length(solve) - stats.union_length(
        mine + solve)
    return 100.0 * both / total
