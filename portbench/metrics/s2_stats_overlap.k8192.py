"""Share of the step tail's statistics' device time during which the solve
kernel runs beside them at K=8192, %: ``s2_stats_overlap.largek``'s
arithmetic, read in the cell at the bottom of config 3, where the
statistics' one cap-0 block shares the card with K2's 128 blocks."""

from portbench import harness


def read(run):
    return harness.load(run.cell.root, "metrics",
                        "s2_stats_overlap.largek").read(run)
