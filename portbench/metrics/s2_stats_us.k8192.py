"""Device µs of the step tail's statistics launched on their own
(``step_stats_kernel``) a live solve at K=8192: ``s2_stats_us.largek``'s
arithmetic, read in the cell at the bottom of config 3, where the
statistics run in one block of 16 warps that read S each pass (cap 0),
on the branch beside the next solve and as a chunk's last alike."""

from portbench import harness


def read(run):
    return harness.load(run.cell.root, "metrics",
                        "s2_stats_us.largek").read(run)
