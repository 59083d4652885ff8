"""K2's share of its roofline at K=8192, %: ``k2_roofline``'s arithmetic
(the bound of the window's live solves, ``roofline.solve_bound_s``, over
the device time of ``solve_tile_kernel``), read in the cell at the bottom
of config 3, where the solve runs 128 tiles of 64 samples at two lanes a
sample."""

from portbench import harness


def read(run):
    return harness.load(run.cell.root, "metrics", "k2_roofline").read(run)
