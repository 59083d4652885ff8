"""K2's share of its roofline at K=65536, %: ``k2_roofline``'s arithmetic
(the bound of the window's live solves, ``roofline.solve_bound_s``, over
the device time of ``solve_tile_kernel``), read in the large-K cell, where
the solve runs 128 tiles of 512 samples at one lane a sample."""

from portbench import harness


def read(run):
    return harness.load(run.cell.root, "metrics", "k2_roofline").read(run)
