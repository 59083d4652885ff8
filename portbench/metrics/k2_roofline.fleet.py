"""K2's share of its roofline in the fleet's step loop, %: ``k2_roofline``'s
arithmetic (the bound of the window's live solves,
``roofline.solve_bound_s``, over the device time of
``solve_tile_kernel``), read where one launch solves all 4096 scenarios
at K=128, T=30: one tile of 128 samples a scenario at one lane a sample,
the window scan at its compiled width."""

from portbench import harness


def read(run):
    return harness.load(run.cell.root, "metrics", "k2_roofline").read(run)
