"""Seconds from the start of the benchmark's process to the first timed
step: imports, CUDA, the kernels' build (a first run in a checkout) and
load, the inputs and the warm-up."""


def read(run):
    return run.setup_s
