"""Device µs of one launch of the step tail (S2, ``step_tail_kernel`` in
``csrc/step_kernel.cu``) in the fleet's step loop: its device time over
the launches the trace kept.  One launch is one step of the whole fleet,
4096 scenarios four to a block, so this is µs a step and not a solve (a
solve's share is this over 4096).  None where the trace holds no
launch."""

KERNEL = "step_tail_kernel"


def read(run):
    secs, seen = run.trace.kernel(KERNEL)
    if not seen:
        return None
    return secs / seen * 1e6
