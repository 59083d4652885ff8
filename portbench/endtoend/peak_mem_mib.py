"""The device memory peak over set-up and window, MiB:
``torch.cuda.max_memory_allocated()`` read when the window closes, after
a reset before set-up.  On a fleet it bounds how many scenarios a card
holds."""


def read(run):
    return run.peak_bytes / 2 ** 20
