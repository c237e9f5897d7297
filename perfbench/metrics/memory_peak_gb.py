"""``torch.cuda.max_memory_allocated()`` over set-up and window on the
card, in GB (1e9 bytes); nothing on the host."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes > 0 else None
