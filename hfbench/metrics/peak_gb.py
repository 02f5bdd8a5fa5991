"""peak_gb: the allocator's peak over the window (reset at its start), less
the bytes of the draws the benchmark made ahead, in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes > 0 else None
