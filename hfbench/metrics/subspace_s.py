"""subspace_s: time to the input active subspace, the window's wall
seconds (from the start of its first pass to the end of its last) over
the passes it ran."""


def read(run):
    return run.window_s / len(run.passes) if run.passes else None
