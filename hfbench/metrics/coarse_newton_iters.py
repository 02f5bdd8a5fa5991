"""coarse_newton_iters: the grid-sequenced warm start's Newton iterations
per kept sample, summed over its coarse levels (the program's
``CoarseNewtonWarmStart.iterations``, each pass's copy in
``PassRecord.coarse_iterations``), over the window's passes; None where
the cell has no coarse level."""


def read(run):
    done = [r for r in run.passes
            if r.error is None and r.n_samples and r.coarse_iterations]
    if not done:
        return None
    return (sum(sum(r.coarse_iterations) for r in done)
            / sum(r.n_samples for r in done))
