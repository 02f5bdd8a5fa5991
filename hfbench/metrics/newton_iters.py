"""newton_iters: fine-level Newton iterations per kept sample, the sum of
the program's ``SampleBatch.iterations`` over the window's passes over
their samples."""


def read(run):
    done = [r for r in run.passes if r.error is None and r.n_samples]
    if not done:
        return None
    return sum(r.iterations for r in done) / sum(r.n_samples for r in done)
