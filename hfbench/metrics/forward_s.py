"""forward_s: the forward stage's seconds per pass (sampling with Newton,
assembly, K1 and K2), the mean of the program's ``stage_seconds`` over
the window's passes."""


def read(run):
    vals = [r.stage_seconds["forward"] for r in run.passes
            if r.error is None and "forward" in r.stage_seconds]
    return sum(vals) / len(vals) if vals else None
