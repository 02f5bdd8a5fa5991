"""jacobian_s: the Jacobian stage's seconds per pass (one adjoint
factorization and one solve of dQ columns per sample), the mean of the
program's ``stage_seconds`` over the window's passes."""


def read(run):
    vals = [r.stage_seconds["jacobian"] for r in run.passes
            if r.error is None and "jacobian" in r.stage_seconds]
    return sum(vals) / len(vals) if vals else None
