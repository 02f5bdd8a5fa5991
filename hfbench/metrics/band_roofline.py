"""band_roofline: the least time, at the H100's published peaks, of the
band work the window's passes need (``roofline.pass_need_seconds``: one
factorization and one solve per Newton iteration per sample at each
level, and the adjoint factorization and solve of dQ columns per sample)
as a percentage of the device seconds of the kernels that
``band_kernels.d`` names.  A share above 100 means band work runs under a
name the list lacks."""

from hfbench import harness


def read(run):
    if run.trace is None:
        return None
    spent = sum(t for name, t in run.trace.kernel_s.items()
                if name in run.band_kernels)
    if spent <= 0:
        return None
    return 100.0 * harness.band_need_seconds(run) / spent
