"""The least time one H100 SXM could take for the band work a pass needs.

The peaks are NVIDIA's data sheet's for the H100 SXM at 700 W: 67 TFLOP/s
in float32 outside the tensor cores (the program never uses TF32) and in
float64 on the FP64 tensor cores, and 3.35 TB/s of HBM3.  A kernel's
bound is the larger of its operations at the peak rate and its bytes at
the memory rate, each input read once and each output written once.

``k1_bound`` and ``k2_bound`` are frozen copies of the program's own
arithmetic (its ``utils/profiling.py``): block-Thomas factorization of
(nb, s) band storage with inverted pivots, and the solve through it.

The band work a Newton pass needs (``newton_need_seconds``), whatever
implements it; an application (``applications/``) counts its own pass
from it or from the kernels' bounds:

* one factorization and one solve of one column per Newton iteration of
  each sample, at the (nb, s) of the level it ran on;
* one factorization and one transposed solve of dQ columns per kept
  sample, the adjoint solve that materializes its Jacobian.
"""

from __future__ import annotations

PEAK_FLOPS = 67.0e12
HBM_BYTES_PER_S = 3350.0e9
ITEMSIZE = {"float32": 4, "float64": 8}


def bound(flops: float, nbytes: float) -> float:
    """Seconds: the larger of ``flops`` at the peak rate and ``nbytes``
    at the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def k1_bound(N: int, nb: int, s: int, dtype: str) -> float:
    """One s x s inverse (2 s^3) at row 0 and two products and an inverse
    (6 s^3) at each later row; the band read once, M and Dinv written
    once."""
    return bound(N * (6 * (nb - 1) + 2) * s ** 3,
                 5 * N * nb * s * s * ITEMSIZE[dtype])


def k2_bound(N: int, nb: int, s: int, k: int, dtype: str) -> float:
    """The 3 nb - 2 blocks of M, Dinv and B a sweep uses, each read once
    and applied to k columns (2 s^2 k); the rhs read and the solution
    written once."""
    blocks = N * (3 * nb - 2)
    return bound(2 * blocks * s * s * k,
                 (blocks * s * s + 2 * N * nb * s * k) * ITEMSIZE[dtype])


def newton_need_seconds(levels: list[tuple[tuple[int, int], int]], dq: int,
                        n_samples: int, dtype: str) -> float:
    """The least seconds of one Newton pass's band work.  ``levels`` holds
    ((nb, s), Newton iterations summed over the samples) for the fine
    level and each coarse level."""
    t = 0.0
    for (nb, s), iterations in levels:
        t += iterations * (k1_bound(1, nb, s, dtype) + k2_bound(1, nb, s, 1, dtype))
    nb, s = levels[0][0]
    t += n_samples * (k1_bound(1, nb, s, dtype) + k2_bound(1, nb, s, dq, dtype))
    return t


def pass_need_seconds(levels: list[tuple[int, int]], dq: int, n_samples: int,
                      dtype: str) -> float:
    """``newton_need_seconds`` where every level's band has nb = s:
    ``levels`` holds (s, Newton iterations summed over the samples)."""
    return newton_need_seconds([((s, s), it) for s, it in levels], dq,
                               n_samples, dtype)
