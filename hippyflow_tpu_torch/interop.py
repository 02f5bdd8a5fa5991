"""Carry state across from the JAX package as numpy arrays.

Every function takes numpy arrays (call ``np.asarray`` on a jax array
first; this module never imports jax) and returns the port's tensors and
NamedTuples on the given device and dtype.  Shapes follow the port's
batched convention: a leading sample axis wherever the JAX package would
vmap.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .fem.band_order import BandOrder
from .models.sampling import SampleBatch
from .ops.structured import (
    BlockCyclicFactor,
    InverseThomasFactor,
    PermutedFactor,
    _CRLevel,
)


def tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A copy of a numpy array as a contiguous tensor (bands, noise xi,
    Omega, prior M/K, states, parameters)."""
    dtype, device = config.resolve(dtype, device)
    if not isinstance(x, np.ndarray):
        raise TypeError(f"expected a numpy array, got {type(x).__name__}")
    return torch.tensor(x, dtype=dtype, device=device)


def inverse_thomas_factor(M, Dinv, B, dtype=None, device=None):
    """InverseThomasFactor from (N, nb, s, s) numpy blocks."""
    return InverseThomasFactor(*(tensor(a, dtype, device) for a in (M, Dinv, B)))


def band_order(border) -> BandOrder:
    """The port's BandOrder from any object with the numpy attributes
    ``order``, ``inv``, ``s``, ``nb`` and ``n_total`` (the JAX package's
    ``BandOrder``)."""
    return BandOrder(np.asarray(border.order), np.asarray(border.inv),
                     border.s, border.nb, border.n_total)


def permuted_factor(M, Dinv, B, border, dtype=None, device=None):
    """PermutedFactor(InverseThomasFactor) from the JAX package's
    ``PermutedFactor`` of a batched inverse-Thomas factor: its (N, nb, s, s)
    numpy blocks and its band order."""
    return PermutedFactor(inverse_thomas_factor(M, Dinv, B, dtype, device),
                          band_order(border))


def block_cyclic_factor(levels, Dinv_root, trans_levels=None,
                        Dinv_root_T=None, dtype=None, device=None):
    """BlockCyclicFactor from the arrays of the JAX package's factor:
    ``levels`` and ``trans_levels`` are sequences (or None) of the
    five-array levels (Dinv_odd, alpha, beta, a_odd, b_odd), and the roots
    (s, s) arrays (or None), all numpy."""

    def conv_levels(lvs):
        if lvs is None:
            return None
        return tuple(
            _CRLevel(*(tensor(a, dtype, device) for a in lv)) for lv in lvs
        )

    def conv(a):
        return None if a is None else tensor(a, dtype, device)

    return BlockCyclicFactor(
        levels=conv_levels(levels),
        Dinv_root=conv(Dinv_root),
        trans_levels=conv_levels(trans_levels),
        Dinv_root_T=conv(Dinv_root_T),
    )


def sample_batch(ms, us, qs, n_failures: int = 0, dtype=None, device=None):
    """SampleBatch from (n, dM), (n, n), (n, dQ) numpy arrays."""
    return SampleBatch(
        ms=tensor(ms, dtype, device),
        us=tensor(us, dtype, device),
        qs=tensor(qs, dtype, device),
        n_failures=int(n_failures),
    )
