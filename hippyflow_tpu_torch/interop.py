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
from .models.sampling import SampleBatch
from .ops.structured import InverseThomasFactor


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


def sample_batch(ms, us, qs, n_failures: int = 0, dtype=None, device=None):
    """SampleBatch from (n, dM), (n, n), (n, dQ) numpy arrays."""
    return SampleBatch(
        ms=tensor(ms, dtype, device),
        us=tensor(us, dtype, device),
        qs=tensor(qs, dtype, device),
        n_failures=int(n_failures),
    )
