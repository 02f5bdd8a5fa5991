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
from .nn.networks import flax_name
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
        zs=None,
        n_failures=int(n_failures),
    )


def flax_params(model, params) -> np.ndarray:
    """Load the JAX package's parameter tree of a network into the port's
    module of the same architecture, in place; returns the index map from
    JAX's raveled parameter vector to the port's flat one.

    ``params`` is the flax tree (``{"params": {...}}`` or its inner dict)
    as nested dicts of numpy arrays.  Kernels (in, out) load transposed
    into the (out, in) weights.  ``jax.flatten_util.ravel_pytree`` lays
    the leaves out in sorted path order, each row-major; the port's flat
    vector (``nn.training``) lays the parameters out in
    ``named_parameters()`` order.  With ``order`` returned, ``port_flat ==
    jax_flat[order]``, and a probe block drawn in JAX's order maps onto the
    port's as ``Omega[order]``."""

    def leaves(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            for key in sorted(tree):
                yield from leaves(tree[key], path + (key,))
        else:
            yield path, np.asarray(tree)

    if "params" not in params:
        params = {"params": params}
    offsets, arrays, offset = {}, {}, 0
    for path, leaf in leaves(params, ()):
        name = "/".join(path)
        offsets[name], arrays[name] = offset, leaf
        offset += leaf.size
    named = dict(model.named_parameters())
    if sorted(flax_name(n) for n in named) != sorted(arrays):
        raise ValueError(
            f"parameter trees differ: port {sorted(map(flax_name, named))}, "
            f"JAX {sorted(arrays)}")
    order = []
    with torch.no_grad():
        for n, p in named.items():
            key = flax_name(n)
            leaf = arrays[key]
            idx = offsets[key] + np.arange(leaf.size).reshape(leaf.shape)
            if key.endswith("/kernel"):
                leaf, idx = leaf.T, idx.T
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {leaf.shape} against {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(leaf), dtype=p.dtype))
            order.append(idx.reshape(-1))
    return np.concatenate(order)
