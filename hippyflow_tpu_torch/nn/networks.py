"""Derivative-informed projected neural networks (DIPNet / DIPResNet) as
``torch.nn`` modules (port of ``hippyflow_tpu/nn/networks.py``).

* ``projected_dense`` -- DIPNet: the input projection (the reduced input
  decoder, an AS or KLE basis) is FROZEN, a buffer and not a parameter;
  a trainable bias follows it; softplus dense layers run in reduced
  coordinates; the last layer starts at the output decoder transposed and
  its bias at ``output_shift``, and both train.
* ``projected_low_rank_residual_network`` -- DIPResNet: rank-r residual
  blocks z += W_out act(W_in z + b) between the projections.
* ``GenericDense`` / ``GenericLinear`` / ``LowRankLinear`` -- unprojected
  baselines.

Submodules carry the JAX package's layer names (``dense_reduction_layer``,
``inner_layer_0``, ``lr_0_in``, ``Dense_0``, ...), so ``flax_name`` maps
each parameter to its path in the flax parameter tree.  The other layers
start as flax's ``Dense`` does: LeCun-normal weights (a normal truncated
at two standard deviations, its scale corrected for the cut) and zero
biases, drawn from the caller's ``torch.Generator`` on the CPU so that
the draws do not depend on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .. import config

# stddev of the standard normal truncated to [-2, 2] (flax's
# variance_scaling with "truncated_normal" divides by it)
_TRUNC_STD = 0.87962566103423978


def softplus(x):
    """log(1 + e^x) as logaddexp(x, 0), as ``jax.nn.softplus`` computes it;
    ``F.softplus`` turns into the identity above its threshold instead."""
    return torch.relu(x) + torch.log1p(torch.exp(-x.abs()))


_ACTIVATIONS = {"softplus": softplus, "sigmoid": torch.sigmoid}


def flax_name(name: str) -> str:
    """The JAX package's path of a parameter of these modules, as its
    ``frozen_prefixes`` spell it: ``output_layer.weight`` ->
    ``params/output_layer/kernel``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(["params", *parts])


def _placement(x, dtype, device):
    """(dtype, device): the explicit ones, else those of a tensor ``x``,
    else the package defaults."""
    if isinstance(x, torch.Tensor):
        return dtype or x.dtype, torch.device(device) if device else x.device
    return config.resolve(dtype, device)


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.detach().to(dtype=dtype, device=device).clone()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).clone()


def _generator(generator):
    return generator if generator is not None else torch.Generator().manual_seed(0)


def dense(n_in, n_out, *, bias=True, generator, dtype, device):
    """``nn.Linear`` started as flax's ``Dense``: LeCun-normal weight, zero
    bias.  Its weight is flax's kernel transposed, (out, in)."""
    layer = nn.Linear(n_in, n_out, bias=bias, dtype=dtype, device=device)
    std = (1.0 / n_in) ** 0.5 / _TRUNC_STD
    w = torch.empty(n_out, n_in, dtype=dtype)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        layer.weight.copy_(w)
        if bias:
            layer.bias.zero_()
    return layer


class _Projected(nn.Module):
    """The frozen input projection with its trainable bias, and the output
    layer started at the output decoder transposed."""

    def _init_projections(self, input_projector, output_projector,
                          output_shift, dtype, device):
        P = _as_tensor(input_projector, dtype, device)
        Phi = _as_tensor(output_projector, dtype, device)
        self.register_buffer("input_projector", P)
        self.input_bias = nn.Parameter(P.new_zeros(P.shape[1]))
        out = nn.Linear(Phi.shape[1], Phi.shape[0], dtype=dtype, device=device)
        with torch.no_grad():
            out.weight.copy_(Phi)  # flax kernel Phi^T, transposed
            if output_shift is None:
                out.bias.zero_()
            else:
                out.bias.copy_(_as_tensor(output_shift, dtype, device))
        return P.shape[1], Phi.shape[1], out

    def _embed(self, m):
        return m @ self.input_projector + self.input_bias


class DIPNet(_Projected):
    """projected_dense: m -> softplus dense stack in reduced coordinates."""

    def __init__(self, input_projector, output_projector,
                 intermediate_layers: int = 1, output_shift=None, *,
                 generator=None, dtype=None, device=None):
        super().__init__()
        dtype, device = _placement(input_projector, dtype, device)
        gen = _generator(generator)
        r_in, r_out, out = self._init_projections(
            input_projector, output_projector, output_shift, dtype, device)
        kw = dict(generator=gen, dtype=dtype, device=device)
        self.dense_reduction_layer = dense(r_in, r_in, **kw)
        self.intermediate_layers = intermediate_layers
        for i in range(intermediate_layers):
            setattr(self, f"inner_layer_{i}",
                    dense(r_in if i == 0 else r_out, r_out, **kw))
        self.output_layer = out

    def forward(self, m):
        z = softplus(self.dense_reduction_layer(self._embed(m)))
        for i in range(self.intermediate_layers):
            z = softplus(getattr(self, f"inner_layer_{i}")(z))
        return self.output_layer(z)


class DIPResNet(_Projected):
    """projected_low_rank_residual_network: low-rank residual blocks."""

    def __init__(self, input_projector, output_projector,
                 ranks: Sequence[int] = (4, 4),
                 residual_activation: str = "softplus", output_shift=None, *,
                 generator=None, dtype=None, device=None):
        super().__init__()
        dtype, device = _placement(input_projector, dtype, device)
        gen = _generator(generator)
        self.act = _ACTIVATIONS[residual_activation]
        dim, r_out, out = self._init_projections(
            input_projector, output_projector, output_shift, dtype, device)
        kw = dict(generator=gen, dtype=dtype, device=device)
        self.ranks = tuple(ranks)
        for i, rank in enumerate(self.ranks):
            setattr(self, f"lr_{i}_in", dense(dim, rank, **kw))
            setattr(self, f"lr_{i}_out", dense(rank, dim, **kw))
        self.reduced_output = dense(dim, r_out, **kw)
        self.output_layer = out

    def forward(self, m):
        z = self._embed(m)
        for i in range(len(self.ranks)):
            h = self.act(getattr(self, f"lr_{i}_in")(z))
            z = z + getattr(self, f"lr_{i}_out")(h)
        return self.output_layer(self.reduced_output(z))


class GenericDense(nn.Module):
    """generic_dense: two softplus dense layers and a linear one."""

    def __init__(self, input_dim: int, output_dim: int, *, generator=None,
                 dtype=None, device=None):
        super().__init__()
        dtype, device = config.resolve(dtype, device)
        kw = dict(generator=_generator(generator), dtype=dtype, device=device)
        self.Dense_0 = dense(input_dim, output_dim, **kw)
        self.Dense_1 = dense(output_dim, output_dim, **kw)
        self.Dense_2 = dense(output_dim, output_dim, **kw)

    def forward(self, m):
        z = softplus(self.Dense_0(m))
        z = softplus(self.Dense_1(z))
        return self.Dense_2(z)


class GenericLinear(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, *, generator=None,
                 dtype=None, device=None):
        super().__init__()
        dtype, device = config.resolve(dtype, device)
        self.Dense_0 = dense(input_dim, output_dim,
                             generator=_generator(generator), dtype=dtype,
                             device=device)

    def forward(self, m):
        return self.Dense_0(m)


class LowRankLinear(nn.Module):
    """low_rank_linear: a bias-free rank-r map, then a dense layer."""

    def __init__(self, input_dim: int, output_dim: int, rank: int = 16, *,
                 generator=None, dtype=None, device=None):
        super().__init__()
        dtype, device = config.resolve(dtype, device)
        kw = dict(generator=_generator(generator), dtype=dtype, device=device)
        self.intermediate = dense(input_dim, rank, bias=False, **kw)
        self.Dense_0 = dense(rank, output_dim, **kw)

    def forward(self, m):
        return self.Dense_0(self.intermediate(m))


def projected_dense(input_projector, output_projector, intermediate_layers=1,
                    output_shift=None, *, generator=None, dtype=None,
                    device=None):
    """Reference-parity factory returning a DIPNet module."""
    return DIPNet(input_projector, output_projector, intermediate_layers,
                  output_shift, generator=generator, dtype=dtype,
                  device=device)


def projected_low_rank_residual_network(
    input_projector, output_projector, ranks=(4, 4),
    residual_activation="softplus", output_shift=None, *, generator=None,
    dtype=None, device=None,
):
    return DIPResNet(input_projector, output_projector, ranks,
                     residual_activation, output_shift, generator=generator,
                     dtype=dtype, device=device)
