"""Seeded random streams (stand-in for ``hippyflow_tpu/utils/prandom.py``).

``jax.random`` keys cannot be reproduced in PyTorch, so the port draws from
an explicit ``torch.Generator`` seeded once.  Every API that draws noise
also accepts given noise, which is how tests feed both packages the same
numpy draws: an object's ``keychain`` may be replaced by a ``GivenNoise``.
"""

from __future__ import annotations

import torch

from .. import config


class KeyChain:
    """A mutable stream of normal and uniform draws from one seeded
    generator on the device the draws are made on."""

    def __init__(self, seed: int = 0, device=None):
        _, self.device = config.resolve(None, device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def next_key(self) -> torch.Generator:
        """A new generator on the chain's device, seeded from the chain's
        next draw: a stream of its own."""
        seed = torch.randint(0, 2**62, (1,), generator=self.generator,
                             device=self.device).item()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def normal(self, shape, dtype=None, sigma: float = 1.0):
        """Normal draws of the given shape, standard deviation ``sigma``."""
        dtype = dtype or config.DEFAULT_DTYPE
        x = torch.randn(shape, generator=self.generator, dtype=dtype,
                        device=self.device)
        return x if sigma == 1.0 else sigma * x

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0, dtype=None):
        """Uniform draws on [lo, hi) of the given shape."""
        dtype = dtype or config.DEFAULT_DTYPE
        x = torch.rand(shape, generator=self.generator, dtype=dtype,
                       device=self.device)
        return lo + (hi - lo) * x


class GivenNoise:
    """A KeyChain whose draws are given: each ``normal`` (``uniform``)
    takes the next standard normals (uniforms) of a numpy Generator, so the
    same numbers land on every device."""

    def __init__(self, rng, device=None):
        _, self.device = config.resolve(None, device)
        self.rng = rng

    def normal(self, shape, dtype=None, sigma: float = 1.0):
        x = torch.as_tensor(self.rng.standard_normal(shape),
                            dtype=dtype or config.DEFAULT_DTYPE,
                            device=self.device)
        return x if sigma == 1.0 else sigma * x

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0, dtype=None):
        return torch.as_tensor(self.rng.uniform(lo, hi, shape),
                               dtype=dtype or config.DEFAULT_DTYPE,
                               device=self.device)
