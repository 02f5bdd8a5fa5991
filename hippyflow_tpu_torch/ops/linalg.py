"""Dense factorizations (port of ``hippyflow_tpu/ops/linalg.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class CholeskyFactor(NamedTuple):
    """Lower Cholesky factor of an SPD matrix."""

    L: torch.Tensor

    def solve(self, b):
        """A^{-1} b for b (n, k)."""
        return torch.cholesky_solve(b, self.L)

    def matvec_L(self, x):
        """L @ x (square-root action of A)."""
        return self.L @ x


def eigh_descending(T):
    """Symmetric eigendecomposition sorted by descending eigenvalue."""
    d, V = torch.linalg.eigh(T)
    return d.flip(0), V.flip(1)
