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


def generalized_eigh(A, B, descending: bool = True):
    """The dense GHEP A v = lambda B v with SPD B, by Cholesky reduction;
    the eigenvectors come back B-orthonormal."""
    L = torch.linalg.cholesky(B)
    # S = L^{-1} A L^{-T}
    S = torch.linalg.solve_triangular(L, A, upper=False)
    S = torch.linalg.solve_triangular(L, S.T, upper=False).T
    S = 0.5 * (S + S.T)
    d, Y = torch.linalg.eigh(S)
    V = torch.linalg.solve_triangular(L.T, Y, upper=True)  # L^{-T} Y
    if descending:
        d, V = d.flip(0), V.flip(1)
    return d, V
