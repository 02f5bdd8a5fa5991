"""Dense factorizations (port of ``hippyflow_tpu/ops/linalg.py``): library
factorizations, as in the JAX package, which calls no Pallas kernel here."""

from __future__ import annotations

from typing import NamedTuple

import torch


def _solve_cols(solve, b, L):
    """Apply a factor's matrix solve to b (..., n) or (..., n, k)."""
    vec = b.ndim == L.ndim - 1
    x = solve(b[..., None] if vec else b)
    return x[..., 0] if vec else x


class CholeskyFactor(NamedTuple):
    """Lower Cholesky factor of an SPD matrix (n, n), or of a batch
    (N, n, n)."""

    L: torch.Tensor

    def solve(self, b, trans: bool = False):
        """A^{-1} b for b (n,) or (n, k), or (N, n) or (N, n, k) with a
        batch; A^T = A, so ``trans`` changes nothing."""
        return _solve_cols(lambda x: torch.cholesky_solve(x, self.L), b, self.L)

    def matvec_L(self, x):
        """L @ x (square-root action of A)."""
        return self.L @ x


class LUFactor(NamedTuple):
    """Pivoted LU factor of a general square matrix (n, n), or of a batch."""

    lu: torch.Tensor
    piv: torch.Tensor

    def solve(self, b, trans: bool = False):
        """A^{-1} b (or A^{-T} b) for b shaped as in ``CholeskyFactor``."""
        return _solve_cols(
            lambda x: torch.linalg.lu_solve(self.lu, self.piv, x, adjoint=trans),
            b, self.lu)


def factorize(A, symmetric: bool):
    """Factorize a dense matrix (n, n) or batch (N, n, n): Cholesky when
    SPD, pivoted LU otherwise.  A failed factorization leaves non-finite
    factors, as in the JAX package, and raises nothing."""
    if symmetric:
        return CholeskyFactor(L=torch.linalg.cholesky_ex(A)[0])
    lu, piv, _ = torch.linalg.lu_factor_ex(A)
    return LUFactor(lu=lu, piv=piv)


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
