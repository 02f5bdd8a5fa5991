"""Dense factorizations and solvers (port of ``hippyflow_tpu/ops/linalg.py``):
library factorizations, as in the JAX package, which calls no Pallas kernel
here, iterative refinement on any factor, and matrix-free conjugate
gradients."""

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

    def solve_L(self, b):
        """L^{-1} b (the square root's inverse action), b shaped as in
        ``solve``."""
        return _solve_cols(
            lambda x: torch.linalg.solve_triangular(self.L, x, upper=False),
            b, self.L)

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
    if A.ndim == 3 and A.device.type == "cpu":
        # one matrix at a time: MKL's batched LU (the CPU wheels' 2024.2)
        # hangs on matrices above ~150 rows once torch.set_num_threads has
        # been called
        lu, piv = (torch.stack(t) for t in zip(
            *(torch.linalg.lu_factor_ex(a)[:2] for a in A)))
        return LUFactor(lu=lu, piv=piv)
    lu, piv, _ = torch.linalg.lu_factor_ex(A)
    return LUFactor(lu=lu, piv=piv)


def solve_refined(factor, A, b, iters: int = 0, trans: bool = False):
    """factor.solve(b) with ``iters`` sweeps of iterative refinement
    against A (n, n) or a batch (N, n, n), b shaped as the factor's solve
    takes it: x += factor.solve(b - A x) (A^T with ``trans``)."""
    x = factor.solve(b, trans=trans)
    op = A.mT if trans else A
    for _ in range(iters):
        x = x + factor.solve(b - _solve_cols(lambda y: op @ y, x, A),
                             trans=trans)
    return x


def cg_solve(matvec, b, x0=None, M=None, tol: float = 1e-10,
             maxiter: int = 1000):
    """Preconditioned conjugate gradients on one system, with the
    semantics of ``jax.scipy.sparse.linalg.cg``: b of any shape is one
    vector, matvec and M (the preconditioner, identity when None) map its
    shape to itself, and the iteration stops at ||r|| <= tol ||b|| or
    after ``maxiter`` steps, returning the last iterate."""
    dot = lambda x, y: (x * y).sum()
    M = (lambda r: r) if M is None else M
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    p, gamma = z, dot(r, z)
    atol2 = tol * tol * dot(b, b)
    for _ in range(maxiter):
        if dot(r, r) <= atol2:
            break
        Ap = matvec(p)
        alpha = gamma / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_ = dot(r, z)
        p = z + (gamma_ / gamma) * p
        gamma = gamma_
    return x


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
