"""Block-tridiagonal direct solvers for structured-mesh FEM operators.

Port of ``hippyflow_tpu/ops/structured.py``.  On a structured rectangle
mesh with row-major numbering a P1 operator is block-tridiagonal with
blocks of size s = nx + 1 and nb = ny + 1 block rows, stored as bands
(..., nb, s, 3s): columns [0, s) hold the sub-diagonal blocks A_j, [s, 2s)
the diagonal D_j and [2s, 3s) the super-diagonal B_j.

* ``InverseThomasFactor`` carries block-Thomas by explicit inverses of the
  pivoted diagonal blocks and serves forward and transposed solves.  It is
  batched over a leading sample axis; factorization and solves go through
  the hand-written kernels K1/K2 (``ops/hopper_kernels.py``) on the card.
* ``BlockTridiagFactor`` is block-Thomas with pivoted LU of the diagonal
  blocks, for the dense prior's K-solves (not a TPU kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .hopper_kernels import banded_factorize, banded_solve


class InverseThomasFactor(NamedTuple):
    """Batched block-Thomas factor A = Lhat Uhat with Lhat unit block-lower
    bidiagonal (sub-diagonal multipliers M) and Uhat block-upper bidiagonal
    with diagonal inverses Dinv and the super-diagonal blocks B of A.

    M, Dinv, B: (N, nb, s, s) contiguous; M[:, 0] = 0, B[:, nb-1] = 0.
    No pivoting between blocks (bc-symmetrized FEM operators)."""

    M: torch.Tensor
    Dinv: torch.Tensor
    B: torch.Tensor

    @property
    def nb(self):
        return self.M.shape[1]

    @property
    def s(self):
        return self.M.shape[2]

    def solve(self, b, trans: bool = False):
        """Solve A x = b (or A^T x = b) per sample; b (N, n) or (N, n, k)."""
        squeeze = b.ndim == 2
        if squeeze:
            b = b[..., None]
        N, nb, s = b.shape[0], self.nb, self.s
        bb = b.reshape(N, nb, s, b.shape[-1]).contiguous()
        x = banded_solve(self.M, self.Dinv, self.B, bb, trans)
        x = x.reshape(N, nb * s, -1)
        return x[..., 0] if squeeze else x


def factorize_thomas_inv_banded(band) -> InverseThomasFactor:
    """Inverse block-Thomas factorization of a batch of bands
    (N, nb, s, 3s): one launch of K1 on the card."""
    s = band.shape[-2]
    band = band.contiguous()
    M, Dinv = banded_factorize(band)
    return InverseThomasFactor(M=M, Dinv=Dinv, B=band[..., 2 * s :].contiguous())


def block_tridiag_matmat(band, X):
    """A @ X per sample for bands (N, nb, s, 3s); X (N, n) or (N, n, k)."""
    squeeze = X.ndim == 2
    if squeeze:
        X = X[..., None]
    N, nb, s = band.shape[0], band.shape[1], band.shape[2]
    xb = X.reshape(N, nb, s, X.shape[-1])
    A, D, B = band[..., :s], band[..., s : 2 * s], band[..., 2 * s :]
    y = D @ xb
    y[:, 1:] += A[:, 1:] @ xb[:, :-1]
    y[:, :-1] += B[:, :-1] @ xb[:, 1:]
    out = y.reshape(N, nb * s, -1)
    return out[..., 0] if squeeze else out


def block_tridiag_matmat_trans(band, X):
    """A^T @ X per sample for bands (N, nb, s, 3s); X (N, n) or (N, n, k)."""
    squeeze = X.ndim == 2
    if squeeze:
        X = X[..., None]
    N, nb, s = band.shape[0], band.shape[1], band.shape[2]
    xb = X.reshape(N, nb, s, X.shape[-1])
    A, D, B = band[..., :s], band[..., s : 2 * s], band[..., 2 * s :]
    y = D.mT @ xb
    y[:, 1:] += B[:, :-1].mT @ xb[:, :-1]
    y[:, :-1] += A[:, 1:].mT @ xb[:, 1:]
    out = y.reshape(N, nb * s, -1)
    return out[..., 0] if squeeze else out


class BlockTridiagFactor(NamedTuple):
    """Block-Thomas factorization (pivoted LU of the diagonal blocks) of one
    block-tridiagonal matrix: L_j = A_j D'_{j-1}^{-1}, D'_j = D_j - L_j B_{j-1}."""

    Dlu: torch.Tensor  # (nb, s, s) LU factors of the pivoted diagonal blocks
    Dpiv: torch.Tensor  # (nb, s) pivots
    L: torch.Tensor  # (nb, s, s) sub-diagonal multipliers, L[0] = 0
    B: torch.Tensor  # (nb, s, s) super-diagonal blocks, B[nb-1] = 0

    def solve(self, b):
        """Solve A x = b; b (n, k)."""
        nb, s = self.Dlu.shape[0], self.Dlu.shape[1]
        bb = b.reshape(nb, s, -1)
        ys = [bb[0]]
        for j in range(1, nb):
            ys.append(bb[j] - self.L[j] @ ys[-1])
        xs = [None] * nb
        xs[-1] = torch.linalg.lu_solve(self.Dlu[-1], self.Dpiv[-1], ys[-1])
        for j in range(nb - 2, -1, -1):
            xs[j] = torch.linalg.lu_solve(
                self.Dlu[j], self.Dpiv[j], ys[j] - self.B[j] @ xs[j + 1]
            )
        return torch.stack(xs).reshape(nb * s, -1)


def factorize_block_tridiag_dense(A, s: int) -> BlockTridiagFactor:
    """Factorize a dense block-tridiagonal (n, n) matrix with block size s."""
    n = A.shape[0]
    nb = n // s
    if nb * s != n:
        raise ValueError(f"block size {s} does not divide {n}")
    Ab = A.reshape(nb, s, nb, s)
    idx = torch.arange(nb, device=A.device)
    D = Ab[idx, :, idx, :]
    L_A = torch.zeros_like(D)
    L_A[1:] = Ab[idx[1:], :, idx[:-1], :]
    B = torch.zeros_like(D)
    B[:-1] = Ab[idx[:-1], :, idx[1:], :]
    Dp = [D[0]]
    Ls = [torch.zeros_like(D[0])]
    for j in range(1, nb):
        lu, piv = torch.linalg.lu_factor(Dp[-1])
        Lj = torch.linalg.lu_solve(lu, piv, L_A[j], left=False)  # A_j D'^{-1}
        Ls.append(Lj)
        Dp.append(D[j] - Lj @ B[j - 1])
    Dlu, Dpiv = torch.linalg.lu_factor(torch.stack(Dp))
    return BlockTridiagFactor(Dlu=Dlu, Dpiv=Dpiv, L=torch.stack(Ls), B=B)
