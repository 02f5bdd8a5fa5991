"""Block-tridiagonal matrices in plain PyTorch, batched over samples.

A batch is held as blocks (N, nb, 3, s, s): slot 0 of block row j is
A[j, j-1], slot 1 is A[j, j] and slot 2 is A[j, j+1] (slot 0 of the first
row and slot 2 of the last are zero).  The factorization is block LU
without pivoting across blocks: each Schur complement
S_j = A[j, j] - A[j, j-1] S_{j-1}^{-1} A[j-1, j] is inverted whole
(``torch.linalg.inv``, partial pivoting inside the block), and every
solve is a sweep of products with those inverses.

Every product goes through an ``Arith``: exact in the tensors' dtype, or
with both operands rounded to TF32 first (10 explicit mantissa bits, as
the tensor cores' TF32 mode reads float32 operands; the sums stay
float32), which is how the control runs the reference one precision
below the program's float32.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


class Arith:
    """Products a @ b, exact in the dtype or with TF32 operands."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a, b):
        if self.tf32 and a.dtype == torch.float32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b


EXACT = Arith(False)


def matmat(blocks, X, ar: Arith = EXACT):
    """A @ X for blocks (N, nb, 3, s, s) (N may be 1 and broadcast) and
    X (N, n, k)."""
    nb, s = blocks.shape[1], blocks.shape[3]
    N, k = X.shape[0], X.shape[-1]
    Xb = X.reshape(N, nb, s, k)
    Y = ar.mm(blocks[:, :, 1], Xb)
    Y[:, 1:] += ar.mm(blocks[:, 1:, 0], Xb[:, :-1])
    Y[:, :-1] += ar.mm(blocks[:, :-1, 2], Xb[:, 1:])
    return Y.reshape(N, nb * s, k)


def factor(blocks, ar: Arith = EXACT):
    """The inverses of the Schur complements, (N, nb, s, s)."""
    N, nb = blocks.shape[:2]
    Sinv = torch.empty_like(blocks[:, :, 1])
    Sinv[:, 0] = torch.linalg.inv(blocks[:, 0, 1])
    for j in range(1, nb):
        S = blocks[:, j, 1] - ar.mm(blocks[:, j, 0],
                                    ar.mm(Sinv[:, j - 1], blocks[:, j - 1, 2]))
        Sinv[:, j] = torch.linalg.inv(S)
    return Sinv


def solve(blocks, Sinv, B, trans: bool = False, ar: Arith = EXACT):
    """A^{-1} B, or A^{-T} B with ``trans``, for B (N, n, k).  The
    transposed sweep uses that the Schur complements of A^T are S_j^T."""
    nb, s = blocks.shape[1], blocks.shape[3]
    N, k = B.shape[0], B.shape[-1]
    Y = B.reshape(N, nb, s, k).clone()
    X = torch.empty_like(Y)
    if not trans:
        lower = lambda j: blocks[:, j, 0]            # A[j, j-1]
        upper = lambda j: blocks[:, j, 2]            # A[j, j+1]
        inv = lambda j: Sinv[:, j]
    else:
        lower = lambda j: blocks[:, j - 1, 2].mT     # A^T[j, j-1]
        upper = lambda j: blocks[:, j + 1, 0].mT     # A^T[j, j+1]
        inv = lambda j: Sinv[:, j].mT
    for j in range(1, nb):
        Y[:, j] -= ar.mm(lower(j), ar.mm(inv(j - 1), Y[:, j - 1]))
    X[:, nb - 1] = ar.mm(inv(nb - 1), Y[:, nb - 1])
    for j in range(nb - 2, -1, -1):
        X[:, j] = ar.mm(inv(j), Y[:, j] - ar.mm(upper(j), X[:, j + 1]))
    return X.reshape(N, nb * s, k)


def cholesky_lower(blocks):
    """The block lower-bidiagonal Cholesky factor L of one symmetric
    positive definite block-tridiagonal matrix (blocks (1, nb, 3, s, s)),
    returned in the same storage (slot 2 zero).  It is the dense Cholesky
    factor: the band keeps no fill outside it."""
    nb = blocks.shape[1]
    L = torch.zeros_like(blocks)
    C = torch.linalg.cholesky(blocks[:, 0, 1])
    L[:, 0, 1] = C
    for j in range(1, nb):
        # Off_j = A[j, j-1] C_{j-1}^{-T}
        off = torch.linalg.solve_triangular(C, blocks[:, j, 0].mT,
                                            upper=False).mT
        C = torch.linalg.cholesky(blocks[:, j, 1] - off @ off.mT)
        L[:, j, 0], L[:, j, 1] = off, C
    return L
