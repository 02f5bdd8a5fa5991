"""Randomized block eigensolvers (port of ``hippyflow_tpu/ops/randomized.py``).

An operator is a callable ``matmat(X: (n, k)) -> (n, k)``.  B-inner-product
orthonormalization is one Householder QR followed by CholQR2 (two rounds
of Cholesky-QR in the B inner product).
"""

from __future__ import annotations

import torch

from .linalg import eigh_descending


def _chol_orth_once(Z, B_matmat):
    W = B_matmat(Z)
    G = Z.T @ W
    # tiny diagonal shift against float32 breakdown for nearly dependent
    # probes; negligible in float64
    eps = torch.finfo(Z.dtype).eps
    G = G + (eps * torch.trace(G) / G.shape[0]) * torch.eye(
        G.shape[0], dtype=Z.dtype, device=Z.device
    )
    L = torch.linalg.cholesky(G)
    return torch.linalg.solve_triangular(L, Z.T, upper=False).T  # Z L^{-T}


def orthogonalize(Z, B_matmat=None, rounds: int = 2):
    """(B-)orthonormalize the columns of Z: Householder QR, then CholQR in
    the B inner product ``rounds`` times when B_matmat is given."""
    Q = torch.linalg.qr(Z).Q
    if B_matmat is None:
        return Q
    for _ in range(rounds):
        Q = _chol_orth_once(Q, B_matmat)
    return Q


def double_pass_g(A_matmat, B_matmat, Binv_matmat, Omega, k: int, s: int = 1):
    """Randomized GHEP A u = lambda B u: returns (d (k,), U (n, k)) with U
    B-orthonormal (hp.doublePassG semantics)."""
    Q = Omega
    for _ in range(s):
        Q = Binv_matmat(A_matmat(Q))
    Q = orthogonalize(Q, B_matmat)
    AQ = A_matmat(Q)
    T = Q.T @ AQ
    T = 0.5 * (T + T.T)
    d, V = eigh_descending(T)
    return d[:k], Q @ V[:, :k]
