"""Randomized block eigensolvers (port of ``hippyflow_tpu/ops/randomized.py``).

An operator is a callable ``matmat(X: (n, k)) -> (n, k)``.  B-inner-product
orthonormalization is one Householder QR followed by CholQR2 (two rounds
of Cholesky-QR in the B inner product).

* ``double_pass``: randomized HEP (hp.doublePass);
* ``double_pass_g``: randomized GHEP in the B inner product (hp.doublePassG);
* ``lanczos_ghep``: smallest GHEP eigenpairs by shift-invert Lanczos;
* ``accuracy_enhanced_svd``: randomized SVD with power iteration
  (hp.accuracyEnhancedSVD).
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


def double_pass(A_matmat, Omega, k: int, s: int = 1):
    """Randomized HEP of a symmetric operator: returns (d (k,), U (n, k)),
    d descending, U orthonormal (hp.doublePass semantics)."""
    Q = Omega
    for _ in range(s):
        Q = A_matmat(Q)
    Q = orthogonalize(Q)
    T = Q.T @ A_matmat(Q)
    T = 0.5 * (T + T.T)
    d, V = eigh_descending(T)
    return d[:k], Q @ V[:, :k]


def lanczos_ghep(Ainv_matmat, B_matmat, v0, k: int, m_iters: int | None = None):
    """The k smallest eigenpairs of the GHEP A v = lambda B v by Lanczos on
    T = A^{-1} B (self-adjoint in the B inner product) with full
    reorthogonalization, two sweeps a step; T's largest Ritz values are
    1/lambda.  ``m_iters`` is the Krylov dimension (default 2k + 10, at
    most n).  Returns (lam (k,) ascending, V (n, k) B-orthonormal)."""
    n = v0.shape[0]
    m = min(m_iters or (2 * k + 10), n)
    dtype, device = v0.dtype, v0.device
    tiny = torch.finfo(dtype).tiny

    def B1(v):
        return B_matmat(v[:, None])[:, 0]

    v0 = v0 / torch.sqrt(v0 @ B1(v0))
    V = torch.zeros((n, m + 1), dtype=dtype, device=device)
    BV = torch.zeros((n, m + 1), dtype=dtype, device=device)
    V[:, 0], BV[:, 0] = v0, B1(v0)
    alphas = torch.empty(m, dtype=dtype, device=device)
    betas = torch.empty(m, dtype=dtype, device=device)
    for j in range(m):
        w = Ainv_matmat(B_matmat(V[:, j, None]))[:, 0]
        alphas[j] = w @ BV[:, j]
        # the not yet filled columns of V and BV are zero, as in the JAX
        # package's scan over preallocated buffers
        for _ in range(2):
            w = w - V @ (BV.T @ w)
        Bw = B1(w)
        beta = torch.sqrt(torch.clamp(w @ Bw, min=tiny))
        V[:, j + 1], BV[:, j + 1] = w / beta, Bw / beta
        betas[j] = beta
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    theta, Y = eigh_descending(T)  # theta ~ 1/lambda
    return 1.0 / theta[:k], V[:, :m] @ Y[:, :k]


def accuracy_enhanced_svd(A_matmat, At_matmat, Omega, k: int, s: int = 1):
    """Randomized SVD of a rectangular operator A (dq, dm) with ``s`` power
    iterations, each re-orthonormalized; Omega (dm, k + oversampling).
    Returns (U (dq, k), sigma (k,), V (dm, k))."""
    Q = orthogonalize(A_matmat(Omega))
    for _ in range(s):
        Z = orthogonalize(At_matmat(Q))
        Q = orthogonalize(A_matmat(Z))
    V_full, sigma, Ut_hat = torch.linalg.svd(At_matmat(Q), full_matrices=False)
    U = Q @ Ut_hat.T
    return U[:, :k], sigma[:k], V_full[:, :k]
