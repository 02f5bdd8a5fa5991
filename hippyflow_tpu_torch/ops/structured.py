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
* ``PermutedFactor`` wraps an ``InverseThomasFactor`` of a band assembled
  in the row order of ``fem/band_order.py`` (P2 and vector states) and
  solves in the original dof order.
* ``BlockTridiagFactor`` is block-Thomas with pivoted LU of the diagonal
  blocks, for the dense prior's K-solves (not a TPU kernel).
* ``BlockCyclicFactor`` is block cyclic reduction of one block-tridiagonal
  matrix, for the structured prior's K and M solves: every level inverts
  its eliminated diagonal blocks in one batched call of K3
  (``batched_inverse``); the solves' batched products are ``torch.matmul``,
  as the JAX package leaves them to XLA.
* ``BlockBidiagCholesky`` is the block Cholesky factor of an SPD band, the
  structured prior's square root of M (no TPU kernel).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .hopper_kernels import banded_factorize, banded_solve, batched_inverse


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


class PermutedFactor(NamedTuple):
    """A factor of P A P^T (the band of a ``fem.band_order.BandOrder``)
    exposed in the original dof order: ``solve`` gathers the rhs into band
    order (zero pad rows at the tail), solves through the inner factor and
    gathers back, one gather each way around the band solve.  Batched
    like its inner factor."""

    inner: InverseThomasFactor
    border: object  # BandOrder (numpy, static)

    def solve(self, b, trans: bool = False):
        """Solve A x = b (or A^T x = b) per sample; b (N, n) or (N, n, k)."""
        bo = self.border
        squeeze = b.ndim == 2
        if squeeze:
            b = b[..., None]
        order = torch.as_tensor(bo.order, device=b.device)
        inv = torch.as_tensor(bo.inv, device=b.device)
        pad = torch.zeros((b.shape[0], bo.n_pad, b.shape[-1]), dtype=b.dtype,
                          device=b.device)
        x = self.inner.solve(torch.cat([b[:, order], pad], dim=1), trans=trans)
        out = x[:, inv]
        return out[..., 0] if squeeze else out


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


# ---------------------------------------------------------------------------
# Block cyclic reduction (port of the JAX package's ops/structured.py)
# ---------------------------------------------------------------------------
#
# Per level, with blocks a_j x_{j-1} + d_j x_j + b_j x_{j+1} = f_j, the odd
# unknowns are eliminated; for even j = 2k the reduced system is
#   a'_k = -alpha_k a_{j-1},   b'_k = -beta_k b_{j+1},
#   d'_k = d_j - alpha_k b_{j-1} - beta_k a_{j+1},
#   f'_k = f_j - alpha_k f_{j-1} - beta_k f_{j+1},
# with alpha_k = a_j inv(d_{j-1}), beta_k = b_j inv(d_{j+1}).  The up sweep
# recovers the odd unknowns: x_j = inv(d_j) (f_j - a_j x_{j-1} - b_j x_{j+1}).


def _block_inv(X):
    """Batched inverse of the eliminated diagonal blocks: K3 on the card."""
    return batched_inverse(X.contiguous())


class _CRLevel(NamedTuple):
    Dinv_odd: torch.Tensor  # (n_odd, s, s) inverses of eliminated diagonals
    alpha: torch.Tensor  # (n_even, s, s)
    beta: torch.Tensor  # (n_even, s, s)
    a_odd: torch.Tensor  # (n_odd, s, s) original sub-diagonals at odd rows
    b_odd: torch.Tensor  # (n_odd, s, s) original super-diagonals at odd rows


def _pad_front(x, pad_block):
    return torch.cat([pad_block[None], x], dim=0)


def _pad_back(x, pad_block):
    return torch.cat([x, pad_block[None]], dim=0)


def _cr_reduce(a, d, b):
    """One cyclic-reduction level. Returns (_CRLevel, (a', d', b'))."""
    n, s = d.shape[0], d.shape[1]
    n_even = (n + 1) // 2
    eye = torch.eye(s, dtype=d.dtype, device=d.device)
    zero = torch.zeros((s, s), dtype=d.dtype, device=d.device)

    a_odd, d_odd, b_odd = a[1::2], d[1::2], b[1::2]
    Dinv_odd = _block_inv(d_odd)

    # neighbour tables of the even rows j = 2k: identity and zero pads stand
    # for the missing j-1 at k=0 and j+1 at the end of an odd-length level
    # (a_0 and b_{n-1} are zero, so the pads never leak)
    Dm1 = _pad_front(Dinv_odd, eye)[:n_even]
    Dp1 = _pad_back(Dinv_odd, eye)[:n_even]
    am1 = _pad_front(a_odd, zero)[:n_even]
    bm1 = _pad_front(b_odd, zero)[:n_even]
    ap1 = _pad_back(a_odd, zero)[:n_even]
    bp1 = _pad_back(b_odd, zero)[:n_even]

    a_e, d_e, b_e = a[0::2], d[0::2], b[0::2]
    n_e = a_e.shape[0]
    ab = torch.cat([a_e, b_e]) @ torch.cat([Dm1, Dp1])  # [alpha; beta]
    alpha, beta = ab[:n_e], ab[n_e:]
    d_new = d_e - torch.cat([alpha, beta], dim=2) @ torch.cat([bm1, ap1], dim=1)
    ab2 = ab @ torch.cat([am1, bp1])
    a_new, b_new = -ab2[:n_e], -ab2[n_e:]
    level = _CRLevel(Dinv_odd=Dinv_odd, alpha=alpha, beta=beta, a_odd=a_odd,
                     b_odd=b_odd)
    return level, (a_new, d_new, b_new)


class BlockCyclicFactor(NamedTuple):
    """Cyclic-reduction factorization of one block-tridiagonal matrix.

    ``trans_levels``/``Dinv_root_T`` hold the factorization of A^T (built
    from the transposed band) when adjoint solves were asked for."""

    levels: Optional[tuple]  # of _CRLevel, coarsening by ~2x each entry
    Dinv_root: Optional[torch.Tensor]  # (s, s)
    trans_levels: Optional[tuple]
    Dinv_root_T: Optional[torch.Tensor]

    @property
    def s(self):
        root = self.Dinv_root if self.Dinv_root is not None else self.Dinv_root_T
        return root.shape[-1]

    def solve(self, rhs, trans: bool = False):
        """Solve A x = rhs (or A^T x = rhs); rhs (n,) or (n, k)."""
        levels = self.trans_levels if trans else self.levels
        Dinv_root = self.Dinv_root_T if trans else self.Dinv_root
        if levels is None:
            raise ValueError(
                "this direction was not factorized (with_transpose/with_forward)"
            )
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs[:, None]
        s = self.s
        f = rhs.reshape(-1, s, rhs.shape[-1])  # (nb, s, k)
        zerov = torch.zeros((s, f.shape[-1]), dtype=f.dtype, device=f.device)

        # down sweep: reduce the rhs level by level
        fs = [f]
        for lv in levels:
            n_even = lv.alpha.shape[0]
            fm1 = _pad_front(f[1::2], zerov)[:n_even]
            fp1 = _pad_back(f[1::2], zerov)[:n_even]
            f = f[0::2] - lv.alpha @ fm1 - lv.beta @ fp1
            fs.append(f)

        x = Dinv_root @ f  # (1, s, k)

        # up sweep: interleave the odd unknowns back in
        for lv, f_l in zip(reversed(levels), reversed(fs[:-1])):
            n_even = x.shape[0]
            n_odd = lv.Dinv_odd.shape[0]
            x_p1 = _pad_back(x[1:], zerov)[:n_odd]
            x_m1 = x[:n_odd]
            rhs_odd = f_l[1::2] - lv.a_odd @ x_m1 - lv.b_odd @ x_p1
            merged = torch.empty((n_even + n_odd,) + x.shape[1:], dtype=x.dtype,
                                 device=x.device)
            merged[0::2] = x
            merged[1::2] = lv.Dinv_odd @ rhs_odd
            x = merged

        out = x.reshape(-1, rhs.shape[-1])
        return out[:, 0] if squeeze else out


def _transpose_band(a, d, b):
    """Band of A^T: (A^T)_{j,j-1} = b_{j-1}^T, diagonal d_j^T,
    (A^T)_{j,j+1} = a_{j+1}^T."""
    zero = torch.zeros_like(d[0])
    a_t = _pad_front(b.mT[:-1], zero)
    b_t = _pad_back(a.mT[1:], zero)
    return a_t, d.mT, b_t


def factorize_block_cyclic(D, L_A, B, with_transpose: bool = True,
                           with_forward: bool = True) -> BlockCyclicFactor:
    """Cyclic-reduction factorization from the three block diagonals
    (nb, s, s) each.  ``with_transpose`` also factorizes A^T (adjoint
    solves); ``with_forward=False`` skips A itself."""
    if not (with_transpose or with_forward):
        raise ValueError("factorize at least one of A and A^T")

    def run(a, d, b):
        levels = []
        while d.shape[0] > 1:
            lv, (a, d, b) = _cr_reduce(a, d, b)
            levels.append(lv)
        return tuple(levels), _block_inv(d)[0]

    levels, Dinv_root = (None, None)
    if with_forward:
        levels, Dinv_root = run(L_A, D, B)
    trans_levels, Dinv_root_T = (None, None)
    if with_transpose:
        trans_levels, Dinv_root_T = run(*_transpose_band(L_A, D, B))
    return BlockCyclicFactor(levels=levels, Dinv_root=Dinv_root,
                             trans_levels=trans_levels, Dinv_root_T=Dinv_root_T)


def factorize_block_cyclic_banded(band, with_transpose: bool = True,
                                  with_forward: bool = True) -> BlockCyclicFactor:
    """Cyclic reduction from (nb, s, 3s) band storage."""
    s = band.shape[1]
    return factorize_block_cyclic(
        band[:, :, s : 2 * s], band[:, :, :s], band[:, :, 2 * s :],
        with_transpose=with_transpose, with_forward=with_forward,
    )


# ---------------------------------------------------------------------------
# Block Cholesky of an SPD band
# ---------------------------------------------------------------------------


class BlockBidiagCholesky(NamedTuple):
    """Block-bidiagonal Cholesky factor L of an SPD block-tridiagonal matrix
    (M = L L^T): lower-triangular diagonal blocks C and sub-diagonal blocks
    Off.  Cholesky keeps the band, so this is the dense Cholesky factor."""

    C: torch.Tensor  # (nb, s, s) lower-triangular diagonal blocks
    Off: torch.Tensor  # (nb, s, s) sub-diagonal blocks, Off[0] = 0

    def matvec_L(self, X):
        """L @ X; X (n,) or (n, k)."""
        squeeze = X.ndim == 1
        if squeeze:
            X = X[:, None]
        nb, s = self.C.shape[0], self.C.shape[1]
        xb = X.reshape(nb, s, -1)
        y = torch.tril(self.C) @ xb
        y[1:] += self.Off[1:] @ xb[:-1]
        out = y.reshape(nb * s, -1)
        return out[:, 0] if squeeze else out


def block_cholesky_tridiag(band) -> BlockBidiagCholesky:
    """Block Cholesky of an SPD matrix in (nb, s, 3s) band storage:
    Off_j = A_j C_{j-1}^{-T},  C_j = chol(D_j - Off_j Off_j^T)."""
    s = band.shape[1]
    L_A, D = band[:, :, :s], band[:, :, s : 2 * s]
    C = torch.empty_like(D)
    Off = torch.zeros_like(D)
    C[0] = torch.linalg.cholesky(D[0])
    for j in range(1, D.shape[0]):
        # Off = A C^{-T}, from C Off^T = A^T
        Off[j] = torch.linalg.solve_triangular(C[j - 1], L_A[j].mT, upper=False).mT
        C[j] = torch.linalg.cholesky(D[j] - Off[j] @ Off[j].mT)
    return BlockBidiagCholesky(C=C, Off=Off)
