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
* ``PermutedFactor`` wraps a factor of a band assembled in the row order
  of ``fem/band_order.py`` (P2 and vector states) and solves in the
  original dof order.
* ``BlockTridiagFactor`` is block-Thomas with pivoted LU of the diagonal
  blocks (``torch.linalg.lu_factor``, as the JAX package uses
  ``jsl.lu_factor``; not a TPU kernel), for the dense prior's K-solves and
  the ``block_tridiag`` solver choice of ``VariationalPDEProblem``.
* ``BlockCyclicFactor`` is block cyclic reduction, for the structured
  prior's K and M solves and the ``block_cyclic`` solver choice: every
  level inverts its eliminated diagonal blocks, of all samples at once, in
  one batched call of K3 (``batched_inverse``); the solves' batched
  products are ``torch.matmul``, as the JAX package leaves them to XLA.
* ``BlockBidiagCholesky`` is the block Cholesky factor of an SPD band, the
  structured prior's square root of M (no TPU kernel).

Factorizations are ``band.factorize`` spans and the factors' solves
``band.solve`` spans (``utils.profiling.annotate``), with their shapes.

``BlockTridiagFactor`` and ``BlockCyclicFactor`` take one matrix or a
batch: every array may carry a leading sample axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.profiling import annotate
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
        with annotate("band.solve", fine=True, N=N, nb=nb, s=s, k=b.shape[-1]):
            bb = b.reshape(N, nb, s, b.shape[-1]).contiguous()
            x = banded_solve(self.M, self.Dinv, self.B, bb, trans)
            x = x.reshape(N, nb * s, -1)
            return x[..., 0] if squeeze else x


def factorize_thomas_inv_banded(band) -> InverseThomasFactor:
    """Inverse block-Thomas factorization of a batch of bands
    (N, nb, s, 3s): one launch of K1 on the card."""
    N, nb, s = band.shape[:3]
    with annotate("band.factorize", fine=True, N=N, nb=nb, s=s):
        band = band.contiguous()
        M, Dinv = banded_factorize(band)
        return InverseThomasFactor(M=M, Dinv=Dinv,
                                   B=band[..., 2 * s :].contiguous())


def thomas_inv_flops(nb: int, s: int, n_rhs: int = 1) -> float:
    """Operations of one inverse block-Thomas factorization and solve of
    one sample (the JAX package's model): 7 s^3 a block row to factorize
    (an s x s inverse and two products) and 6 s^2 a block row and rhs to
    solve (one product forward, two back)."""
    return float(nb) * (7.0 * s**3 + 6.0 * s**2 * n_rhs)


def thomas_inv_bytes(nb: int, s: int, n_rhs: int = 1,
                     itemsize: int = 4) -> float:
    """Bytes one assembly, factorization and solve of one sample must move
    (the JAX package's model): the band (3 s^2 a block row) written by
    assembly, read and written at the same size by the factorization and
    read by the solve, four times in all, and the rhs block vector three
    times (b read, the carry, x written)."""
    band = 3.0 * nb * s * s * itemsize
    rhs = nb * s * n_rhs * itemsize
    return 4.0 * band + 3.0 * rhs


class PermutedFactor(NamedTuple):
    """A factor of P A P^T (the band of a ``fem.band_order.BandOrder``)
    exposed in the original dof order: ``solve`` gathers the rhs into band
    order (zero pad rows at the tail), solves through the inner factor and
    gathers back, one gather each way around the band solve.  The inner
    factor is any batched band factor (inverse-Thomas, block-Thomas or
    cyclic reduction)."""

    inner: object
    border: object  # BandOrder (numpy, static)

    def solve(self, b, trans: bool = False):
        """Solve A x = b (or A^T x = b) per sample; b (N, n) or (N, n, k)."""
        bo = self.border
        squeeze = b.ndim == 2
        if squeeze:
            b = b[..., None]
        with annotate("band.solve", fine=True, N=b.shape[0], k=b.shape[-1]):
            order = torch.as_tensor(bo.order, device=b.device)
            inv = torch.as_tensor(bo.inv, device=b.device)
            pad = torch.zeros((b.shape[0], bo.n_pad, b.shape[-1]), dtype=b.dtype,
                              device=b.device)
            x = self.inner.solve(torch.cat([b[:, order], pad], dim=1),
                                 trans=trans)
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


def _row(x, j):
    """Block row j of (..., nb, s, t) blocks."""
    return x[..., j, :, :]


def _rhs_blocks(b, lead, nb, s):
    """b (*lead, n) or (*lead, n, k) -> ((*lead, nb, s, k), squeezed)."""
    squeeze = b.ndim == len(lead) + 1
    if squeeze:
        b = b[..., None]
    return b.reshape(*lead, nb, s, b.shape[-1]), squeeze


def _from_blocks(x, lead, squeeze):
    out = x.reshape(*lead, -1, x.shape[-1])
    return out[..., 0] if squeeze else out


class BlockTridiagFactor(NamedTuple):
    """Block-Thomas factorization with pivoted LU of the diagonal blocks:
    L_j = A_j D'_{j-1}^{-1}, D'_j = D_j - L_j B_{j-1}.  Every field has an
    optional leading sample axis: one matrix (the dense prior's K) or a
    batch (the ``block_tridiag`` solver of ``VariationalPDEProblem``)."""

    Dlu: torch.Tensor  # (..., nb, s, s) LU factors of the pivoted diagonal blocks
    Dpiv: torch.Tensor  # (..., nb, s) pivots
    L: torch.Tensor  # (..., nb, s, s) sub-diagonal multipliers, L[0] = 0
    B: torch.Tensor  # (..., nb, s, s) super-diagonal blocks, B[nb-1] = 0

    @property
    def nb(self) -> int:
        return self.Dlu.shape[-3]

    @property
    def s(self) -> int:
        return self.Dlu.shape[-2]

    def solve(self, b, trans: bool = False):
        """Solve A x = b (or A^T x = b); b (n,) or (n, k) for one matrix,
        (N, n) or (N, n, k) for a batch."""
        with annotate("band.solve", fine=True, nb=self.nb, s=self.s):
            return self._solve(b, trans)

    def _solve(self, b, trans: bool):
        lead = self.Dlu.shape[:-3]
        nb, s = self.nb, self.s
        bb, squeeze = _rhs_blocks(b, lead, nb, s)

        def lu_solve(j, r, adjoint=False):
            return torch.linalg.lu_solve(_row(self.Dlu, j), self.Dpiv[..., j, :],
                                         r, adjoint=adjoint)

        xs = [None] * nb
        if not trans:
            ys = [_row(bb, 0)]
            for j in range(1, nb):
                ys.append(_row(bb, j) - _row(self.L, j) @ ys[-1])
            xs[-1] = lu_solve(nb - 1, ys[-1])
            for j in range(nb - 2, -1, -1):
                xs[j] = lu_solve(j, ys[j] - _row(self.B, j) @ xs[j + 1])
        else:
            # A^T = Uhat^T Lhat^T: z_j = D'_j^{-T} (b_j - B_{j-1}^T z_{j-1}),
            # then x_j = z_j - L_{j+1}^T x_{j+1}
            zs = [lu_solve(0, _row(bb, 0), True)]
            for j in range(1, nb):
                zs.append(lu_solve(j, _row(bb, j) - _row(self.B, j - 1).mT @ zs[-1],
                                   True))
            xs[-1] = zs[-1]
            for j in range(nb - 2, -1, -1):
                xs[j] = zs[j] - _row(self.L, j + 1).mT @ xs[j + 1]
        return _from_blocks(torch.stack(xs, dim=-3), lead, squeeze)


def factorize_block_tridiag(D, L_A, B) -> BlockTridiagFactor:
    """Block-Thomas factorization from the three block diagonals
    (..., nb, s, s), a sequential loop over the block rows whose steps are
    batched over the leading axes."""
    with annotate("band.factorize", fine=True, nb=D.shape[-3], s=D.shape[-1]):
        return _factorize_block_tridiag(D, L_A, B)


def _factorize_block_tridiag(D, L_A, B) -> BlockTridiagFactor:
    nb = D.shape[-3]
    Dp = [_row(D, 0)]
    Ls = [torch.zeros_like(Dp[0])]
    for j in range(1, nb):
        lu, piv, _ = torch.linalg.lu_factor_ex(Dp[-1])
        Lj = torch.linalg.lu_solve(lu, piv, _row(L_A, j), left=False)  # A_j D'^{-1}
        Ls.append(Lj)
        Dp.append(_row(D, j) - Lj @ _row(B, j - 1))
    Dlu, Dpiv, _ = torch.linalg.lu_factor_ex(torch.stack(Dp, dim=-3))
    return BlockTridiagFactor(Dlu=Dlu, Dpiv=Dpiv, L=torch.stack(Ls, dim=-3), B=B)


def extract_block_tridiag(A, s: int):
    """(D, L_A, B), each (nb, s, s): the diagonal, sub- and super-diagonal
    blocks of a dense block-tridiagonal (n, n) matrix, L_A[0] = B[nb-1] =
    0."""
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
    return D, L_A, B


def factorize_block_tridiag_dense(A, s: int) -> BlockTridiagFactor:
    """Factorize a dense block-tridiagonal (n, n) matrix with block size s."""
    return factorize_block_tridiag(*extract_block_tridiag(A, s))


def factorize_block_tridiag_banded(band) -> BlockTridiagFactor:
    """Block-Thomas from (..., nb, s, 3s) band storage: no dense matrix."""
    s = band.shape[-2]
    return factorize_block_tridiag(band[..., s : 2 * s], band[..., :s],
                                   band[..., 2 * s :])


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
#
# Every array carries optional leading sample axes: the JAX package runs
# the per-matrix code under vmap, the port runs the same levels for all
# samples at once, so each level inverts all samples' eliminated blocks in
# one call of K3.


def _block_inv(X):
    """Inverses of the (..., n, s, s) eliminated diagonal blocks: one call
    of K3 on the card over all leading axes, (prod(...) n, s, s)."""
    s = X.shape[-1]
    return batched_inverse(X.reshape(-1, s, s).contiguous()).reshape(X.shape)


class _CRLevel(NamedTuple):
    Dinv_odd: torch.Tensor  # (..., n_odd, s, s) inverses of eliminated diagonals
    alpha: torch.Tensor  # (..., n_even, s, s)
    beta: torch.Tensor  # (..., n_even, s, s)
    a_odd: torch.Tensor  # (..., n_odd, s, s) original sub-diagonals at odd rows
    b_odd: torch.Tensor  # (..., n_odd, s, s) original super-diagonals at odd rows


def _pad_front(x, pad_block):
    pad = pad_block.expand(*x.shape[:-3], 1, *pad_block.shape)
    return torch.cat([pad, x], dim=-3)


def _pad_back(x, pad_block):
    pad = pad_block.expand(*x.shape[:-3], 1, *pad_block.shape)
    return torch.cat([x, pad], dim=-3)


def _rows(x, start, step=2):
    return x[..., start::step, :, :]


def _cr_reduce(a, d, b):
    """One cyclic-reduction level. Returns (_CRLevel, (a', d', b'))."""
    n, s = d.shape[-3], d.shape[-1]
    n_even = (n + 1) // 2
    eye = torch.eye(s, dtype=d.dtype, device=d.device)
    zero = torch.zeros((s, s), dtype=d.dtype, device=d.device)
    head = lambda x: x[..., :n_even, :, :]

    a_odd, d_odd, b_odd = _rows(a, 1), _rows(d, 1), _rows(b, 1)
    Dinv_odd = _block_inv(d_odd)

    # neighbour tables of the even rows j = 2k: identity and zero pads stand
    # for the missing j-1 at k=0 and j+1 at the end of an odd-length level
    # (a_0 and b_{n-1} are zero, so the pads never leak)
    Dm1 = head(_pad_front(Dinv_odd, eye))
    Dp1 = head(_pad_back(Dinv_odd, eye))
    am1 = head(_pad_front(a_odd, zero))
    bm1 = head(_pad_front(b_odd, zero))
    ap1 = head(_pad_back(a_odd, zero))
    bp1 = head(_pad_back(b_odd, zero))

    a_e, d_e, b_e = _rows(a, 0), _rows(d, 0), _rows(b, 0)
    n_e = a_e.shape[-3]
    # [alpha; beta]
    ab = torch.cat([a_e, b_e], dim=-3) @ torch.cat([Dm1, Dp1], dim=-3)
    alpha, beta = ab[..., :n_e, :, :], ab[..., n_e:, :, :]
    d_new = d_e - (torch.cat([alpha, beta], dim=-1)
                   @ torch.cat([bm1, ap1], dim=-2))
    ab2 = ab @ torch.cat([am1, bp1], dim=-3)
    a_new, b_new = -ab2[..., :n_e, :, :], -ab2[..., n_e:, :, :]
    level = _CRLevel(Dinv_odd=Dinv_odd, alpha=alpha, beta=beta, a_odd=a_odd,
                     b_odd=b_odd)
    return level, (a_new, d_new, b_new)


class BlockCyclicFactor(NamedTuple):
    """Cyclic-reduction factorization of a block-tridiagonal matrix, or of
    a batch of them (a leading sample axis on every array).

    ``trans_levels``/``Dinv_root_T`` hold the factorization of A^T (built
    from the transposed band) when adjoint solves were asked for."""

    levels: Optional[tuple]  # of _CRLevel, coarsening by ~2x each entry
    Dinv_root: Optional[torch.Tensor]  # (..., s, s)
    trans_levels: Optional[tuple]
    Dinv_root_T: Optional[torch.Tensor]

    @property
    def root(self):
        return self.Dinv_root if self.Dinv_root is not None else self.Dinv_root_T

    @property
    def s(self):
        return self.root.shape[-1]

    def solve(self, rhs, trans: bool = False):
        """Solve A x = rhs (or A^T x = rhs); rhs (n,) or (n, k) for one
        matrix, (N, n) or (N, n, k) for a batch."""
        levels = self.trans_levels if trans else self.levels
        if levels is None:
            raise ValueError(
                "this direction was not factorized (with_transpose/with_forward)"
            )
        with annotate("band.solve", fine=True, levels=len(levels), s=self.s):
            return self._solve(rhs, trans)

    def _solve(self, rhs, trans: bool):
        levels = self.trans_levels if trans else self.levels
        Dinv_root = self.Dinv_root_T if trans else self.Dinv_root
        s, lead = self.s, Dinv_root.shape[:-2]
        f, squeeze = _rhs_blocks(rhs, lead, rhs.shape[len(lead)] // s, s)
        zerov = torch.zeros((s, f.shape[-1]), dtype=f.dtype, device=f.device)

        # down sweep: reduce the rhs level by level
        fs = [f]
        for lv in levels:
            n_even = lv.alpha.shape[-3]
            fm1 = _pad_front(_rows(f, 1), zerov)[..., :n_even, :, :]
            fp1 = _pad_back(_rows(f, 1), zerov)[..., :n_even, :, :]
            f = _rows(f, 0) - lv.alpha @ fm1 - lv.beta @ fp1
            fs.append(f)

        x = Dinv_root[..., None, :, :] @ f  # (..., 1, s, k)

        # up sweep: interleave the odd unknowns back in
        for lv, f_l in zip(reversed(levels), reversed(fs[:-1])):
            n_even = x.shape[-3]
            n_odd = lv.Dinv_odd.shape[-3]
            x_p1 = _pad_back(x[..., 1:, :, :], zerov)[..., :n_odd, :, :]
            x_m1 = x[..., :n_odd, :, :]
            rhs_odd = _rows(f_l, 1) - lv.a_odd @ x_m1 - lv.b_odd @ x_p1
            merged = x.new_empty(x.shape[:-3] + (n_even + n_odd,) + x.shape[-2:])
            merged[..., 0::2, :, :] = x
            merged[..., 1::2, :, :] = lv.Dinv_odd @ rhs_odd
            x = merged
        return _from_blocks(x, lead, squeeze)


def _transpose_band(a, d, b):
    """Band of A^T: (A^T)_{j,j-1} = b_{j-1}^T, diagonal d_j^T,
    (A^T)_{j,j+1} = a_{j+1}^T."""
    zero = torch.zeros(d.shape[-2:], dtype=d.dtype, device=d.device)
    a_t = _pad_front(b.mT[..., :-1, :, :], zero)
    b_t = _pad_back(a.mT[..., 1:, :, :], zero)
    return a_t, d.mT, b_t


def factorize_block_cyclic(D, L_A, B, with_transpose: bool = True,
                           with_forward: bool = True) -> BlockCyclicFactor:
    """Cyclic-reduction factorization from the three block diagonals
    (..., nb, s, s) each.  ``with_transpose`` also factorizes A^T (adjoint
    solves); ``with_forward=False`` skips A itself.  Each direction calls
    K3 once per level and once at the root: ceil(log2 nb) + 1 launches."""
    if not (with_transpose or with_forward):
        raise ValueError("factorize at least one of A and A^T")
    with annotate("band.factorize", fine=True, nb=D.shape[-3], s=D.shape[-1]):
        return _factorize_block_cyclic(D, L_A, B, with_transpose, with_forward)


def _factorize_block_cyclic(D, L_A, B, with_transpose: bool,
                            with_forward: bool) -> BlockCyclicFactor:
    def run(a, d, b):
        levels = []
        while d.shape[-3] > 1:
            lv, (a, d, b) = _cr_reduce(a, d, b)
            levels.append(lv)
        return tuple(levels), _block_inv(d)[..., 0, :, :]

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
    """Cyclic reduction from (..., nb, s, 3s) band storage."""
    s = band.shape[-2]
    return factorize_block_cyclic(
        band[..., s : 2 * s], band[..., :s], band[..., 2 * s :],
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


def block_cholesky_tridiag(band, C_prev=None) -> BlockBidiagCholesky:
    """Block Cholesky of an SPD matrix in (nb, s, 3s) band storage:
    Off_j = A_j C_{j-1}^{-T},  C_j = chol(D_j - Off_j Off_j^T).  With
    ``C_prev``, the band is the block rows after those whose last diagonal
    factor C_prev is (a row-sharded band's next share; its first row's A
    couples to that row); otherwise A_0 = 0."""
    s = band.shape[1]
    L_A, D = band[:, :, :s], band[:, :, s : 2 * s]
    C = torch.empty_like(D)
    Off = torch.zeros_like(D)
    if C_prev is not None:
        Off[0] = torch.linalg.solve_triangular(C_prev, L_A[0].mT, upper=False).mT
    C[0] = torch.linalg.cholesky(D[0] - Off[0] @ Off[0].mT)
    for j in range(1, D.shape[0]):
        # Off = A C^{-T}, from C Off^T = A^T
        Off[j] = torch.linalg.solve_triangular(C[j - 1], L_A[j].mT, upper=False).mT
        C[j] = torch.linalg.cholesky(D[j] - Off[j] @ Off[j].mT)
    return BlockBidiagCholesky(C=C, Off=Off)
