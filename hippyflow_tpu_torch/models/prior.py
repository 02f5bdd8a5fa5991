"""BiLaplacian Gaussian priors (port of ``hippyflow_tpu/models/prior.py``).

Precision R = K M^{-1} K with K = gamma * stiffness(Theta) + delta * M
(+ a Robin boundary mass with ``robin_bc``).  Samples are
m = mean + K^{-1} L_M xi with M = L_M L_M^T.

* ``BiLaplacianPrior`` (dense): K-solves by block-Thomas with pivoted LU
  blocks on structured meshes and by a dense Cholesky factor of K on
  unstructured ones, M-solves by the dense Cholesky factor.
* ``StructuredBiLaplacianPrior``: the same distribution in (nb, s, 3s) band
  storage for large structured meshes (no n x n array): M and K matvecs
  are banded, M and K solves run through block cyclic reduction (K3 on
  the card), and L_M is the block Cholesky factor of M's band, which is
  the dense Cholesky factor.  ``confusion_prior`` takes it above 20000
  dofs (the nx=192 lane).

``LaplacianPrior`` (dense) has the precision R = gamma A + delta M itself,
isotropic, with a dense Cholesky factor R = L_R L_R^T; its samples are
m = mean + L_R^{-T} xi.

``sample`` is a ``prior.sample`` span, and the R, R^-1, K^-1 and M^-1
products ``prior.solve`` spans (``utils.profiling.annotate``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..fem import (
    FunctionSpace,
    boundary_mass_matrix,
    boundary_mass_matrix_banded,
    mass_matrix,
    mass_matrix_banded,
    stiffness_matrix,
    stiffness_matrix_banded,
)
from ..fem.assembly import (
    _boundary_mass_elements,
    band_indices,
    p1_mass_elements,
    p1_stiffness_elements,
)
from ..ops.linalg import CholeskyFactor
from ..ops.structured import (
    block_cholesky_tridiag,
    block_tridiag_matmat,
    factorize_block_cyclic_banded,
    factorize_block_tridiag_dense,
)
from ..utils.profiling import annotate


def aniso_tensor_2d(theta0: float, theta1: float, alpha: float) -> np.ndarray:
    """Constant anisotropic diffusion tensor (hippylib's AnisTensor2D)."""
    sa, ca = math.sin(alpha), math.cos(alpha)
    return np.array(
        [
            [theta0 * sa * sa + theta1 * ca * ca, (theta0 - theta1) * sa * ca],
            [(theta0 - theta1) * sa * ca, theta0 * ca * ca + theta1 * sa * sa],
        ]
    )


class _BiLaplacianOperators:
    """The operator surface both priors share, on X (n, k) -> (n, k).
    Subclasses provide M_matmat, Msolver_matmat and K_matmat and the
    factors ``_M_chol`` (``matvec_L``) and ``_K_fac`` (``solve``)."""

    Vh: FunctionSpace
    mean: torch.Tensor

    @property
    def dim(self) -> int:
        return self.Vh.dim

    @property
    def noise_dim(self) -> int:
        return self.Vh.dim

    def sqrtM_matmat(self, X):
        """L_M @ X with M = L_M L_M^T."""
        return self._M_chol.matvec_L(X)

    def Ksolver_matmat(self, X):
        with annotate("prior.solve", fine=True):
            return self._K_fac.solve(X)

    def R_matmat(self, X):
        """R @ X = K M^{-1} K X."""
        with annotate("prior.solve", fine=True):
            return self.K_matmat(self.Msolver_matmat(self.K_matmat(X)))

    def Rsolver_matmat(self, X):
        """R^{-1} @ X = K^{-1} M K^{-1} X (this is also C @ X)."""
        with annotate("prior.solve", fine=True):
            return self.Ksolver_matmat(self.M_matmat(self.Ksolver_matmat(X)))

    def C_matmat(self, X):
        return self.Rsolver_matmat(X)

    def sample(self, noise):
        """White noise (N, n) or (n,) -> prior samples mean + K^{-1} L_M xi
        of the same shape."""
        with annotate("prior.sample", fine=True):
            noise = torch.as_tensor(noise, dtype=self.mean.dtype,
                                    device=self.mean.device)
            batched = noise.ndim == 2
            xi = noise.T if batched else noise[:, None]
            m = self.Ksolver_matmat(self.sqrtM_matmat(xi))
            m = m.T if batched else m[:, 0]
            return self.mean + m

    def sample_n(self, keychain, n: int, dtype=None):
        """n prior samples (n, dim) from the white noise of a ``KeyChain``
        or ``GivenNoise`` stream, drawn and sampled at the prior's dtype,
        returned at ``dtype`` (default the prior's)."""
        m = self.sample(keychain.normal((n, self.noise_dim),
                                        dtype=self.mean.dtype))
        return m if dtype is None else m.to(dtype)


def robin_coefficient(gamma: float, delta: float) -> float:
    """hippylib's Robin correction beta = sqrt(gamma delta) / 1.42 of the
    boundary mass term, which reduces the boundary variance inflation."""
    return math.sqrt(gamma * delta) / 1.42


class BiLaplacianPrior(_BiLaplacianOperators):
    """Matern-like Gaussian prior with BiLaplacian precision, dense."""

    def __init__(
        self,
        Vh: FunctionSpace,
        gamma: float,
        delta: float,
        theta0: float = 2.0,
        theta1: float = 0.5,
        alpha: float = math.pi / 4.0,
        mean=None,
        robin_bc: bool = False,
        dtype=None,
        device=None,
    ):
        dtype, device = config.resolve(dtype, device)
        self.Vh = Vh
        self.gamma, self.delta = float(gamma), float(delta)
        self.M = mass_matrix(Vh, dtype=dtype, device=device)
        self._M_chol = CholeskyFactor(L=torch.linalg.cholesky(self.M))
        A = stiffness_matrix(
            Vh, aniso_tensor_2d(theta0, theta1, alpha), dtype=dtype, device=device
        )
        self.K = self.gamma * A + self.delta * self.M
        if robin_bc:
            self.K = self.K + robin_coefficient(self.gamma, self.delta) * (
                boundary_mass_matrix(Vh, dtype=dtype, device=device))
        if Vh.mesh.structured_shape is not None:
            self._K_fac = factorize_block_tridiag_dense(
                self.K, Vh.mesh.structured_shape[0] + 1)
        else:
            self._K_fac = CholeskyFactor(L=torch.linalg.cholesky(self.K))
        if mean is None:
            mean = torch.zeros(Vh.dim, dtype=dtype, device=device)
        self.mean = torch.as_tensor(mean, dtype=dtype, device=device)

    def M_matmat(self, X):
        return self.M @ X

    def Msolver_matmat(self, X):
        with annotate("prior.solve", fine=True):
            return self._M_chol.solve(X)

    def K_matmat(self, X):
        return self.K @ X


class StructuredBiLaplacianPrior(_BiLaplacianOperators):
    """The BiLaplacian prior in band storage, O(n s) memory.

    The same covariance, precision and sampling distribution as
    ``BiLaplacianPrior`` (given the same noise, the same samples up to
    roundoff), with the operator surface of the JAX package's
    ``StructuredBiLaplacianPrior``.  Not ported: ``materialize=False``,
    which only keeps XLA's programs small (the port builds its bands and
    factors once, here); so ``device``, ``mesh`` and ``fem_axis``, which
    follow it in the JAX package's order, are keyword-only here.

    With a device ``mesh`` (``parallel.make_sample_fem_mesh``) the prior
    is dof-sharded over its ``fem_axis``: each rank assembles only its own
    block rows (``parallel.dist_assemble_band``), the K and M solves are
    partitioned SPIKE factors (``parallel.factorize_distributed_banded``),
    the products halo products (``parallel.dist_block_tridiag_matmat``),
    and the block Cholesky factor of M runs down the ranks, each taking
    the last diagonal factor of the rank before it (one hop a rank).
    Inputs and outputs stay the global tensors every rank holds."""

    def __init__(
        self,
        Vh: FunctionSpace,
        gamma: float,
        delta: float,
        theta0: float = 2.0,
        theta1: float = 0.5,
        alpha: float = math.pi / 4.0,
        mean=None,
        robin_bc: bool = False,
        dtype=None,
        *,
        device=None,
        mesh=None,
        fem_axis: str = "fem",
    ):
        if Vh.mesh.structured_shape is None or Vh.degree != 1:
            raise NotImplementedError("structured P1 meshes only")
        dtype, device = config.resolve(dtype, device)
        self.Vh = Vh
        self.gamma, self.delta = float(gamma), float(delta)
        kw = dict(dtype=dtype, device=device)
        self._mesh, self._fem_axis = mesh, fem_axis
        if mesh is not None:
            self._build_sharded(theta0, theta1, alpha, robin_bc, kw)
            self.mean = (torch.zeros(Vh.dim, **kw) if mean is None
                         else torch.as_tensor(mean, **kw))
            return
        self.M_band = mass_matrix_banded(Vh, **kw)
        A_band = stiffness_matrix_banded(
            Vh, aniso_tensor_2d(theta0, theta1, alpha), **kw
        )
        K_band = self.gamma * A_band + self.delta * self.M_band
        if robin_bc:
            K_band = K_band + robin_coefficient(self.gamma, self.delta) * (
                boundary_mass_matrix_banded(Vh, **kw))
        self.K_band = K_band
        self._M_chol = block_cholesky_tridiag(self.M_band)
        self._K_fac = factorize_block_cyclic_banded(K_band, with_transpose=False)
        self._M_fac = factorize_block_cyclic_banded(self.M_band,
                                                    with_transpose=False)
        if mean is None:
            mean = torch.zeros(Vh.dim, **kw)
        self.mean = torch.as_tensor(mean, **kw)

    def _build_sharded(self, theta0, theta1, alpha, robin_bc, kw):
        """The dof-sharded bands and factors (see the class doc)."""
        from ..parallel.dist_banded import (
            _axis,
            _rows_dtensor,
            dist_assemble_band,
            factorize_distributed_banded,
            partition_cells_by_row,
        )

        Vh, mesh, axis = self.Vh, self._mesh, self._fem_axis
        s = Vh.mesh.structured_shape[0] + 1
        nb = Vh.dim // s
        ax = _axis(mesh, axis)
        np_dtype = torch.empty((), dtype=kw["dtype"]).numpy().dtype

        def assemble(vals_e, conn, pad_identity=True):
            idx = band_indices(Vh, conn)
            plan, _ = partition_cells_by_row((np.asarray(conn) // s).min(axis=1),
                                             nb, ax.size)
            vals = torch.as_tensor(vals_e.reshape(len(idx), -1).astype(np_dtype),
                                   device=kw["device"])
            return dist_assemble_band(mesh, vals, torch.as_tensor(idx),
                                      plan, nb, s, axis, pad_identity)

        cells = Vh.mesh.cells
        M_e = p1_mass_elements(Vh)
        K_e = (self.gamma * p1_stiffness_elements(
            Vh, aniso_tensor_2d(theta0, theta1, alpha)) + self.delta * M_e)
        self.M_band = assemble(M_e, cells)
        K_band = assemble(K_e, cells)
        if robin_bc:
            edges, Mb_e = _boundary_mass_elements(Vh)
            K_band = K_band + assemble(
                robin_coefficient(self.gamma, self.delta) * Mb_e, edges,
                pad_identity=False)
        self.K_band = K_band
        n, P = Vh.dim, ax.size
        self._K_fac = factorize_distributed_banded(K_band, P, with_transpose=False,
                                                   n_true=n)
        self._M_fac = factorize_distributed_banded(self.M_band, P,
                                                   with_transpose=False, n_true=n)
        # M's block Cholesky down the ranks: each rank's first row couples
        # to the previous rank's last, whose diagonal factor arrives in one
        # hop (rank 0 starts)
        M_loc = self.M_band.to_local()
        C_prev = None
        if ax.pos > 0:
            C_prev = torch.empty_like(M_loc[0, :, :s])
            torch.distributed.recv(C_prev, torch.distributed.get_global_rank(
                ax.group, ax.pos - 1), group=ax.group)
        chol = block_cholesky_tridiag(M_loc, C_prev)
        if ax.pos + 1 < ax.size:
            torch.distributed.send(chol.C[-1].contiguous(),
                                   torch.distributed.get_global_rank(
                                       ax.group, ax.pos + 1), group=ax.group)
        # L_M is block lower bidiagonal: the band [Off, tril(C), 0]
        band_L = torch.cat([chol.Off, torch.tril(chol.C),
                            torch.zeros_like(chol.C)], dim=-1)
        self._M_chol = _ShardedCholesky(
            _rows_dtensor(band_L, mesh, axis, self.M_band.shape[0]), mesh, axis)

    def M_matmat(self, X):
        return _band_matmat(self.M_band, X, self._mesh, self._fem_axis)

    def Msolver_matmat(self, X):
        with annotate("prior.solve", fine=True):
            return self._M_fac.solve(X)

    def K_matmat(self, X):
        return _band_matmat(self.K_band, X, self._mesh, self._fem_axis)


class _ShardedCholesky:
    """The row-sharded band of L_M; ``matvec_L`` is its halo product."""

    def __init__(self, band_L, mesh, axis):
        self.band_L, self.mesh, self.axis = band_L, mesh, axis

    def matvec_L(self, X):
        return _band_matmat(self.band_L, X, self.mesh, self.axis)


def _band_matmat(band, X, mesh=None, axis="fem"):
    """One (nb, s, 3s) band times X (n, k) or (n,): the halo product of a
    row-sharded band over ``mesh``'s ``axis``, else the serial one."""
    if mesh is not None:
        from ..parallel.dist_banded import dist_block_tridiag_matmat

        return dist_block_tridiag_matmat(mesh, band, X, axis)
    return block_tridiag_matmat(band[None], X[None])[0]


class LaplacianPrior:
    """Gaussian prior with Laplacian precision R = gamma A + delta M,
    dense.  As in the JAX package (and the reference, which drops
    ``anis_diff`` when it calls hp.LaplacianPrior), the stiffness is
    isotropic.  ``K`` and ``A`` alias R: the KLE's prior mode takes the
    GHEP of (K, M)."""

    def __init__(self, Vh: FunctionSpace, gamma: float, delta: float,
                 mean=None, dtype=None, device=None):
        dtype, device = config.resolve(dtype, device)
        self.Vh = Vh
        self.gamma, self.delta = float(gamma), float(delta)
        self.M = mass_matrix(Vh, dtype=dtype, device=device)
        self._M_chol = CholeskyFactor(L=torch.linalg.cholesky(self.M))
        A = stiffness_matrix(Vh, None, dtype=dtype, device=device)
        self.R = self.gamma * A + self.delta * self.M
        self.K = self.A = self.R
        self._R_chol = CholeskyFactor(L=torch.linalg.cholesky(self.R))
        if mean is None:
            mean = torch.zeros(Vh.dim, dtype=dtype, device=device)
        self.mean = torch.as_tensor(mean, dtype=dtype, device=device)

    @property
    def dim(self) -> int:
        return self.Vh.dim

    @property
    def noise_dim(self) -> int:
        return self.Vh.dim

    def M_matmat(self, X):
        return self.M @ X

    def Msolver_matmat(self, X):
        with annotate("prior.solve", fine=True):
            return self._M_chol.solve(X)

    def sqrtM_matmat(self, X):
        return self._M_chol.matvec_L(X)

    def R_matmat(self, X):
        with annotate("prior.solve", fine=True):
            return self.R @ X

    def Rsolver_matmat(self, X):
        with annotate("prior.solve", fine=True):
            return self._R_chol.solve(X)

    Ksolver_matmat = Rsolver_matmat
    C_matmat = Rsolver_matmat

    def sample(self, noise):
        """White noise (N, n) or (n,) -> mean + L_R^{-T} xi, so that the
        covariance is R^{-1}."""
        with annotate("prior.sample", fine=True):
            noise = torch.as_tensor(noise, dtype=self.mean.dtype,
                                    device=self.mean.device)
            batched = noise.ndim == 2
            xi = noise.T if batched else noise[:, None]
            m = torch.linalg.solve_triangular(self._R_chol.L.T, xi, upper=True)
            m = m.T if batched else m[:, 0]
            return self.mean + m

    def sample_n(self, keychain, n: int, dtype=None):
        """n prior samples (n, dim) from the white noise of a ``KeyChain``
        or ``GivenNoise`` stream, drawn and sampled at the prior's dtype,
        returned at ``dtype`` (default the prior's)."""
        m = self.sample(keychain.normal((n, self.noise_dim),
                                        dtype=self.mean.dtype))
        return m if dtype is None else m.to(dtype)


def BiLaplacian2D(Vh, gamma: float = 0.1, delta: float = 0.1,
                  theta0: float = 2.0, theta1: float = 0.5,
                  alpha: float = math.pi / 4.0, mean=None,
                  robin_bc: bool = False, dtype=None, device=None):
    """Reference-parity factory (hippyflow's ``maternPrior.BiLaplacian2D``)."""
    return BiLaplacianPrior(Vh, gamma, delta, theta0, theta1, alpha,
                            mean=mean, robin_bc=robin_bc, dtype=dtype,
                            device=device)


def Laplacian2D(Vh, gamma: float = 0.1, delta: float = 0.1,
                theta0: float = 2.0, theta1: float = 0.5,
                alpha: float = math.pi / 4.0, mean=None, dtype=None,
                device=None):
    """Reference-parity factory (hippyflow's ``maternPrior.Laplacian2D``):
    the anisotropy arguments are taken and dropped, as there."""
    del theta0, theta1, alpha
    return LaplacianPrior(Vh, gamma, delta, mean=mean, dtype=dtype,
                          device=device)
