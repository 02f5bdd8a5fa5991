"""BiLaplacian Gaussian priors (port of ``hippyflow_tpu/models/prior.py``).

Precision R = K M^{-1} K with K = gamma * stiffness(Theta) + delta * M
(+ a Robin boundary mass with ``robin_bc``).  Samples are
m = mean + K^{-1} L_M xi with M = L_M L_M^T.

* ``BiLaplacianPrior`` (dense): K-solves by block-Thomas with pivoted LU
  blocks, M-solves by the dense Cholesky factor.
* ``StructuredBiLaplacianPrior``: the same distribution in (nb, s, 3s) band
  storage for large structured meshes (no n x n array): M and K matvecs
  are banded, M and K solves run through block cyclic reduction (K3 on
  the card), and L_M is the block Cholesky factor of M's band, which is
  the dense Cholesky factor.  ``confusion_prior`` takes it above 20000
  dofs (the nx=192 lane).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..fem import (
    FunctionSpace,
    boundary_mass_matrix_banded,
    mass_matrix,
    mass_matrix_banded,
    stiffness_matrix,
    stiffness_matrix_banded,
)
from ..ops.linalg import CholeskyFactor
from ..ops.structured import (
    block_cholesky_tridiag,
    block_tridiag_matmat,
    factorize_block_cyclic_banded,
    factorize_block_tridiag_dense,
)


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
        return self._K_fac.solve(X)

    def R_matmat(self, X):
        """R @ X = K M^{-1} K X."""
        return self.K_matmat(self.Msolver_matmat(self.K_matmat(X)))

    def Rsolver_matmat(self, X):
        """R^{-1} @ X = K^{-1} M K^{-1} X (this is also C @ X)."""
        return self.Ksolver_matmat(self.M_matmat(self.Ksolver_matmat(X)))

    def C_matmat(self, X):
        return self.Rsolver_matmat(X)

    def sample(self, noise):
        """White noise (N, n) or (n,) -> prior samples mean + K^{-1} L_M xi
        of the same shape."""
        noise = torch.as_tensor(noise, dtype=self.mean.dtype,
                                device=self.mean.device)
        batched = noise.ndim == 2
        xi = noise.T if batched else noise[:, None]
        m = self.Ksolver_matmat(self.sqrtM_matmat(xi))
        m = m.T if batched else m[:, 0]
        return self.mean + m


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
        dtype=None,
        device=None,
    ):
        if Vh.mesh.structured_shape is None:
            raise NotImplementedError("only structured meshes")
        dtype, device = config.resolve(dtype, device)
        self.Vh = Vh
        self.gamma, self.delta = float(gamma), float(delta)
        self.M = mass_matrix(Vh, dtype=dtype, device=device)
        self._M_chol = CholeskyFactor(L=torch.linalg.cholesky(self.M))
        A = stiffness_matrix(
            Vh, aniso_tensor_2d(theta0, theta1, alpha), dtype=dtype, device=device
        )
        self.K = self.gamma * A + self.delta * self.M
        self._K_fac = factorize_block_tridiag_dense(
            self.K, Vh.mesh.structured_shape[0] + 1
        )
        if mean is None:
            mean = torch.zeros(Vh.dim, dtype=dtype, device=device)
        self.mean = torch.as_tensor(mean, dtype=dtype, device=device)

    def M_matmat(self, X):
        return self.M @ X

    def Msolver_matmat(self, X):
        return self._M_chol.solve(X)

    def K_matmat(self, X):
        return self.K @ X


class StructuredBiLaplacianPrior(_BiLaplacianOperators):
    """The BiLaplacian prior in band storage, O(n s) memory.

    The same covariance, precision and sampling distribution as
    ``BiLaplacianPrior`` (given the same noise, the same samples up to
    roundoff), with the operator surface of the JAX package's
    ``StructuredBiLaplacianPrior`` (materialized, single device).  Not
    ported: ``materialize=False``, which only keeps XLA's programs small
    (the port builds its bands and factors once, here), and the
    dof-sharded ``mesh=`` path (partitioned SPIKE), which belongs with the
    parallel layer."""

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
        if Vh.mesh.structured_shape is None or Vh.degree != 1:
            raise NotImplementedError("structured P1 meshes only")
        dtype, device = config.resolve(dtype, device)
        self.Vh = Vh
        self.gamma, self.delta = float(gamma), float(delta)
        kw = dict(dtype=dtype, device=device)
        self.M_band = mass_matrix_banded(Vh, **kw)
        A_band = stiffness_matrix_banded(
            Vh, aniso_tensor_2d(theta0, theta1, alpha), **kw
        )
        K_band = self.gamma * A_band + self.delta * self.M_band
        if robin_bc:
            beta = math.sqrt(self.gamma * self.delta) / 1.42
            K_band = K_band + beta * boundary_mass_matrix_banded(Vh, **kw)
        self.K_band = K_band
        self._M_chol = block_cholesky_tridiag(self.M_band)
        self._K_fac = factorize_block_cyclic_banded(K_band, with_transpose=False)
        self._M_fac = factorize_block_cyclic_banded(self.M_band,
                                                    with_transpose=False)
        if mean is None:
            mean = torch.zeros(Vh.dim, **kw)
        self.mean = torch.as_tensor(mean, **kw)

    def M_matmat(self, X):
        return _band_matmat(self.M_band, X)

    def Msolver_matmat(self, X):
        return self._M_fac.solve(X)

    def K_matmat(self, X):
        return _band_matmat(self.K_band, X)


def _band_matmat(band, X):
    """One (nb, s, 3s) band times X (n, k) or (n,)."""
    return block_tridiag_matmat(band[None], X[None])[0]


def BiLaplacian2D(Vh, gamma: float = 0.1, delta: float = 0.1,
                  theta0: float = 2.0, theta1: float = 0.5,
                  alpha: float = math.pi / 4.0, mean=None, dtype=None,
                  device=None):
    """Reference-parity factory (hippyflow's ``maternPrior.BiLaplacian2D``)."""
    return BiLaplacianPrior(Vh, gamma, delta, theta0, theta1, alpha,
                            mean=mean, dtype=dtype, device=device)
