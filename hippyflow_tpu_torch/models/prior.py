"""Dense BiLaplacian Gaussian prior (port of ``hippyflow_tpu/models/prior.py``,
``BiLaplacianPrior``).

Precision R = K M^{-1} K with K = gamma * stiffness(Theta) + delta * M.
Samples are m = mean + K^{-1} L_M xi with M = L_M L_M^T.  K-solves use
block-Thomas with pivoted LU blocks (K is block-tridiagonal on structured
meshes); M-solves the dense Cholesky factor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..fem import FunctionSpace, mass_matrix, stiffness_matrix
from ..ops.linalg import CholeskyFactor
from ..ops.structured import factorize_block_tridiag_dense


def aniso_tensor_2d(theta0: float, theta1: float, alpha: float) -> np.ndarray:
    """Constant anisotropic diffusion tensor (hippylib's AnisTensor2D)."""
    sa, ca = math.sin(alpha), math.cos(alpha)
    return np.array(
        [
            [theta0 * sa * sa + theta1 * ca * ca, (theta0 - theta1) * sa * ca],
            [(theta0 - theta1) * sa * ca, theta0 * ca * ca + theta1 * sa * sa],
        ]
    )


class BiLaplacianPrior:
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

    @property
    def noise_dim(self) -> int:
        return self.Vh.dim

    def R_matmat(self, X):
        """R @ X = K M^{-1} K X."""
        return self.K @ self._M_chol.solve(self.K @ X)

    def Rsolver_matmat(self, X):
        """R^{-1} @ X = K^{-1} M K^{-1} X."""
        return self._K_fac.solve(self.M @ self._K_fac.solve(X))

    def sample(self, noise):
        """White noise (N, n) or (n,) -> prior samples of the same shape."""
        noise = torch.as_tensor(noise, dtype=self.mean.dtype,
                                device=self.mean.device)
        batched = noise.ndim == 2
        xi = noise.T if batched else noise[:, None]
        m = self._K_fac.solve(self._M_chol.matvec_L(xi))
        m = m.T if batched else m[:, 0]
        return self.mean + m


def BiLaplacian2D(Vh, gamma: float = 0.1, delta: float = 0.1,
                  theta0: float = 2.0, theta1: float = 0.5,
                  alpha: float = math.pi / 4.0, mean=None, dtype=None,
                  device=None):
    """Reference-parity factory (hippyflow's ``maternPrior.BiLaplacian2D``)."""
    return BiLaplacianPrior(Vh, gamma, delta, theta0, theta1, alpha,
                            mean=mean, dtype=dtype, device=device)
