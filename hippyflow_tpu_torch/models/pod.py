"""Proper orthogonal decomposition from a data matrix (port of
``PODProjectorFromData`` in ``hippyflow_tpu/models/pod.py``).

Dense POD with a mass-weighted inner product in three variants (hep /
ghep / inverse_ghep) and an optional mean shift, as the reference's
``PODProjector.py:666-852``.  The sampled POD (``PODProjector``) is not
ported yet.
"""

from __future__ import annotations


import numpy as np
import torch

from .. import config
from ..fem import mass_matrix
from ..ops.linalg import CholeskyFactor, eigh_descending, generalized_eigh


def weighted_l2_norm_vector(x, W):
    """Column-wise W-weighted norms (reference `PODProjector.py:658-661`)."""
    Wx = W @ x
    return torch.sqrt(torch.einsum("ij,ij->j", Wx, x))


class PODProjectorFromData:
    """Dense POD from a data matrix with an M-weighted inner product.

    ``M_output`` is the weight (a tensor, or a numpy array placed on
    ``dtype``/``device``); where it is None the P1 mass matrix of ``Vu``
    is assembled on ``dtype``/``device``.  The data of
    ``construct_subspace`` is taken to M's dtype and device.
    """

    def __init__(self, Vu, M_output=None, dtype=None, device=None):
        if isinstance(Vu, (list, tuple)):
            Vu = Vu[0]  # the reference passes the Vh list
        self.Vu = Vu
        if M_output is None:
            self.M = mass_matrix(Vu, dtype=dtype, device=device)
        elif isinstance(M_output, torch.Tensor):
            self.M = M_output
        else:
            dtype, device = config.resolve(dtype, device)
            self.M = torch.as_tensor(np.asarray(M_output), dtype=dtype,
                                     device=device)
        self._M_chol = CholeskyFactor(L=torch.linalg.cholesky(self.M))

    def construct_subspace(self, u_data, u_rank: int, shifted: bool = True,
                           method: str = "hep", verify: bool = False):
        """Returns (d, phi, Mphi, u_shift); phi M-orthonormal, Mphi = M phi."""
        M = self.M
        u_data = torch.as_tensor(u_data, dtype=M.dtype, device=M.device)
        n_data, dim_u = u_data.shape
        assert u_rank <= n_data, "need more samples than the requested rank"

        if shifted:
            u_shift = u_data.mean(dim=0)
            u_data = u_data - u_shift[None, :]
        else:
            u_shift = u_data.new_zeros(dim_u)

        X = u_data.T  # (dim_u, n_data)
        if method == "hep":
            # Gram eigendecomposition: X^T M X (n_data x n_data)
            G = X.T @ (M @ X)
            d_all, Ug = eigh_descending(G)
            d = d_all[:u_rank] / n_data
            phi = X @ Ug[:, :u_rank]
            phi = phi / weighted_l2_norm_vector(phi, M)[None, :]
            Mphi = M @ phi
        elif method == "ghep":
            # H phi = d M phi with H = (M X)(M X)^T / n
            MX = M @ X
            H = (MX @ MX.T) / n_data
            d_all, V = generalized_eigh(H, M, descending=True)
            d = d_all[:u_rank]
            phi = V[:, :u_rank]
            Mphi = M @ phi
        elif method == "inverse_ghep":
            # H v = d M^{-1} v with H = X X^T / n and v = M phi:
            # congruence S = L^T H L, v = L y, phi = M^{-1} v.
            L = self._M_chol.L
            H = (X @ X.T) / n_data
            S = L.T @ H @ L
            S = 0.5 * (S + S.T)
            d_all, Y = eigh_descending(S)
            d = d_all[:u_rank]
            Mphi = L @ Y[:, :u_rank]
            phi = self._M_chol.solve(Mphi)
        else:
            raise ValueError(f"unavailable method {method!r}")

        if verify:
            self._verify(X, phi, Mphi, u_rank - 1 if shifted else u_rank)
        return d, phi, Mphi, u_shift

    def _verify(self, X, phi, Mphi, rank):
        """Print the M-orthogonality and reconstruction errors of the
        first ``rank`` columns (the reference's ``verify``)."""
        M = self.M
        pv = phi[:, :rank]
        eye = torch.eye(rank, dtype=M.dtype, device=M.device)
        orth = torch.linalg.norm(pv.T @ (M @ pv) - eye)
        print(f"Basis Orthogonality error: {orth.item()}")
        recon = X - pv @ (Mphi[:, :rank].T @ X)
        rel = weighted_l2_norm_vector(recon, M) / weighted_l2_norm_vector(X, M)
        print(f"Mean reconstruction error: {rel.mean().item():.3e}")
        print(f"Max reconstruction error: {rel.max().item():.3e}")
