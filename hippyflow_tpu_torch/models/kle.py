"""Karhunen-Loeve expansion of the prior covariance (port of
``hippyflow_tpu/models/kle.py``), in three orthogonality modes:

* 'mass'     — randomized GHEP of M C M against M (``double_pass_g``); the
               decoder is M-orthonormal, encoder = M @ decoder;
* 'prior'    — the GHEP K v = lambda M v, dense up to ``dense_cutoff``
               dofs, else shift-invert Lanczos on K's solver; covariance
               eigenvalues 1/lambda^2, decoder columns scaled by 1/lambda,
               encoder = R @ decoder;
* 'identity' — randomized HEP of C = R^{-1} (``double_pass``).

``BoundaryRestrictedKLEProjector``: the KLE of boundary data, the GHEP of
M_b C M_b against the boundary mass with its interior filled by the
identity.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..fem import boundary_mass_matrix
from ..ops.linalg import CholeskyFactor, generalized_eigh
from ..ops.operators import low_rank_operator, prior_preconditioned_projector
from ..ops.randomized import double_pass, double_pass_g, lanczos_ghep, orthogonalize
from ..parallel.collective import NullCollective
from ..utils import KeyChain, ParameterList
from ..utils.plotting import spectrum_plot


class MassPreconditionedCovarianceOperator:
    """The block operator M C M, the left-hand side of the mass-orthogonal
    KLE's GHEP; ``matmat`` on (n, j) blocks."""

    def __init__(self, C_matmat, M_matmat):
        self.C_matmat = C_matmat
        self.M_matmat = M_matmat

    def matmat(self, X):
        return self.M_matmat(self.C_matmat(self.M_matmat(X)))

    __call__ = matmat


def KLEParameterList() -> ParameterList:
    """The JAX package's KLE parameter list (reference
    `KLEProjector.py:30-45`)."""
    return ParameterList(
        {
            "error_test_samples": [50, "Number of samples for error test"],
            "rank": [128, "Rank of subspace"],
            "oversampling": [10, "Oversampling for randomized algorithms"],
            "verbose": [True, "Print progress"],
            "output_directory": [None, "output directory for arrays"],
            "plot_label_suffix": ["", "suffix for plot label"],
            "save_and_plot": [False, "save the arrays or not"],
            "input_decoder_name": ["KLE_decoder", "naming"],
            "seed": [0, "seed of the probe and test-sample generator"],
        }
    )


class KLEProjector:
    """Input subspace projector from the prior alone.  ``keychain`` draws
    the probe block and the test samples (replace it with a
    ``utils.GivenNoise`` to give them).  ``collective`` is kept as in the
    JAX package: the KLE needs no sample reduction, so every rank computes
    the same subspace."""

    def __init__(self, prior, collective=None,
                 parameters: ParameterList | None = None):
        self.prior = prior
        self.collective = collective or NullCollective()
        self.parameters = parameters or KLEParameterList()
        self.keychain = KeyChain(self.parameters["seed"], prior.mean.device)
        self.d_KLE = None
        self.V_KLE = None
        self.M_orthogonal = None
        self._subspace_construction_time = None

    def _probe(self):
        r = self.parameters["rank"] + self.parameters["oversampling"]
        return self.keychain.normal((self.prior.dim, r),
                                    dtype=self.prior.mean.dtype)

    def random_input_projector(self):
        """An orthonormalized Gaussian basis (reference
        `KLEProjector.py:114-128`)."""
        return orthogonalize(self._probe())

    def construct_input_subspace(self, orthogonality: str = "mass"):
        """The KLE subspace: returns (d, decoder, encoder).  The probe block
        is drawn in every mode, as in the JAX package, though the 'prior'
        mode does not use it."""
        t0 = time.time()
        prior = self.prior
        r = self.parameters["rank"]
        Omega = self._probe()
        mode = orthogonality.lower()
        if mode == "mass":
            kle_op = MassPreconditionedCovarianceOperator(
                prior.Rsolver_matmat, prior.M_matmat)
            self.d_KLE, self.V_KLE = double_pass_g(
                kle_op, prior.M_matmat, prior.Msolver_matmat, Omega, r, s=1)
            self.M_orthogonal = True
            kle_decoder = self.V_KLE
            kle_encoder = prior.M_matmat(kle_decoder)
        elif mode == "prior":
            self.d_KLE, kle_decoder, kle_encoder = KLESubspaceConstructor(
                prior).compute_kle_subspace(r)
            self.V_KLE = kle_decoder
            self.M_orthogonal = False
        elif mode == "identity":
            self.d_KLE, self.V_KLE = double_pass(prior.Rsolver_matmat, Omega, r,
                                                 s=1)
            self.M_orthogonal = False
            kle_decoder = kle_encoder = self.V_KLE
        else:
            raise ValueError(f"unknown orthogonality {orthogonality!r}")
        self._subspace_construction_time = time.time() - t0
        if self.parameters["verbose"]:
            print("KLE subspace construction took "
                  f"{self._subspace_construction_time:.3f}s")
        self._save()
        return self.d_KLE, kle_decoder, kle_encoder

    def test_errors(self, ranks=(8, 16, 32, 64), cut_off: float = 1e-12):
        """Monte-Carlo relative projection error of prior samples onto the
        KLE basis at each rank up to the numerical rank (reference
        `KLEProjector.py:202-282`).  Returns (avg, std)."""
        if len(ranks) == 0:
            raise ValueError("test_errors needs at least one rank")
        if self.d_KLE is None or len(self.d_KLE) < max(ranks):
            self.parameters["rank"] = max(max(ranks), self.parameters["rank"])
            self.construct_input_subspace()
        d = self.d_KLE.cpu().numpy()
        numerical_rank = (int(np.flatnonzero(d > cut_off)[-1]) + 1
                          if (d > cut_off).any() else 0)
        ranks = [r for r in sorted(ranks) if r <= numerical_rank]
        noise = self.keychain.normal(
            (self.parameters["error_test_samples"], self.prior.noise_dim),
            dtype=self.prior.mean.dtype)
        samples = self.prior.sample(noise)  # (n, dM)
        norms = torch.linalg.vector_norm(samples, dim=1)
        avg, std = [], []
        for r in ranks:
            V = self.V_KLE[:, :r]
            if self.M_orthogonal:
                proj = prior_preconditioned_projector(V, self.prior.M_matmat)
            else:
                proj = low_rank_operator(V.new_ones(r), V)
            errs = torch.linalg.vector_norm(samples - proj(samples.T).T,
                                            dim=1) / norms
            # np.std's population form, as the JAX package takes it
            avg.append(errs.mean().item())
            std.append(errs.std(correction=0).item())
            if self.parameters["verbose"]:
                print(f"KLE naive avg rel error = {avg[-1]:.4e} at rank {r}")
        return np.asarray(avg), np.asarray(std)

    def _save(self):
        """``<input_decoder_name>.npy``, ``KLE_d.npy`` and the spectrum's
        plot ``KLE_eigenvalues_<rank>.pdf`` (where matplotlib is
        installed)."""
        outdir = self.parameters["output_directory"]
        if (not self.parameters["save_and_plot"] or outdir is None
                or self.collective.rank() != 0):
            return
        os.makedirs(outdir, exist_ok=True)
        np.save(os.path.join(outdir, self.parameters["input_decoder_name"]),
                self.V_KLE.cpu().numpy())
        d = self.d_KLE.cpu().numpy()
        np.save(os.path.join(outdir, "KLE_d"), d)
        spectrum_plot(d, axis_label=[
            "i", r"$\lambda_i$",
            "Eigenvalues of $C$" + self.parameters["plot_label_suffix"]],
            out_name=os.path.join(
                outdir, f"KLE_eigenvalues_{self.parameters['rank']}.pdf"))


class KLESubspaceConstructor:
    """Prior-orthonormal KLE basis from the GHEP K v = lambda M v of the
    prior's elliptic operator: a dense generalized eigendecomposition up to
    ``dense_cutoff`` dofs (it needs the prior's dense K and M), else
    shift-invert Lanczos (``lanczos_ghep``) on the prior's K solver.
    Covariance eigenvalues are 1/lambda^2; decoder columns are scaled by
    1/lambda, so the decoder is C^{-1}-orthonormal; encoder = R @ decoder."""

    def __init__(self, prior, dense_cutoff: int = 2048):
        self.prior = prior
        self.dense_cutoff = dense_cutoff

    def compute_kle_subspace(self, rank: int):
        """Returns (covariance eigenvalues (rank,), decoder, encoder)."""
        prior = self.prior
        if prior.dim <= self.dense_cutoff:
            d_all, V_all = generalized_eigh(prior.K, prior.M, descending=False)
            lam, V = d_all[:rank], V_all[:, :rank]
        else:
            v0 = torch.ones_like(prior.mean)
            lam, V = lanczos_ghep(prior.Ksolver_matmat, prior.M_matmat, v0, rank,
                                  m_iters=2 * rank + 20)
        decoder = V / lam[None, :]
        return 1.0 / lam**2, decoder, prior.R_matmat(decoder)


class BoundaryRestrictedKLEProjector:
    """Prior-based KLE for boundary data (reference `KLEProjector.py:
    337-434`): the randomized GHEP of the boundary-mass-preconditioned
    covariance M_b C M_b against B = M_b + I_interior (the zero interior
    diagonal filled by the identity, so that B is invertible), through
    ``double_pass_g`` with B's Cholesky solve.  The decoder is
    B-orthonormal; encoder = M_b @ decoder.  ``keychain`` draws the probe
    block (replace it with a ``utils.GivenNoise`` to give it)."""

    def __init__(self, prior, parameters: ParameterList | None = None):
        self.prior = prior
        self.parameters = parameters or KLEParameterList()
        self.keychain = KeyChain(self.parameters["seed"], prior.mean.device)
        self.Vh = prior.Vh
        self.M_b = self.make_boundary_restricted_mass_matrix(fill_nullspace=False)
        self.B = self.make_boundary_restricted_mass_matrix(fill_nullspace=True)
        self._B_chol = CholeskyFactor(L=torch.linalg.cholesky(self.B))
        self.KLE_operator = MassPreconditionedCovarianceOperator(
            prior.Rsolver_matmat, lambda X: self.M_b @ X)

    def make_boundary_restricted_mass_matrix(self, fill_nullspace: bool = False):
        """The boundary mass matrix int_dOmega u v ds; with
        ``fill_nullspace`` its zero (interior) diagonal entries become 1
        (reference `KLEProjector.py:364-398`)."""
        mean = self.prior.mean
        Mb = boundary_mass_matrix(self.Vh, dtype=mean.dtype, device=mean.device)
        if fill_nullspace:
            interior = torch.isclose(torch.diagonal(Mb), Mb.new_zeros(()))
            Mb = Mb + torch.diag(interior.to(Mb.dtype))
        return Mb

    def construct_input_subspace(self):
        """Returns (d, decoder, encoder); the decoder B-orthonormal."""
        r = self.parameters["rank"]
        Omega = self.keychain.normal(
            (self.prior.dim, r + self.parameters["oversampling"]),
            dtype=self.prior.mean.dtype)
        d, decoder = double_pass_g(self.KLE_operator, lambda X: self.B @ X,
                                   self._B_chol.solve, Omega, r, s=1)
        return d, decoder, self.M_b @ decoder
