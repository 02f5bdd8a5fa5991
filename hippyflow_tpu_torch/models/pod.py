"""Proper orthogonal decomposition of observable samples (port of
``hippyflow_tpu/models/pod.py``):

* ``PODProjector``: the randomized HEP of the sampled E[q q^T]
  (``double_pass``), the projection error tests, and training-data
  generation that resumes chunk by chunk;
* ``PODProjectorFromData``: dense POD from a data matrix with a
  mass-weighted inner product in three variants (hep / ghep /
  inverse_ghep) and an optional mean shift (reference
  ``PODProjector.py:666-852``).

With a control distribution the samples carry controls z (``z_data``
beside ``m_data`` and ``q_data``).  ``save_mass_and_stiffness_matrices``
writes the state space's mass and stiffness matrices as scipy CSR files,
and ``two_state_solution`` the solves at the prior mean and at one prior
sample, as ``.npy`` and legacy-VTK files.

With a ``collective`` (``parallel.DeviceCollective``) the forward solves
of the samples are split over its ranks (``sample_until_solved``) and
every rank holds the gathered samples; the error tests' averages go
through the collective's ``allReduce`` of scalars (every rank runs the
same test), as in the JAX package.  The resumable training-data files
are read and written by global rank 0 alone (``collective.rank()``), which
hands every rank the resume point and the finished arrays.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from .. import config
from ..fem import mass_matrix, stiffness_matrix
from ..ops.linalg import CholeskyFactor, eigh_descending, generalized_eigh
from ..ops.operators import low_rank_operator, prior_preconditioned_projector
from ..ops.randomized import double_pass
from ..parallel.collective import NullCollective
from ..utils import KeyChain, ParameterList
from ..utils.mesh_utils import export_vtk
from ..utils.plotting import spectrum_plot
from .sampling import auto_chunk_size, fresh_solves, sample_until_solved


def PODParameterList() -> ParameterList:
    """The JAX package's POD parameter list (reference
    `PODProjector.py:35-49`)."""
    return ParameterList(
        {
            "sample_per_process": [100, "Number of samples per process"],
            "rank": [128, "Rank of POD subspace"],
            "oversampling": [10, "Oversampling for randomized algorithms"],
            "data_per_process": [250, "Training data points per process"],
            "verbose": [True, "Print progress"],
            "output_directory": [None, "output directory"],
            "plot_label_suffix": ["", "plot label suffix"],
            "save_and_plot": [False, "save the arrays or not"],
            "chunk_size": [None, "sample-batch chunk size (None = auto)"],
            "coarse_warm_start": [
                None,
                "grid sequencing: a noise -> u0 map from "
                "fem.multigrid.coarse_newton_warm_start",
            ],
            "seed": [0, "seed of the sample and probe generator"],
        }
    )


def _rel_errors(Q, P):
    """Row-wise ||q - p|| / ||q||."""
    return (torch.linalg.vector_norm(Q - P, dim=1)
            / torch.linalg.vector_norm(Q, dim=1))


class PODProjector:
    """POD subspace of the observable's output (reference
    `PODProjector.py:52-654`).  ``keychain`` draws the samples and the
    probe block (replace it with a ``utils.GivenNoise`` to give them);
    ``generate_training_data`` draws per chunk, or takes ``noise``."""

    def __init__(self, observable, prior, control_distribution=None,
                 collective=None, parameters: ParameterList | None = None):
        self.observable = observable
        self.control_distribution = control_distribution
        self.collective = collective or NullCollective()
        self.prior = prior
        self.parameters = parameters or PODParameterList()
        self.keychain = KeyChain(self.parameters["seed"], prior.mean.device)
        self.d = None
        self.U_MV = None
        self.u_at_mean = None
        self.samples = None
        self._subspace_construction_time = None
        self._data_generation_time = None

    def solve_at_mean(self):
        """The forward solve at the prior mean (n,), and at the control
        distribution's mean where there is one."""
        z = None
        if self.control_distribution is not None:
            mean = self.prior.mean
            z = self.control_distribution.mean(mean.dtype, mean.device)[None]
        u, _ = self.observable.problem.solve_fwd(self.prior.mean[None], z=z)
        self.u_at_mean = u[0]
        return self.u_at_mean

    def _ensure_samples(self, n):
        if self.samples is not None and self.samples.qs.shape[0] >= n:
            return
        self.samples = sample_until_solved(
            self.observable, self.prior, self.keychain, n,
            chunk_size=self.parameters["chunk_size"],
            verbose=self.parameters["verbose"],
            coarse_warm_start=self.parameters["coarse_warm_start"],
            control_distribution=self.control_distribution,
            collective=self.collective,
        )

    def _average(self, errs):
        """(mean, std) of the errors through the collective's average."""
        avg = self.collective.allReduce(errs.mean().item(), "avg")
        var = self.collective.allReduce(errs.std(correction=0).item() ** 2, "avg")
        return avg, float(np.sqrt(var))

    def construct_subspace(self):
        """Randomized HEP of (1/N) sum_i q_i q_i^T (reference
        `PODProjector.py:331-389`); writes ``POD_projector.npy``,
        ``POD_d.npy`` and the spectrum's plot when saving.  Returns (d, decoder, encoder)."""
        t0 = time.time()
        n = self.parameters["sample_per_process"]
        self._ensure_samples(n)
        Q = self.samples.qs[:n]  # (N, dQ)
        N, dQ = Q.shape
        op = low_rank_operator(Q.new_full((N,), 1.0 / N), Q.T)
        r = min(self.parameters["rank"], dQ)
        nvec = min(r + self.parameters["oversampling"], dQ)
        Omega = self.keychain.normal((dQ, nvec), dtype=Q.dtype)
        self.d, self.U_MV = double_pass(op, Omega, r, s=1)
        self._subspace_construction_time = time.time() - t0
        if self.parameters["verbose"]:
            print("POD subspace construction took "
                  f"{self._subspace_construction_time:.3f}s")
        outdir = self.parameters["output_directory"]
        if (self.parameters["save_and_plot"] and outdir
                and self.collective.rank() == 0):
            os.makedirs(outdir, exist_ok=True)
            np.save(os.path.join(outdir, "POD_projector"), self.U_MV.cpu().numpy())
            d = self.d.cpu().numpy()
            np.save(os.path.join(outdir, "POD_d"), d)
            spectrum_plot(d, axis_label=[
                "i", r"$\lambda_i$",
                r"Eigenvalues of $\mathbb{E}_{\nu}[qq^T]$"
                + self.parameters["plot_label_suffix"]],
                out_name=os.path.join(
                    outdir, f"POD_eigenvalues_{self.parameters['rank']}.pdf"))
        return self.d, self.U_MV, self.U_MV

    def generate_training_data(self, output_directory="data/",
                               n_data: int | None = None, check_for_data=True,
                               noise=None, controls=None):
        """Sample (m_i, q_i[, z_i]) into ``mq_data.npz`` (reference
        `PODProjector.py:118-222`).  Finished chunks persist under
        ``<output_directory>/chunks_pod/``; a killed run resumes at the
        first missing chunk, and each chunk draws from its own generator
        (``chunk_keychain``, tag 1), so a resumed run writes the same bits
        as an uninterrupted one.  ``noise`` (n_data, noise_dim) and
        ``controls`` (n_data, dZ) give the chunks' first draws.  Under a
        collective every rank solves its share of each chunk's samples,
        and global rank 0 (``collective.rank()``) alone reads and writes
        the files: it finds the resume point and broadcasts it with the
        arrays it read (a finished bundle, or the chunks before the resume
        point), and writes each chunk (a barrier follows) and the bundle;
        every rank keeps the chunks this run made.  Returns (m_data,
        q_data) as numpy arrays, the same on every rank."""
        from .data_generator import chunk_keychain

        coll = self.collective
        writer = coll.rank() == 0
        t0 = time.time()
        n = n_data or self.parameters["data_per_process"]
        out_path = os.path.join(output_directory, "mq_data.npz")
        chunk_dir = os.path.join(output_directory, "chunks_pod")
        # global rank 0 (the I/O gate) reads a finished bundle or finds
        # where to resume; every rank gets the plan and what was read
        plan, read = None, None
        if writer:
            os.makedirs(output_directory, exist_ok=True)
            plan, read = _resume_plan(out_path, chunk_dir, n, check_for_data)
        plan = coll.bcast_io(plan)
        if plan["finished"] or plan["start"] > 0:
            read = coll.bcast_io_tensors(
                read and {k: torch.from_numpy(v) for k, v in read.items()})
            read = {k: v.cpu().numpy() for k, v in read.items()}
        if plan["finished"]:
            if self.parameters["verbose"] and writer:
                print("training data already generated, skipping")
            return read["m_data"], read["q_data"]
        i = plan["start"]
        made = [read] if i > 0 else []  # numpy chunks, in sample order
        if i > 0 and self.parameters["verbose"] and writer:
            print(f"resuming training-data generation at sample {i}")
        problem = self.observable.problem
        dtype, device = self.prior.mean.dtype, self.prior.mean.device
        chunk_size = self.parameters["chunk_size"] or auto_chunk_size(
            problem.state_dim, dtype, problem=problem, device=device)
        while i < n:
            b = min(chunk_size, n - i)
            # every rank draws the chunk's noise whole and solves its share
            batch = sample_until_solved(
                self.observable, self.prior,
                chunk_keychain(self.parameters["seed"], 1, i, device), b,
                chunk_size=b, verbose=self.parameters["verbose"],
                noise=None if noise is None else noise[i:i + b],
                coarse_warm_start=self.parameters["coarse_warm_start"],
                control_distribution=self.control_distribution,
                controls=None if controls is None else controls[i:i + b],
                collective=coll,
            )
            payload = {"m_data": batch.ms, "q_data": batch.qs}
            if batch.zs is not None:
                payload["z_data"] = batch.zs
            payload = {k: v.cpu().numpy() for k, v in payload.items()}
            if writer:
                np.savez(os.path.join(chunk_dir, f"chunk_{i}_{i + b}.npz"),
                         **payload)
            coll.barrier()
            made.append(payload)
            i += b
        cat = {k: np.concatenate([c[k] for c in made])[:n] for k in made[-1]}
        if writer:
            np.savez_compressed(out_path, **cat)
            shutil.rmtree(chunk_dir, ignore_errors=True)
        coll.barrier()
        self._data_generation_time = time.time() - t0
        return cat["m_data"], cat["q_data"]

    def _output_directory(self, output_directory):
        outdir = output_directory or self.parameters["output_directory"]
        if outdir is None:
            raise ValueError("set output_directory")
        os.makedirs(outdir, exist_ok=True)
        return outdir

    def save_mass_and_stiffness_matrices(self, output_directory=None):
        """``mass_csr.npz`` and ``stiffness_csr.npz``: the state space's
        mass and stiffness matrices as scipy CSR matrices (reference
        `PODProjector.py:298-327`), assembled in float64 on the CPU."""
        import scipy.sparse as sp

        outdir = self._output_directory(output_directory)
        Vu = self.observable.problem.Vu
        kw = dict(dtype=torch.float64, device="cpu")
        for name, A in (("mass_csr", mass_matrix(Vu, **kw)),
                        ("stiffness_csr", stiffness_matrix(Vu, **kw))):
            sp.save_npz(os.path.join(outdir, name), sp.csr_matrix(A.numpy()))

    def two_state_solution(self, output_directory=None):
        """Solve at the prior mean and at one prior sample and save both
        pairs under ``two_states/`` as ``m_mean``, ``u_at_mean``,
        ``m_sample`` and ``u_at_sample`` (.npy, and .vtk on the parameter
        and state meshes; the reference writes dolfin .pvd files,
        `PODProjector.py:481-537`).  With a control distribution both
        solves take its mean.  Returns ((m_mean, u_at_mean), (m_sample,
        u_at_sample))."""
        save_dir = os.path.join(self._output_directory(output_directory),
                                "two_states")
        os.makedirs(save_dir, exist_ok=True)
        problem = self.observable.problem
        m_mean = self.prior.mean
        z = None
        if self.control_distribution is not None:
            z = self.control_distribution.mean(m_mean.dtype, m_mean.device)[None]
        u_at_mean = problem.solve_fwd(m_mean[None], z=z)[0][0]
        noise = self.keychain.normal((1, self.prior.noise_dim), dtype=m_mean.dtype)
        m_sample = self.prior.sample(noise)[0]
        u_at_sample = problem.solve_fwd(m_sample[None], z=z)[0][0]
        arrays = {"m_mean": m_mean, "u_at_mean": u_at_mean,
                  "m_sample": m_sample, "u_at_sample": u_at_sample}
        for name, x in arrays.items():
            if self.parameters["verbose"]:
                print(f"||{name}|| = {torch.linalg.vector_norm(x).item():.6e}")
            x = x.cpu().numpy()
            np.save(os.path.join(save_dir, name), x)
            field, space = ("m", problem.Vm) if name.startswith("m") else ("u", problem.Vu)
            export_vtk(os.path.join(save_dir, name), space.mesh, {field: x})
        return (m_mean, u_at_mean), (m_sample, u_at_sample)

    def input_output_error_test(self, V, Cinv_matmat=None, rank_pairs=((8, 8),)):
        """Joint input/output projection error (reference
        `PODProjector.py:541-654`): project each sample m onto the first
        rank_in columns of V (prior-preconditioned, V V^T C^{-1}, when
        ``Cinv_matmat`` is given), solve forward again at the projection
        (cold Newton, as the JAX package), project its output onto the
        first rank_out POD vectors, and average ||q(m) - U U^T q(P m)|| /
        ||q(m)|| over the samples.  Returns (avg list, std list); the
        re-solves' Newton iterations and their count of unconverged lanes
        per rank pair are left in ``io_iterations`` and ``io_failed``."""
        if self.control_distribution is not None:
            raise ValueError("the input-output error test is not worked out "
                             "for control problems (as in the JAX package)")
        if self.U_MV is None:
            raise RuntimeError("construct_subspace first")
        V = torch.as_tensor(V, dtype=self.U_MV.dtype, device=self.U_MV.device)
        for rank_in, rank_out in rank_pairs:
            if rank_in > V.shape[1] or rank_out > self.U_MV.shape[1]:
                raise ValueError(f"rank pair ({rank_in}, {rank_out}) exceeds "
                                 "the bases")
        n = self.parameters["sample_per_process"]
        self._ensure_samples(n)
        ms, qs = self.samples.ms[:n], self.samples.qs[:n]
        avg, std = [], []
        self.io_iterations, self.io_failed = [], []
        for rank_in, rank_out in rank_pairs:
            Vr = V[:, :rank_in]
            if Cinv_matmat is not None:
                proj = prior_preconditioned_projector(Vr, Cinv_matmat)
            else:
                proj = low_rank_operator(Vr.new_ones(rank_in), Vr)
            q_red, ok, its = fresh_solves(self.observable, proj(ms.T).T,
                                          self.parameters["chunk_size"])
            U = self.U_MV[:, :rank_out]
            errs = _rel_errors(qs, q_red @ U @ U.T)
            a, sd = self._average(errs)
            avg.append(a)
            std.append(sd)
            self.io_iterations.append(its)
            self.io_failed.append(int((~ok).sum().item()))
            if self.parameters["verbose"]:
                print(f"Rank pair ({rank_in},{rank_out}): avg rel error = "
                      f"{avg[-1]:.4e}")
        return avg, std

    def test_output_errors(self, ranks=(8, 16, 32, 64), n_samples: int | None = None):
        """Monte-Carlo relative projection error of the observable samples
        onto the POD basis (reference `PODProjector.py:392-478`).  Returns
        (avg, std) numpy arrays."""
        if self.U_MV is None:
            raise RuntimeError("construct_subspace first")
        n = n_samples or self.parameters["sample_per_process"]
        self._ensure_samples(n)
        Q = self.samples.qs[:n]
        avg, std = [], []
        for r in ranks:
            U = self.U_MV[:, :r]
            errs = _rel_errors(Q, Q @ U @ U.T)
            a, sd = self._average(errs)
            avg.append(a)
            std.append(sd)
            if self.parameters["verbose"]:
                print(f"POD avg rel error = {avg[-1]:.4e} at rank {r}")
        return np.asarray(avg), np.asarray(std)


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


def _resume_plan(out_path, chunk_dir, n, check_for_data):
    """Where ``generate_training_data`` stands, read by the I/O rank: the
    plan ({"finished", "start"}) and the arrays read.  A finished bundle
    of n samples or more gives its m_data and q_data.  Else a resume
    starts at the first gap, deletes the stale chunks beyond it (they may
    come from another chunk grid) and gives the chunks before it
    concatenated (None from sample 0); a run from scratch clears the chunk
    directory outright."""
    from .data_generator import load_chunks_validated, prune_stale_chunks

    if check_for_data and os.path.exists(out_path):
        with np.load(out_path) as existing:
            if existing["m_data"].shape[0] >= n:
                return ({"finished": True, "start": n},
                        {"m_data": existing["m_data"],
                         "q_data": existing["q_data"]})
    if check_for_data:
        os.makedirs(chunk_dir, exist_ok=True)
        start = prune_stale_chunks(chunk_dir)
        return ({"finished": False, "start": start},
                load_chunks_validated(chunk_dir, start) if start else None)
    shutil.rmtree(chunk_dir, ignore_errors=True)
    os.makedirs(chunk_dir)
    return {"finished": False, "start": 0}, None
