"""Derivative-informed input and output subspaces (port of the
materialized, prior-preconditioned path of
``hippyflow_tpu/models/active_subspace.py``).

The Gauss-Newton operator E[J^T J] is applied from the materialized
per-sample Jacobians as two large matmuls; the randomized GHEP against the
prior precision R gives the input active subspace, and the randomized HEP
of E[J J^T] = (1/N) sum_i J_i J_i^T, from the same Jacobians, the output
one.  Samples and Jacobians come from the staged pass
(``sample_until_solved``, optionally grid-sequenced, then
``materialize_jacobians``) or, for a linear symmetric operator without
Dirichlet rows, from the fused pass (``sample_and_materialize_symmetric``:
one factorization per sample).  ``construct_low_rank_Jacobians`` saves the
exact SVD of each Jacobian, resuming chunk by chunk, and ``test_errors``
runs the projection error tests.

With a control distribution the samples carry controls z, and
``construct_low_rank_control_Jacobians`` saves the SVD of each dq/dz.
Not ported (ROADMAP M11 item 5): the matrix-free and serialized
operators, the unpreconditioned HEP and ``test_errors_double_loop``.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from ..ops.operators import prior_preconditioned_projector
from ..ops.randomized import double_pass, double_pass_g
from ..utils import KeyChain, ParameterList
from .sampling import (
    SampleBatch,
    fresh_solves,
    materialize_jacobians,
    sample_and_materialize_symmetric,
    sample_until_solved,
)


def ActiveSubspaceParameterList() -> ParameterList:
    """The slice of the JAX package's parameter list that the port runs."""
    return ParameterList(
        {
            "samples_per_process": [64, "Number of samples used in expectations"],
            "error_test_samples": [50, "Number of samples for error test"],
            "rank": [128, "Rank of subspace"],
            "jacobian_rank": [128, "Rank of Jacobians generated"],
            "control_jacobian_rank": [None, "Rank of control Jacobians generated"],
            "oversampling": [10, "Oversampling for randomized algorithms"],
            "verbose": [True, "Print progress"],
            "input_decoder_name": ["_input_decoder", "naming"],
            "output_decoder_name": ["_output_decoder", "naming"],
            "output_directory": [None, "output directory for arrays"],
            "save_and_plot": [False, "save the decoders and spectra"],
            "store_Omega": [False, "keep the drawn probe blocks"],
            "ms_given": [False, "use externally supplied samples .ms"],
            "chunk_size": [None, "sample-batch chunk size (None = auto)"],
            "jac_chunk_size": [
                None,
                "chunk size for Jacobian materialization (None = chunk_size)",
            ],
            "seed": [0, "seed of the sampling and probe generator"],
            "reset_initial_guess": [
                False,
                "cold-start every Newton solve instead of warm-starting "
                "each chunk on the previous chunk's states",
            ],
            "coarse_warm_start": [
                None,
                "grid sequencing: a noise -> u0 map from "
                "fem.multigrid.coarse_newton_warm_start; each Newton solve "
                "starts from its own coarse-grid solution interpolant",
            ],
        }
    )


class ActiveSubspaceProjector:
    """Input and output active subspaces of m -> q(m) = B u(m) under a
    Gaussian prior.

    Set ``.ms`` (and ``.zs`` with a control distribution; with
    ``ms_given``), ``.Omega_GN`` and/or ``.Omega_NG`` before the
    constructions to supply the samples and the probe blocks instead of
    drawing them; ``keychain`` draws the rest (replace it with a
    ``utils.GivenNoise`` to give those too)."""

    def __init__(self, observable, prior, parameters: ParameterList | None = None,
                 control_distribution=None):
        self.observable = observable
        self.prior = prior
        self.control_distribution = control_distribution
        self.parameters = parameters or ActiveSubspaceParameterList()
        self.keychain = KeyChain(self.parameters["seed"], prior.mean.device)
        self.samples: SampleBatch | None = None
        self.Js = None  # (N, dQ, dM)
        self.ms = None
        self.zs = None
        self.Omega_GN = None
        self.Omega_NG = None
        self.d_GN = None
        self.V_GN = None
        self.d_NG = None
        self.U_NG = None
        self.stage_seconds = None
        self._input_subspace_construction_time = None
        self._output_subspace_construction_time = None

    def _ensure_samples(self):
        if self.samples is not None:
            return
        problem = self.observable.problem
        if self.parameters["ms_given"]:
            if self.ms is None:
                raise ValueError("set .ms before an ms_given construction")
            us, info = problem.solve_fwd(self.ms, z=self.zs)
            self.samples = SampleBatch(
                ms=self.ms, us=us, qs=self.observable.evalu(us), n_failures=0,
                iterations=info.iterations, zs=self.zs,
            )
            return
        t0 = time.time()
        self.samples = sample_until_solved(
            self.observable,
            self.prior,
            self.keychain,
            self.parameters["samples_per_process"],
            chunk_size=self.parameters["chunk_size"],
            verbose=self.parameters["verbose"],
            reset_initial_guess=self.parameters["reset_initial_guess"],
            coarse_warm_start=self.parameters["coarse_warm_start"],
            control_distribution=self.control_distribution,
        )
        if self.parameters["verbose"]:
            print(
                f"forward sampling took {time.time() - t0:.3f}s "
                f"({self.samples.n_failures} resampled failures)"
            )

    def _fused_symmetric_eligible(self) -> bool:
        """True when sampling takes the fused forward + Jacobian pass: a
        linear operator with A^T = A, no Dirichlet rows (bc masking breaks
        the symmetry), drawn samples, no controls and no grid sequencing."""
        problem = self.observable.problem
        return (
            self.control_distribution is None
            and problem.is_fwd_linear
            and problem.operator_symmetric
            and not problem._has_bc
            and not self.parameters["ms_given"]
            and self.parameters["coarse_warm_start"] is None
        )

    def _ensure_jacobians(self):
        self._ensure_samples()
        if self.Js is None:
            s = self.samples
            self.Js = materialize_jacobians(
                self.observable, s.ms, s.us, s.zs,
                chunk_size=(
                    self.parameters["jac_chunk_size"]
                    or self.parameters["chunk_size"]
                ),
            )

    def construct_input_subspace(self, prior_preconditioned: bool = True):
        """GHEP of E[J^T J] against R.  Returns (d_GN, decoder, encoder)
        with encoder = R @ decoder.  Wall seconds of the stages, each ended
        by a device synchronize, are left in ``stage_seconds``: forward,
        jacobian and ghep, or fused (forward + Jacobian in one pass) and
        ghep; their sum in ``_input_subspace_construction_time``."""
        if not prior_preconditioned:
            raise NotImplementedError("only the prior-preconditioned GHEP")
        device = self.prior.mean.device

        def lap(t_prev):
            _synchronize(device)
            t = time.perf_counter()
            return t, t - t_prev

        t = time.perf_counter()
        if (self.samples is None and self.Js is None
                and self._fused_symmetric_eligible()):
            self.samples, self.Js = sample_and_materialize_symmetric(
                self.observable,
                self.prior,
                self.keychain,
                self.parameters["samples_per_process"],
                chunk_size=(
                    self.parameters["jac_chunk_size"]
                    or self.parameters["chunk_size"]
                ),
                verbose=self.parameters["verbose"],
            )
            t, fused = lap(t)
            stages = {"fused": fused}
        else:
            self._ensure_samples()
            t, forward = lap(t)
            self._ensure_jacobians()
            t, jacobian = lap(t)
            stages = {"forward": forward, "jacobian": jacobian}
        J = self.Js
        r = self.parameters["rank"]
        p = self.parameters["oversampling"]
        Omega = self.Omega_GN
        if Omega is None:
            Omega = self.keychain.normal((self.observable.dM, r + p),
                                         dtype=self.prior.mean.dtype)
            if self.parameters["store_Omega"]:
                self.Omega_GN = Omega
        Jf = J.reshape(-1, J.shape[-1])  # (N dQ, dM)

        def avg_jtj(X):
            return (Jf.T @ (Jf @ X)) / J.shape[0]

        self.d_GN, self.V_GN = double_pass_g(
            avg_jtj, self.prior.R_matmat, self.prior.Rsolver_matmat, Omega, r
        )
        encoder = self.prior.R_matmat(self.V_GN)
        _, ghep = lap(t)
        self.stage_seconds = {**stages, "ghep": ghep}
        self._input_subspace_construction_time = sum(self.stage_seconds.values())
        if self.parameters["verbose"]:
            print("input subspace construction took "
                  f"{self._input_subspace_construction_time:.3f}s")
        self._save("input", self.d_GN, self.V_GN)
        return self.d_GN, self.V_GN, encoder

    def construct_output_subspace(self):
        """Randomized HEP of E[J J^T] (reference
        `activeSubspaceProjector.py:625-673`), applied as
        (1/N) sum_i J_i (J_i^T X) from the Jacobians of the input subspace
        (materialized here if there are none yet).  Returns (d_NG, decoder,
        encoder), encoder = decoder."""
        t0 = time.time()
        self._ensure_jacobians()
        J = self.Js
        dQ = self.observable.dQ
        r = min(self.parameters["rank"], dQ)
        Omega = self.Omega_NG
        if Omega is None:
            Omega = self.keychain.normal(
                (dQ, min(r + self.parameters["oversampling"], dQ)),
                dtype=self.prior.mean.dtype)
            if self.parameters["store_Omega"]:
                self.Omega_NG = Omega

        def avg_jjt(X):
            return (J @ (J.mT @ X)).sum(dim=0) / J.shape[0]

        self.d_NG, self.U_NG = double_pass(avg_jjt, Omega, r, s=1)
        _synchronize(self.prior.mean.device)
        self._output_subspace_construction_time = time.time() - t0
        if self.parameters["verbose"]:
            print("output subspace construction took "
                  f"{self._output_subspace_construction_time:.3f}s")
        self._save("output", self.d_NG, self.U_NG)
        return self.d_NG, self.U_NG, self.U_NG

    def construct_low_rank_Jacobians(self, output_directory="jacobian_data/",
                                     check_for_data: bool = True):
        """The exact SVD of each sample's Jacobian truncated at
        ``jacobian_rank``, in the reference's Jsvd schema (its randomized
        accuracyEnhancedSVD per sample, `activeSubspaceProjector.py:816`,
        is replaced by the exact batched SVD of the materialized J, as in
        the JAX package).  With ``check_for_data`` finished chunks under
        ``<output_directory>/chunks/`` are loaded, not computed again.
        Returns (U (N, dQ, r), sigma (N, r), V (N, dM, r))."""
        return self._jacobian_data(output_directory, check_for_data)

    def construct_low_rank_control_Jacobians(self, output_directory="jacobian_data/",
                                             check_for_data: bool = True):
        """The same for the control Jacobians dq/dz, truncated at
        ``control_jacobian_rank`` (else ``jacobian_rank``), in the
        ``Jzsvd_data.npz`` schema (``Uz_data``, ``sigmaz_data``,
        ``Vz_data``), chunks under ``<output_directory>/chunksz/``."""
        if self.control_distribution is None:
            raise ValueError("control Jacobians need a control distribution")
        return self._jacobian_data(output_directory, check_for_data,
                                   control=True)

    def _jacobian_data(self, output_directory, check_for_data,
                       control: bool = False):
        from .data_generator import _save_bundle, _scan_chunks, _svd_payload

        self._ensure_samples()
        s = self.samples
        n = s.ms.shape[0]
        prefix = "z" if control else ""
        rank_param = ((self.parameters["control_jacobian_rank"] if control
                       else None) or self.parameters["jacobian_rank"])
        chunk_size = self.parameters["chunk_size"] or n
        chunk_dir = (None if output_directory is None
                     else os.path.join(output_directory, f"chunks{prefix}"))
        done = {}
        if chunk_dir is not None:
            os.makedirs(chunk_dir, exist_ok=True)
            if check_for_data:
                done = {(a, b): f for a, b, f in _scan_chunks(chunk_dir)}
        keys = tuple(f"{k}{prefix}_data" for k in ("U", "sigma", "V"))
        parts = {k: [] for k in keys}
        for a in range(0, n, chunk_size):
            b = min(a + chunk_size, n)
            if (a, b) in done:
                with np.load(done[(a, b)]) as z:
                    for k in keys:
                        parts[k].append(torch.as_tensor(z[k], device=s.ms.device))
                continue
            # reuse the Jacobians of the subspace build where they exist
            if not control and self.Js is not None:
                J = self.Js[a:b]
            else:
                J = materialize_jacobians(
                    self.observable, s.ms[a:b], s.us[a:b],
                    None if s.zs is None else s.zs[a:b], chunk_size=b - a,
                    control=control)
            rank = min(rank_param, *J.shape[1:])
            chunk = dict(zip(keys, _svd_payload(J, rank)))
            if chunk_dir is not None:
                np.savez(os.path.join(chunk_dir, f"chunk_{a}_{b}.npz"),
                         **{k: v.cpu().numpy() for k, v in chunk.items()})
            for k in keys:
                parts[k].append(chunk[k])
        U, sig, V = (torch.cat(parts[k]) for k in keys)
        if output_directory is not None:
            _save_bundle(
                os.path.join(output_directory, f"J{prefix}svd_data.npz"),
                **{k: v.cpu().numpy() for k, v in zip(keys, (U, sig, V))})
            np.save(os.path.join(output_directory, "mq_m_data.npy"),
                    s.ms.cpu().numpy())
            np.save(os.path.join(output_directory, "mq_q_data.npy"),
                    s.qs.cpu().numpy())
            shutil.rmtree(chunk_dir, ignore_errors=True)
        return U, sig, V

    def test_errors(self, ranks=(8, 16, 32, 64), test_input: bool = True,
                    test_output: bool = False, n_samples: int | None = None):
        """Monte-Carlo relative projection errors of the subspaces at the
        given ranks (reference `activeSubspaceProjector.py:1048-1335`, its
        naive test).  Input: ||m - V_r V_r^T R m|| / ||m|| over prior
        samples.  Output: ||q - U_r U_r^T q|| / ||q|| over fresh forward
        solves; samples whose Newton solve fails are discarded and the
        average runs over the survivors (the reference's discarded-sample
        correction), their count under ('output_discarded', None).
        Returns a dict ('input' | 'output', r) -> (avg, std)."""
        n = n_samples or self.parameters["error_test_samples"]
        dtype = self.prior.mean.dtype
        out = {}
        if test_input:
            if self.V_GN is None:
                raise RuntimeError("construct_input_subspace first")
            ms = self.prior.sample(
                self.keychain.normal((n, self.prior.noise_dim), dtype=dtype))
            norms = torch.linalg.vector_norm(ms, dim=1)
            for r in ranks:
                proj = prior_preconditioned_projector(self.V_GN[:, :r],
                                                      self.prior.R_matmat)
                errs = torch.linalg.vector_norm(ms - proj(ms.T).T, dim=1) / norms
                out[("input", r)] = (errs.mean().item(),
                                     errs.std(correction=0).item())
        if test_output:
            if self.U_NG is None:
                raise RuntimeError("construct_output_subspace first")
            ms = self.prior.sample(
                self.keychain.normal((n, self.prior.noise_dim), dtype=dtype))
            zs = (None if self.control_distribution is None else
                  self.control_distribution.sample_n(self.keychain, n, dtype))
            qs, ok, _ = self._fresh_solves(ms, zs)
            out[("output_discarded", None)] = n - int(ok.sum().item())
            if not ok.any():
                raise RuntimeError(
                    "output error test: every fresh forward solve failed; "
                    "no samples left after the discard correction")
            Q = qs[ok]
            norms = torch.linalg.vector_norm(Q, dim=1)
            for r in ranks:
                U = self.U_NG[:, :r]
                errs = torch.linalg.vector_norm(Q - Q @ U @ U.T, dim=1) / norms
                out[("output", r)] = (errs.mean().item(),
                                      errs.std(correction=0).item())
        return out

    def _fresh_solves(self, ms, zs=None):
        """Cold-started forward solves of ms (and zs): (qs, converged (N,)
        bool, Newton iterations (N,))."""
        return fresh_solves(self.observable, ms, self.parameters["chunk_size"],
                            zs)

    def _save(self, which: str, d, decoder):
        """AS_<n><input|output_decoder_name>.npy and AS_<n>_d_GN.npy or
        AS_<n>_d_NG.npy (arrays only)."""
        outdir = self.parameters["output_directory"]
        if not self.parameters["save_and_plot"] or outdir is None:
            return
        os.makedirs(outdir, exist_ok=True)
        name = f"AS_{int(self.parameters['samples_per_process'])}"
        suffix = self.parameters[f"{which}_decoder_name"]
        np.save(os.path.join(outdir, name + suffix), decoder.cpu().numpy())
        dname = "_d_GN" if which == "input" else "_d_NG"
        np.save(os.path.join(outdir, name + dname), d.cpu().numpy())


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
