"""Derivative-informed input and output subspaces (port of
``hippyflow_tpu/models/active_subspace.py``).

The input subspace is the randomized GHEP of E[J^T J] against the prior
precision R (``prior_preconditioned``, encoder = R @ decoder) or its HEP
(encoder = decoder); the output subspace is the randomized HEP of
E[J J^T].  The expectations are applied in one of three ways
(``_avg_gn_operator``):

* materialized: the per-sample Jacobians J_i (N, dQ, dM), formed once, and
  two large matmuls per application.  Samples and Jacobians come from the
  staged pass (``sample_until_solved``, optionally grid-sequenced, then
  ``materialize_jacobians``) or, for a linear symmetric operator without
  Dirichlet rows, from the fused pass (``sample_and_materialize_symmetric``:
  one factorization per sample).  This needs a B whose dense form and
  transpose agree (``materializable``);
* batched matrix-free, for a B that is not materializable (the full-state
  observable, whose transpose is the mass matrix): the linearizations of
  all samples are kept (``linearize_batch``, K1 once) and each application
  is the mean of J_i^T (J_i X) (or J_i (J_i^T X)) through incremental
  solves (K2 twice);
* serialized (``serialized_sampling``): each application loops over
  chunks of ``chunk_size`` samples (16 by default), linearizes the chunk
  afresh (K1), applies J and J^T (K2) and adds the chunk's sum into one
  (n, k) block, so that one chunk of factors is alive at a time.  The
  JAX package scans over chunks padded with copies of the first sample at
  weight 0; here the last chunk is short.  The sums are the same.

With a ``collective`` (``parallel.DeviceCollective``) the samples are
drawn and solved split over its ranks (``sample_until_solved``), each
rank makes the Jacobians (or linearizations) of its share of them
(``collective.local_slice``), and every application of the expectations
sums the rank's share and meets the other ranks' sums in one
``all_reduce`` (``collective.sum_partials``); the eigensolves then run on
every rank alike.  The fused pass runs on one rank only, as in the JAX
package.

``construct_low_rank_Jacobians`` saves the exact SVD of each Jacobian,
resuming chunk by chunk (under a collective each rank makes its share of
every chunk and global rank 0 alone reads and writes the files);
``test_errors`` runs the projection error tests and
``test_errors_double_loop`` the double-loop Monte-Carlo error of the input
subspace.  With a control distribution the samples carry controls
z, and ``construct_low_rank_control_Jacobians`` saves the SVD of each
dq/dz.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import time

import numpy as np
import torch

from ..ops.operators import low_rank_operator, prior_preconditioned_projector
from ..parallel.collective import NullCollective
from ..ops.randomized import double_pass, double_pass_g
from ..utils import KeyChain, ParameterList
from ..utils.plotting import spectrum_plot
from ..utils.profiling import PhaseTimer, stage
from .jacobian import ObservableJacobian, jjt_matmat, jtj_matmat
from .sampling import (
    SampleBatch,
    fresh_solves,
    linearize_batch,
    materialize_jacobians,
    sample_and_materialize_symmetric,
    sample_until_solved,
)


def ActiveSubspaceParameterList() -> ParameterList:
    """The JAX package's parameter list, but for the knobs of its XLA
    programs and host transfers."""
    return ParameterList(
        {
            "samples_per_process": [64, "Number of samples used in expectations"],
            "jacobian_data_per_process": [512, "Number of Jacobian data samples"],
            "error_test_samples": [50, "Number of samples for error test"],
            "double_loop_samples": [
                20,
                "Inner (conditional-resample) samples per outer sample in "
                "the double-loop MC error test",
            ],
            "rank": [128, "Rank of subspace"],
            "jacobian_rank": [128, "Rank of Jacobians generated"],
            "control_jacobian_rank": [None, "Rank of control Jacobians generated"],
            "oversampling": [10, "Oversampling for randomized algorithms"],
            "verbose": [True, "Print progress"],
            "input_decoder_name": ["_input_decoder", "naming"],
            "output_decoder_name": ["_output_decoder", "naming"],
            "serialized_sampling": [
                False,
                "apply J and J^T chunk by chunk, linearizing each chunk "
                "inside every operator application (one chunk of factors "
                "alive at a time)",
            ],
            "output_directory": [None, "output directory for arrays"],
            "plot_label_suffix": ["", "suffix for plot label"],
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

    def __init__(self, observable, prior, control_distribution=None,
                 collective=None, parameters: ParameterList | None = None):
        self.observable = observable
        self.prior = prior
        self.control_distribution = control_distribution
        self.collective = collective or NullCollective()
        self.parameters = parameters or ActiveSubspaceParameterList()
        self.keychain = KeyChain(self.parameters["seed"], prior.mean.device)
        self.samples: SampleBatch | None = None
        self.Js = None  # (N, dQ, dM), the materialized strategy
        self.lins = None  # the batched matrix-free strategy's linearizations
        self.prior_preconditioned = None
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
            collective=self.collective,
        )
        if self.parameters["verbose"]:
            print(
                f"forward sampling took {time.time() - t0:.3f}s "
                f"({self.samples.n_failures} resampled failures)"
            )

    def _materializable(self) -> bool:
        return getattr(self.observable.B, "materializable", True)

    def _fused_symmetric_eligible(self) -> bool:
        """True when sampling takes the fused forward + Jacobian pass: a
        linear operator with A^T = A, no Dirichlet rows (bc masking breaks
        the symmetry), a materializable B, the materialized strategy, drawn
        samples, no controls, no grid sequencing and one rank."""
        problem = self.observable.problem
        return (
            self.collective.size() == 1
            and self.control_distribution is None
            and problem.is_fwd_linear
            and problem.operator_symmetric
            and not problem._has_bc
            and self._materializable()
            and not self.parameters["serialized_sampling"]
            and not self.parameters["ms_given"]
            and self.parameters["coarse_warm_start"] is None
        )

    def _jac_chunk(self):
        return self.parameters["jac_chunk_size"] or self.parameters["chunk_size"]

    @contextlib.contextmanager
    def _stage(self, timer, name):
        """One stage: a profiler range, timed by ``timer`` up to the end of
        the device's work."""
        with stage(timer, name, block_on=self.prior.mean):
            yield

    def _prepare(self, timer):
        """Samples, and what the operator needs before its first
        application (the Jacobians, or the kept linearizations), each a
        stage of ``timer`` (a ``PhaseTimer``)."""
        if (self.samples is None and self.Js is None
                and self._fused_symmetric_eligible()):
            with self._stage(timer, "fused"):
                self.samples, self.Js = sample_and_materialize_symmetric(
                    self.observable, self.prior, self.keychain,
                    self.parameters["samples_per_process"],
                    chunk_size=self._jac_chunk(),
                    verbose=self.parameters["verbose"],
                )
            return
        with self._stage(timer, "forward"):
            self._ensure_samples()
        if self.parameters["serialized_sampling"]:
            return
        ms, us, zs = self._local_samples()
        if self._materializable():
            with self._stage(timer, "jacobian"):
                if self.Js is None:
                    self.Js = materialize_jacobians(
                        self.observable, ms, us, zs,
                        chunk_size=self._jac_chunk())
        else:
            with self._stage(timer, "linearize"):
                if self.lins is None:
                    self.lins = linearize_batch(self.observable, ms, us, zs)

    def _local_samples(self):
        """(ms, us, zs) of this rank's share of the samples (all of them
        on one process)."""
        s = self.samples
        sl = self.collective.local_slice(s.ms.shape[0])
        return s.ms[sl], s.us[sl], None if s.zs is None else s.zs[sl]

    def _avg_gn_operator(self, operation: str):
        """The block operator X (n, k) -> E[J^T J] X (operation 'JTJ', n =
        dM) or E[J J^T] X ('JJT', n = dQ) in the strategy the module's
        docstring describes; ``_prepare`` has run.  Each application sums
        this rank's samples and adds the other ranks' sums
        (``collective.sum_partials``)."""
        n = self.samples.ms.shape[0]
        red = self.collective.sum_partials
        J = ObservableJacobian(self.observable)
        per_sample = jtj_matmat if operation == "JTJ" else jjt_matmat
        if self.parameters["serialized_sampling"]:
            problem = self.observable.problem
            ms, us, zs = self._local_samples()
            n_loc = ms.shape[0]
            chunk = max(1, min(self.parameters["chunk_size"] or 16, n))

            def serialized(X):
                acc = torch.zeros_like(X)
                for a in range(0, n_loc, chunk):
                    e = min(a + chunk, n_loc)
                    lin = problem.linearize(
                        us[a:e], ms[a:e], None if zs is None else zs[a:e])
                    acc += per_sample(J, lin)(X).sum(dim=0)
                    del lin  # free this chunk's factors before the next's
                return red(acc) / n

            return serialized
        if self._materializable():
            Js = self.Js
            if operation == "JTJ":
                Jf = Js.reshape(-1, Js.shape[-1])  # (N dQ, dM)
                return lambda X: red(Jf.T @ (Jf @ X)) / n
            return lambda X: red((Js @ (Js.mT @ X)).sum(dim=0)) / n
        apply = per_sample(J, self.lins)
        return lambda X: red(apply(X).sum(dim=0)) / n

    def construct_input_subspace(self, prior_preconditioned: bool = True):
        """The GHEP of E[J^T J] against R (``prior_preconditioned``) or its
        HEP.  Returns (d_GN, decoder, encoder) with encoder = R @ decoder,
        or the decoder itself.  Wall seconds of the stages, each ended by a
        device synchronize, are left in ``stage_seconds``: forward, then
        jacobian (materialized) or linearize (batched matrix-free), or
        fused (forward + Jacobian in one pass); then ghep (which holds
        every linearization of the serialized strategy); their sum in
        ``_input_subspace_construction_time``.  Each stage is a phase of a
        ``PhaseTimer`` and an ``annotate`` range of its name."""
        timer = PhaseTimer()
        self._prepare(timer)
        with self._stage(timer, "ghep"):
            avg_jtj = self._avg_gn_operator("JTJ")
            r = self.parameters["rank"]
            p = self.parameters["oversampling"]
            Omega = self.Omega_GN
            if Omega is None:
                Omega = self.keychain.normal((self.observable.dM, r + p),
                                             dtype=self.prior.mean.dtype)
                if self.parameters["store_Omega"]:
                    self.Omega_GN = Omega
            if prior_preconditioned:
                self.d_GN, self.V_GN = double_pass_g(
                    avg_jtj, self.prior.R_matmat, self.prior.Rsolver_matmat,
                    Omega, r)
                encoder = self.prior.R_matmat(self.V_GN)
            else:
                self.d_GN, self.V_GN = double_pass(avg_jtj, Omega, r, s=1)
                encoder = self.V_GN
        self.prior_preconditioned = prior_preconditioned
        self.stage_seconds = dict(timer.timings)
        self._input_subspace_construction_time = sum(self.stage_seconds.values())
        if self.parameters["verbose"]:
            print("input subspace construction took "
                  f"{self._input_subspace_construction_time:.3f}s")
        self._save("input", self.d_GN, self.V_GN)
        return self.d_GN, self.V_GN, encoder

    def construct_output_subspace(self):
        """Randomized HEP of E[J J^T] (reference
        `activeSubspaceProjector.py:625-673`), in the input subspace's
        strategy (its Jacobians or linearizations are reused, or made
        here).  Returns (d_NG, decoder, encoder), encoder = decoder."""
        timer = PhaseTimer()
        self._prepare(timer)
        with self._stage(timer, "hep"):
            avg_jjt = self._avg_gn_operator("JJT")
            dQ = self.observable.dQ
            r = min(self.parameters["rank"], dQ)
            Omega = self.Omega_NG
            if Omega is None:
                Omega = self.keychain.normal(
                    (dQ, min(r + self.parameters["oversampling"], dQ)),
                    dtype=self.prior.mean.dtype)
                if self.parameters["store_Omega"]:
                    self.Omega_NG = Omega
            self.d_NG, self.U_NG = double_pass(avg_jjt, Omega, r, s=1)
        self._output_subspace_construction_time = sum(timer.timings.values())
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
        """The Jacobians' SVD data, chunk by chunk.  Under a collective
        global rank 0 (``collective.rank()``, the I/O gate) scans the chunk
        directory and broadcasts the finished chunks' ranges; it loads each
        finished chunk when the loop reaches it and broadcasts its arrays.
        Each rank makes the SVD of its share of every missing chunk's
        samples, the shares are gathered, and rank 0 alone writes the chunk
        and the bundle, each write followed by a barrier.  Every rank
        returns the same arrays."""
        from .data_generator import _save_bundle, _scan_chunks, _svd_payload

        self._ensure_samples()
        s = self.samples
        n = s.ms.shape[0]
        coll = self.collective
        writer = coll.rank() == 0
        prefix = "z" if control else ""
        rank_param = ((self.parameters["control_jacobian_rank"] if control
                       else None) or self.parameters["jacobian_rank"])
        chunk_size = self.parameters["chunk_size"] or n
        chunk_dir = (None if output_directory is None
                     else os.path.join(output_directory, f"chunks{prefix}"))
        keys = tuple(f"{k}{prefix}_data" for k in ("U", "sigma", "V"))
        done, finished = {}, set()
        if chunk_dir is not None:
            if writer:
                os.makedirs(chunk_dir, exist_ok=True)
                if check_for_data:
                    done = {(a, b): f for a, b, f in _scan_chunks(chunk_dir)}
            finished = set(coll.bcast_io(sorted(done)))
        parts = {k: [] for k in keys}
        for a in range(0, n, chunk_size):
            b = min(a + chunk_size, n)
            if (a, b) in finished:
                chunk = None
                if writer:
                    with np.load(done[(a, b)]) as z:
                        chunk = {k: torch.as_tensor(z[k]) for k in keys}
                for k, v in coll.bcast_io_tensors(chunk).items():
                    parts[k].append(v.to(s.ms.device))
                continue
            share = coll.local_slice(b - a)
            J = self._chunk_jacobians(a + share.start, a + share.stop, control)
            rank = min(rank_param, *J.shape[1:])
            chunk = dict(zip(keys, (coll.gather_samples(x, b - a)
                                    for x in _svd_payload(J, rank))))
            if chunk_dir is not None:
                if writer:
                    np.savez(os.path.join(chunk_dir, f"chunk_{a}_{b}.npz"),
                             **{k: v.cpu().numpy() for k, v in chunk.items()})
                coll.barrier()
            for k in keys:
                parts[k].append(chunk[k])
        U, sig, V = (torch.cat(parts[k]) for k in keys)
        if output_directory is not None:
            if writer:
                _save_bundle(
                    os.path.join(output_directory, f"J{prefix}svd_data.npz"),
                    **{k: v.cpu().numpy() for k, v in zip(keys, (U, sig, V))})
                np.save(os.path.join(output_directory, "mq_m_data.npy"),
                        s.ms.cpu().numpy())
                np.save(os.path.join(output_directory, "mq_q_data.npy"),
                        s.qs.cpu().numpy())
                shutil.rmtree(chunk_dir, ignore_errors=True)
            coll.barrier()
        return U, sig, V

    def _chunk_jacobians(self, lo, hi, control: bool):
        """The Jacobians (or control Jacobians) of samples [lo, hi): the
        subspace build's where this rank holds them, else materialized."""
        s = self.samples
        if not control and self.Js is not None:
            held = self.collective.local_slice(s.ms.shape[0])
            if (self.Js.shape[0] == held.stop - held.start
                    and held.start <= lo and hi <= held.stop):
                return self.Js[lo - held.start:hi - held.start]
        return materialize_jacobians(
            self.observable, s.ms[lo:hi], s.us[lo:hi],
            None if s.zs is None else s.zs[lo:hi], chunk_size=max(1, hi - lo),
            control=control)

    def test_errors(self, ranks=(8, 16, 32, 64), test_input: bool = True,
                    test_output: bool = False, n_samples: int | None = None):
        """Monte-Carlo relative projection errors of the subspaces at the
        given ranks (reference `activeSubspaceProjector.py:1048-1335`, its
        naive test).  Input: ||m - P_r m|| / ||m|| over prior samples, with
        P_r = V_r V_r^T R after the prior-preconditioned GHEP and V_r V_r^T
        after the HEP.  Output: ||q - U_r U_r^T q|| / ||q|| over fresh forward
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
                proj = self._input_projector(r)
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

    def _input_projector(self, r):
        """The rank-r projector onto the input subspace: V V^T R after the
        prior-preconditioned GHEP, V V^T after the HEP."""
        V = self.V_GN[:, :r]
        if self.prior_preconditioned:
            return prior_preconditioned_projector(V, self.prior.R_matmat)
        return low_rank_operator(V.new_ones(r), V)

    def test_errors_double_loop(self, ranks=(8, 16, 32), n_samples: int | None = None,
                                double_loop_samples: int | None = None):
        """Double-loop Monte-Carlo error of the input subspace (reference
        `activeSubspaceProjector.py:1147-1245`): for each rank r, with P_r
        the rank-r input projector,

            err_i = ||q(m_i) - E_y[q(P_r m_i + (I - P_r) y)]|| / ||q(m_i)||,

        y drawn from the prior, the inner mean over ``double_loop_samples``
        draws per outer sample.  The outer samples' fresh solves run
        first and their failures are discarded; then, per rank, the
        n_valid x double_loop_samples conditional resamples run as one
        batch of solves, and each inner mean is taken over its survivors
        (an outer sample with none is discarded).  Returns ("double_loop",
        r) -> (avg, std) and ("double_loop_discarded", r) -> (outer
        discarded, inner discarded); the averages are also left in
        ``_double_loop_errors``.  The averages go through the collective's
        ``allReduce`` of scalars, as in the JAX package: every rank runs
        the same test, so the average is the identity."""
        if self.V_GN is None:
            raise RuntimeError("construct_input_subspace first")
        n = n_samples or self.parameters["error_test_samples"]
        nj = double_loop_samples or self.parameters["double_loop_samples"]
        prior, dtype = self.prior, self.prior.mean.dtype
        ms = prior.sample(self.keychain.normal((n, prior.noise_dim), dtype=dtype))
        zs = (None if self.control_distribution is None else
              self.control_distribution.sample_n(self.keychain, n, dtype))
        qs, ok, _ = self._fresh_solves(ms, zs)
        if not ok.any():
            raise RuntimeError("double-loop test: every outer solve failed")
        ms_v, qs_v = ms[ok], qs[ok]
        zs_v = None if zs is None else zs[ok]
        nv = ms_v.shape[0]
        den = torch.linalg.vector_norm(qs_v, dim=1)
        out, results = {}, []
        for r in ranks:
            proj = self._input_projector(r)
            m_r = proj(ms_v.T).T
            y = prior.sample(self.keychain.normal((nv * nj, prior.noise_dim),
                                                  dtype=dtype))
            m_inner = m_r.repeat_interleave(nj, dim=0) + (y - proj(y.T).T)
            z_inner = None if zs_v is None else zs_v.repeat_interleave(nj, dim=0)
            q_in, ok_in, _ = self._fresh_solves(m_inner, z_inner)
            q_in, ok_in = q_in.reshape(nv, nj, -1), ok_in.reshape(nv, nj)
            n_ok = ok_in.sum(dim=1)
            cond_mean = (torch.where(ok_in[..., None], q_in, 0.0).sum(dim=1)
                         / n_ok.clamp(min=1)[:, None])
            valid = n_ok > 0
            errs = (torch.linalg.vector_norm(qs_v - cond_mean, dim=1) / den)[valid]
            # collective averages of replicated scalars (every rank ran the
            # same test), the identity as in the JAX package
            avg = self.collective.allReduce(errs.mean().item(), "avg")
            std = math.sqrt(self.collective.allReduce(
                errs.std(correction=0).item() ** 2, "avg"))
            out[("double_loop", r)] = (avg, std)
            out[("double_loop_discarded", r)] = (
                int(n - nv + (~valid).sum().item()), int(nj * nv - n_ok.sum().item()))
            results.append(avg)
            if self.parameters["verbose"]:
                print("Double loop MC global average relative error input = "
                      f"{avg:.6f} for rank {r}")
        self._double_loop_errors = results
        return out

    def _fresh_solves(self, ms, zs=None):
        """Cold-started forward solves of ms (and zs): (qs, converged (N,)
        bool, Newton iterations (N,))."""
        return fresh_solves(self.observable, ms, self.parameters["chunk_size"],
                            zs)

    def _save(self, which: str, d, decoder):
        """AS_<n><input|output_decoder_name>.npy, AS_<n>_d_GN.npy or
        AS_<n>_d_NG.npy, and the spectrum's plot
        AS_<n>_<which>_eigenvalues_<rank>.pdf (where matplotlib is
        installed)."""
        outdir = self.parameters["output_directory"]
        if (not self.parameters["save_and_plot"] or outdir is None
                or self.collective.rank() != 0):
            return
        os.makedirs(outdir, exist_ok=True)
        # the JAX package's name: samples_per_process times the size
        n = self.parameters["samples_per_process"] * self.collective.size()
        name = f"AS_{int(n)}"
        suffix = self.parameters[f"{which}_decoder_name"]
        np.save(os.path.join(outdir, name + suffix), decoder.cpu().numpy())
        dname = "_d_GN" if which == "input" else "_d_NG"
        d = d.cpu().numpy()
        np.save(os.path.join(outdir, name + dname), d)
        spectrum_plot(d, axis_label=["i", r"$\lambda_i$", "spectrum"],
                      out_name=os.path.join(
                          outdir, f"{name}_{which}_eigenvalues_"
                          f"{self.parameters['rank']}.pdf"))
