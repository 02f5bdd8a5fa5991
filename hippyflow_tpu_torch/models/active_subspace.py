"""Derivative-informed input subspace (port of the materialized,
prior-preconditioned path of ``hippyflow_tpu/models/active_subspace.py``).

The Gauss-Newton operator E[J^T J] is applied from the materialized
per-sample Jacobians as two large matmuls; the randomized GHEP against the
prior precision R gives the active subspace.  Samples and Jacobians come
from the staged pass (``sample_until_solved``, optionally grid-sequenced,
then ``materialize_jacobians``) or, for a linear symmetric operator without
Dirichlet rows, from the fused pass (``sample_and_materialize_symmetric``:
one factorization per sample).
"""

from __future__ import annotations

import time

import torch

from ..ops.randomized import double_pass_g
from ..utils import KeyChain, ParameterList
from .sampling import (
    SampleBatch,
    materialize_jacobians,
    sample_and_materialize_symmetric,
    sample_until_solved,
)


def ActiveSubspaceParameterList() -> ParameterList:
    """The slice of the JAX package's parameter list that the port runs."""
    return ParameterList(
        {
            "samples_per_process": [64, "Number of samples used in expectations"],
            "rank": [128, "Rank of subspace"],
            "oversampling": [10, "Oversampling for randomized algorithms"],
            "verbose": [True, "Print progress"],
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
    """Input active subspace of m -> q(m) = B u(m) under a Gaussian prior.

    Set ``.ms`` (with ``ms_given``) and/or ``.Omega_GN`` before
    ``construct_input_subspace`` to supply the samples and the probe block
    instead of drawing them."""

    def __init__(self, observable, prior, parameters: ParameterList | None = None):
        self.observable = observable
        self.prior = prior
        self.parameters = parameters or ActiveSubspaceParameterList()
        self.keychain = KeyChain(self.parameters["seed"], prior.mean.device)
        self.samples: SampleBatch | None = None
        self.Js = None  # (N, dQ, dM)
        self.ms = None
        self.Omega_GN = None
        self.d_GN = None
        self.V_GN = None
        self.stage_seconds = None

    def _ensure_samples(self):
        if self.samples is not None:
            return
        problem = self.observable.problem
        if self.parameters["ms_given"]:
            if self.ms is None:
                raise ValueError("set .ms before an ms_given construction")
            us, info = problem.solve_fwd(self.ms)
            self.samples = SampleBatch(
                ms=self.ms, us=us, qs=self.observable.evalu(us), n_failures=0,
                iterations=info.iterations,
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
        )
        if self.parameters["verbose"]:
            print(
                f"forward sampling took {time.time() - t0:.3f}s "
                f"({self.samples.n_failures} resampled failures)"
            )

    def _fused_symmetric_eligible(self) -> bool:
        """True when sampling takes the fused forward + Jacobian pass: a
        linear operator with A^T = A, no Dirichlet rows (bc masking breaks
        the symmetry), drawn samples and no grid sequencing."""
        problem = self.observable.problem
        return (
            problem.is_fwd_linear
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
                self.observable, s.ms, s.us,
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
        ghep."""
        if not prior_preconditioned:
            raise NotImplementedError("only the prior-preconditioned GHEP")
        device = self.prior.mean.device

        def lap(t_prev):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
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
        Jf = J.reshape(-1, J.shape[-1])  # (N dQ, dM)

        def avg_jtj(X):
            return (Jf.T @ (Jf @ X)) / J.shape[0]

        self.d_GN, self.V_GN = double_pass_g(
            avg_jtj, self.prior.R_matmat, self.prior.Rsolver_matmat, Omega, r
        )
        encoder = self.prior.R_matmat(self.V_GN)
        _, ghep = lap(t)
        self.stage_seconds = {**stages, "ghep": ghep}
        return self.d_GN, self.V_GN, encoder
