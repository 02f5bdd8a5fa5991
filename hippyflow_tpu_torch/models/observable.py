"""Pointwise observables q = B u (port of ``hippyflow_tpu/models/observable.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..fem import FunctionSpace, assemble_pointwise_observation
from .pde_problem import Linearization, VariationalPDEProblem


class PointwiseObservation:
    """Dense B (n_obs, n) from P1 interpolation at target points (numpy
    construction, a tensor on the device)."""

    def __init__(self, space: FunctionSpace, targets, dtype=None, device=None):
        dtype, device = config.resolve(dtype, device)
        Bnp = assemble_pointwise_observation(space, np.asarray(targets))
        self.B = torch.as_tensor(Bnp, dtype=dtype, device=device)
        self.targets = np.asarray(targets)

    @property
    def dim(self) -> int:
        return self.B.shape[0]

    def apply(self, u):
        """B u for states (N, n) -> (N, n_obs), or blocks (N, n, k) ->
        (N, n_obs, k)."""
        return u @ self.B.T if u.ndim == 2 else self.B @ u

    def applyt(self, q):
        """B^T q for (N, n_obs) -> (N, n), or (N, n_obs, k) -> (N, n, k)."""
        return q @ self.B if q.ndim == 2 else self.B.T @ q

    def dense(self):
        return self.B


class LinearStateObservable:
    """q(m[, z]) = B u(m[, z]), batched over samples."""

    def __init__(self, problem: VariationalPDEProblem, B: PointwiseObservation):
        self.problem = problem
        self.B = B
        self.is_control_problem = problem.has_control

    @property
    def dQ(self) -> int:
        return self.B.dim

    @property
    def dM(self) -> int:
        return self.problem.Vm.dim

    def eval(self, m, z=None, u0=None):
        """Solve forward and observe: q (N, dQ)."""
        u, _ = self.problem.solve_fwd(m, z=z, u0=u0)
        return self.B.apply(u)

    def evalu(self, u):
        return self.B.apply(u)

    def solve_fwd(self, m, z=None, u0=None):
        return self.problem.solve_fwd(m, z=z, u0=u0)

    def linearize(self, m, z=None, u=None, u0=None):
        """Solve forward (where u is not given) and factorize the
        linearized state operator at (u, m, z)."""
        if u is None:
            u, _ = self.problem.solve_fwd(m, z=z, u0=u0)
        return self.problem.linearize(u, m, z)

    def applyB(self, u):
        return self.B.apply(u)

    def applyBt(self, q):
        return self.B.applyt(q)

    def applyC(self, lin: Linearization, dm):
        return self.problem.apply_C(lin, dm)

    def applyCt(self, lin: Linearization, dp):
        return self.problem.apply_Ct(lin, dp)

    def applyCz(self, lin: Linearization, dz):
        return self.problem.apply_Cz(lin, dz)

    def applyCzt(self, lin: Linearization, dp):
        return self.problem.apply_Czt(lin, dp)

    def solveFwdIncremental(self, lin: Linearization, rhs):
        return self.problem.solve_incremental(lin, rhs, is_adj=False)

    def solveAdjIncremental(self, lin: Linearization, rhs):
        return self.problem.solve_incremental(lin, rhs, is_adj=True)
