"""Observables q = B u (port of ``hippyflow_tpu/models/observable.py``).

A B-operator has ``apply`` / ``applyt`` on states (N, n) or blocks
(N, n, k) and ``dense``; ``materializable`` says whether ``dense()`` and
``applyt`` are consistent transposes, so that a Jacobian through B may be
formed as one dense matrix.

* ``PointwiseObservation``: dense B (n_obs, n) from P1 interpolation.
* ``StateSpaceIdentityOperator``: the full state, B = I, with the
  M-adjoint transpose B^T q = M q when ``use_mass_matrix``; no single
  dense matrix gives both, so it is not materializable.
* ``DomainRestrictedOperator``: zero the state outside an indicator first.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..fem import FunctionSpace, assemble_pointwise_observation, mass_matrix
from .pde_problem import Linearization, VariationalPDEProblem


def _scale_rows(x, s):
    """x (N, n) or (N, n, k) times the per-row factor s (n,)."""
    return x * (s[:, None] if x.ndim == 3 else s)


def _dense_apply(A, x):
    """A (p, n) applied to x (N, n) -> (N, p), or (N, n, k) -> (N, p, k)."""
    return x @ A.T if x.ndim == 2 else A @ x


class PointwiseObservation:
    """Dense B (n_obs, n) from P1 interpolation at target points (numpy
    construction, a tensor on the device)."""

    materializable = True

    def __init__(self, space: FunctionSpace, targets, dtype=None, device=None):
        dtype, device = config.resolve(dtype, device)
        Bnp = assemble_pointwise_observation(space, np.asarray(targets))
        self.B = torch.as_tensor(Bnp, dtype=dtype, device=device)
        self.targets = np.asarray(targets)

    @property
    def dim(self) -> int:
        return self.B.shape[0]

    @property
    def state_dim(self) -> int:
        return self.B.shape[1]

    def apply(self, u):
        """B u for states (N, n) -> (N, n_obs), or blocks (N, n, k) ->
        (N, n_obs, k)."""
        return _dense_apply(self.B, u)

    def applyt(self, q):
        """B^T q for (N, n_obs) -> (N, n), or (N, n_obs, k) -> (N, n, k)."""
        return _dense_apply(self.B.T, q)

    def dense(self):
        return self.B


class StateSpaceIdentityOperator:
    """The full-state observable B = I; B^T q = M q with ``use_mass_matrix``
    (the M-adjoint), else q (reference `fullStateObservable.py:18-53`)."""

    materializable = False

    def __init__(self, space: FunctionSpace, use_mass_matrix: bool = True,
                 dtype=None, device=None):
        dtype, device = config.resolve(dtype, device)
        self.space = space
        self.use_mass_matrix = use_mass_matrix
        self.M = (mass_matrix(space, dtype=dtype, device=device)
                  if use_mass_matrix else None)
        self._dtype, self._device = dtype, device

    @property
    def dim(self) -> int:
        return self.space.dim

    @property
    def state_dim(self) -> int:
        return self.space.dim

    def apply(self, u):
        return u

    def applyt(self, q):
        return _dense_apply(self.M, q) if self.use_mass_matrix else q

    def dense(self):
        return torch.eye(self.space.dim, dtype=self._dtype, device=self._device)


class DomainRestrictedOperator:
    """B applied to the state restricted by an indicator (n,) (reference
    `observable.py:38-63`)."""

    def __init__(self, indicator, B):
        self.indicator = torch.as_tensor(indicator)
        self.inner = B
        self.materializable = getattr(B, "materializable", True)

    @property
    def dim(self):
        return self.inner.dim

    @property
    def state_dim(self):
        return self.inner.state_dim

    def apply(self, u):
        return self.inner.apply(_scale_rows(u, self.indicator.to(u)))

    def applyt(self, q):
        x = self.inner.applyt(q)
        return _scale_rows(x, self.indicator.to(x))

    def dense(self):
        D = self.inner.dense()
        return D * self.indicator.to(D)[None, :]


class LinearStateObservable:
    """q(m[, z]) = B u(m[, z]), batched over samples.

    ``parameter_projection``: an indicator (dM,) or a matrix P (dM, dM)
    applied to the parameter direction before C (and P^T after C^T), which
    restricts the sensitivity to a subdomain (reference
    `observable.py:263-297`)."""

    def __init__(self, problem: VariationalPDEProblem, B, parameter_projection=None):
        self.problem = problem
        self.B = B
        self.is_control_problem = problem.has_control
        self.parameter_projection = (
            None if parameter_projection is None else torch.as_tensor(
                parameter_projection, dtype=problem.dtype, device=problem.device))

    def _project_parameter(self, dm):
        P = self.parameter_projection
        if P is None:
            return dm
        return _scale_rows(dm, P) if P.ndim == 1 else _dense_apply(P, dm)

    def _project_parameter_t(self, g):
        P = self.parameter_projection
        if P is None:
            return g
        return _scale_rows(g, P) if P.ndim == 1 else _dense_apply(P.T, g)

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
        return self.problem.apply_C(lin, self._project_parameter(dm))

    def applyCt(self, lin: Linearization, dp):
        return self._project_parameter_t(self.problem.apply_Ct(lin, dp))

    def applyCz(self, lin: Linearization, dz):
        return self.problem.apply_Cz(lin, dz)

    def applyCzt(self, lin: Linearization, dp):
        return self.problem.apply_Czt(lin, dp)

    def solveFwdIncremental(self, lin: Linearization, rhs):
        return self.problem.solve_incremental(lin, rhs, is_adj=False)

    def solveAdjIncremental(self, lin: Linearization, rhs):
        return self.problem.solve_incremental(lin, rhs, is_adj=True)
