"""Materialized observable Jacobians (port of ``hippyflow_tpu/models/jacobian.py``).

J = -B A^{-1} C, so J^T = -C^T A^{-T} B^T: one adjoint solve with dQ
right-hand sides per sample (K2 with trans=True on the card), then C^T.
"""

from __future__ import annotations

from .observable import LinearStateObservable
from .pde_problem import Linearization


class ObservableJacobian:
    """J(m) = d(B u)/dm at a batch of linearization points."""

    def __init__(self, observable: LinearStateObservable):
        self.observable = observable

    @property
    def shape(self):
        return (self.observable.dQ, self.observable.dM)

    def materialize(self, lin: Linearization):
        """Dense J (N, dQ, dM) from one blocked adjoint solve per sample."""
        obs = self.observable
        N = lin.u.shape[0]
        Bt = obs.B.dense().T.expand(N, -1, -1)  # (N, n, dQ)
        X = obs.solveAdjIncremental(lin, Bt)  # A^{-T} B^T
        return -obs.applyCt(lin, X).mT  # (N, dQ, dM)
