"""Observable Jacobians (port of ``hippyflow_tpu/models/jacobian.py``).

J = -B A^{-1} C, so J^T = -C^T A^{-T} B^T, and the control Jacobian
Jz = -B A^{-1} Cz.  ``mult`` and ``transpmult`` apply them through
incremental solves against the factors of a batch of linearizations (K2
on the card); ``materialize`` forms the dense J (Jz) with one adjoint solve
of dQ right-hand sides per sample, then C^T (Cz^T).
"""

from __future__ import annotations

from ..utils.profiling import annotate
from .observable import LinearStateObservable
from .pde_problem import Linearization


class ObservableJacobian:
    """J(m) = d(B u)/dm at a batch of linearization points."""

    def __init__(self, observable: LinearStateObservable):
        self.observable = observable

    @property
    def shape(self):
        return (self.observable.dQ, self.observable.dM)

    def _C(self, lin, dx):
        return self.observable.applyC(lin, dx)

    def _Ct(self, lin, dp):
        return self.observable.applyCt(lin, dp)

    def mult(self, lin: Linearization, dm):
        """J dm for dm (N, dM) or (N, dM, k), one sample per linearization."""
        obs = self.observable
        uhat = obs.solveFwdIncremental(lin, self._C(lin, dm))
        return -obs.applyB(uhat)

    def transpmult(self, lin: Linearization, dq):
        """J^T dq for dq (N, dQ) or (N, dQ, k)."""
        obs = self.observable
        phat = obs.solveAdjIncremental(lin, obs.applyBt(dq))
        return -self._Ct(lin, phat)

    def materialize(self, lin: Linearization):
        """Dense J (N, dQ, dM) from one blocked adjoint solve per sample."""
        obs = self.observable
        N = lin.u.shape[0]
        with annotate("fem.apply_c", fine=True):
            Bt = obs.B.dense().T.expand(N, -1, -1)  # (N, n, dQ)
        X = obs.solveAdjIncremental(lin, Bt)  # A^{-T} B^T
        return -self._Ct(lin, X).mT  # (N, dQ, dM)


class ObservableControlJacobian(ObservableJacobian):
    """Jz(m, z) = d(B u)/dz at a batch of linearization points: the same
    products with Cz = dr/dz in place of C (reference
    ``controlJacobian.py:22-95``)."""

    def __init__(self, observable: LinearStateObservable):
        if not observable.is_control_problem:
            raise ValueError("the observable's problem has no control")
        super().__init__(observable)

    @property
    def shape(self):
        return (self.observable.dQ, self.observable.problem.control_dim)

    def mult(self, lin: Linearization, dz):
        """Jz dz for dz (N, dz) or (N, dz, k), one sample per
        linearization (the JAX package's keyword ``dz``)."""
        return super().mult(lin, dz)

    def _C(self, lin, dz):
        return self.observable.applyCz(lin, dz)

    def _Ct(self, lin, dp):
        return self.observable.applyCzt(lin, dp)


def jtj_matmat(J: ObservableJacobian, lin: Linearization):
    """X (dM, k) -> J_i^T J_i X for every sample i of ``lin``: (N, dM, k)
    (reference JTJ)."""
    N = lin.u.shape[0]
    return lambda X: J.transpmult(lin, J.mult(lin, X.expand(N, -1, -1)))


def jjt_matmat(J: ObservableJacobian, lin: Linearization):
    """X (dQ, k) -> J_i J_i^T X for every sample i of ``lin``: (N, dQ, k)
    (reference JJT)."""
    N = lin.u.shape[0]
    return lambda X: J.mult(lin, J.transpmult(lin, X.expand(N, -1, -1)))
