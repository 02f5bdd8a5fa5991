"""The inverse-problem wrapper (port of ``hippyflow_tpu/models/model_wrapper.py``,
after `hippyflow/modeling/hippylibModelWrapper.py:42-369`): observable
evaluations, the misfit and regularization costs and their gradients,
Jacobian and Gauss-Newton Hessian actions, prior sampling and synthetic
data, for

    min_m  0.5 / sigma^2 ||B u(m) - d||^2 + 0.5 ||m - m0||_R^2.

Batched over samples: every method takes parameters m (N, dM) and returns
one value per sample (costs (N,), gradients (N, dM), J products (N, dQ) or
(N, dQ, k)); the data d (dQ,) is shared.  The gradient is adjoint-based:
one linearization (K1 on the card) and one adjoint solve with one
right-hand side per sample (K2).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import KeyChain, ParameterList
from .jacobian import ObservableJacobian
from .observable import LinearStateObservable


def modelWrapperSettings() -> ParameterList:
    """The JAX package's settings (reference `hippylibModelWrapper.py:28-38`)."""
    return ParameterList(
        {
            "seed": [0, "seed of the wrapper's own generator"],
            "rel_noise": [None, "Relative noise for inverse problem data"],
        }
    )


@dataclass
class PointwiseMisfit:
    """The quadratic misfit 0.5 / sigma^2 ||B u - d||^2 (hp.Misfit)."""

    d: torch.Tensor  # (dQ,)
    noise_variance: float


def _rows(op, X):
    """A block operator on columns (n, k) applied to rows X (N, n)."""
    return op(X.T).T


class ModelWrapper:
    """Observable, prior and misfit, with gradient and Hessian actions.
    ``keychain`` draws the prior samples and the data noise (replace it
    with a ``utils.GivenNoise`` to give them)."""

    def __init__(self, observable: LinearStateObservable, prior,
                 misfit: PointwiseMisfit | None = None,
                 settings: ParameterList | None = None):
        self.observable = observable
        self.prior = prior
        self.misfit = misfit
        self.settings = settings or modelWrapperSettings()
        self.keychain = KeyChain(self.settings["seed"], prior.mean.device)
        self.J = ObservableJacobian(observable)
        self.dQ, self.dM = self.J.shape
        self.mtrue = None

    def _misfit(self) -> PointwiseMisfit:
        if self.misfit is None:
            raise RuntimeError("no misfit: call setUpInverseProblem first")
        return self.misfit

    # -- forward and costs ----------------------------------------------------
    def evalObs(self, m, u0=None):
        return self.observable.eval(m, u0=u0)

    def evalMisfit(self, m, u0=None):
        """(q - d) / sigma^2, (N, dQ)."""
        mis = self._misfit()
        return (self.evalObs(m, u0=u0) - mis.d) / mis.noise_variance

    def evalMisfitCost(self, m, u0=None):
        """0.5 / sigma^2 ||q - d||^2, (N,)."""
        mis = self._misfit()
        r = self.evalObs(m, u0=u0) - mis.d
        return 0.5 / mis.noise_variance * (r * r).sum(dim=1)

    def evalRegularizationCost(self, m):
        """0.5 (m - m0)^T R (m - m0), (N,)."""
        dm = m - self.prior.mean
        return 0.5 * (dm * _rows(self.prior.R_matmat, dm)).sum(dim=1)

    def evalCost(self, m, u0=None):
        return self.evalMisfitCost(m, u0=u0) + self.evalRegularizationCost(m)

    # -- gradients --------------------------------------------------------------
    def evalVariationalGradient(self, m, u0=None, misfit_only: bool = True):
        """J^T (q - d) / sigma^2 [+ R (m - m0)], (N, dM): the adjoint-based
        gradient (reference `hippylibModelWrapper.py:119-155`)."""
        mis = self._misfit()
        lin = self.observable.linearize(m, u0=u0)
        q = self.observable.evalu(lin.u)
        mg = self.J.transpmult(lin, (q - mis.d) / mis.noise_variance)
        if not misfit_only:
            mg = mg + self.evalRegularizationGradient(m)
        return mg

    def evalRegularizationGradient(self, m):
        return _rows(self.prior.R_matmat, m - self.prior.mean)

    def evalGradient(self, m, u0=None, misfit_only: bool = True,
                     invert_regularization: bool = False):
        """The gradient preconditioned by the mass matrix, or by R
        (reference `hippylibModelWrapper.py:157-168`)."""
        mg = self.evalVariationalGradient(m, u0=u0, misfit_only=misfit_only)
        if invert_regularization:
            return self.invertRegularization(mg)
        return self.invertMassMatrix(mg)

    def invertMassMatrix(self, rhs):
        return _rows(self.prior.Msolver_matmat, rhs)

    def invertRegularization(self, rhs):
        return _rows(self.prior.Rsolver_matmat, rhs)

    # -- Jacobian actions -------------------------------------------------------
    def _lin(self, m, lin):
        return self.observable.linearize(m) if lin is None else lin

    def evalJ(self, mhat, m=None, lin=None):
        return self.J.mult(self._lin(m, lin), mhat)

    def evalJt(self, qhat, m=None, lin=None):
        return self.J.transpmult(self._lin(m, lin), qhat)

    def evalGNHessian(self, mhat, m=None, lin=None):
        """J^T Sigma^{-1} J mhat for mhat (N, dM) or (N, dM, k)."""
        mis = self._misfit()
        lin = self._lin(m, lin)
        return self.J.transpmult(lin, self.J.mult(lin, mhat) / mis.noise_variance)

    def evalJacobian(self, m=None, lin=None):
        """The dense Jacobians (N, dQ, dM), one adjoint solve of dQ
        right-hand sides per sample."""
        return self.J.materialize(self._lin(m, lin))

    def evalLowRankJacobian(self, rank: int, m=None, lin=None):
        """The SVD of each Jacobian truncated at ``rank``: (U (N, dQ, r),
        sigma (N, r), V (N, dM, r))."""
        U, s, Vt = torch.linalg.svd(self.evalJacobian(m=m, lin=lin),
                                    full_matrices=False)
        return U[..., :rank], s[..., :rank], Vt.mT[..., :rank]

    # -- sampling and synthetic data --------------------------------------------
    def samplePrior(self, n: int = 1):
        return self.prior.sample(self.keychain.normal(
            (n, self.prior.noise_dim), dtype=self.prior.mean.dtype))

    def setUpInverseProblem(self, mtrue=None, rel_noise: float | None = None):
        """Noisy data at a drawn or given true parameter mtrue (dM,)
        (reference `hippylibModelWrapper.py:340-369`): noise_std = rel_noise
        max|q_true|.  As in the JAX package, ``rel_noise or
        settings['rel_noise']``: 0 falls through to the setting."""
        rel_noise = rel_noise or self.settings["rel_noise"]
        if rel_noise is None:
            raise ValueError("set rel_noise")
        mean = self.prior.mean
        mtrue = (self.samplePrior(1)[0] if mtrue is None else torch.as_tensor(
            mtrue, dtype=mean.dtype, device=mean.device))
        self.mtrue = mtrue
        q_true = self.evalObs(mtrue[None])[0]
        noise_std = float(rel_noise * q_true.abs().max())
        noise = noise_std * self.keychain.normal(q_true.shape, dtype=q_true.dtype)
        self.misfit = PointwiseMisfit(d=q_true + noise, noise_variance=noise_std**2)
        return self.misfit
