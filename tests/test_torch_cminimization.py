"""The port's constrained Newton solver (``models/cminimization.py``)
against the JAX package, in float64 on the CPU, on the same numpy inputs:
the three cases of the JAX package's own test (a quadratic that Newton
solves in one step, a strictly convex cosh energy, a linear constraint
term that the first iteration's pre-step corrects) and a nonlinear P1
energy at nx=8 with a Dirichlet condition,
int 1/2 |grad u|^2 + 1/4 u^4 - f u (the quartic term mass-lumped).
Each case: the same iterations, reason and convergence, and u to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu as hf
from hippyflow_tpu.models import ConstrainedNSolver as JSolver
from hippyflow_tpu_torch.fem import (
    DirichletBC,
    FunctionSpace,
    mass_matrix,
    stiffness_matrix,
    unit_square_mesh,
)
from hippyflow_tpu_torch.models import ConstrainedNSolver, newtonSolver_ParameterList

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")


def _quadratic():
    rng = np.random.default_rng(0)
    n = 12
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1, 5, n)) @ Q.T
    b = rng.standard_normal(n)
    return (lambda x, u: 0.5 * u @ x(A) @ u - x(b) @ u,
            lambda x, u: 0.0 * u.sum(), np.zeros(n), np.zeros(n), None)


def _cosh():
    b = 0.3 * np.random.default_rng(2).standard_normal(8)
    return (lambda x, u: (u.cosh() if hasattr(u, "cosh") else jnp.cosh(u)).sum()
            - x(b) @ u, lambda x, u: 0.0, np.zeros(8), np.zeros(8), None)


def _constraint_prestep():
    n = 6
    A, c = 2.0 * np.eye(n), np.ones(n)
    return (lambda x, u: 0.5 * u @ x(A) @ u, lambda x, u: x(c) @ u,
            np.zeros(n), c, None)


def _fe_energy():
    """1/2 u^T K u + 1/4 w . u^4 - (M f) . u on a P1 space at nx=8 (w the
    lumped mass), u = 0 on the boundary."""
    V = FunctionSpace(unit_square_mesh(8))
    K = stiffness_matrix(V, **F64).numpy()
    M = mass_matrix(V, **F64).numpy()
    x = V.dof_coords
    f = 40.0 * np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    w, Mf = M.sum(axis=1), M @ f
    bc = DirichletBC.from_predicate(V, None, 0.0)
    return (lambda t, u: 0.5 * u @ t(K) @ u + 0.25 * t(w) @ u**4 - t(Mf) @ u,
            lambda t, u: 0.0 * u.sum(), np.zeros(V.dim), np.zeros(V.dim), bc)


CASES = {"quadratic": _quadratic, "cosh": _cosh,
         "constraint_prestep": _constraint_prestep, "fe_energy": _fe_energy}


@pytest.mark.parametrize("case", sorted(CASES))
def test_constrained_newton_matches_jax(case):
    F, C, u0, cvec, bc = CASES[case]()
    jx, tx = jnp.asarray, lambda a: torch.as_tensor(a, **F64)
    jbc = None if bc is None else hf.DirichletBC(mask=bc.mask, value=bc.value)
    js = JSolver()
    ju, jreason = js.solve(lambda u: F(jx, u), lambda u: C(jx, u), jx(u0),
                           jx(cvec), bc=jbc)
    params = newtonSolver_ParameterList()
    params["print_level"] = -1
    ts = ConstrainedNSolver(params)
    tu, treason = ts.solve(lambda u: F(tx, u), lambda u: C(tx, u), tx(u0),
                           tx(cvec), bc=bc)
    assert (treason, ts.it, ts.converged) == (jreason, js.it, js.converged)
    assert ts.converged
    ju = np.asarray(ju)
    assert np.abs(tu.numpy() - ju).max() <= 1e-10 * max(1.0, np.abs(ju).max())
    if case == "constraint_prestep":
        # stationarity of L = F + C: A u + c = 0
        np.testing.assert_allclose(2.0 * tu.numpy() + cvec, 0.0, atol=1e-8)
    if case == "fe_energy":
        assert ts.it >= 3  # the quartic term makes Newton iterate
