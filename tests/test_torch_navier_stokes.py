"""The port's steady Navier-Stokes solve (``applications/navier_stokes.py``)
and the vector form's cell coefficients against the JAX package, in
float64 on the CPU, at nx=10 and 16 (three-component P1 state, blocks of
s=33 and 51 in band order, an indefinite nonsymmetric saddle-point band):

* the residual and the banded Jacobian of the Navier-Stokes form (whose
  pressure stabilization reads the cell diameters through
  ``cell_coefficients``) to 1e-12 of their largest entry;
* velocity and pressure to 1e-9 relative, and the Newton iterations and
  termination of every Reynolds step equal to JAX's;
* the confusion observable with its default (Navier-Stokes) velocity on
  one forward solve to 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applications.confusion import confusion_linear_observable as j_observable
from applications.navier_stokes import _ns_bc as j_ns_bc
from applications.navier_stokes import _ns_form as j_ns_form
from applications.navier_stokes import steady_navier_stokes as j_ns
from hippyflow_tpu.fem import FunctionSpace as JSpace
from hippyflow_tpu.fem import unit_square_mesh as j_mesh
from hippyflow_tpu.models import VariationalPDEProblem as JProblem
from hippyflow_tpu_torch.applications import navier_stokes as tns
from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable as t_observable,
    confusion_velocity,
)
from hippyflow_tpu_torch.fem import FunctionSpace, unit_square_mesh
from hippyflow_tpu_torch.models import VariationalPDEProblem

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_solve(nx):
    """JAX's steady_navier_stokes, and its continuation replayed step by
    step for each step's Newton (iterations, converged)."""
    V = JSpace(j_mesh(nx))
    v, p, _ = j_ns(V)
    bc, u, steps = j_ns_bc(V), None, []
    for re in (10.0, 40.0, 100.0):
        problem = JProblem(V, V, j_ns_form(V, re), bc, is_fwd_linear=False,
                           newton_max_iter=50, newton_rtol=1e-8)
        u, info = problem.solve_fwd(jnp.zeros(V.dim), u0=u)
        steps.append((re, int(info.iterations), bool(info.converged)))
    np.testing.assert_array_equal(np.asarray(u[: 2 * V.dim]).reshape(2, -1).T,
                                  np.asarray(v))
    return np.asarray(v), np.asarray(p), steps


@pytest.mark.parametrize("nx", [10, 16])
def test_form_residual_and_band_match_jax(nx):
    jV, tV = JSpace(j_mesh(nx)), FunctionSpace(unit_square_mesh(nx))
    jp = JProblem(jV, jV, j_ns_form(jV, 40.0), j_ns_bc(jV), is_fwd_linear=False)
    tp = VariationalPDEProblem(tV, tV, tns._ns_form(tV, 40.0), tns._ns_bc(tV),
                               **F64)
    assert tp._block_size == 3 * (nx + 1) == jp._block_size
    rng = np.random.default_rng(nx)
    u = rng.standard_normal((2, tp.state_dim))
    m = np.zeros((2, tV.dim))
    ju, jm, tu, tm = jnp.asarray(u), jnp.asarray(m), torch.tensor(u), torch.tensor(m)
    want = jax.vmap(jp.bound.residual)(ju, jm)
    _close(tp.bound.residual(tu, tm), want, 1e-12)
    # the cell diameters reach the pressure stabilization: without them
    # the residual differs
    bare = VariationalPDEProblem(
        tV, tV, tns.VectorGalerkinForm(3, tp.form.flux, tp.form.source, 3,
                                       cell_coefficients={"h": 0 * tV.mesh.cell_diameters()}),
        tns._ns_bc(tV), **F64)
    assert np.abs(bare.bound.residual(tu, tm).numpy() - np.asarray(want)).max() > 1e-6
    bo = jp._band_order
    band_j = jax.vmap(lambda a, b: jp.bound.assemble_A_banded_ordered(a, b, None, bo))(
        ju, jm)
    band_t = tp.bound.assemble_A_banded_ordered(tu, tm, None, tp._band_order)
    assert band_t.shape == (2, bo.nb, bo.s, 3 * bo.s)
    _close(band_t, band_j, 1e-12)


@pytest.mark.parametrize("nx", [10, 16])
def test_steady_navier_stokes_matches_jax(nx):
    v_j, p_j, steps_j = _jax_solve(nx)
    v, p, info = tns.steady_navier_stokes(FunctionSpace(unit_square_mesh(nx)),
                                          **F64)
    assert info.history == steps_j
    assert all(ok for _, _, ok in info.history)
    assert bool(info.converged[0]) and int(info.iterations[0]) == steps_j[-1][1]
    assert v.shape == (v_j.shape[0], 2) and p.shape == p_j.shape
    _close(v, v_j, 1e-9)
    _close(p, p_j, 1e-9)


def test_unconverged_solve_raises():
    V = FunctionSpace(unit_square_mesh(6))
    with pytest.raises(RuntimeError, match="did not converge"):
        tns.steady_navier_stokes(V, continuation=(), newton_max_iter=1, **F64)


def test_confusion_velocity_kinds():
    V = FunctionSpace(unit_square_mesh(10))
    v_j, _, _ = _jax_solve(10)
    np.testing.assert_allclose(confusion_velocity(V, device="cpu"), v_j,
                               rtol=0, atol=1e-9 * np.abs(v_j).max())
    assert confusion_velocity(V, "analytic").shape == (V.dim, 2)
    with pytest.raises(ValueError, match="navier_stokes"):
        confusion_velocity(V, "stokes")


def test_default_confusion_observable_matches_jax():
    """The default confusion observable (Navier-Stokes velocity) on one
    forward solve at a prior-like draw of m."""
    jobs, _ = j_observable(nx=10)
    tobs, _ = t_observable(nx=10, **F64)
    m = 0.5 * np.random.default_rng(3).standard_normal((1, tobs.dM))
    u_t, info = tobs.problem.solve_fwd(torch.tensor(m))
    u_j, info_j = jobs.problem.solve_fwd(jnp.asarray(m[0]))
    assert bool(info.converged[0]) and bool(info_j.converged)
    assert int(info.iterations[0]) == int(info_j.iterations)
    _close(u_t[0], u_j, 1e-9)
    _close(tobs.B.apply(u_t)[0], jobs.B.apply(u_j), 1e-9)
