"""The vector form's dof-valued coefficients and any-degree parameter space
in the PyTorch port against the JAX package, float64 on the CPU, on the
same numpy inputs:

* a 2-component P2 state with a P2 parameter space, a nonlinear flux
  scaled by a P1 dof-valued coefficient (``coefficients``) and a source
  scaled by a per-cell constant (``cell_coefficients``), at nx=(6, 4):
  ``residual``, ``assemble_A``, the ordered band, ``assemble_A_diag``,
  ``apply_C`` and ``apply_Ct`` (vectors and blocks) to 1e-12 of the
  largest entry;
* the same with a P1 parameter space, and the coefficient's values at
  the points (its P1 interpolant);
* the helmholtz form at 600 Hz scaled by a P1 dof-valued coefficient, with
  a P2 parameter space, through ``VariationalPDEProblem``: the forward
  solve and J^T dq through the observable to 1e-10; with the coefficient
  all ones and m the P2 interpolant of a P1 field, its band equals the
  lane's own form's (P1 parameter) to rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu.fem as jfem
import hippyflow_tpu.models as jmodels
from applications.helmholtz import helmholtz_linear_observable as j_observable
from hippyflow_tpu.fem.band_order import structured_band_order as j_band_order
from hippyflow_tpu.fem.vector_assembly import (
    VectorBoundGalerkinForm as JVectorBound,
)
from hippyflow_tpu.fem.vector_assembly import VectorGalerkinForm as JVectorForm
from hippyflow_tpu_torch import fem as tfem
from hippyflow_tpu_torch import models as tmodels
from hippyflow_tpu_torch.applications.helmholtz import (
    helmholtz_linear_observable as t_observable,
)
from hippyflow_tpu_torch.fem.vector_assembly import (
    VectorBoundGalerkinForm,
    VectorGalerkinForm,
)

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
N = 3


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jvmap(f, *args):
    return np.asarray(jax.jit(jax.vmap(f))(*(jnp.asarray(a) for a in args)))


# the nonlinear form: flux a(x) e^m (1 + u_k^2) grad u_k, source
# h (m u_1, -m u_0) + m^2, with ``a`` P1 dof values and ``h`` per cell
def _jax_form(a, h):
    return JVectorForm(
        2,
        lambda x, u, gu, m, z, c: c["a"] * jnp.exp(m) * (1.0 + u[:, None] ** 2) * gu,
        lambda x, u, gu, m, z, c: c["h"] * m * jnp.stack([u[1], -u[0]]) + m * m,
        4, False, {"a": a}, {"h": h})


def _port_form(a, h):
    def flux(x, u, gu, m, z, c):
        return ((c["a"] * torch.exp(m))[..., None, None]
                * (1.0 + u * u)[..., None] * gu)

    def source(x, u, gu, m, z, c):
        return ((c["h"] * m)[..., None] * torch.stack([u[..., 1], -u[..., 0]], -1)
                + (m * m)[..., None])

    return VectorGalerkinForm(2, flux, source, 4, False, {"a": a}, {"h": h})


@functools.lru_cache(maxsize=None)
def _bound(m_degree):
    """Both packages' bound forms (P2 state, parameter of ``m_degree``) at
    nx=(6, 4), their band orders and the shared inputs."""
    jmesh, tmesh = jfem.unit_square_mesh(6, 4), tfem.unit_square_mesh(6, 4)
    jV, tV = jfem.FunctionSpace(jmesh, 2), tfem.FunctionSpace(tmesh, 2)
    jVm = jfem.FunctionSpace(jmesh, m_degree)
    tVm = tfem.FunctionSpace(tmesh, m_degree)
    rng = np.random.default_rng(m_degree)
    x = tmesh.vertices
    a = 1.0 + 0.5 * np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
    h = 1.0 + 0.1 * rng.standard_normal(tmesh.cells.shape[0])
    jb = JVectorBound(jV, jVm, _jax_form(a, h))
    tb = VectorBoundGalerkinForm(tV, tVm, _port_form(a, h), **F64)
    jbo, tbo = j_band_order(jV, ncomp=2), tfem.structured_band_order(tV, ncomp=2)
    jb.prepare_banded_ordered(jbo)
    u = 0.5 * rng.standard_normal((N, tb.n_total))
    m = 0.3 * rng.standard_normal((N, tVm.dim))
    return jb, tb, jbo, tbo, u, m, a


@pytest.mark.parametrize("m_degree", [1, 2])
@pytest.mark.parametrize("entry", ["residual", "assemble_A", "band", "diag"])
def test_vector_form_matches_jax(entry, m_degree):
    jb, tb, jbo, tbo, u, m, _ = _bound(m_degree)
    assert tb.n_m == tb.Vm.dim and tb._phi_m.shape[1] == tb.Vm.nd
    fns = {"residual": (lambda uu, mm: jb.residual(uu, mm), tb.residual),
           "assemble_A": (lambda uu, mm: jb.assemble_A(uu, mm), tb.assemble_A),
           "band": (lambda uu, mm: jb.assemble_A_banded_ordered(uu, mm, None, jbo),
                    lambda uu, mm: tb.assemble_A_banded_ordered(uu, mm, None, tbo)),
           "diag": (lambda uu, mm: jb.assemble_A_diag(uu, mm), tb.assemble_A_diag)}
    jfn, tfn = fns[entry]
    want = _jvmap(jfn, u, m)
    got = tfn(_t(u), _t(m))
    assert _rel(got, want) < 1e-12
    if entry == "assemble_A":
        assert _rel(tb.assemble_A_diag(_t(u), _t(m)),
                    np.diagonal(want, axis1=1, axis2=2)) < 1e-12


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("m_degree", [1, 2])
def test_vector_apply_C_and_Ct_match_jax(m_degree, k):
    jb, tb, _, _, u, m, _ = _bound(m_degree)
    rng = np.random.default_rng(10 + m_degree)
    tail = () if k is None else (k,)
    dm = rng.standard_normal((N, tb.n_m) + tail)
    dp = rng.standard_normal((N, tb.n_total) + tail)

    def cols(fn):
        if k is None:
            return fn
        return lambda uu, mm, xx: jax.vmap(lambda c: fn(uu, mm, c), in_axes=1,
                                           out_axes=1)(xx)

    want_c = _jvmap(cols(jb.apply_C), u, m, dm)
    want_ct = _jvmap(cols(jb.apply_Ct), u, m, dp)
    assert _rel(tb.apply_C(_t(u), _t(m), _t(dm)), want_c) < 1e-12
    assert _rel(tb.apply_Ct(_t(u), _t(m), _t(dp)), want_ct) < 1e-12


def test_prolong_p1_to_p2_is_exact():
    """The P2 interpolant of a P1 field holds a linear function at every
    P2 dof (blocks too), and P2 evaluation at the points is P1's."""
    mesh = tfem.unit_square_mesh(5, 3)
    V1, V2 = tfem.FunctionSpace(mesh), tfem.FunctionSpace(mesh, 2)
    lin = lambda x: 1.0 + 2.0 * x[:, 0] - 3.0 * x[:, 1]
    x1 = _t(np.stack([lin(V1.dof_coords), 2 * lin(V1.dof_coords)], -1))[None]
    got = tfem.prolong_p1_to_p2(x1, V1, V2)
    want = np.stack([lin(V2.dof_coords), 2 * lin(V2.dof_coords)], -1)[None]
    assert _rel(got, want) < 1e-14
    m1 = np.random.default_rng(7).standard_normal((2, V1.dim))
    m2 = tfem.prolong_p1_to_p2(_t(m1), V1, V2).numpy()
    pts = np.array([[0.13, 0.41], [0.77, 0.29], [0.5, 0.9]])
    B1 = tfem.assemble_pointwise_observation(V1, pts)
    B2 = tfem.assemble_pointwise_observation(V2, pts)
    assert _rel(m2 @ B2.T, m1 @ B1.T) < 1e-14
    with pytest.raises(ValueError):
        tfem.prolong_p1_to_p2(_t(m1), V2, V1)


def test_vector_coefficients_are_their_p1_interpolant():
    """A flux of the coefficient alone integrates it: with F = (a, 0) per
    component and a = 1 + 2x - y (P1 exactly), r_k = int a dv_k/dx,
    equal to the same form with a written in x."""
    tV = tfem.FunctionSpace(tfem.unit_square_mesh(5, 3), 2)
    x = tV.mesh.vertices
    a = 1.0 + 2.0 * x[:, 0] - x[:, 1]

    def flux_c(x, u, gu, m, z, c):
        e = torch.zeros_like(gu)
        e[..., 0] = c["a"][..., None]
        return e

    def flux_x(x, u, gu, m, z, c):
        e = torch.zeros_like(gu)
        e[..., 0] = (1.0 + 2.0 * x[..., 0] - x[..., 1])[..., None]
        return e

    u = torch.zeros((2, 2 * tV.dim), **F64)
    m = torch.zeros((2, tV.mesh.num_vertices), **F64)
    V1 = tfem.FunctionSpace(tV.mesh)
    got = VectorBoundGalerkinForm(
        tV, V1, VectorGalerkinForm(2, flux_c, coefficients={"a": a}),
        **F64).residual(u, m)
    want = VectorBoundGalerkinForm(
        tV, V1, VectorGalerkinForm(2, flux_x), **F64).residual(u, m)
    assert float(want.abs().max()) > 0.1
    assert _rel(got, want) < 1e-12


# -- the helmholtz form with a coefficient and a P2 parameter space -----------

NX, FREQ = 8, 600.0


def _scaled(base, lib):
    """The helmholtz form's flux and source scaled by the P1 coefficient
    ``a``: pointwise for JAX, on whole tensors for the port."""
    if lib == "jax":
        return (lambda x, u, gu, m, z, c: c["a"] * base.flux(x, u, gu, m, z, c),
                lambda x, u, gu, m, z, c: c["a"] * base.source(x, u, gu, m, z, c))
    return (lambda x, u, gu, m, z, c:
            c["a"][..., None, None] * base.flux(x, u, gu, m, z, c),
            lambda x, u, gu, m, z, c:
            c["a"][..., None] * base.source(x, u, gu, m, z, c))


@functools.lru_cache(maxsize=None)
def _helmholtz(ones=False):
    """(JAX problem, port problem, the lane's own port problem, m (P2), the
    P1 field it interpolates): the lane's mesh, state, rhs and targets,
    a P2 parameter space and the coefficient ``a`` (all ones with
    ``ones``)."""
    jobs, _ = j_observable(nx=NX, frequency=FREQ)
    tobs, tVh = t_observable(nx=NX, frequency=FREQ, **F64)
    jp, tp = jobs.problem, tobs.problem
    x = tVh.mesh.vertices
    a = np.ones(len(x)) if ones else 1.0 + 0.3 * np.sin(x[:, 0]) * np.cos(x[:, 1])
    jbase, tbase = jp.form, tp.form
    jform = JVectorForm(2, *_scaled(jbase, "jax"), 4, False, {"a": a})
    tform = VectorGalerkinForm(2, *_scaled(tbase, "torch"), 4, False, {"a": a})
    jVm = jfem.FunctionSpace(jp.Vu.mesh, 2)
    tVm = tfem.FunctionSpace(tp.Vu.mesh, 2)
    rhs = np.asarray(tp.rhs_vector)
    jpde = jmodels.VariationalPDEProblem(
        jp.Vu, jVm, jform, jp.bc, True, rhs_vector=jnp.asarray(rhs),
        operator_symmetric=True)
    tpde = tmodels.VariationalPDEProblem(
        tp.Vu, tVm, tform, tp.bc, True, rhs_vector=rhs, operator_symmetric=True,
        **F64)
    rng = np.random.default_rng(3)
    m1 = 0.2 * np.sin(x[:, 0])[None] + 0.05 * rng.standard_normal((2, len(x)))
    m2 = tfem.prolong_p1_to_p2(_t(m1), tp.Vm, tVm).numpy()
    return jobs, tobs, jpde, tpde, m2, m1


def test_helmholtz_p2_parameter_jt_matches_jax():
    """The forward solve and J^T dq (dq blocks of 2) through the lane's
    observation of both components, to 1e-10 of the largest entry."""
    jobs, tobs, jpde, tpde, m, _ = _helmholtz()
    assert tpde.Vm.degree == 2 and tpde.bound.n_m == tpde.Vm.dim
    ju = np.asarray(jax.jit(jax.vmap(lambda mm: jpde.solve_fwd(mm)[0]))(
        jnp.asarray(m)))
    tu, info = tpde.solve_fwd(_t(m))
    assert bool(info.converged.all())
    assert _rel(tu, ju) < 1e-10
    jB = jobs.B
    tB = tobs.B
    jo = jmodels.LinearStateObservable(jpde, jB)
    to = tmodels.LinearStateObservable(tpde, tB)
    dq = np.random.default_rng(4).standard_normal((2, to.dQ, 2))
    JJ = jmodels.ObservableJacobian(jo)
    want = jax.jit(jax.vmap(lambda mm, uu, d: JJ.transpmult(
        jpde.linearize(uu, mm), d)))(jnp.asarray(m), jnp.asarray(ju),
                                     jnp.asarray(dq))
    J = tmodels.ObservableJacobian(to)
    lin = tpde.linearize(tu, _t(m), needs="adj")
    got = J.transpmult(lin, _t(dq))
    assert got.shape == (2, tpde.Vm.dim, 2)
    assert _rel(got, want) < 1e-10
    assert _rel(got, torch.einsum("nqm,nqk->nmk", J.materialize(lin), _t(dq))) < 1e-10


def test_helmholtz_unit_coefficient_band_is_the_lanes():
    """With a = 1 and m the P2 interpolant of a P1 field, the form's band
    and residual are the lane's own (P1 parameter) to rounding."""
    _, tobs, _, tpde, m2, m1 = _helmholtz(ones=True)
    lane = tobs.problem
    u = _t(np.random.default_rng(5).standard_normal((2, lane.state_dim)))
    bo = lane._band_order
    got = tpde.bound.assemble_A_banded_ordered(u, _t(m2), None, bo)
    want = lane.bound.assemble_A_banded_ordered(u, _t(m1), None, bo)
    assert _rel(got, want) < 1e-13
    assert _rel(tpde.bound.residual(u, _t(m2)),
                lane.bound.residual(u, _t(m1))) < 1e-13
