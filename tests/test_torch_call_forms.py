"""The JAX package's positional call forms on the PyTorch port, float64 on
the CPU, against the JAX package on the same numpy inputs:

* ``assemble_A_banded_ordered(u, m, None, border)`` of a scalar P2 form
  and of the helmholtz vector form at nx=8: 1e-12; without a border it
  raises ``TypeError``;
* ``Linearization(u, m, z, factor)`` built and unpacked positionally,
  through C and Cz: 1e-12;
* ``GalerkinForm(flux, source, quad_degree, symmetric, coefficients,
  cell_coefficients)`` and ``VectorGalerkinForm(ncomp, ...)`` built
  positionally: the same fields as the JAX forms and residuals to 1e-12;
* a positional ``VariationalPDEProblem`` (through ``solver``) solved with
  Newton: 1e-10 and the same iterations; ``IterativeFactor``, the
  projectors and ``BiLaplacianPrior(..., robin_bc)`` bind positionally as
  in JAX;
* ``ObservableControlJacobian.mult(lin, dz=...)``: 1e-12;
* each parameter of the JAX package that the port leaves out, passed by
  position (and by name), raises ``TypeError``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu as hf
import hippyflow_tpu.fem as jfem
import hippyflow_tpu.models as jmodels
from hippyflow_tpu import testing as jt
from hippyflow_tpu.fem.band_order import structured_band_order as j_band_order
from hippyflow_tpu.fem.vector_assembly import (
    VectorBoundGalerkinForm as JVectorBound,
)
from hippyflow_tpu.fem.vector_assembly import VectorGalerkinForm as JVectorForm
import hippyflow_tpu_torch as hft
from hippyflow_tpu_torch import fem as tfem
from hippyflow_tpu_torch import models as tmodels
from hippyflow_tpu_torch import testing as tt
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
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(f))(*(jnp.asarray(a) for a in args)))


# -- assemble_A_banded_ordered(u, m, None, border) ------------------------------

def _p2_bound():
    """A nonlinear scalar P2 form (P1 parameter) at nx=8 on both sides."""
    jmesh, tmesh = jfem.unit_square_mesh(8), tfem.unit_square_mesh(8)
    jform = jfem.GalerkinForm(lambda x, u, gu, m, z, c: jnp.exp(m) * gu,
                              lambda x, u, gu, m, z, c: u**3 - 1.0, 4)
    tform = tfem.GalerkinForm(
        lambda x, u, gu, m, z, c: torch.exp(m)[..., None] * gu,
        lambda x, u, gu, m, z, c: u**3 - 1.0, 4)
    jb = jfem.BoundGalerkinForm(jfem.FunctionSpace(jmesh, 2),
                                jfem.FunctionSpace(jmesh), jform)
    tb = tfem.BoundGalerkinForm(tfem.FunctionSpace(tmesh, 2),
                                tfem.FunctionSpace(tmesh), tform, **F64)
    jbo = j_band_order(jb.Vu)
    jb.prepare_banded_ordered(jbo)
    return jb, tb, jbo, tfem.structured_band_order(tb.Vu), tb.n, tb.n_m


@functools.lru_cache(maxsize=None)
def _helmholtz():
    from applications.helmholtz import helmholtz_linear_observable as jh
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable as th,
    )

    jobs, _ = jh(nx=8, frequency=600.0)
    tobs, _ = th(nx=8, frequency=600.0, **F64)
    return jobs, tobs


def _helmholtz_bound():
    jobs, tobs = _helmholtz()
    jp, tp = jobs.problem, tobs.problem
    return (jp.bound, tp.bound, jp._band_order, tp._band_order, tp.state_dim,
            tp.Vm.dim)


@pytest.mark.parametrize("case", ["scalar_p2", "vector_helmholtz"])
def test_assemble_A_banded_ordered_takes_jax_order(case):
    jb, tb, jbo, tbo, n, n_m = (_p2_bound if case == "scalar_p2"
                                else _helmholtz_bound)()
    rng = np.random.default_rng(0)
    u = 0.5 * rng.standard_normal((N, n))
    m = 0.3 * rng.standard_normal((N, n_m))
    want = _jvmap(lambda uu, mm: jb.assemble_A_banded_ordered(uu, mm, None, jbo),
                  u, m)
    got = tb.assemble_A_banded_ordered(_t(u), _t(m), None, tbo)
    assert got.shape == (N, tbo.nb, tbo.s, 3 * tbo.s)
    assert _rel(got, want) < 1e-12
    assert torch.equal(got, tb.assemble_A_banded_ordered(_t(u), _t(m),
                                                         border=tbo))
    with pytest.raises(TypeError, match="border"):
        tb.assemble_A_banded_ordered(_t(u), _t(m))


# -- Linearization, GalerkinForm, VectorGalerkinForm --------------------------------

@functools.lru_cache(maxsize=None)
def _control():
    """The nonlinear Poisson control problem at nx=8 on both sides (JAX
    observable, port observable) and a solved point (u, m, z), numpy."""
    st = jt.poisson_control_settings()
    st["nx"] = st["ny"] = 8
    st["LINEAR"] = False
    jpde, jpr, _, jV = jt.setup_poisson_control_problem(st)
    tpde, _, _, tV = tt.setup_poisson_control_problem(st, **F64)
    jobs = jt.poisson_pointwise_observable(jpde, jV, 10)
    tobs = tt.poisson_pointwise_observable(tpde, tV, 10)
    rng = np.random.default_rng(1)
    m = np.asarray(jax.vmap(jpr.sample)(
        jnp.asarray(rng.standard_normal((N, jpr.noise_dim)))))
    z = rng.uniform(-1.0, 1.0, (N, tpde.control_dim))
    u, info = tpde.solve_fwd(_t(m), _t(z))
    assert bool(info.converged.all())
    return jobs, tobs, u.numpy(), m, z


def test_linearization_is_built_and_unpacked_in_jax_order():
    jobs, tobs, u, m, z = _control()
    lin = tmodels.Linearization(_t(u), _t(m), _t(z), None)
    assert tmodels.Linearization._fields == jmodels.Linearization._fields
    uu, mm, zz, factor = lin
    assert torch.equal(zz, _t(z)) and factor is None and torch.equal(mm, _t(m))
    rng = np.random.default_rng(2)
    dm = rng.standard_normal((N, tobs.dM))
    dz = rng.standard_normal((N, tobs.problem.control_dim))
    jp = jobs.problem
    JLin = jmodels.Linearization
    want = _jvmap(lambda a, b, c, d: jp.apply_C(JLin(a, b, c, None), d),
                  u, m, z, dm)
    assert _rel(tobs.problem.apply_C(lin, _t(dm)), want) < 1e-12
    want = _jvmap(lambda a, b, c, d: jp.apply_Cz(JLin(a, b, c, None), d),
                  u, m, z, dz)
    assert _rel(tobs.problem.apply_Cz(lin, _t(dz)), want) < 1e-12
    # linearize fills the same fields
    full = tobs.problem.linearize(_t(u), _t(m), _t(z))
    assert torch.equal(full[2], _t(z)) and full[3] is full.factor


def test_galerkin_form_fields_bind_in_jax_order():
    """GalerkinForm(f, s, 4, True) is symmetric with no coefficients on
    both sides; with coefficients and per-cell constants by position the
    residual is JAX's."""
    f = lambda x, u, gu, m, z, c: gu
    s = lambda x, u, gu, m, z, c: u
    for form in (jfem.GalerkinForm(f, s, 4, True), tfem.GalerkinForm(f, s, 4, True)):
        assert form.symmetric is True and dict(form.coefficients) == {}
        assert form.quad_degree == 4 and dict(form.cell_coefficients) == {}
    jmesh, tmesh = jfem.unit_square_mesh(6, 5), tfem.unit_square_mesh(6, 5)
    x = tmesh.vertices
    a = 1.0 + x[:, 0] * x[:, 1]
    h = 1.0 + 0.1 * np.arange(tmesh.cells.shape[0]) / tmesh.cells.shape[0]
    jform = jfem.GalerkinForm(
        lambda x, u, gu, m, z, c: c["a"] * jnp.exp(m) * gu,
        lambda x, u, gu, m, z, c: c["h"] * u**3 - m, 2, False, {"a": a},
        {"h": h})
    tform = tfem.GalerkinForm(
        lambda x, u, gu, m, z, c: (c["a"] * torch.exp(m))[..., None] * gu,
        lambda x, u, gu, m, z, c: c["h"] * u**3 - m, 2, False, {"a": a},
        {"h": h})
    jV, tV = jfem.FunctionSpace(jmesh), tfem.FunctionSpace(tmesh)
    jb = jfem.BoundGalerkinForm(jV, jV, jform)
    tb = tfem.BoundGalerkinForm(tV, tV, tform, **F64)
    rng = np.random.default_rng(3)
    u, m = rng.standard_normal((2, N, tV.dim))
    want = _jvmap(jb.residual, u, m)
    assert _rel(tb.residual(_t(u), _t(m)), want) < 1e-12


def test_vector_galerkin_form_fields_bind_in_jax_order():
    """VectorGalerkinForm(2, f, s, 4, False, coefficients) on both sides:
    the same fields, and the helmholtz residual scaled by the coefficient
    is JAX's."""
    jobs, tobs = _helmholtz()
    jbase, tbase = jobs.problem.form, tobs.problem.form
    x = tobs.problem.Vu.mesh.vertices
    a = 1.0 + 0.2 * np.cos(x[:, 0])
    jform = JVectorForm(
        2, lambda x, u, gu, m, z, c: c["a"] * jbase.flux(x, u, gu, m, z, c),
        lambda x, u, gu, m, z, c: c["a"] * jbase.source(x, u, gu, m, z, c),
        4, False, {"a": a})
    tform = VectorGalerkinForm(
        2, lambda x, u, gu, m, z, c: c["a"][..., None, None]
        * tbase.flux(x, u, gu, m, z, c),
        lambda x, u, gu, m, z, c: c["a"][..., None]
        * tbase.source(x, u, gu, m, z, c), 4, False, {"a": a})
    for form in (jform, tform):
        assert (form.ncomp, form.quad_degree, form.symmetric) == (2, 4, False)
        assert list(form.coefficients) == ["a"] and not form.cell_coefficients
    jp, tp = jobs.problem, tobs.problem
    jb = JVectorBound(jp.Vu, jp.Vm, jform)
    tb = VectorBoundGalerkinForm(tp.Vu, tp.Vm, tform, **F64)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((N, tp.state_dim))
    m = 0.3 * rng.standard_normal((N, tp.Vm.dim))
    assert _rel(tb.residual(_t(u), _t(m)), _jvmap(jb.residual, u, m)) < 1e-12


# -- problems, factors, projectors and priors --------------------------------------

def _nonlinear_problems(stale):
    """A nonlinear P1 problem, every parameter through ``solver`` by
    position: JAX's and the port's."""
    jV = jfem.FunctionSpace(jfem.unit_square_mesh(8))
    tV = tfem.FunctionSpace(tfem.unit_square_mesh(8))
    jform = jfem.GalerkinForm(lambda x, u, gu, m, z, c: jnp.exp(m) * gu,
                              lambda x, u, gu, m, z, c: u**3 - 10.0)
    tform = tfem.GalerkinForm(
        lambda x, u, gu, m, z, c: torch.exp(m)[..., None] * gu,
        lambda x, u, gu, m, z, c: u**3 - 10.0)
    jbc = jfem.DirichletBC.from_predicate(jV, None, 0.0)
    tbc = tfem.DirichletBC.from_predicate(tV, None, 0.0)
    args = (False, None, 1e-9, 1e-12, 25, 8, stale, None, "auto")
    return (jmodels.VariationalPDEProblem(jV, jV, jform, jbc, *args),
            tmodels.VariationalPDEProblem(tV, tV, tform, tbc, *args, **F64),
            tV)


@pytest.mark.parametrize("stale", [1, 2])
def test_positional_variational_problem_solves_as_jax(stale):
    jpde, tpde, tV = _nonlinear_problems(stale)
    assert (tpde.is_fwd_linear, tpde.control_dim, tpde.newton_stale_factor,
            tpde.solver, tpde.rhs_vector) == (False, None, stale, "auto", None)
    x = tV.dof_coords
    m = np.stack([0.3 * np.sin(3 * x[:, 0]), 0.5 * x[:, 1] - 0.2])
    ju, jinfo = _jvmap(jpde.solve_fwd, m)
    tu, tinfo = tpde.solve_fwd(_t(m))
    assert bool(tinfo.converged.all())
    assert _rel(tu, ju) < 1e-10
    np.testing.assert_array_equal(tinfo.iterations.numpy(), jinfo.iterations)
    assert int(tinfo.iterations.min()) >= 2


def test_iterative_factor_binds_in_jax_order():
    """IterativeFactor(u, m, z, diag, problem, tol, maxiter) solves as the
    factor the problem's iterative solver builds."""
    _, tpde, tV = _nonlinear_problems(1)
    tpde = tmodels.VariationalPDEProblem(
        tpde.Vu, tpde.Vm, tpde.form, tpde.bc, solver="iterative", **F64)
    rng = np.random.default_rng(5)
    u, m, b = (_t(0.3 * rng.standard_normal((2, tV.dim))) for _ in range(3))
    lin = tpde.linearize(u, m)
    f = lin.factor
    again = tmodels.IterativeFactor(u, m, None, f.diag, tpde, f.tol, f.maxiter)
    assert (again.problem, again.tol, again.maxiter) == (tpde, 1e-10, 1000)
    assert torch.equal(again.solve(b), f.solve(b))


def test_projectors_and_priors_bind_in_jax_order():
    """(observable, prior, control_distribution, collective, parameters),
    (prior, collective, parameters), and robin_bc as the eighth argument
    of the BiLaplacian prior (its K against JAX's at 1e-12)."""
    _, tobs, _, _, _ = _control()
    tV = tobs.problem.Vm
    prior = hft.BiLaplacianPrior(tV, 0.1, 1.0, **F64)
    p = tmodels.ActiveSubspaceParameterList()
    proj = tmodels.ActiveSubspaceProjector(tobs, prior, None, None, p)
    assert proj.parameters is p and proj.control_distribution is None
    p = tmodels.PODParameterList()
    proj = tmodels.PODProjector(tobs, prior, None, None, p)
    assert proj.parameters is p
    p = tmodels.KLEParameterList()
    assert tmodels.KLEProjector(prior, None, p).parameters is p
    jV = jfem.FunctionSpace(jfem.unit_square_mesh(6))
    tV = tfem.FunctionSpace(tfem.unit_square_mesh(6))
    args = (0.1, 1.0, 2.0, 0.5, math.pi / 4, None, True)
    want = hf.BiLaplacianPrior(jV, *args)
    got = hft.BiLaplacianPrior(tV, *args, torch.float64, "cpu")
    assert _rel(got.K, want.K) < 1e-12
    xi = np.random.default_rng(6).standard_normal((2, got.noise_dim))
    assert _rel(got.sample(_t(xi)), want.sample(jnp.asarray(xi))) < 1e-12
    structured = hft.StructuredBiLaplacianPrior(tV, *args, torch.float64,
                                                device="cpu")
    by_name = hft.StructuredBiLaplacianPrior(tV, 0.1, 1.0, robin_bc=True, **F64)
    assert torch.equal(structured.sample(_t(xi)), by_name.sample(_t(xi)))


def test_control_jacobian_mult_takes_dz():
    jobs, tobs, u, m, z = _control()
    rng = np.random.default_rng(7)
    dz = rng.standard_normal((N, tobs.problem.control_dim, 2))
    JJ = jmodels.ObservableControlJacobian(jobs)
    want = _jvmap(lambda a, b, c, d: jax.vmap(
        lambda col: JJ.mult(jobs.problem.linearize(a, b, c), dz=col),
        in_axes=1, out_axes=1)(d), u, m, z, dz)
    Jz = tmodels.ObservableControlJacobian(tobs)
    lin = tobs.problem.linearize(_t(u), _t(m), _t(z))
    got = Jz.mult(lin, dz=_t(dz))
    assert _rel(got, want) < 1e-12
    assert torch.equal(got, Jz.mult(lin, _t(dz)))


# -- the JAX parameters the port leaves out ----------------------------------------

def _calls():
    """(JAX call form, port call with every argument through the left-out
    one by position): each binds before any work."""
    from hippyflow_tpu_torch.fem import coarse_newton_warm_start
    from hippyflow_tpu_torch.models.sampling import (
        SampleBatch,
        materialize_jacobians,
        sample_and_materialize_symmetric,
        sample_until_solved,
    )

    x = object()
    return {
        "StructuredBiLaplacianPrior(materialize)": lambda: (
            hft.StructuredBiLaplacianPrior(x, 0.1, 1.0, 2.0, 0.5, 0.7, None,
                                           False, torch.float64, False)),
        "sample_until_solved(prefetch_host)": lambda: sample_until_solved(
            x, x, x, 4, None, None, 10, False, None, False, True),
        "sample_and_materialize_symmetric(precompile_only)": lambda: (
            sample_and_materialize_symmetric(x, x, x, 4, None, 10, 1, False,
                                             True)),
        "materialize_jacobians(precompile_only)": lambda: materialize_jacobians(
            x, x, x, None, None, False, True),
        "coarse_newton_warm_start(split)": lambda: coarse_newton_warm_start(
            x, x, x, x, None, True),
        "SampleBatch.host_chunks": lambda: SampleBatch(x, x, x, None, 0, None,
                                                       []),
    }


@pytest.mark.parametrize("form", sorted(_calls()))
def test_a_left_out_parameter_by_position_raises(form):
    with pytest.raises(TypeError, match="positional argument"):
        _calls()[form]()


@pytest.mark.parametrize("name", ["materialize", "prefetch_host",
                                  "precompile_only"])
def test_a_left_out_parameter_by_name_raises_naming_it(name):
    from hippyflow_tpu_torch.models.sampling import (
        sample_and_materialize_symmetric,
        sample_until_solved,
    )

    fn = {"materialize": hft.StructuredBiLaplacianPrior,
          "prefetch_host": sample_until_solved,
          "precompile_only": sample_and_materialize_symmetric}[name]
    with pytest.raises(TypeError, match=name):
        fn(None, None, None, 4, **{name: True})
