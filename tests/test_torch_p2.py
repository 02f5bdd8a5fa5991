"""Scalar P2 states in the PyTorch port against the JAX package, float64
on the CPU, on the JAX package's own P2 fixtures (``tests/test_p2.py``,
``tests/test_band_order.py``), with the same numpy inputs:

* the P2 mass and stiffness matrices at nx=8: 1e-12;
* every ``BoundGalerkinForm`` entry point with a P2 state and a P1
  parameter (the flux exp(m) grad u, the source u^3 - 1 and a control
  term) and the ordered band at nx=(9, 7): 1e-12;
* the nonlinear problem's forward solve, incremental forward and adjoint
  solves and the observable's Jacobian and its transpose: 1e-10, with the
  same Newton iterations;
* every solver choice of the port against the JAX package's ``auto``:
  1e-10 (``iterative`` 1e-8);
* the Poisson problem whose solution x^2 P2 holds exactly, at nx=8: 1e-9;
* the float64 input active subspace at nx=8 from the same samples and
  probe: 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu.fem as jfem
import hippyflow_tpu.fem.band_order as jband_order
import hippyflow_tpu.models as jmodels
from hippyflow_tpu_torch import fem as tfem
from hippyflow_tpu_torch import models as tmodels

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
N = 3
DZ = 2


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _spaces(pkg, nx, ny=None):
    mesh = pkg.unit_square_mesh(nx, ny) if ny else pkg.unit_square_mesh(nx)
    return pkg.FunctionSpace(mesh, degree=2), pkg.FunctionSpace(mesh)


# the fixture's form, pointwise for JAX and on whole tensors for the port;
# "control" adds z_0 x + z_1 y to the source, "parameter" is the source m
def _jax_form(kind):
    if kind == "parameter":
        return jfem.GalerkinForm(source=lambda x, u, gu, m, z, c: m,
                                 quad_degree=4)
    ctrl = (lambda x, z: z[0] * x[0] + z[1] * x[1]) if kind == "control" else (
        lambda x, z: 0.0)
    return jfem.GalerkinForm(
        flux=lambda x, u, gu, m, z, c: jnp.exp(m) * gu,
        source=lambda x, u, gu, m, z, c: u**3 - 1.0 - ctrl(x, z),
        quad_degree=4)


def _port_form(kind):
    if kind == "parameter":
        return tfem.GalerkinForm(source=lambda x, u, gu, m, z, c: m,
                                 quad_degree=4)

    def ctrl(x, z):
        if kind != "control":
            return 0.0
        return z[:, 0, None, None] * x[..., 0] + z[:, 1, None, None] * x[..., 1]

    return tfem.GalerkinForm(
        flux=lambda x, u, gu, m, z, c: torch.exp(m)[..., None] * gu,
        source=lambda x, u, gu, m, z, c: u**3 - 1.0 - ctrl(x, z),
        quad_degree=4)


@functools.lru_cache(maxsize=None)
def _bound(kind):
    """Both packages' bound forms at nx=(9, 7) and the shared inputs."""
    jV2, jV1 = _spaces(jfem, 9, 7)
    tV2, tV1 = _spaces(tfem, 9, 7)
    jb = jfem.BoundGalerkinForm(jV2, jV1, _jax_form(kind))
    tb = tfem.BoundGalerkinForm(tV2, tV1, _port_form(kind), **F64)
    rng = np.random.default_rng(0)
    u = 0.5 * rng.standard_normal((N, tV2.dim))
    m = 0.3 * rng.standard_normal((N, tV1.dim))
    z = rng.standard_normal((N, DZ))
    return jb, tb, u, m, z


def _jax_batch(fn, *arrays):
    return np.asarray(jax.vmap(fn)(*(jnp.asarray(a) for a in arrays)))


def test_p2_mass_and_stiffness():
    jV2, _ = _spaces(jfem, 8)
    tV2, _ = _spaces(tfem, 8)
    theta = np.array([[2.0, 0.3], [0.3, 0.5]])
    for want, got in (
            (jfem.mass_matrix(jV2), tfem.mass_matrix(tV2, **F64)),
            (jfem.stiffness_matrix(jV2), tfem.stiffness_matrix(tV2, **F64)),
            (jfem.stiffness_matrix(jV2, theta),
             tfem.stiffness_matrix(tV2, theta, **F64))):
        assert got.shape == (tV2.dim, tV2.dim)
        assert _rel(got, want) < 1e-12
    # partition of unity: the total mass is the area
    assert abs(float(tfem.mass_matrix(tV2, **F64).sum()) - 1.0) < 1e-12


@pytest.mark.parametrize("kind", ["nonlinear", "parameter"])
def test_p2_residual_evaluates_the_parameter_with_its_own_basis(kind):
    """The residual; with the source m it is the mixed P2 x P1 mass matrix
    applied to m, so the parameter's values at the points are JAX's."""
    jb, tb, u, m, _ = _bound(kind)
    want = _jax_batch(lambda uu, mm: jb.residual(uu, mm), u, m)
    got = tb.residual(_t(u), _t(m))
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("entry", ["assemble_A", "assemble_C", "assemble_Cz",
                                   "assemble_A_diag"])
def test_p2_assembly_entry_points(entry):
    jb, tb, u, m, z = _bound("control")
    if entry == "assemble_A_diag":
        want = _jax_batch(lambda uu, mm, zz: jb.assemble_A_diag(uu, mm, zz),
                          u, m, z)
    else:
        want = _jax_batch(lambda uu, mm, zz: getattr(jb, entry)(uu, mm, zz),
                          u, m, z)
    got = getattr(tb, entry)(_t(u), _t(m), _t(z))
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("entry", ["apply_C", "apply_Ct", "apply_Cz",
                                   "apply_Czt"])
@pytest.mark.parametrize("cols", [None, 3])
def test_p2_products(entry, cols):
    jb, tb, u, m, z = _bound("control")
    rng = np.random.default_rng(1)
    size = {"apply_C": tb.n_m, "apply_Ct": tb.n, "apply_Cz": DZ,
            "apply_Czt": tb.n}[entry]
    x = rng.standard_normal((N, size) + (() if cols is None else (cols,)))

    def one(uu, mm, zz, xx):
        if entry == "apply_Cz":  # the JAX form has no apply_Cz: C_z dz
            return jb.assemble_Cz(uu, mm, zz) @ xx
        if entry == "apply_Czt":
            return jb.assemble_Cz(uu, mm, zz).T @ xx
        fn = jb.apply_C if entry == "apply_C" else jb.apply_Ct
        if cols is None:
            return fn(uu, mm, xx, zz)
        return jax.vmap(lambda c: fn(uu, mm, c, zz), in_axes=1, out_axes=1)(xx)

    want = _jax_batch(one, u, m, z, x)
    args = (_t(u), _t(m), _t(z), _t(x)) if entry in ("apply_Cz", "apply_Czt") \
        else (_t(u), _t(m), _t(x), _t(z))
    got = getattr(tb, entry)(*args)
    assert _rel(got, want) < 1e-12


def test_p2_ordered_band():
    jb, tb, u, m, z = _bound("control")
    jborder = jband_order.structured_band_order(jb.Vu)
    tborder = tfem.structured_band_order(tb.Vu)
    assert (tborder.s, tborder.nb) == (jborder.s, jborder.nb) == (2 * 19, 8)
    jb.prepare_banded_ordered(jborder)
    want = _jax_batch(
        lambda uu, mm, zz: jb.assemble_A_banded_ordered(uu, mm, zz, jborder),
        u, m, z)
    got = tb.assemble_A_banded_ordered(_t(u), _t(m), _t(z), tborder)
    assert got.shape == (N, 8, 38, 114)
    assert _rel(got, want) < 1e-12


# -- the nonlinear P2 problem ---------------------------------------------------

TARGETS = np.array([[0.3, 0.4], [0.62, 0.55], [0.81, 0.2]])


@functools.lru_cache(maxsize=None)
def _problems(solver="auto"):
    """(JAX pde and observable, port pde and observable, m) on the
    fixture of ``test_band_order.py`` at nx=(9, 7)."""
    jV2, jV1 = _spaces(jfem, 9, 7)
    tV2, tV1 = _spaces(tfem, 9, 7)
    jbc = jfem.DirichletBC.from_predicate(jV2, None, 0.0)
    tbc = tfem.DirichletBC.from_predicate(tV2, None, 0.0)
    jpde = jmodels.VariationalPDEProblem(jV2, jV1, _jax_form("nonlinear"), jbc)
    tpde = tmodels.VariationalPDEProblem(tV2, tV1, _port_form("nonlinear"),
                                         tbc, solver=solver, **F64)
    jobs = jmodels.LinearStateObservable(
        jpde, jmodels.PointwiseObservation(jV2, TARGETS))
    tobs = tmodels.LinearStateObservable(
        tpde, tmodels.PointwiseObservation(tV2, TARGETS, **F64))
    x = tV1.dof_coords
    m = np.stack([0.3 * np.sin(3 * x[:, 0]), 0.5 * np.cos(2 * x[:, 1]),
                  0.2 * x[:, 0] * x[:, 1]])
    return jpde, jobs, tpde, tobs, m


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's auto solve: u, iterations, incremental solves of a shared rhs
    and the dense Jacobian of the observable."""
    jpde, jobs, _, _, m = _problems()
    rhs = np.random.default_rng(2).standard_normal((N, jpde.state_dim, 3))

    def one(mm, bb):
        u, info = jpde.solve_fwd(mm)
        lin = jpde.linearize(u, mm)
        J = jmodels.ObservableJacobian(jobs).materialize(lin)
        return (u, info.iterations, jpde.solve_incremental(lin, bb),
                jpde.solve_incremental(lin, bb, is_adj=True), J)

    out = jax.jit(jax.vmap(one))(jnp.asarray(m), jnp.asarray(rhs))
    return rhs, tuple(np.asarray(a) for a in out)


def test_p2_forward_incremental_and_jacobian():
    _, _, tpde, tobs, m = _problems()
    rhs, (u_j, it_j, du_j, dp_j, J_j) = _jax_reference()
    assert tpde._band_order is not None and tpde.fwd_solver == "thomas_inv"
    u, info = tpde.solve_fwd(_t(m))
    assert bool(info.converged.all())
    np.testing.assert_array_equal(info.iterations.numpy(), it_j)
    assert _rel(u, u_j) < 1e-10
    lin = tpde.linearize(u, _t(m))
    assert _rel(tpde.solve_incremental(lin, _t(rhs)), du_j) < 1e-10
    assert _rel(tpde.solve_incremental(lin, _t(rhs), is_adj=True), dp_j) < 1e-10
    jac = tmodels.ObservableJacobian(tobs)
    J = jac.materialize(lin)
    assert _rel(J, J_j) < 1e-10
    # J and J^T through apply_C and apply_Ct with the two dofmaps
    rng = np.random.default_rng(3)
    dm = _t(rng.standard_normal((N, tpde.Vm.dim)))
    dq = _t(rng.standard_normal((N, len(TARGETS))))
    assert _rel(jac.mult(lin, dm), torch.einsum("nqm,nm->nq", J, dm)) < 1e-10
    assert _rel(jac.transpmult(lin, dq), torch.einsum("nqm,nq->nm", J, dq)) < 1e-10


@pytest.mark.parametrize("solver", ["auto", "dense", "thomas_inv",
                                    "block_tridiag", "block_cyclic",
                                    "iterative"])
def test_p2_every_solver_choice(solver):
    _, _, tpde, _, m = _problems(solver)
    rhs, (u_j, it_j, du_j, dp_j, _) = _jax_reference()
    tol = 1e-8 if solver == "iterative" else 1e-10
    u, info = tpde.solve_fwd(_t(m))
    assert bool(info.converged.all())
    np.testing.assert_array_equal(info.iterations.numpy(), it_j)
    assert _rel(u, u_j) < tol
    lin = tpde.linearize(u, _t(m))
    assert _rel(tpde.solve_incremental(lin, _t(rhs)), du_j) < tol
    assert _rel(tpde.solve_incremental(lin, _t(rhs), is_adj=True), dp_j) < tol


@pytest.mark.parametrize("solver", ["auto", "dense"])
def test_p2_exact_for_a_quadratic_solution(solver):
    """-Laplace(u) = -2 with u = x^2 on the boundary: P2 holds x^2
    exactly, so the solve returns it to roundoff; the linear path's lift
    of the inhomogeneous values goes through the ordered band's mask."""
    tV2, tV1 = _spaces(tfem, 8)
    jV2, jV1 = _spaces(jfem, 8)
    u_exact = lambda x: x[:, 0] ** 2
    tpde = tmodels.VariationalPDEProblem(
        tV2, tV1, tfem.GalerkinForm(flux=lambda x, u, gu, m, z, c: gu,
                                    source=lambda x, u, gu, m, z, c: 2.0,
                                    quad_degree=3, symmetric=True),
        tfem.DirichletBC.from_predicate(tV2, None, u_exact),
        is_fwd_linear=True, solver=solver, **F64)
    jpde = jmodels.VariationalPDEProblem(
        jV2, jV1, jfem.GalerkinForm(flux=lambda x, u, gu, m, z, c: gu,
                                    source=lambda x, u, gu, m, z, c: 2.0,
                                    quad_degree=3, symmetric=True),
        jfem.DirichletBC.from_predicate(jV2, None, u_exact), is_fwd_linear=True)
    u, info = tpde.solve_fwd(torch.zeros((1, tV1.dim), **F64))
    assert bool(info.converged.all())
    np.testing.assert_allclose(u[0].numpy(), u_exact(tV2.dof_coords), atol=1e-9)
    u_j, _ = jpde.solve_fwd(jnp.zeros(jV1.dim))
    assert _rel(u[0], u_j) < 1e-10


def test_p2_active_subspace_matches_jax():
    """The float64 input active subspace of the nonlinear P2 problem at
    nx=8 (P1 parameter, dense BiLaplacian prior) from the same samples and
    probe: the spectra and the leading projector to 1e-9."""
    jV2, jV1 = _spaces(jfem, 8)
    tV2, tV1 = _spaces(tfem, 8)
    targets = jfem.grid_targets(0.2, 0.8, 3)
    jpde = jmodels.VariationalPDEProblem(
        jV2, jV1, _jax_form("nonlinear"),
        jfem.DirichletBC.from_predicate(jV2, None, 0.0))
    tpde = tmodels.VariationalPDEProblem(
        tV2, tV1, _port_form("nonlinear"),
        tfem.DirichletBC.from_predicate(tV2, None, 0.0), **F64)
    jobs = jmodels.LinearStateObservable(
        jpde, jmodels.PointwiseObservation(jV2, targets))
    tobs = tmodels.LinearStateObservable(
        tpde, tmodels.PointwiseObservation(tV2, targets, **F64))
    jpr = jmodels.BiLaplacian2D(jV1, gamma=0.1, delta=1.0)
    tpr = tmodels.BiLaplacian2D(tV1, gamma=0.1, delta=1.0, **F64)
    rng = np.random.default_rng(5)
    n, rank, over = 12, 6, 4
    xi = rng.standard_normal((n, tpr.noise_dim))
    omega = rng.standard_normal((tV1.dim, rank + over))
    out = []
    for P, AS, obs, pr, conv in (
            (jmodels.ActiveSubspaceParameterList, jmodels.ActiveSubspaceProjector,
             jobs, jpr, jnp.asarray),
            (tmodels.ActiveSubspaceParameterList, tmodels.ActiveSubspaceProjector,
             tobs, tpr, _t)):
        p = P()
        p["rank"], p["oversampling"], p["samples_per_process"] = rank, over, n
        p["ms_given"], p["verbose"] = True, False
        proj = AS(obs, pr, parameters=p)
        proj.ms = (jax.vmap(pr.sample)(conv(xi)) if AS is
                   jmodels.ActiveSubspaceProjector else pr.sample(conv(xi)))
        proj.Omega_GN = conv(omega)
        d, V, _ = proj.construct_input_subspace()
        out.append((np.asarray(d), np.asarray(V)))
    (jd, jV), (td, tV) = out
    assert _rel(td, jd) < 1e-9
    lead = lambda V: V[:, :3] @ V[:, :3].T
    assert _rel(lead(tV), lead(jV)) < 1e-9
