"""The port's solver choices against the JAX package, in float64 on the
CPU, on the Poisson control problem (``testing.py``) at nx=8.

* ``solve_fwd`` on every ``solver=`` (auto, dense, block_tridiag,
  block_cyclic, thomas_inv, iterative), linear and nonlinear: identical
  Newton iteration counts, the state within 1e-10 of JAX's relative to
  its largest entry (direct solvers), and the incremental forward and
  adjoint solves at the linearization point likewise; ``iterative``
  within 1e-8 of JAX's BiCGStab, and both BiCGStabs' solves within 10 tol
  = 1e-9 of the direct solve, relative to the solution's norm;
* Shamanskii Newton (``newton_stale_factor`` 1, 2, 3) with JAX's iterates;
* a starved BiCGStab (maxiter 2) reports stagnation through
  ``solve_info`` and the linear solve's flag, with JAX's two iterates;
* the ``auto`` rule's picks equal JAX's on the fixture, on a long thin
  rectangle (s=9, nb=301) and on helmholtz nx=16 (explicit
  ``block_cyclic`` too); helmholtz's indefinite blocks through the
  port's unpivoted cyclic reduction within 1e-10 of JAX's pivoted one;
* the batched cyclic-reduction factor and its solves against JAX's
  ``factorize_block_cyclic_banded`` under vmap with the interpret-mode
  Pallas Gauss-Jordan (``batched_inverse(force="pallas")``), 1e-12;
* ``dist_banded`` on a one-rank mesh against ``auto`` and JAX (1e-10);
* a permuted-numbering unstructured mesh: residual, dense A, its
  diagonal, dense Cz and Cz^T against JAX at 1e-12, and the dense and
  iterative solves against the structured one;
* the BiLaplacian prior with ``robin_bc`` on structured and unstructured
  meshes against JAX at 1e-12;
* ``save_mesh`` / ``load_mesh`` round trips, readable by either package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu as hf
from hippyflow_tpu import testing as jt
from hippyflow_tpu.ops import pallas_kernels as jpk
from hippyflow_tpu.ops import structured as jstructured
from hippyflow_tpu_torch import testing as tt
from hippyflow_tpu_torch.fem import FunctionSpace as TFunctionSpace
from hippyflow_tpu_torch.fem import Mesh2D as TMesh, rectangle_mesh
from hippyflow_tpu_torch.models import BiLaplacianPrior, VariationalPDEProblem
from hippyflow_tpu_torch.ops.structured import factorize_block_cyclic_banded

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N = 8, 3
SOLVERS = ("auto", "dense", "block_tridiag", "block_cyclic", "thomas_inv",
           "iterative")
DIRECT_TOL, ITERATIVE_TOL = 1e-10, 1e-8


def _settings(nx=NX, linear=True):
    st = jt.poisson_control_settings()
    st["nx"] = st["ny"] = nx
    st["LINEAR"] = linear
    return st


def _jax_problem(st, solver="auto", mesh=None, stale=1):
    """The JAX package's fixture problem with a given solver and mesh."""
    V = hf.FunctionSpace(mesh or hf.fem.unit_square_mesh(st["nx"], st["ny"]))
    bc = hf.DirichletBC.from_predicate(V, jt._u_boundary, lambda x: x[:, 1])
    return hf.VariationalPDEProblem(
        V, V, jt.make_poisson_varf(st), bc, is_fwd_linear=st["LINEAR"],
        control_dim=25, solver=solver, newton_stale_factor=stale)


@functools.lru_cache(maxsize=None)
def _pair(linear, solver="auto", nx=NX, stale=1):
    """(JAX problem, port problem) of the fixture."""
    st = _settings(nx, linear)
    tpde = tt.setup_poisson_control_problem(
        st, solver=solver, newton_stale_factor=stale, **F64)[0]
    return _jax_problem(st, solver, stale=stale), tpde


@functools.lru_cache(maxsize=None)
def _inputs(nx=NX, seed=0):
    """Prior samples m (N, n) and controls z (N, 25), numpy."""
    jpr = jt.setup_poisson_control_problem(_settings(nx))[1]
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((N, jpr.noise_dim))
    m = np.asarray(jax.vmap(jpr.sample)(jnp.asarray(noise)))
    return m, rng.uniform(-1.0, 1.0, (N, 25))


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _j_solve(jpde, m, z):
    return jax.jit(jax.vmap(lambda mm, zz: jpde.solve_fwd(mm, zz)))(
        jnp.asarray(m), jnp.asarray(z))


def _j_solve_and_incremental(jpde, m, z, rhs):
    """JAX's solve_fwd and its (forward, adjoint) incremental solves at the
    solution, one program."""
    def one(mm, zz, r):
        u, info = jpde.solve_fwd(mm, zz)
        lin = jpde.linearize(u, mm, zz)
        return (u, info, jpde.solve_incremental(lin, r, False),
                jpde.solve_incremental(lin, r, True))

    return jax.jit(jax.vmap(one))(jnp.asarray(m), jnp.asarray(z),
                                  jnp.asarray(rhs))


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("linear", [True, False])
def test_solve_fwd_and_incremental_match_jax(linear, solver):
    jpde, tpde = _pair(linear, solver)
    m, z = _inputs()
    rhs = np.random.default_rng(1).standard_normal((N, tpde.state_dim, 2))
    u, info, *wants = _j_solve_and_incremental(jpde, m, z, rhs)
    ut, infot = tpde.solve_fwd(_t(m), _t(z))
    tol = ITERATIVE_TOL if solver == "iterative" else DIRECT_TOL
    assert np.array_equal(infot.iterations.numpy(), np.asarray(info.iterations))
    assert bool(infot.converged.all()) and bool(np.asarray(info.converged).all())
    assert _rel(ut, u) <= tol
    lin = tpde.linearize(ut, _t(m), _t(z))
    direct = _pair(linear, "dense")[1]
    lin_d = direct.linearize(ut, _t(m), _t(z))
    for is_adj, want in zip((False, True), wants):
        got = tpde.solve_incremental(lin, _t(rhs), is_adj=is_adj)
        assert _rel(got, want) <= tol
        if solver == "iterative":
            # both BiCGStabs within 10 tol of the direct solve
            exact = direct.solve_incremental(lin_d, _t(rhs), is_adj=is_adj)
            for x in (got, _t(want)):
                err = (torch.linalg.vector_norm(x - exact, dim=1)
                       / torch.linalg.vector_norm(exact, dim=1))
                assert err.max().item() <= 10 * tpde._iterative_tol


@pytest.mark.parametrize("linear", [True, False])
def test_iterative_within_ten_tol_of_direct(linear):
    """BiCGStab at tol 1e-10 against the dense direct solve of the same
    linearization: forward, adjoint and solve_info's residual."""
    _, it_pde = _pair(linear, "iterative")
    _, direct = _pair(linear, "dense")
    m, z = _inputs()
    u, _ = direct.solve_fwd(_t(m), _t(z))
    rhs = _t(np.random.default_rng(2).standard_normal((N, direct.state_dim, 3)))
    lin_i = it_pde.linearize(u, _t(m), _t(z))
    lin_d = direct.linearize(u, _t(m), _t(z))
    for is_adj in (False, True):
        x, rel = it_pde.solve_incremental(lin_i, rhs, is_adj, return_info=True)
        want = direct.solve_incremental(lin_d, rhs, is_adj)
        err = (torch.linalg.vector_norm(x - want, dim=1)
               / torch.linalg.vector_norm(want, dim=1))
        assert err.max().item() <= 10 * it_pde._iterative_tol
        assert rel.shape == (N,) and rel.max().item() <= it_pde._iterative_tol
        _, rel_d = direct.solve_incremental(lin_d, rhs, is_adj, return_info=True)
        assert not rel_d.any()


@pytest.mark.parametrize("stale", [1, 2, 3])
def test_newton_stale_factor_matches_jax(stale):
    jpde, tpde = _pair(False, "auto", NX, stale)
    m, z = _inputs()
    u, info = _j_solve(jpde, 2.0 * m, 3.0 * z)
    ut, infot = tpde.solve_fwd(_t(2.0 * m), _t(3.0 * z))
    assert np.array_equal(infot.iterations.numpy(), np.asarray(info.iterations))
    assert bool(infot.converged.all())
    assert _rel(ut, u) <= DIRECT_TOL


def test_solve_info_surfaces_stagnation():
    """A starved BiCGStab (2 iterations): its iterate equals JAX's, the
    linear solve flags failure and solve_info reports a large residual;
    with the default budget the residual is within tol."""
    st = _settings()
    tpde = tt.setup_poisson_control_problem(st, solver="iterative", **F64)[0]
    starved = tt.setup_poisson_control_problem(st, solver="iterative", **F64)[0]
    starved._iterative_maxiter = 2
    jstarved = _jax_problem(st, "iterative")
    jstarved._iterative_maxiter = 2
    m, z = _inputs()
    rhs = np.random.default_rng(3).standard_normal((N, tpde.state_dim, 2))
    u, jinfo, jx, _ = _j_solve_and_incremental(jstarved, m, z, rhs)
    ut, info = starved.solve_fwd(_t(m), _t(z))
    assert not info.converged.any() and not np.asarray(jinfo.converged).any()
    assert _rel(ut, u) <= 1e-10
    lin = starved.linearize(ut, _t(m), _t(z))
    x, rel = starved.solve_incremental(lin, _t(rhs), return_info=True)
    assert rel.min().item() > 1e-4
    assert _rel(x, jx) <= 1e-10
    healthy = tpde.linearize(ut, _t(m), _t(z))
    _, rel2 = tpde.solve_incremental(healthy, _t(rhs), return_info=True)
    assert rel2.max().item() <= tpde._iterative_tol


def _auto_problems(case):
    """(JAX problem, port problem) of an auto-rule case."""
    from applications.helmholtz import helmholtz_linear_observable as jh
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable as th,
    )

    if case.startswith("helmholtz"):
        solver = "block_cyclic" if case.endswith("cyclic") else "auto"
        return (jh(nx=16, frequency=150.0, solver=solver)[0].problem,
                th(nx=16, frequency=150.0, solver=solver, **F64)[0].problem)
    st = _settings(8, False)
    solver = "thomas_inv" if case.endswith("thomas") else "auto"
    if case.startswith("thin"):
        st["ny"] = 300
    return (_jax_problem(st, solver),
            tt.setup_poisson_control_problem(st, solver=solver, **F64)[0])


@pytest.mark.parametrize("case", ["fixture", "thin", "thin_thomas", "helmholtz",
                                  "helmholtz_cyclic"])
def test_auto_rule_picks_match_jax(case):
    jp, tp = _auto_problems(case)
    assert (tp._structured_solver, tp._structured_solver_fwd) == (
        jp._structured_solver, jp._structured_solver_fwd)
    assert tp._use_block_tridiag == jp._use_block_tridiag
    if case == "thin":
        assert tp._structured_solver == "block_cyclic"


@pytest.mark.parametrize("solver, mesh, pair", [
    ("auto", "structured", ("thomas_inv", "thomas_inv")),
    ("auto", "thin", ("thomas_inv", "block_cyclic")),
    ("auto", "unstructured", ("dense", "dense")),
    ("block_cyclic", "structured", ("block_cyclic", "block_cyclic")),
    ("dense", "structured", ("dense", "dense")),
    ("iterative", "structured", ("iterative", "iterative")),
])
def test_solver_resolves_to_a_factor_pair(solver, mesh, pair):
    """``solver=`` resolves once into the forward and adjoint factors, and
    the memory per sample follows: 16 n s bytes on a band, 3 n^2 on a
    dense matrix (the dense and iterative solvers)."""
    st = _settings(NX, False)
    kw = {}
    if mesh == "thin":
        st["ny"] = 300
    elif mesh == "unstructured":
        kw["mesh"] = _permuted_meshes(NX)[1]
    p = tt.setup_poisson_control_problem(st, solver=solver, **kw, **F64)[0]
    assert (p.fwd_solver, p.adj_solver) == pair
    n = p.state_dim
    s = NX + 1 if pair[0] not in ("dense", "iterative") else None
    want = 16.0 * n * s * 8 if s else 3.0 * n * n * 8
    assert p.bytes_per_sample(torch.float64) == want


def test_helmholtz_cyclic_reduction_matches_jax():
    """The indefinite helmholtz blocks (nx=16, s=132) through the port's
    cyclic reduction (unpivoted Gauss-Jordan, K3's algorithm) against the
    JAX package's (pivoted ``jnp.linalg.inv`` on the CPU): the adjoint
    solve of the fused pass, 1e-10 relative."""
    from applications.helmholtz import helmholtz_linear_observable as jh
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable as th,
    )

    jp = jh(nx=16, frequency=150.0, solver="block_cyclic")[0].problem
    tp = th(nx=16, frequency=150.0, solver="block_cyclic", **F64)[0].problem
    m = np.random.default_rng(4).standard_normal((1, tp.Vm.dim)) * 0.1
    zero = np.zeros((1, tp.state_dim))
    rhs = np.random.default_rng(5).standard_normal((1, tp.state_dim, 2))
    want = jax.jit(jax.vmap(lambda uu, mm, r: jp.solve_incremental(
        jp.linearize(uu, mm, None, needs="adj"), r, True)))(
        jnp.asarray(zero), jnp.asarray(m), jnp.asarray(rhs))
    lin = tp.linearize(_t(zero), _t(m), needs="adj")
    assert _rel(tp.solve_incremental(lin, _t(rhs), True), want) <= 1e-10


def _bands(nb, s, seed):
    """(N, nb, s, 3s) diagonally dominant bands, A_0 = B_{nb-1} = 0."""
    rng = np.random.default_rng(seed)
    band = 0.2 * rng.standard_normal((N, nb, s, 3 * s))
    band[:, :, :, s : 2 * s] += 4.0 * np.eye(s)
    band[:, 0, :, :s] = 0.0
    band[:, -1, :, 2 * s :] = 0.0
    return band


@pytest.mark.parametrize("nb,s", [(1, 4), (2, 4), (5, 4), (8, 3), (3, 16)])
def test_batched_cyclic_reduction_matches_pallas(nb, s, monkeypatch):
    band = _bands(nb, s, nb * s)
    rhs = np.random.default_rng(nb).standard_normal((N, nb * s, 3))
    monkeypatch.setattr(jstructured, "_block_inv",
                        lambda X: jpk.batched_inverse(X, force="pallas"))
    jfac = jax.jit(jax.vmap(lambda b: jstructured.factorize_block_cyclic_banded(
        b, with_transpose=True)))(jnp.asarray(band))
    tfac = factorize_block_cyclic_banded(_t(band), with_transpose=True)
    for tl, jl in zip(tfac.levels + tfac.trans_levels,
                      jfac.levels + jfac.trans_levels):
        for a, b in zip(tl, jl):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12
    adj = factorize_block_cyclic_banded(_t(band), with_forward=False)
    assert adj.levels is None
    for trans in (False, True):
        want = jax.vmap(lambda f, r: f.solve(r, trans=trans))(
            jfac, jnp.asarray(rhs))
        assert _rel(tfac.solve(_t(rhs), trans=trans), want) <= 1e-12
        assert _rel(tfac.solve(_t(rhs[..., 0]), trans=trans),
                    np.asarray(want)[..., 0]) <= 1e-12
    assert _rel(adj.solve(_t(rhs), trans=True),
                jax.vmap(lambda f, r: f.solve(r, trans=True))(
                    jfac, jnp.asarray(rhs))) <= 1e-12


def _permuted_meshes(nx, seed=0):
    """(JAX mesh, port mesh, perm): the unit square with its vertices
    renumbered, new vertex i = old vertex perm[i], no structured shape."""
    base = rectangle_mesh(nx, nx)
    perm = np.random.default_rng(seed).permutation(base.num_vertices)
    inv = np.argsort(perm)
    args = (base.vertices[perm], inv[base.cells].astype(np.int32),
            base.boundary_mask[perm])
    return hf.fem.Mesh2D(*args), TMesh(*args), perm


@functools.lru_cache(maxsize=None)
def _unstructured(linear):
    jmesh, tmesh, perm = _permuted_meshes(NX)
    st = _settings(NX, linear)
    return _jax_problem(st, mesh=jmesh), tmesh, perm, st


def test_unstructured_assembly_matches_jax():
    jpde, tmesh, perm, st = _unstructured(False)
    tpde = tt.setup_poisson_control_problem(st, mesh=tmesh, **F64)[0]
    assert tpde.bound.plan is None and not tpde._use_block_tridiag
    m, z = _inputs()
    m, u = m[:, perm], np.random.default_rng(6).standard_normal(m.shape)
    jb, tb = jpde.bound, tpde.bound
    args = (jnp.asarray(u), jnp.asarray(m), jnp.asarray(z))
    targs = tuple(_t(a) for a in args)
    for name in ("residual", "assemble_A", "assemble_A_diag", "assemble_Cz"):
        want = jax.jit(jax.vmap(getattr(jb, name)))(*args)
        assert _rel(getattr(tb, name)(*targs), want) <= 1e-12, name
    dp = np.random.default_rng(7).standard_normal((N, tpde.state_dim, 2))
    want = jax.jit(jax.vmap(lambda a, b, c, d: jax.vmap(
        lambda col: jb.apply_Czt(a, b, c, col), 1, 1)(d)))(*args, jnp.asarray(dp))
    assert _rel(tb.apply_Czt(*targs, _t(dp)), want) <= 1e-12


@pytest.mark.parametrize("solver", ["auto", "dense", "iterative"])
@pytest.mark.parametrize("linear", [True, False])
def test_unstructured_solves_match_structured(linear, solver):
    _, tmesh, perm, st = _unstructured(linear)
    tpde = tt.setup_poisson_control_problem(st, mesh=tmesh, solver=solver,
                                            **F64)[0]
    _, ref = _pair(linear, "auto")
    m, z = _inputs()
    u, info = ref.solve_fwd(_t(m), _t(z))
    up, infop = tpde.solve_fwd(_t(m[:, perm]), _t(z))
    assert np.array_equal(infop.iterations.numpy(), info.iterations.numpy())
    tol = ITERATIVE_TOL if solver == "iterative" else DIRECT_TOL
    assert _rel(up[:, np.argsort(perm)], u) <= tol


@pytest.mark.parametrize("mesh", ["structured", "unstructured"])
def test_robin_prior_matches_jax(mesh):
    st = _settings()
    if mesh == "structured":
        jV = hf.FunctionSpace(hf.fem.unit_square_mesh(NX, NX))
        tV = TFunctionSpace(rectangle_mesh(NX, NX))
    else:
        jmesh, tmesh, _ = _permuted_meshes(NX, seed=1)
        jV, tV = hf.FunctionSpace(jmesh), TFunctionSpace(tmesh)
    kw = dict(theta0=st["THETA0"], theta1=st["THETA1"], alpha=st["ALPHA"])
    jpr = hf.BiLaplacianPrior(jV, st["GAMMA"], st["DELTA"], robin_bc=True,
                              mean=jnp.ones(jV.dim), **kw)
    tpr = BiLaplacianPrior(tV, st["GAMMA"], st["DELTA"], robin_bc=True,
                           mean=torch.ones(tV.dim, **F64), **kw, **F64)
    assert _rel(tpr.K, jpr.K) <= 1e-12
    noise = np.random.default_rng(8).standard_normal((N, tV.dim))
    assert _rel(tpr.sample(_t(noise)), jax.vmap(jpr.sample)(jnp.asarray(noise))) <= 1e-12
    X = np.random.default_rng(9).standard_normal((tV.dim, 3))
    for name in ("R_matmat", "Rsolver_matmat"):
        assert _rel(getattr(tpr, name)(_t(X)), getattr(jpr, name)(jnp.asarray(X))) <= 1e-12


def test_dist_banded_raises():
    """dist_banded without a device mesh, and a band solver on an
    unstructured mesh, are refused."""
    _, tpde = _pair(True)
    with pytest.raises(ValueError, match="dist_mesh"):
        VariationalPDEProblem(tpde.Vu, tpde.Vm, tpde.form, tpde.bc,
                              solver="dist_banded", **F64)
    with pytest.raises(ValueError, match="structured mesh"):
        _, tmesh, _, st = _unstructured(True)
        tt.setup_poisson_control_problem(st, mesh=tmesh, solver="block_cyclic",
                                         **F64)


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A one-rank gloo group and its (1, 1) mesh (the partitioned solves
    across ranks: ``tests/test_torch_parallel_ranks.py``)."""
    from _torch_parallel_worker import world_one

    with world_one(tmp_path_factory.mktemp("group") / "store") as mesh:
        yield mesh


@pytest.mark.parametrize("linear", [True, False])
def test_dist_banded_matches_auto(linear, one_rank_mesh):
    """solver='dist_banded' on a one-rank 'fem' axis (one SPIKE partition:
    the cyclic-reduction factor of the whole band and the interface system)
    against ``auto`` and the JAX package: the same Newton iterations, the
    state and the incremental solves within 1e-10."""
    jpde, auto = _pair(linear)
    st = _settings(NX, linear)
    dist = tt.setup_poisson_control_problem(
        st, solver="dist_banded", dist_mesh=one_rank_mesh, dist_axis="fem",
        **F64)[0]
    m, z = _inputs()
    rhs = np.random.default_rng(1).standard_normal((N, dist.state_dim, 2))
    u, info, *wants = _j_solve_and_incremental(jpde, m, z, rhs)
    ud, infod = dist.solve_fwd(_t(m), _t(z))
    ua, infoa = auto.solve_fwd(_t(m), _t(z))
    assert np.array_equal(infod.iterations.numpy(), np.asarray(info.iterations))
    assert torch.equal(infod.iterations, infoa.iterations)
    assert _rel(ud, u) <= DIRECT_TOL and _rel(ud, ua) <= DIRECT_TOL
    lin, lin_a = dist.linearize(ud, _t(m), _t(z)), auto.linearize(ud, _t(m), _t(z))
    for is_adj, want in zip((False, True), wants):
        got = dist.solve_incremental(lin, _t(rhs), is_adj=is_adj)
        assert _rel(got, want) <= DIRECT_TOL
        assert _rel(got, auto.solve_incremental(lin_a, _t(rhs), is_adj=is_adj)) \
            <= DIRECT_TOL


@pytest.mark.parametrize("structured", [True, False])
def test_mesh_save_load_round_trip(tmp_path, structured):
    from hippyflow_tpu.utils.mesh_utils import load_mesh as j_load
    from hippyflow_tpu_torch.utils import load_mesh, save_mesh

    mesh = rectangle_mesh(4, 3) if structured else _permuted_meshes(4)[1]
    save_mesh(mesh, str(tmp_path / "mesh"))
    for got in (load_mesh(str(tmp_path / "mesh")), j_load(str(tmp_path / "mesh"))):
        assert got.structured_shape == mesh.structured_shape
        for name in ("vertices", "cells", "boundary_mask"):
            assert np.array_equal(getattr(got, name), getattr(mesh, name))
