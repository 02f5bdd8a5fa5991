"""The helmholtz lane of the PyTorch port against the JAX package.

Split-complex P2 state, PML, P1 parameter, float64, at nx=8 (ny=6; blocks
of s=68, nb=7, 34 pad rows) and nx=12 (s=100), on the same numpy noise:

* ``BandOrder`` equals the JAX one exactly (P1/P2, ncomp 1/2);
* residual, ordered band, C and C^T match to 1e-12 of their largest
  entry at 300 and 600 Hz (batch 3), and the ordered band is the dense
  operator permuted, its pad rows identity rows;
* ``PermutedFactor`` solves (forward and transposed) match the JAX factor
  (converted through ``interop``) and a dense solve to 1e-10;
* no pivoting: the row design's plain version (K3 without pivoting on the
  indefinite Schur complements) and the pivoted plain factorization match
  the JAX ``factorize_thomas_inv_banded`` to 1e-10;
* ``solve_fwd`` and the fused pass (``sample_and_materialize_symmetric``)
  match to 1e-10; fused and staged spectra agree to 1e-7; head eigenvalues
  match the JAX package to 1e-8 on a shared probe block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applications.helmholtz import (
    helmholtz_linear_observable as j_observable,
    helmholtz_prior as j_prior,
)
from hippyflow_tpu.fem import FunctionSpace as JSpace
from hippyflow_tpu.fem import bc_symmetrize_banded_masked as j_bc_sym
from hippyflow_tpu.fem import unit_square_mesh as j_mesh
from hippyflow_tpu.fem.band_order import (
    ordered_band_mask as j_band_mask,
    structured_band_order as j_band_order,
)
from hippyflow_tpu.fem.vector_assembly import (
    ComponentObservation as JComponentObservation,
)
from hippyflow_tpu.models import ActiveSubspaceProjector as JProjector
from hippyflow_tpu.models.observable import (
    PointwiseObservation as JPointwiseObservation,
)
from hippyflow_tpu.models.pde_problem import Linearization as JLin
from hippyflow_tpu.models.sampling import (
    sample_and_materialize_symmetric as j_fused,
)
from hippyflow_tpu.ops.structured import factorize_thomas_inv_banded as j_thomas
from hippyflow_tpu.utils import KeyChain as JKeyChain
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch.applications.helmholtz import (
    helmholtz_linear_observable as t_observable,
    helmholtz_prior as t_prior,
)
from hippyflow_tpu_torch.fem import (
    ComponentObservation,
    DirichletBC,
    FunctionSpace,
    GalerkinForm,
    bc_symmetrize_banded_masked,
    ordered_band_mask,
    rectangle_mesh,
    structured_band_order,
    unit_square_mesh,
)
from hippyflow_tpu_torch.models import (
    ActiveSubspaceParameterList,
    ActiveSubspaceProjector,
    PointwiseObservation,
    VariationalPDEProblem,
    materialize_jacobians,
    sample_and_materialize_symmetric,
    sample_until_solved,
)
from hippyflow_tpu_torch.models.pde_problem import Linearization
from hippyflow_tpu_torch.ops import hopper_kernels as hk
from hippyflow_tpu_torch.utils import KeyChain

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX = 8
TOL = 1e-10


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _setup(nx=NX, frequency=600.0):
    jobs, jV = j_observable(nx=nx, frequency=frequency)
    tobs, tV = t_observable(nx=nx, frequency=frequency, **F64)
    return jobs, tobs, j_prior(jV), t_prior(tV, **F64)


def _jvmap(f, *args):
    """The JAX function over a leading batch axis, compiled, as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(f))(*args))


def _noise(n, dim, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim))


@pytest.mark.parametrize("degree,ncomp", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_band_order_matches_jax(degree, ncomp):
    t = structured_band_order(FunctionSpace(unit_square_mesh(6, 4), degree),
                              ncomp=ncomp)
    j = j_band_order(JSpace(j_mesh(6, 4), degree), ncomp=ncomp)
    assert (t.s, t.nb, t.n_total, t.n_pad) == (j.s, j.nb, j.n_total, j.n_pad)
    np.testing.assert_array_equal(t.order, j.order)
    np.testing.assert_array_equal(t.inv, j.inv)
    mask = np.random.default_rng(degree).random(t.n_total) < 0.3
    np.testing.assert_array_equal(ordered_band_mask(mask, t),
                                  j_band_mask(mask, j))


@functools.lru_cache(maxsize=None)
def _assembly(frequency):
    jobs, tobs, jpr, tpr = _setup(NX, frequency)
    jp, tp = jobs.problem, tobs.problem
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, tp.state_dim))
    m = _jvmap(jpr.sample, jnp.asarray(_noise(3, tpr.noise_dim)))
    return jp, tp, u, m


@pytest.mark.parametrize("frequency", [300.0, 600.0])
def test_vector_assembly_matches_jax(frequency):
    jp, tp, u, m = _assembly(frequency)
    ju, jm, tu, tm = jnp.asarray(u), jnp.asarray(m), torch.tensor(u), torch.tensor(m)
    _close(tp.residual_masked(tu, tm),
           _jvmap(lambda a, b: jp.residual_masked(a, b), ju, jm), 1e-12)
    bo = jp._band_order
    band_j = _jvmap(lambda a, b: j_bc_sym(
        jp.bound.assemble_A_banded_ordered(a, b, None, bo), jp._band_mask), ju, jm)
    band_t = bc_symmetrize_banded_masked(
        tp.bound.assemble_A_banded_ordered(tu, tm, None, tp._band_order), tp._band_mask)
    _close(band_t, band_j, 1e-12)
    rng = np.random.default_rng(2)
    dm, dp = rng.standard_normal((3, tp.Vm.dim, 2)), rng.standard_normal(
        (3, tp.state_dim, 4))
    lin_t = Linearization(u=tu, m=tm, z=None, factor=None)
    _close(tp.apply_C(lin_t, torch.tensor(dm)),
           _jvmap(lambda a, b, c: jp.apply_C(JLin(a, b, None, None), c), ju, jm,
                jnp.asarray(dm)), 1e-12)
    _close(tp.apply_Ct(lin_t, torch.tensor(dp)),
           _jvmap(lambda a, b, c: jp.apply_Ct(JLin(a, b, None, None), c), ju, jm,
                jnp.asarray(dp)), 1e-12)


def test_ordered_band_is_the_dense_operator_permuted():
    _, tp, u, m = _assembly(600.0)
    tu, tm = torch.tensor(u), torch.tensor(m)
    bo = tp._band_order
    band = bc_symmetrize_banded_masked(
        tp.bound.assemble_A_banded_ordered(tu, tm, None, bo), tp._band_mask).numpy()
    A = tp.bound.assemble_A(tu, tm).numpy()
    s, nb, n = bo.s, bo.nb, bo.n_total
    dense = np.zeros((3, nb * s, nb * s))
    for j in range(nb):
        for o in range(3):
            c = j + o - 1
            if 0 <= c < nb:
                dense[:, j * s : (j + 1) * s, c * s : (c + 1) * s] = band[
                    :, j, :, o * s : (o + 1) * s]
    np.testing.assert_allclose(dense[:, :n, :n], A[:, bo.order][:, :, bo.order],
                               atol=1e-12 * np.abs(A).max())
    # pad rows at the band tail are identity rows (and columns)
    np.testing.assert_array_equal(dense[:, n:, n:], np.broadcast_to(
        np.eye(bo.n_pad), (3, bo.n_pad, bo.n_pad)))
    assert not dense[:, n:, :n].any() and not dense[:, :n, n:].any()
    # the split form assembles to A^T = A
    np.testing.assert_allclose(A, A.transpose(0, 2, 1), atol=1e-12 * np.abs(A).max())


@functools.lru_cache(maxsize=None)
def _factors():
    jp, tp, _, m = _assembly(600.0)
    zero = jnp.zeros(jp.state_dim)
    jfac = jax.jit(jax.vmap(lambda b: jp.linearize(zero, b).factor))(
        jnp.asarray(m))
    inner = jfac.inner
    tfac = interop.permuted_factor(*(np.asarray(a) for a in (
        inner.M, inner.Dinv, inner.B)), jfac.border, **F64)
    return jp, tp, m, jfac, tfac


@pytest.mark.parametrize("trans", [False, True])
def test_permuted_factor_matches_jax_and_dense(trans):
    jp, tp, m, jfac, tfac = _factors()
    rhs = np.random.default_rng(3).standard_normal((3, tp.state_dim, 2))
    x_t = tfac.solve(torch.tensor(rhs), trans=trans).numpy()
    x_j = _jvmap(lambda f, b: f.solve(b, trans=trans), jfac, jnp.asarray(rhs))
    _close(x_t, x_j, TOL)
    # the port's own factor of the port's band
    own = tp.linearize(torch.zeros(3, tp.state_dim, **F64), torch.tensor(m)).factor
    _close(own.solve(torch.tensor(rhs), trans=trans), x_j, TOL)
    A = tp.bound.assemble_A(torch.zeros(3, tp.state_dim, **F64),
                          torch.tensor(m)).numpy()
    A = A.transpose(0, 2, 1) if trans else A
    _close(x_t, np.linalg.solve(A, rhs), TOL)
    # a single rhs vector
    _close(own.solve(torch.tensor(rhs[..., 0]), trans=trans), x_j[..., 0], TOL)


@pytest.mark.parametrize("nx", [8, 12])
def test_no_pivoting_holds_on_helmholtz_bands(nx):
    """K1's row design runs K3, Gauss-Jordan without pivoting, on the
    Schur complements of the indefinite split-complex band.  Its plain
    version, and the pivoted plain factorization, match the JAX package's
    factorization (pivoted inverses at every size) to 1e-10."""
    jobs, tobs, jpr, _ = _setup(nx, 600.0)
    jp = jobs.problem
    m = _jvmap(jpr.sample, jnp.asarray(_noise(2, tobs.problem.Vm.dim, 4)))
    zero = jnp.zeros(jp.state_dim)
    band = _jvmap(lambda b: j_bc_sym(jp.bound.assemble_A_banded_ordered(
        zero, b, None, jp._band_order), jp._band_mask), jnp.asarray(m))
    jf = _jvmap(j_thomas, jnp.asarray(band))
    tb = torch.tensor(band)
    for fac in (hk.banded_factorize_rows_plain, hk.banded_factorize_plain):
        M, Dinv = fac(tb)
        _close(M, jf.M, TOL)
        _close(Dinv, jf.Dinv, TOL)


def test_solve_fwd_matches_jax():
    jobs, tobs, jpr, _ = _setup()
    m = _jvmap(jpr.sample, jnp.asarray(_noise(3, tobs.dM, 5)))
    u_j, info_j = jax.jit(jax.vmap(jobs.problem.solve_fwd))(jnp.asarray(m))
    u_t, info_t = tobs.problem.solve_fwd(torch.tensor(m))
    assert bool(info_t.converged.all()) and bool(np.asarray(info_j.converged).all())
    assert (info_t.iterations == 1).all()
    _close(u_t, u_j, TOL)
    _close(tobs.evalu(u_t), np.asarray(u_j) @ np.asarray(jobs.B.dense()).T, TOL)


@functools.lru_cache(maxsize=None)
def _fused(n=6, chunk=3, seed=7):
    """The JAX fused pass from KeyChain(seed), and the port's on the same
    draws (the JAX KeyChain's per-chunk normals, taken again)."""
    jobs, tobs, jpr, tpr = _setup()
    jb, jJ = j_fused(jobs, jpr, JKeyChain(seed), n, chunk_size=chunk)
    kc = JKeyChain(seed)
    xi = np.concatenate([np.asarray(kc.normal((chunk, jpr.noise_dim)))
                         for _ in range(0, n, chunk)])
    tb, tJ = sample_and_materialize_symmetric(
        tobs, tpr, KeyChain(0, "cpu"), n, chunk_size=chunk,
        noise=torch.tensor(xi))
    return jb, jJ, tb, tJ, xi


def test_fused_pass_matches_jax():
    jb, jJ, tb, tJ, _ = _fused()
    assert tb.n_failures == 0 and jb.n_failures == 0
    _close(tb.ms, jb.ms, 1e-12)
    _close(tb.us, jb.us, TOL)
    _close(tb.qs, jb.qs, TOL)
    assert tJ.shape == (6, 200, tb.ms.shape[1])
    _close(tJ, jJ, TOL)


def test_fused_pass_matches_the_staged_pipeline():
    """Same noise: the fused pass and the staged one (solve_fwd, then
    linearize + adjoint solves) give the same ms bit for bit, and u and J
    to 1e-10."""
    _, tobs, _, tpr = _setup()
    _, _, tb, tJ, xi = _fused()
    sb = sample_until_solved(tobs, tpr, KeyChain(0, "cpu"), 6, chunk_size=3,
                             noise=torch.tensor(xi))
    assert torch.equal(sb.ms, tb.ms)
    _close(tb.us, sb.us, TOL)
    _close(tJ, materialize_jacobians(tobs, sb.ms, sb.us, chunk_size=3), TOL)


def test_fused_pass_resamples_failed_lanes():
    """A lane whose linear solve fails the convergence check is resampled
    from the keychain; the others keep their draws."""
    _, tobs, _, tpr = _setup()
    _, _, tb, _, xi = _fused()
    noise = torch.tensor(xi)
    noise[1] = float("nan")
    kc = KeyChain(3, "cpu")
    fb, fJ = sample_and_materialize_symmetric(tobs, tpr, kc, 6, chunk_size=3,
                                              noise=noise)
    assert fb.n_failures == 1 and fb.failed_ms.shape == (1, tobs.dM)
    keep = [0, 2, 3, 4, 5]
    assert torch.equal(fb.ms[keep], tb.ms[keep])
    redraw = tpr.sample(KeyChain(3, "cpu").normal((3, tpr.noise_dim),
                                                  dtype=torch.float64))
    torch.testing.assert_close(fb.ms[1], redraw[0], rtol=0, atol=0)
    assert torch.isfinite(fJ).all()


@pytest.mark.parametrize("component", [0, 1])
def test_component_observation_matches_jax(component):
    """One component of a 2-component P2 state observed at points: apply
    on a batch and the dense operator, against the JAX package's."""
    targets = np.array([[0.3, 0.4], [0.55, 0.8], [0.9, 0.1]])
    tV = FunctionSpace(unit_square_mesh(4), 2)
    jV = JSpace(j_mesh(4), 2)
    t_obs = ComponentObservation(PointwiseObservation(tV, targets, **F64), 2,
                                 component)
    j_obs = JComponentObservation(JPointwiseObservation(jV, targets), 2,
                                  component)
    assert (t_obs.dim, t_obs.state_dim) == (j_obs.dim, j_obs.state_dim)
    u = np.random.default_rng(component).standard_normal((3, t_obs.state_dim))
    _close(t_obs.apply(torch.tensor(u)),
           np.stack([np.asarray(j_obs.apply(jnp.asarray(x))) for x in u]), 1e-14)
    np.testing.assert_allclose(t_obs.dense().numpy(), np.asarray(j_obs.dense()),
                               atol=1e-15)


def test_auto_rule_refuses_the_cyclic_reduction_regime():
    """Blocks below 128 on a band longer than 256 rows are where the JAX
    package's 'auto' rule takes the cyclic-reduction adjoint factor.  The
    port refused such a problem until cyclic reduction was ported for the
    PDE operator; now it takes the same factors as the JAX rule: cyclic
    reduction for the adjoint factor (only A^T with needs='adj'), the
    inverse block-Thomas forward, and solves them."""
    from hippyflow_tpu_torch.ops.structured import (
        BlockCyclicFactor,
        InverseThomasFactor,
    )

    V = FunctionSpace(rectangle_mesh(16, 300, 0.0, 0.0, 1.0, 1.0))
    mask = V.boundary_dofs(lambda x: x[:, 1] < 1e-12)
    bc = DirichletBC(mask=mask, value=np.zeros(V.dim))
    form = GalerkinForm(flux=lambda x, u, gu, m, z, c: gu,
                        source=lambda x, u, gu, m, z, c: m * u)
    p = VariationalPDEProblem(V, V, form, bc, **F64)
    assert (p._structured_solver, p._structured_solver_fwd) == (
        "block_cyclic", "thomas_inv")
    m = torch.ones((2, V.dim), **F64)
    u = torch.zeros((2, V.dim), **F64)
    adj, fwd = p.linearize(u, m, needs="adj"), p.linearize(u, m, needs="fwd")
    assert isinstance(adj.factor, BlockCyclicFactor) and adj.factor.levels is None
    assert isinstance(fwd.factor, InverseThomasFactor)
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal((2, V.dim)),
                          **F64)
    x = p.solve_incremental(adj, rhs, is_adj=True)
    y = p.solve_incremental(fwd, rhs)
    np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-10)


def _subspace(tobs, tpr, symmetric, n=6, rank=5, oversampling=4, seed=2):
    tobs.problem.operator_symmetric = symmetric
    try:
        p = ActiveSubspaceParameterList()
        p["samples_per_process"], p["rank"] = n, rank
        p["oversampling"], p["verbose"], p["seed"] = oversampling, False, seed
        proj = ActiveSubspaceProjector(tobs, tpr, parameters=p)
        d = proj.construct_input_subspace()[0].numpy()
    finally:
        tobs.problem.operator_symmetric = True
    return d, proj


def test_fused_and_staged_spectra_agree():
    _, tobs, _, tpr = _setup()
    d_f, proj_f = _subspace(tobs, tpr, True)
    d_s, proj_s = _subspace(tobs, tpr, False)
    assert set(proj_f.stage_seconds) == {"fused", "ghep"}
    assert set(proj_s.stage_seconds) == {"forward", "jacobian", "ghep"}
    np.testing.assert_allclose(d_f, d_s, rtol=1e-7, atol=1e-12 * d_s[0])
    assert np.all(np.diff(d_f) <= 0) and np.isfinite(d_f).all()


def test_head_eigenvalues_match_jax():
    """Samples and Jacobians from the fused pass on the JAX draws, a shared
    probe block: eigenvalues above 1e-4 lambda_0 agree to 1e-8."""
    jobs, tobs, jpr, tpr = _setup()
    jb, jJ, tb, tJ, _ = _fused()
    rank, p = 5, 4
    omega = np.random.default_rng(9).standard_normal((tobs.dM, rank + p))
    jproj = JProjector(jobs, jpr)
    jproj.parameters["rank"], jproj.parameters["oversampling"] = rank, p
    jproj.parameters["verbose"] = False
    jproj.samples, jproj.Js = jb, jJ
    jproj.Omega_GN = jnp.asarray(omega)
    d_j = np.asarray(jproj.construct_input_subspace()[0])
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"], params["verbose"] = rank, p, False
    tproj = ActiveSubspaceProjector(tobs, tpr, parameters=params)
    tproj.samples, tproj.Js = tb, tJ
    tproj.Omega_GN = torch.tensor(omega)
    d_t = tproj.construct_input_subspace()[0].numpy()
    head = np.abs(d_j) > 1e-4 * abs(d_j[0])
    assert head.sum() >= 3
    assert (np.abs(d_t - d_j) / np.abs(d_j))[head].max() <= 1e-8
