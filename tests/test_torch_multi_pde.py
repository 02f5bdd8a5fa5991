"""The port's multi-source problems (``models/multi_pde.py``) against the
JAX package, in float64 on the CPU: two log-diffusion Poisson problems
that share m, each with its own Gaussian source, on a P1 space at nx=8,
observed at two points, as in the JAX package's own test.

* ``MultiPDEProblem.solve_fwd``: the states (k, N, n) against JAX per
  sample and against each problem alone, the Newton info aggregated per
  sample; 1e-10;
* ``MultiStateLinearObservable``: q = sum_k B_k u_k, and
  ``ObservableJacobian.mult`` / ``transpmult`` through it against JAX's
  incremental-solve chain, on single directions and blocks; a dot test
  and a central difference; 1e-10;
* ``BlockVector``: axpy, scale, inner and zero against JAX, and
  ``export``'s files.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu as hf
from hippyflow_tpu.models import (
    BlockVector as JBlockVector,
    MultiPDEProblem as JMulti,
    MultiStateLinearObservable as JMultiObs,
    PointwiseObservation as JPointwise,
)
from hippyflow_tpu_torch.fem import (
    DirichletBC,
    FunctionSpace,
    GalerkinForm,
    unit_square_mesh,
)
from hippyflow_tpu_torch.models import (
    BlockVector,
    MultiPDEProblem,
    MultiStateLinearObservable,
    ObservableJacobian,
    PointwiseObservation,
    VariationalPDEProblem,
)

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N = 8, 3
CENTERS = [(0.3, 0.3), (0.7, 0.7)]
TARGETS = np.array([[0.5, 0.5], [0.25, 0.5]])


def _jax_problem(V, c):
    form = hf.GalerkinForm(
        flux=lambda x, u, gu, m, z, k: jnp.exp(m) * gu,
        source=lambda x, u, gu, m, z, k: -jnp.exp(
            -50.0 * ((x[0] - c[0]) ** 2 + (x[1] - c[1]) ** 2)),
        quad_degree=3, symmetric=True)
    return hf.VariationalPDEProblem(V, V, form, hf.DirichletBC.from_predicate(
        V, None, 0.0), is_fwd_linear=True)


def _torch_problem(V, c):
    def source(x, u, gu, m, z, k):
        f = torch.exp(-50.0 * ((x[..., 0] - c[0]) ** 2 + (x[..., 1] - c[1]) ** 2))
        return -f - 0.0 * u

    form = GalerkinForm(flux=lambda x, u, gu, m, z, k: torch.exp(m)[..., None] * gu,
                        source=source, quad_degree=3, symmetric=True)
    return VariationalPDEProblem(V, V, form, DirichletBC.from_predicate(V, None, 0.0),
                                 is_fwd_linear=True, **F64)


@functools.lru_cache(maxsize=None)
def _setup():
    jV = hf.FunctionSpace(hf.unit_square_mesh(NX))
    tV = FunctionSpace(unit_square_mesh(NX))
    jps = [_jax_problem(jV, c) for c in CENTERS]
    tps = [_torch_problem(tV, c) for c in CENTERS]
    jobs = JMultiObs(JMulti(jps), JPointwise(jV, TARGETS))
    tobs = MultiStateLinearObservable(MultiPDEProblem(tps),
                                      PointwiseObservation(tV, TARGETS, **F64))
    ms = 0.2 * np.random.default_rng(0).standard_normal((N, tV.dim))
    return jobs, tobs, tps, ms


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _directions(k):
    _, tobs, _, _ = _setup()
    rng = np.random.default_rng(10 + (k or 0))
    tail = () if k is None else (k,)
    return (rng.standard_normal((N, tobs.dM) + tail),
            rng.standard_normal((N, tobs.dQ) + tail))


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's states, q, J dm and J^T dq at each sample (one jitted vmap):
    J = -B A^{-1} C summed over the problems, through the observable's
    incremental solves as the JAX package's test takes them."""
    jobs, _, _, ms = _setup()
    dirs = {k: _directions(k) for k in (None, 4)}

    def one(m, dm1, dq1, dm4, dq4):
        u, info = jobs.problem.solve_fwd(m)
        lins = jobs.problem.linearize(u, m)
        out = {"u": u, "q": jobs.eval(m), "converged": info.converged,
               "iterations": info.iterations}
        for k, dm, dq in ((None, dm1, dq1), (4, dm4, dq4)):
            uhat = jobs.solveFwdIncremental(lins, jobs.applyC(lins, dm))
            out[f"J_{k}"] = -jobs.evalu(uhat)
            phat = jobs.solveAdjIncremental(lins, jobs.applyBt(dq))
            out[f"Jt_{k}"] = -jobs.applyCt(lins, phat)
        return out

    args = [jnp.asarray(x) for x in (ms, *dirs[None], *dirs[4])]
    return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(one))(*args).items()}


def test_solve_matches_jax_and_each_problem():
    _, tobs, tps, ms = _setup()
    m = torch.as_tensor(ms, **F64)
    u, info = tobs.problem.solve_fwd(m)
    ref = _jax_reference()
    assert u.shape == (len(CENTERS), N, tps[0].state_dim)
    assert _rel(u, ref["u"].transpose(1, 0, 2)) < 1e-10
    for k, p in enumerate(tps):
        uk, _ = p.solve_fwd(m)
        assert _rel(u[k], uk) < 1e-12
    assert info.converged.shape == (N,) and bool(info.converged.all())
    np.testing.assert_array_equal(info.iterations.numpy(), ref["iterations"])


def test_observable_is_the_sum():
    _, tobs, tps, ms = _setup()
    m = torch.as_tensor(ms, **F64)
    q = tobs.eval(m)
    want = sum(B.apply(p.solve_fwd(m)[0]) for B, p in zip(tobs.Bs, tps))
    assert _rel(q, want) < 1e-12
    assert _rel(q, _jax_reference()["q"]) < 1e-10


@pytest.mark.parametrize("k", [None, 4])
def test_jacobian_through_the_multi_observable_matches_jax(k):
    _, tobs, _, ms = _setup()
    m = torch.as_tensor(ms, **F64)
    J = ObservableJacobian(tobs)
    lins = tobs.linearize(m)
    dm, dq = (torch.as_tensor(x, **F64) for x in _directions(k))
    Jdm, Jtdq = J.mult(lins, dm), J.transpmult(lins, dq)
    ref = _jax_reference()
    assert _rel(Jdm, ref[f"J_{k}"]) < 1e-10
    assert _rel(Jtdq, ref[f"Jt_{k}"]) < 1e-10
    # the dot test <dq, J dm> = <J^T dq, dm>, sample by sample
    lhs, rhs = (dq * Jdm).sum(dim=1), (Jtdq * dm).sum(dim=1)
    assert ((lhs - rhs).abs() / lhs.abs()).max() < 1e-12


def test_jacobian_central_difference():
    _, tobs, _, ms = _setup()
    m = torch.as_tensor(ms, **F64)
    dm = torch.as_tensor(_directions(None)[0], **F64)
    Jdm = ObservableJacobian(tobs).mult(tobs.linearize(m), dm)
    eps = 1e-6
    fd = (tobs.eval(m + eps * dm) - tobs.eval(m - eps * dm)) / (2 * eps)
    assert (torch.linalg.vector_norm(fd - Jdm) / torch.linalg.vector_norm(Jdm)) < 1e-7


def test_block_vector_algebra_matches_jax():
    rng = np.random.default_rng(3)
    a = [rng.standard_normal(3), rng.standard_normal((2, 4))]
    b = [rng.standard_normal(3), rng.standard_normal((2, 4))]
    jv, jw = JBlockVector(map(jnp.asarray, a)), JBlockVector(map(jnp.asarray, b))
    tv = BlockVector(torch.as_tensor(x, **F64) for x in a)
    tw = BlockVector(torch.as_tensor(x, **F64) for x in b)
    jv.axpy(0.5, jw).scale(-1.5)
    tv.axpy(0.5, tw).scale(-1.5)
    assert tv.nv == 2
    for k in range(2):
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=1e-15)
    assert abs(float(tv.inner(tw)) - float(jv.inner(jw))) < 1e-12
    tv[1] = torch.ones(2, 4, **F64)
    assert float(tv[1].sum()) == 8.0
    assert float(tv.zero().inner(tv)) == 0.0


def test_block_vector_export_matches_jax(tmp_path):
    jmesh, tmesh = hf.unit_square_mesh(3), unit_square_mesh(3)
    nv = tmesh.num_vertices
    data = [np.arange(nv, dtype=np.float64), np.linspace(-1, 1, nv)]
    jpaths = JBlockVector(map(jnp.asarray, data)).export(jmesh, str(tmp_path / "j"), "u")
    tpaths = BlockVector(torch.as_tensor(x) for x in data).export(
        tmesh, str(tmp_path / "t"), "u")
    assert [p.split("/")[-1] for p in tpaths] == [p.split("/")[-1] for p in jpaths]
    for jp, tp in zip(jpaths, tpaths):
        # every line but the title line is the same
        jl, tl = open(jp).read().splitlines(), open(tp).read().splitlines()
        assert len(jl) == len(tl) and jl[2:] == tl[2:] and jl[0] == tl[0]
