"""The port's control paths against the JAX package, in float64 on the CPU,
on the nonlinear Poisson control problem (``testing.py``, the u^3 term so
Newton runs) at nx=8 with 10 pointwise observations.

Both packages see the same draws: given streams (``GivenNoise`` and its
twin here) feed the prior noise and, through ``UniformDistribution``, the
controls in the JAX package's order (each chunk's noise, then its
controls); the chunked generators get the JAX package's own
``chunk_keychain`` draws replayed as ``noise`` and ``controls``.

* ``apply_Cz`` / ``apply_Czt``: 1e-12;
* ``ObservableControlJacobian``: the dot test, a central difference, and
  ``materialize`` against JAX at 1e-10;
* ``sample_until_solved`` with a control distribution: m, z, q at 1e-10,
  identical Newton counts; a failed lane draws new noise, then new
  controls, and given controls are not written to;
* the problem's helpers (``evalGradientParameter``, ``generate_*``, the
  variable constants) and ``linearize_batch``;
* ``DataGenerator.generate(derivatives=(1, 1))``: every file and array
  against JAX at 1e-9 (the J^T Phi sketches, and the SVDs through their
  products), and a killed run resumed to identical bits;
* ``PODProjector`` with a control distribution (subspace, ``z_data``,
  ``solve_at_mean`` at the distribution's mean);
* ``construct_low_rank_control_Jacobians``: the ``Jzsvd`` schema at 1e-9.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu import testing as jt
from hippyflow_tpu.models import (
    ActiveSubspaceParameterList as JASParams,
    ActiveSubspaceProjector as JAS,
    DataGenerator as JDataGenerator,
    Linearization as JLin,
    ObservableControlJacobian as JControlJacobian,
    PODParameterList as JPODParams,
    PODProjector as JPOD,
    UniformDistribution as JUniform,
)
from hippyflow_tpu.models import data_generator as jdg
from hippyflow_tpu.models.sampling import sample_until_solved as j_sample
from hippyflow_tpu_torch import testing as tt
from hippyflow_tpu_torch.models import (
    ActiveSubspaceParameterList as TASParams,
    ActiveSubspaceProjector as TAS,
    DataGenerator as TDataGenerator,
    Linearization,
    ObservableControlJacobian,
    PODParameterList as TPODParams,
    PODProjector as TPOD,
    sample_until_solved,
)
from hippyflow_tpu_torch.models import data_generator as tdg
from hippyflow_tpu_torch.utils import GivenNoise

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N_OBS, DZ = 8, 10, 25


class JaxGivenNoise:
    """The JAX side's keychain: the same numpy stream as ``GivenNoise``."""

    def __init__(self, rng):
        self.rng = rng

    def normal(self, shape, dtype=None, sigma=1.0):
        return sigma * jnp.asarray(self.rng.standard_normal(shape),
                                   dtype=dtype or jnp.float64)

    def next_key(self):
        return None


class JaxGivenUniform:
    """The JAX side's control distribution drawing from that stream."""

    def __init__(self, rng, dim=DZ, a=-1.0, b=1.0):
        self.rng, self.dim, self.a, self.b = rng, dim, a, b

    def sample_n(self, key, n, dtype=None):
        return jnp.asarray(self.rng.uniform(self.a, self.b, (n, self.dim)))


def _given(seed):
    """(JAX keychain, JAX control distribution, port keychain) of one
    numpy stream each side."""
    jrng = np.random.default_rng(seed)
    return (JaxGivenNoise(jrng), JaxGivenUniform(jrng),
            GivenNoise(np.random.default_rng(seed), "cpu"))


def _settings():
    st = jt.poisson_control_settings()
    st["nx"] = st["ny"] = NX
    st["LINEAR"] = False
    return st


@functools.lru_cache(maxsize=None)
def _problems():
    """(JAX observable, prior, port observable, prior, port control
    distribution)."""
    jpde, jpr, _, jV = jt.setup_poisson_control_problem(_settings())
    tpde, tpr, tdist, tV = tt.setup_poisson_control_problem(_settings(), **F64)
    return (jt.poisson_pointwise_observable(jpde, jV, N_OBS), jpr,
            tt.poisson_pointwise_observable(tpde, tV, N_OBS), tpr, tdist)


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _point(n=3):
    """A solved linearization point (u, m, z) of n samples, numpy."""
    jobs, jpr, tobs, _, _ = _problems()
    rng = np.random.default_rng(0)
    m = np.asarray(jax.vmap(jpr.sample)(
        jnp.asarray(rng.standard_normal((n, jpr.noise_dim)))))
    z = rng.uniform(-1.0, 1.0, (n, DZ))
    u, info = tobs.problem.solve_fwd(_t(m), _t(z))
    assert bool(info.converged.all())
    return u.numpy(), m, z


@pytest.mark.parametrize("k", [None, 3])
def test_apply_Cz_and_Czt_match_jax(k):
    jobs, _, tobs, _, _ = _problems()
    u, m, z = _point()
    rng = np.random.default_rng(1)
    dz = rng.standard_normal((3, DZ) + (() if k is None else (k,)))
    dp = rng.standard_normal((3, tobs.problem.state_dim)
                             + (() if k is None else (k,)))
    lin = Linearization(_t(u), _t(m), _t(z), None)
    jp = jobs.problem
    want_cz = jax.vmap(lambda a, b, c, d: jp.apply_Cz(JLin(a, b, c, None), d))(
        u, m, z, dz)
    want_czt = jax.vmap(lambda a, b, c, d: jp.apply_Czt(JLin(a, b, c, None), d))(
        u, m, z, dp)
    _close(tobs.problem.apply_Cz(lin, _t(dz)), want_cz, 1e-12)
    _close(tobs.problem.apply_Czt(lin, _t(dp)), want_czt, 1e-12)


def test_control_jacobian_matches_jax():
    """Dot test, central difference, and materialize against JAX and
    against its own mult / transpmult."""
    jobs, _, tobs, _, _ = _problems()
    u, m, z = _point()
    lin = tobs.problem.linearize(_t(u), _t(m), _t(z))
    Jz = ObservableControlJacobian(tobs)
    assert Jz.shape == (N_OBS, DZ)
    rng = np.random.default_rng(2)
    dz, dq = _t(rng.standard_normal((3, DZ))), _t(rng.standard_normal((3, N_OBS)))
    lhs = (Jz.mult(lin, dz) * dq).sum(1)
    rhs = (dz * Jz.transpmult(lin, dq)).sum(1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-10)
    h = 1e-5
    q_plus = tobs.eval(_t(m), _t(z) + h * dz)
    q_minus = tobs.eval(_t(m), _t(z) - h * dz)
    _close(Jz.mult(lin, dz), (q_plus - q_minus) / (2 * h), 1e-7)
    dense = Jz.materialize(lin)
    _close(dense, Jz.mult(lin, torch.eye(DZ, **F64).expand(3, -1, -1)), 1e-12)
    want = jax.jit(jax.vmap(lambda a, b, c: JControlJacobian(jobs).materialize(
        jobs.problem.linearize(a, b, c))))(u, m, z)
    _close(dense, want, 1e-10)


def test_sample_until_solved_with_control_matches_jax():
    jobs, jpr, tobs, tpr, tdist = _problems()
    jkc, jdist, tkc = _given(3)
    want = j_sample(jobs, jpr, jkc, 5, control_distribution=jdist, chunk_size=2)
    got = sample_until_solved(tobs, tpr, tkc, 5, chunk_size=2,
                              control_distribution=tdist)
    assert got.zs.shape == (5, DZ) and got.n_failures == want.n_failures == 0
    _close(got.ms, want.ms, 1e-12)
    _close(got.zs, want.zs, 0)
    _close(got.qs, want.qs, 1e-10)
    assert int(got.iterations.max()) >= 2


def _replayed(seed, tag, n, chunk, noise_dim):
    """The JAX package's first draws of every chunk of a chunked generator:
    (noise, controls)."""
    noise, z = [], []
    for i in range(0, n, chunk):
        b = min(chunk, n - i)
        kc = jdg.chunk_keychain(seed, tag, i)
        noise.append(np.asarray(kc.normal((b, noise_dim), dtype=jnp.float64)))
        z.append(np.asarray(JUniform(DZ, -1.0, 1.0).sample_n(kc.next_key(), b)))
    return _t(np.concatenate(noise)), _t(np.concatenate(z))


def _svd_product(zz, prefix):
    return np.einsum("nqr,nr,nmr->nqm", zz[f"U{prefix}_data"],
                     zz[f"sigma{prefix}_data"], zz[f"V{prefix}_data"])


@pytest.mark.parametrize("kind", ["JstarPhi", "Jsvd"])
def test_data_generator_with_control_matches_jax(kind, tmp_path):
    jobs, jpr, tobs, tpr, tdist = _problems()
    n, chunk = 5, 3
    Phi = np.linalg.qr(np.random.default_rng(6).standard_normal((N_OBS, 4)))[0]
    kw = dict(output_decoder=Phi) if kind == "JstarPhi" else {}
    settings = dict(chunk_size=chunk, verbose=False, rM=3, rZ=2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JDataGenerator(jobs, jpr, control_distribution=JUniform(DZ, -1.0, 1.0),
                   settings=settings).generate(
        n, derivatives=(1, 1), data_dir=jdir, **kw)
    noise, controls = _replayed(0, 0, n, chunk, tpr.noise_dim)
    gen = TDataGenerator(tobs, tpr, control_distribution=tdist,
                         settings=settings)
    gen.generate(n, derivatives=(1, 1), data_dir=tdir, noise=noise,
                 controls=controls, **kw)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert set(gen.stage_seconds) == {"forward", "jacobian", "jacobian_z", "write"}
    assert gen.samples["iterations"].shape == (n,)
    mzq_j, mzq_t = (np.load(os.path.join(d, "mzq_data.npz")) for d in (jdir, tdir))
    assert sorted(mzq_t.files) == sorted(mzq_j.files) == ["m_data", "q_data",
                                                          "z_data"]
    _close(mzq_t["m_data"], mzq_j["m_data"], 1e-12)
    _close(mzq_t["z_data"], mzq_j["z_data"], 1e-15)
    _close(mzq_t["q_data"], mzq_j["q_data"], 1e-10)
    names = (["JstarPhi_data", "JzstarPhi_data"] if kind == "JstarPhi"
             else ["Jsvd_data", "Jzsvd_data"])
    for name in names:
        zj, zt = (np.load(os.path.join(d, name + ".npz")) for d in (jdir, tdir))
        assert sorted(zt.files) == sorted(zj.files)
        if kind == "JstarPhi":
            for key in zj.files:
                _close(zt[key], zj[key], 1e-9)
        else:
            prefix = "z" if name.startswith("Jz") else ""
            assert zt[f"sigma{prefix}_data"].shape == (n, 2 if prefix else 3)
            _close(zt[f"sigma{prefix}_data"], zj[f"sigma{prefix}_data"], 1e-9)
            _close(_svd_product(zt, prefix), _svd_product(zj, prefix), 1e-9)


class Killed(Exception):
    pass


def test_data_generator_with_control_resumes_bit_exact(tmp_path, monkeypatch):
    _, _, tobs, tpr, tdist = _problems()
    Phi = np.linalg.qr(np.random.default_rng(9).standard_normal((N_OBS, 3)))[0]

    def run(d):
        TDataGenerator(tobs, tpr, control_distribution=tdist,
                       settings=dict(chunk_size=2, verbose=False)).generate(
            5, derivatives=(1, 1), output_decoder=Phi, data_dir=str(d))

    run(tmp_path / "ref")
    real, calls = tdg.materialize_jacobians, [0]

    def killed_on_fourth(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 4:
            raise Killed
        return real(*args, **kwargs)

    with monkeypatch.context() as mp:
        mp.setattr(tdg, "materialize_jacobians", killed_on_fourth)
        with pytest.raises(Killed):
            run(tmp_path / "run")
    assert os.listdir(tmp_path / "run" / "chunks") == ["chunk_0_2.npz"]
    run(tmp_path / "run")
    for f in ("mzq_data.npz", "JstarPhi_data.npz", "JzstarPhi_data.npz"):
        with np.load(tmp_path / "run" / f) as a, np.load(tmp_path / "ref" / f) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (f, k)


def test_pod_with_control_matches_jax(tmp_path):
    jobs, jpr, tobs, tpr, tdist = _problems()
    jkc, jdist, tkc = _given(4)
    jp, tp = JPODParams(), TPODParams()
    for p in (jp, tp):
        p["sample_per_process"], p["rank"], p["oversampling"] = 6, 4, 2
        p["verbose"], p["chunk_size"], p["data_per_process"] = False, 4, 5
    jpod = JPOD(jobs, jpr, control_distribution=jdist, parameters=jp)
    jpod.keychain = jkc
    tpod = TPOD(tobs, tpr, control_distribution=tdist, parameters=tp)
    tpod.keychain = tkc
    jd, jU, _ = jpod.construct_subspace()
    td, tU, _ = tpod.construct_subspace()
    _close(tpod.samples.zs, jpod.samples.zs, 0)
    _close(td, jd, 1e-9)
    _close(tU[:, :3] @ tU[:, :3].T, np.asarray(jU[:, :3] @ jU[:, :3].T), 1e-9)
    u_mean = tpod.solve_at_mean()
    want = jobs.problem.solve_fwd(jpr.mean, jnp.zeros(DZ))[0]
    _close(u_mean, want, 1e-10)
    noise, controls = _replayed(0, 1, 5, 4, tpr.noise_dim)
    tpod.generate_training_data(str(tmp_path), noise=noise, controls=controls)
    with np.load(tmp_path / "mq_data.npz") as data:
        assert sorted(data.files) == ["m_data", "q_data", "z_data"]
        _close(data["z_data"], controls, 0)


def test_low_rank_control_jacobians_match_jax(tmp_path):
    jobs, jpr, tobs, tpr, tdist = _problems()
    jkc, jdist, tkc = _given(5)
    jp, tp = JASParams(), TASParams()
    for p in (jp, tp):
        p["samples_per_process"], p["jacobian_rank"] = 4, 6
        p["control_jacobian_rank"], p["verbose"], p["chunk_size"] = 3, False, 3
    jas = JAS(jobs, jpr, control_distribution=jdist, parameters=jp)
    jas.keychain = jkc
    tas = TAS(tobs, tpr, parameters=tp, control_distribution=tdist)
    tas.keychain = tkc
    jU, js, jV = jas.construct_low_rank_control_Jacobians(str(tmp_path / "jax"))
    tU, ts, tV = tas.construct_low_rank_control_Jacobians(str(tmp_path / "port"))
    assert tU.shape == (4, N_OBS, 3) and tV.shape == (4, DZ, 3)
    _close(ts, js, 1e-9)
    _close(torch.einsum("nqr,nr,nmr->nqm", tU, ts, tV),
           np.einsum("nqr,nr,nmr->nqm", jU, js, jV), 1e-9)
    with np.load(tmp_path / "port" / "Jzsvd_data.npz") as z:
        assert sorted(z.files) == ["Uz_data", "Vz_data", "sigmaz_data"]
    assert not os.path.exists(tmp_path / "port" / "chunksz")


def test_problem_helpers_match_jax():
    """has_control, generate_state / parameter / control, the variable
    constants, evalGradientParameter (C^T p) and linearize_batch."""
    from hippyflow_tpu.models import pde_problem as jpp
    from hippyflow_tpu_torch.models import pde_problem as tpp
    from hippyflow_tpu_torch.models import linearize_batch

    jobs, _, tobs, _, _ = _problems()
    jp, tp = jobs.problem, tobs.problem
    assert (tpp.STATE, tpp.PARAMETER, tpp.ADJOINT, tpp.CONTROL) == (
        jpp.STATE, jpp.PARAMETER, jpp.ADJOINT, jpp.CONTROL)
    assert tp.has_control and tobs.is_control_problem
    for name in ("generate_state", "generate_parameter", "generate_control"):
        assert getattr(tp, name)().shape == getattr(jp, name)().shape
    u, m, z = _point()
    p = np.random.default_rng(8).standard_normal(u.shape)
    want = jax.vmap(jp.evalGradientParameter)(u, m, p, z)
    _close(tp.evalGradientParameter(_t(u), _t(m), _t(p), _t(z)), want, 1e-12)
    lin = linearize_batch(tobs, _t(m), _t(u), _t(z))
    rhs = _t(p)
    x = tp.solve_incremental(lin, rhs, is_adj=True)
    _close(x, tp.solve_incremental(tp.linearize(_t(u), _t(m), _t(z)), rhs,
                                   is_adj=True), 0)


def test_resampled_lanes_draw_new_controls():
    """A lane whose solve fails is resampled with new noise and, after it,
    new controls from the same stream (the JAX package's order); given
    controls are not written to."""
    _, _, tobs, tpr, tdist = _problems()
    problem, calls = tobs.problem, [0]
    real = problem.solve_fwd

    def first_lane_fails_once(m, z=None, u0=None):
        u, info = real(m, z=z, u0=u0)
        calls[0] += 1
        if calls[0] == 1:
            info = info._replace(converged=info.converged.clone())
            info.converged[1] = False
        return u, info

    controls = _t(np.random.default_rng(11).uniform(-1, 1, (3, DZ)))
    given = controls.clone()
    problem.solve_fwd = first_lane_fails_once
    try:
        batch = sample_until_solved(tobs, tpr, GivenNoise(
            np.random.default_rng(12), "cpu"), 3, controls=controls,
            control_distribution=tdist)
    finally:
        del problem.solve_fwd
    assert torch.equal(controls, given)
    rng = np.random.default_rng(12)
    rng.standard_normal((3, tpr.noise_dim))  # the chunk's noise
    rng.standard_normal((3, tpr.noise_dim))  # the resampled noise
    z2 = rng.uniform(-1.0, 1.0, (3, DZ))
    assert batch.n_failures == 1 and batch.failed_ms.shape == (1, tpr.dim)
    _close(batch.zs[[0, 2]], given[[0, 2]], 0)
    _close(batch.zs[1], z2[0], 0)
