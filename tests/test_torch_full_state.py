"""The port's full-state paths against the JAX package, in float64 on the
CPU, on the linear Poisson control problem (``testing.py``) at nx=8 (81
dofs, 25 controls), with the same numpy samples, probes and draws.

* ``StateSpaceIdentityOperator`` (with and without the mass matrix),
  ``DomainRestrictedOperator`` and ``LinearStateObservable``'s
  ``parameter_projection`` (indicator and matrix): 1e-12;
* the input active subspace of the full-state observable, batched
  matrix-free and serialized, against JAX's on shared samples and probe:
  spectra to 1e-10, decoders through their leading projector to 1e-9; the
  port's two strategies against each other to 1e-11 (short last chunk
  included), never materializing a Jacobian; the output subspace the same
  way;
* the unpreconditioned HEP (materialized and matrix-free) and its
  ``test_errors``: 1e-10;
* ``test_errors_double_loop`` on given noise: the averages and spreads to
  1e-10, the same discard counts;
* ``two_step_generate``: every array of its files against JAX's from the
  same draws, 1e-9 (the POD basis up to the sign of each column);
* ``PODProjector.two_state_solution`` and
  ``save_mass_and_stiffness_matrices``: their files.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hippyflow_tpu import testing as jt
from hippyflow_tpu.models import (
    ActiveSubspaceParameterList as JASParams,
    ActiveSubspaceProjector as JAS,
    DataGenerator as JDataGenerator,
    DomainRestrictedOperator as JDomain,
    LinearStateObservable as JObservable,
    PODParameterList as JPODParams,
    PODProjector as JPOD,
    StateSpaceIdentityOperator as JIdentity,
    UniformDistribution as JUniform,
)
from hippyflow_tpu.models import data_generator as jdg
from hippyflow_tpu_torch import testing as tt
from hippyflow_tpu_torch.models import (
    ActiveSubspaceParameterList as TASParams,
    ActiveSubspaceProjector as TAS,
    DataGenerator as TDataGenerator,
    DomainRestrictedOperator,
    LinearStateObservable,
    ObservableJacobian,
    PODParameterList as TPODParams,
    PODProjector as TPOD,
    StateSpaceIdentityOperator,
)
from hippyflow_tpu_torch.utils import GivenNoise

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N, DZ, N_OBS = 8, 8, 25, 15
RANK, OVERSAMPLING = 12, 6


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


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _problems():
    """(JAX pde, prior, space; port pde, prior, control distribution,
    space; samples ms, controls zs, probes)."""
    st = jt.poisson_control_settings()
    st["nx"] = st["ny"] = NX
    jpde, jpr, _, jV = jt.setup_poisson_control_problem(st)
    tpde, tpr, tdist, tV = tt.setup_poisson_control_problem(st, **F64)
    rng = np.random.default_rng(0)
    ms = tpr.sample(_t(rng.standard_normal((N, tV.dim)))).numpy()
    zs = rng.uniform(-1.0, 1.0, (N, DZ))
    probes = {"GN": rng.standard_normal((tV.dim, RANK + OVERSAMPLING)),
              "NG": rng.standard_normal((tV.dim, RANK + OVERSAMPLING))}
    return jpde, jpr, jV, tpde, tpr, tdist, tV, ms, zs, probes


def _observables(kind):
    jpde, _, jV, tpde, _, _, tV, *_ = _problems()
    if kind == "full":
        return (jt.poisson_full_state_observable(jpde, jV),
                tt.poisson_full_state_observable(tpde, tV))
    return (jt.poisson_pointwise_observable(jpde, jV, n_obs=N_OBS),
            tt.poisson_pointwise_observable(tpde, tV, n_obs=N_OBS))


def _projectors(kind, serialized, chunk_size=None, jax_side=True):
    """Both packages' projectors on the shared samples and probes (JAX's
    None where not asked for)."""
    jpde, jpr, _, _, tpr, tdist, _, ms, zs, probes = _problems()
    jobs, tobs = _observables(kind)
    out = []
    for P, AS, obs, pr, dist, conv in (
            (JASParams, JAS, jobs, jpr, JUniform(DZ, -1.0, 1.0), jnp.asarray),
            (TASParams, TAS, tobs, tpr, tdist, _t)):
        if AS is JAS and not jax_side:
            out.append(None)
            continue
        p = P()
        p["rank"], p["oversampling"], p["samples_per_process"] = (
            RANK, OVERSAMPLING, N)
        p["serialized_sampling"], p["chunk_size"] = serialized, chunk_size
        p["ms_given"], p["verbose"] = True, False
        proj = AS(obs, pr, control_distribution=dist, parameters=p)
        proj.ms, proj.zs = conv(ms), conv(zs)
        proj.Omega_GN, proj.Omega_NG = conv(probes["GN"]), None
        out.append(proj)
    return out


def _lead_projector(V, k=4):
    V = np.asarray(V)[:, :k]
    return V @ V.T


# -- the observables ------------------------------------------------------------

@pytest.mark.parametrize("use_mass", [True, False])
def test_state_identity_operator_matches_jax(use_mass):
    _, _, jV, _, _, _, tV, *_ = _problems()
    jB = JIdentity(jV, use_mass_matrix=use_mass)
    tB = StateSpaceIdentityOperator(tV, use_mass_matrix=use_mass, **F64)
    assert not tB.materializable and tB.dim == tB.state_dim == tV.dim
    rng = np.random.default_rng(1)
    q, Q = rng.standard_normal((3, tV.dim)), rng.standard_normal((3, tV.dim, 4))
    np.testing.assert_array_equal(tB.apply(_t(q)).numpy(), q)
    want = np.stack([np.asarray(jB.applyt(jnp.asarray(x))) for x in q])
    assert _rel(tB.applyt(_t(q)), want) < 1e-12
    want = np.stack([np.asarray(jB.applyt(jnp.asarray(x))) for x in Q])
    assert _rel(tB.applyt(_t(Q)), want) < 1e-12
    np.testing.assert_array_equal(tB.dense().numpy(), np.asarray(jB.dense()))


def test_domain_restricted_operator_matches_jax():
    jobs, tobs = _observables("pointwise")
    _, _, _, _, _, _, tV, *_ = _problems()
    ind = (tV.dof_coords[:, 0] < 0.5).astype(float)
    jB, tB = JDomain(ind, jobs.B), DomainRestrictedOperator(ind, tobs.B)
    assert tB.materializable and tB.dim == N_OBS
    rng = np.random.default_rng(2)
    u, q = rng.standard_normal((3, tV.dim, 2)), rng.standard_normal((3, N_OBS))
    assert _rel(tB.apply(_t(u)), np.stack(
        [np.asarray(jB.apply(jnp.asarray(x))) for x in u])) < 1e-12
    assert _rel(tB.applyt(_t(q)), np.stack(
        [np.asarray(jB.applyt(jnp.asarray(x))) for x in q])) < 1e-12
    assert _rel(tB.dense(), jB.dense()) < 1e-15


@pytest.mark.parametrize("projection", ["indicator", "matrix"])
def test_parameter_projection_matches_jax(projection):
    jpde, _, _, tpde, _, _, tV, ms, zs, _ = _problems()
    jobs, tobs = _observables("pointwise")
    ind = (tV.dof_coords[:, 0] < 0.5).astype(float)
    if projection == "indicator":
        P = ind
    else:
        W = np.random.default_rng(3).standard_normal((tV.dim, 4))
        P = W @ np.linalg.pinv(W)  # a projector onto four directions
    jo = JObservable(jpde, jobs.B, parameter_projection=P)
    to = LinearStateObservable(tpde, tobs.B, parameter_projection=P)
    m, z = _t(ms[:3]), _t(zs[:3])
    lin = to.linearize(m, z=z)
    rng = np.random.default_rng(4)
    dm, dp = rng.standard_normal((3, tV.dim)), rng.standard_normal((3, tV.dim))
    got_c, got_ct = to.applyC(lin, _t(dm)), to.applyCt(lin, _t(dp))

    def one(m, z, dm, dp):
        jlin = jo.linearize(m, z=z)
        return jo.applyC(jlin, dm), jo.applyCt(jlin, dp)

    want_c, want_ct = jax.jit(jax.vmap(one))(
        *(jnp.asarray(x) for x in (ms[:3], zs[:3], dm, dp)))
    assert _rel(got_c, want_c) < 1e-12
    assert _rel(got_ct, want_ct) < 1e-12
    if projection == "indicator":
        # a perturbation outside the subdomain has no effect
        outside = _t(np.where(ind > 0, 0.0, dm))
        assert float(to.applyC(lin, outside).abs().max()) < 1e-13


# -- the matrix-free strategies --------------------------------------------------

def _no_materialize(monkeypatch):
    def refuse(self, lin):
        raise AssertionError("materialize called on a matrix-free path")

    monkeypatch.setattr(ObservableJacobian, "materialize", refuse)


@functools.lru_cache(maxsize=None)
def _jax_spectra(serialized, which):
    jproj, _ = _projectors("full", serialized)
    if which == "input":
        d, dec, enc = jproj.construct_input_subspace()
    else:
        _, _, _, _, _, _, _, _, _, probes = _problems()
        jproj.Omega_NG = jnp.asarray(probes["NG"])
        d, dec, enc = jproj.construct_output_subspace()
    return np.asarray(d), np.asarray(dec), np.asarray(enc)


@pytest.mark.parametrize("which", ["input", "output"])
@pytest.mark.parametrize("serialized", [False, True])
def test_full_state_subspaces_match_jax(serialized, which, monkeypatch):
    _no_materialize(monkeypatch)
    _, tproj = _projectors("full", serialized, jax_side=False)
    if which == "input":
        d, dec, enc = tproj.construct_input_subspace()
        stages = {"forward", "ghep"} | (set() if serialized else {"linearize"})
        assert set(tproj.stage_seconds) == stages
        assert tproj.Js is None and (tproj.lins is None) == serialized
    else:
        tproj.Omega_NG = _t(_problems()[-1]["NG"])
        d, dec, enc = tproj.construct_output_subspace()
    jd, jdec, jenc = _jax_spectra(serialized, which)
    assert _rel(d, jd) < 1e-10
    assert _rel(_lead_projector(dec), _lead_projector(jdec)) < 1e-9
    assert _rel(enc.T @ dec, jenc.T @ jdec) < 1e-9


@pytest.mark.parametrize("which", ["input", "output"])
def test_port_strategies_agree(which, monkeypatch):
    """Batched matrix-free against serialized, chunks of 3 (a short last
    chunk of 2) and of 16 (one chunk), as the JAX package's own test."""
    _no_materialize(monkeypatch)
    runs = []
    for serialized, chunk in ((False, None), (True, 3), (True, 16)):
        _, tproj = _projectors("full", serialized, chunk, jax_side=False)
        if which == "input":
            runs.append(tproj.construct_input_subspace())
        else:
            tproj.Omega_NG = _t(_problems()[-1]["NG"])
            runs.append(tproj.construct_output_subspace())
    for d, dec, _ in runs[1:]:
        assert float(torch.linalg.vector_norm(d - runs[0][0])
                     / torch.linalg.vector_norm(runs[0][0])) < 1e-11
        assert _rel(_lead_projector(dec), _lead_projector(runs[0][1])) < 1e-9


def test_serialized_pointwise_matches_materialized():
    """On a pointwise observable the serialized strategy agrees with the
    materialized one (the reference's batched-versus-serialized test)."""
    runs = []
    for serialized in (False, True):
        _, tproj = _projectors("pointwise", serialized, 3, jax_side=False)
        runs.append(tproj.construct_input_subspace())
        assert (tproj.Js is None) == serialized
    assert float(torch.linalg.vector_norm(runs[0][0] - runs[1][0])) < 1e-11 * float(
        torch.linalg.vector_norm(runs[0][0]))


# -- the unpreconditioned HEP and the double loop ---------------------------------

@pytest.mark.parametrize("kind", ["pointwise", "full"])
def test_unpreconditioned_hep_and_its_errors_match_jax(kind):
    jproj, tproj = _projectors(kind, False)
    jd, jV, jE = jproj.construct_input_subspace(prior_preconditioned=False)
    td, tV, tE = tproj.construct_input_subspace(prior_preconditioned=False)
    assert tE is tV and tproj.prior_preconditioned is False
    assert _rel(td, jd) < 1e-10
    assert _rel(_lead_projector(tV), _lead_projector(jV)) < 1e-9
    eye = torch.eye(RANK, **F64)
    assert float((tV.T @ tV - eye).abs().max()) < 1e-10
    jproj.keychain = JaxGivenNoise(np.random.default_rng(8))
    tproj.keychain = GivenNoise(np.random.default_rng(8), "cpu")
    ranks = (2, 6)
    je = jproj.test_errors(ranks=ranks, n_samples=5)
    te = tproj.test_errors(ranks=ranks, n_samples=5)
    for r in ranks:
        assert np.allclose(te[("input", r)], je[("input", r)], rtol=1e-10, atol=0)


def test_double_loop_matches_jax():
    jproj, tproj = _projectors("pointwise", False)
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    jproj.construct_input_subspace()
    tproj.construct_input_subspace()
    jproj.keychain, jproj.control_distribution = (JaxGivenNoise(jrng),
                                                  JaxGivenUniform(jrng))
    tproj.keychain = GivenNoise(trng, "cpu")
    ranks = (2, 6, RANK)
    je = jproj.test_errors_double_loop(ranks=ranks, n_samples=6,
                                       double_loop_samples=4)
    te = tproj.test_errors_double_loop(ranks=ranks, n_samples=6,
                                       double_loop_samples=4)
    assert set(te) == set(je)
    for r in ranks:
        assert te[("double_loop_discarded", r)] == je[("double_loop_discarded", r)]
        assert np.allclose(te[("double_loop", r)], je[("double_loop", r)],
                           rtol=1e-10, atol=0)
    assert tproj._double_loop_errors == [te[("double_loop", r)][0] for r in ranks]
    errs = tproj._double_loop_errors
    assert errs[0] >= errs[1] >= errs[2]


def test_double_loop_discards_failed_solves():
    """A failed inner solve (non-finite here) leaves its outer sample's
    mean over the survivors; a failed outer solve is discarded."""
    _, tproj = _projectors("pointwise", False, jax_side=False)
    tproj.construct_input_subspace()
    real = tproj._fresh_solves
    calls = []

    def failing(ms, zs=None):
        qs, ok, its = real(ms, zs)
        calls.append(ms.shape[0])
        ok = ok.clone()
        if len(calls) == 1:
            ok[0] = False  # the first outer sample
        else:
            qs = qs.clone()
            qs[1], ok[1] = float("nan"), False  # one inner sample
        return qs, ok, its

    tproj._fresh_solves = failing
    out = tproj.test_errors_double_loop(ranks=(4,), n_samples=5,
                                        double_loop_samples=3)
    assert calls == [5, 12]
    assert out[("double_loop_discarded", 4)] == (1, 1)
    assert np.isfinite(out[("double_loop", 4)]).all()


# -- two-step generation and the POD extras --------------------------------------

def _replayed(n, chunk, noise_dim, seed=0, tag=0):
    """The JAX generator's draws per chunk: (noise, controls)."""
    noise, z = [], []
    for i in range(0, n, chunk):
        b = min(chunk, n - i)
        kc = jdg.chunk_keychain(seed, tag, i)
        noise.append(np.asarray(kc.normal((b, noise_dim), dtype=jnp.float64)))
        z.append(np.asarray(JUniform(DZ, -1.0, 1.0).sample_n(kc.next_key(), b)))
    return _t(np.concatenate(noise)), _t(np.concatenate(z))


def test_two_step_generate_matches_jax(tmp_path):
    _, jpr, _, _, tpr, tdist, tV, *_ = _problems()
    jobs, tobs = _observables("full")
    n, chunk, rank = 6, 3, 4
    settings = dict(chunk_size=chunk, verbose=False)
    jdir, tdir = str(tmp_path / "jax") + "/", str(tmp_path / "port") + "/"
    JDataGenerator(jobs, jpr, control_distribution=JUniform(DZ, -1.0, 1.0),
                   settings=settings).two_step_generate(
        n, derivatives=(1, 1), pod_rank=rank, data_dir=jdir)
    noise, controls = _replayed(n, chunk, tpr.noise_dim)
    TDataGenerator(tobs, tpr, control_distribution=tdist,
                   settings=settings).two_step_generate(
        n, derivatives=(1, 1), pod_rank=rank, data_dir=tdir, noise=noise,
        controls=controls)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir + "POD")) == sorted(os.listdir(jdir + "POD"))
    load = lambda d, f: np.load(os.path.join(d, f))
    jphi, tphi = load(jdir, "POD/POD_decoder.npy"), load(tdir, "POD/POD_decoder.npy")
    assert tphi.shape == (tV.dim, rank)
    sign = np.sign((jphi * tphi).sum(axis=0))  # each column's sign
    for f in ("POD/d_POD.npy", "POD/POD_shift.npy"):
        assert _rel(load(tdir, f), load(jdir, f)) < 1e-9, f
    for f in ("POD/POD_decoder.npy", "POD/POD_encoder.npy"):
        assert _rel(load(tdir, f) * sign, load(jdir, f)) < 1e-9, f
    for name, key in (("JstarPhi_data", "JstarPhi_data"),
                      ("JzstarPhi_data", "JzstarPhi_data")):
        zt, zj = load(tdir, name + ".npz"), load(jdir, name + ".npz")
        assert sorted(zt.files) == sorted(zj.files)
        assert zt[key].shape == ((n, tV.dim, rank) if name == "JstarPhi_data"
                                 else (n, DZ, rank))
        assert _rel(zt[key] * sign, zj[key]) < 1e-9, name
        assert _rel(zt["Phi"] * sign, zj["Phi"]) < 1e-9
    zt, zj = load(tdir, "mzq_data.npz"), load(jdir, "mzq_data.npz")
    for key in ("m_data", "q_data", "z_data"):
        assert _rel(zt[key], zj[key]) < 1e-9, key


def _no_control_problems():
    """The JAX package's POD-extras problem (log-diffusion Poisson, unit
    source, u = 0 on the boundary, no control) in both packages, with a
    pointwise observable and the dense BiLaplacian prior."""
    import hippyflow_tpu as hf
    from hippyflow_tpu.models import BiLaplacianPrior as JBiLaplacian
    from hippyflow_tpu_torch.fem import (
        DirichletBC, FunctionSpace, GalerkinForm, unit_square_mesh)
    from hippyflow_tpu_torch.models import BiLaplacianPrior, VariationalPDEProblem

    jV = hf.FunctionSpace(hf.unit_square_mesh(NX))
    jform = hf.GalerkinForm(flux=lambda x, u, gu, m, z, c: jnp.exp(m) * gu,
                            source=lambda x, u, gu, m, z, c: -1.0)
    jpde = hf.VariationalPDEProblem(jV, jV, jform, hf.DirichletBC.from_predicate(
        jV, None, 0.0), is_fwd_linear=True)
    tV = FunctionSpace(unit_square_mesh(NX))
    tform = GalerkinForm(flux=lambda x, u, gu, m, z, c: torch.exp(m)[..., None] * gu,
                         source=lambda x, u, gu, m, z, c: -1.0 + 0.0 * u)
    tpde = VariationalPDEProblem(tV, tV, tform, DirichletBC.from_predicate(
        tV, None, 0.0), is_fwd_linear=True, **F64)
    return ((jt.poisson_pointwise_observable(jpde, jV, n_obs=N_OBS),
             JBiLaplacian(jV, gamma=0.1, delta=1.0)),
            (tt.poisson_pointwise_observable(tpde, tV, n_obs=N_OBS),
             BiLaplacianPrior(tV, gamma=0.1, delta=1.0, **F64)))


def test_pod_extras_match_jax(tmp_path):
    (jobs, jpr), (tobs, tpr) = _no_control_problems()
    outs = {}
    for name, Params, POD, obs, pr, kc in (
            ("jax", JPODParams, JPOD, jobs, jpr, JaxGivenNoise),
            ("port", TPODParams, TPOD, tobs, tpr,
             lambda rng: GivenNoise(rng, "cpu"))):
        p = Params()
        p["verbose"], p["output_directory"] = False, str(tmp_path / name)
        pod = POD(obs, pr, parameters=p)
        pod.keychain = kc(np.random.default_rng(12))
        outs[name] = pod.two_state_solution()
        pod.save_mass_and_stiffness_matrices()
    (tm, tu), (tms, tus) = outs["port"]
    assert tu.shape == tm.shape == (tpr.dim,)
    for f in ("m_mean", "u_at_mean", "m_sample", "u_at_sample"):
        got = np.load(tmp_path / "port" / "two_states" / f"{f}.npy")
        want = np.load(tmp_path / "jax" / "two_states" / f"{f}.npy")
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max()), f
        assert os.path.exists(tmp_path / "port" / "two_states" / f"{f}.vtk")
    for f in ("mass_csr.npz", "stiffness_csr.npz"):
        got = sp.load_npz(tmp_path / "port" / f).toarray()
        want = sp.load_npz(tmp_path / "jax" / f).toarray()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
