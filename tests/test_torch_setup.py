"""The port's reduced-basis setup path against the JAX package, in float64
on the CPU: confusion at nx=12 (analytic velocity, 16 observations).

Both packages see the same noise: given samples and probe blocks
(``ms_given``, ``Omega_GN``, ``Omega_NG``), projectors whose ``keychain``
draws the same numpy stream (``GivenNoise`` here, a twin on the JAX
side), and, for the chunked generators, the JAX package's per-chunk draws
replayed from its ``chunk_keychain`` and given to the port as ``noise``.

* ``ObservableJacobian.mult``/``transpmult`` (and ``jtj_matmat``,
  ``jjt_matmat``) against JAX and against ``materialize``: 1e-10 relative;
* the output subspace, ``test_errors`` (input and output) and the
  low-rank Jacobians: 1e-9 relative (eigen- and singular vectors through
  their projectors or products), the fresh solves' Newton iterations
  equal to JAX's;
* POD ``construct_subspace``, ``test_output_errors`` and
  ``input_output_error_test``: 1e-9 relative, the re-solves' Newton
  iterations equal to JAX's lane by lane;
* every ``DataGenerator`` payload (JstarPhi, JPsi, Jsvd) through
  ``generate`` and ``compress_dataset``, and
  ``compute_jacobians_in_subspace``: 1e-9 relative;
* a killed ``generate_training_data``, ``construct_low_rank_Jacobians``
  and ``DataGenerator.generate`` resume to bit-identical arrays;
* the port's driver at nx=12 writes the JAX driver's file layout
  (``tests/test_drivers.py``), and ``confusion_training`` trains one sweep
  from it.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applications.confusion import (
    confusion_linear_observable as j_observable,
    confusion_prior as j_prior,
)
from hippyflow_tpu.models import (
    ActiveSubspaceParameterList as JASParams,
    ActiveSubspaceProjector as JAS,
    DataGenerator as JDataGenerator,
    ObservableJacobian as JJacobian,
    PODParameterList as JPODParams,
    PODProjector as JPOD,
)
from hippyflow_tpu.models import data_generator as jdg
from hippyflow_tpu.models.jacobian import jjt_matmat as j_jjt, jtj_matmat as j_jtj
from hippyflow_tpu_torch.applications import confusion_setup, confusion_training
from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable as t_observable,
    confusion_prior as t_prior,
)
from hippyflow_tpu_torch.models import (
    ActiveSubspaceParameterList as TASParams,
    ActiveSubspaceProjector as TAS,
    DataGenerator as TDataGenerator,
    ObservableJacobian,
    PODParameterList as TPODParams,
    PODProjector as TPOD,
    jjt_matmat,
    jtj_matmat,
)
from hippyflow_tpu_torch.models import data_generator as tdg
from hippyflow_tpu_torch.models import pod as tpod_module
from hippyflow_tpu_torch.utils import GivenNoise

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, SQRT_OBS = 12, 4
N, RANK, OVERSAMPLING = 10, 6, 4


class JaxGivenNoise:
    """The JAX side's keychain: the same numpy stream as ``GivenNoise``."""

    def __init__(self, rng):
        self.rng = rng

    def normal(self, shape, dtype=None, sigma=1.0):
        return sigma * jnp.asarray(self.rng.standard_normal(shape),
                                   dtype=dtype or jnp.float64)


def _given(seed):
    return (JaxGivenNoise(np.random.default_rng(seed)),
            GivenNoise(np.random.default_rng(seed), "cpu"))


@functools.lru_cache(maxsize=None)
def _problems():
    jobs, jV = j_observable(nx=NX, sqrt_n_obs=SQRT_OBS, velocity="analytic")
    tobs, tV = t_observable(nx=NX, sqrt_n_obs=SQRT_OBS, velocity="analytic",
                            **F64)
    return jobs, j_prior(jV), tobs, t_prior(tV, **F64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _separated(d, ranks, rel=1e-6, head=1e-4):
    """The ranks r with d[r-1] above head * d[0] (as the parity checks cut
    eigenvalues) and d[r-1], d[r] apart by more than rel * d[0]: the cuts
    at which the first r eigenvectors' span is well conditioned."""
    d = np.abs(np.asarray(d))
    return [r for r in ranks if d[r - 1] > head * d[0]
            and (r == len(d) or abs(d[r - 1] - d[r]) > rel * d[0])]


def _j_solve(jobs, ms):
    """JAX's vmapped cold solve_fwd: (us, converged, iterations)."""
    u, info = jax.vmap(lambda m: jobs.problem.solve_fwd(m))(jnp.asarray(ms))
    return np.asarray(u), np.asarray(info.converged), np.asarray(info.iterations)


# -- Jacobian actions ---------------------------------------------------------

def test_jacobian_actions_match_jax_and_materialize():
    jobs, _, tobs, tpr = _problems()
    rng = np.random.default_rng(1)
    n, k = 3, 4
    m = tpr.sample(torch.as_tensor(rng.standard_normal((n, tpr.noise_dim))))
    u, info = tobs.problem.solve_fwd(m)
    assert info.converged.all()
    lin = tobs.problem.linearize(u, m)
    J = ObservableJacobian(tobs)
    Jmat = J.materialize(lin)  # (n, dQ, dM)
    dm = torch.as_tensor(rng.standard_normal((n, tobs.dM, k)))
    dq = torch.as_tensor(rng.standard_normal((n, tobs.dQ, k)))
    Jdm, Jtdq = J.mult(lin, dm), J.transpmult(lin, dq)
    _close(Jdm, (Jmat @ dm).numpy(), 1e-10)
    _close(Jtdq, (Jmat.mT @ dq).numpy(), 1e-10)
    _close(J.mult(lin, dm[..., 0]), Jdm[..., 0].numpy(), 1e-12)
    _close(J.transpmult(lin, dq[..., 0]), Jtdq[..., 0].numpy(), 1e-12)
    X = torch.as_tensor(rng.standard_normal((tobs.dM, 2)))
    Y = torch.as_tensor(rng.standard_normal((tobs.dQ, 2)))
    jtj, jjt = jtj_matmat(J, lin)(X), jjt_matmat(J, lin)(Y)
    JJ = JJacobian(jobs)

    def one(uu, mm, a, b):
        jlin = jobs.problem.linearize(uu, mm)
        return (JJ.mult(jlin, a), JJ.transpmult(jlin, b),
                j_jtj(JJ, jlin)(jnp.asarray(X.numpy())),
                j_jjt(JJ, jlin)(jnp.asarray(Y.numpy())))

    want = jax.jit(jax.vmap(one))(*(jnp.asarray(x.numpy()) for x in (u, m, dm, dq)))
    for got, w in zip((Jdm, Jtdq, jtj, jjt), want):
        for i in range(n):
            _close(got[i], w[i], 1e-10)


# -- active subspaces: output subspace, error tests, low-rank Jacobians ----------

@functools.lru_cache(maxsize=None)
def _as_runs():
    jobs, jpr, tobs, tpr = _problems()
    rng = np.random.default_rng(2)
    xi = rng.standard_normal((N, tpr.noise_dim))
    om_gn = rng.standard_normal((tobs.dM, RANK + OVERSAMPLING))
    om_ng = rng.standard_normal((tobs.dQ, min(RANK + OVERSAMPLING, tobs.dQ)))
    jkc, tkc = _given(3)
    out = []
    for cls, params, obs, pr, kc, arr in (
        (JAS, JASParams(), jobs, jpr, jkc, jnp.asarray),
        (TAS, TASParams(), tobs, tpr, tkc, torch.as_tensor),
    ):
        params["rank"], params["oversampling"] = RANK, OVERSAMPLING
        params["samples_per_process"], params["jacobian_rank"] = N, 4
        params["ms_given"], params["verbose"] = True, False
        params["error_test_samples"] = 8
        proj = cls(obs, pr, parameters=params)
        proj.ms = pr.sample(arr(xi))
        proj.Omega_GN, proj.Omega_NG = arr(om_gn), arr(om_ng)
        proj.keychain = kc
        res = {"in": proj.construct_input_subspace(),
               "out": proj.construct_output_subspace()}
        ranks = _separated(res["out"][0], range(1, RANK + 1))
        ranks = [r for r in ranks if r in _separated(res["in"][0], ranks)]
        res["errors"] = proj.test_errors(ranks=ranks, test_input=True,
                                         test_output=True)
        res["svd"] = proj.construct_low_rank_Jacobians(None)
        out.append((proj, res))
    return out


def test_output_subspace_matches_jax():
    (jproj, jr), (tproj, tr) = _as_runs()
    d_j, U_j, E_j = map(np.asarray, jr["out"])
    d_t, U_t, E_t = map(_np, tr["out"])
    assert d_t.shape == (RANK,) and U_t.shape == (tproj.observable.dQ, RANK)
    assert np.abs(d_t - d_j).max() <= 1e-9 * d_j[0]
    assert np.all(np.diff(d_t) <= 0)
    np.testing.assert_array_equal(U_t, E_t)
    np.testing.assert_allclose(U_t.T @ U_t, np.eye(RANK), atol=1e-12)
    for r in _separated(d_j, range(1, RANK + 1)):
        _close(U_t[:, :r] @ U_t[:, :r].T, U_j[:, :r] @ U_j[:, :r].T, 1e-9)
    # the Jacobians of the input subspace were reused, not solved again
    assert tproj.Js.shape == (N, tproj.observable.dQ, tproj.observable.dM)


def test_as_test_errors_match_jax():
    (jproj, jr), (tproj, tr) = _as_runs()
    je, te = jr["errors"], tr["errors"]
    assert set(te) == set(je)
    assert te[("output_discarded", None)] == je[("output_discarded", None)] == 0
    inputs = sorted(r for kind, r in te if kind == "input")
    assert len(inputs) >= 3
    for key in je:
        if key[0] in ("input", "output"):
            np.testing.assert_allclose(te[key], je[key], rtol=1e-9, err_msg=str(key))
    # the output test's fresh solves: JAX's Newton iterations, lane by lane
    ms = tproj.prior.sample(GivenNoise(np.random.default_rng(3), "cpu").normal(
        (2 * 8, tproj.prior.noise_dim), dtype=torch.float64)[8:])
    _, ok, its = tproj._fresh_solves(ms)
    _, ok_j, its_j = _j_solve(jproj.observable, ms.numpy())
    np.testing.assert_array_equal(its.numpy(), its_j)
    assert ok.all() and ok_j.all()


def test_low_rank_jacobians_match_jax():
    (_, jr), (tproj, tr) = _as_runs()
    U_j, s_j, V_j = map(np.asarray, jr["svd"])
    U_t, s_t, V_t = map(_np, tr["svd"])
    dQ, dM = tproj.observable.dQ, tproj.observable.dM
    assert U_t.shape == (N, dQ, 4) and s_t.shape == (N, 4) and V_t.shape == (N, dM, 4)
    _close(s_t, s_j, 1e-9)
    _close(np.einsum("nqr,nr,nmr->nqm", U_t, s_t, V_t),
           np.einsum("nqr,nr,nmr->nqm", U_j, s_j, V_j), 1e-9)
    # the truncated SVD of the materialized Jacobians
    J = tproj.Js.numpy()
    s_ref = np.linalg.svd(J, compute_uv=False)[:, :4]
    _close(s_t, s_ref, 1e-12)


# -- POD --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pod_runs():
    jobs, jpr, tobs, tpr = _problems()
    (_, _), (tproj, _) = _as_runs()
    V = tproj.V_GN.numpy()
    rank = min(RANK, tobs.dQ)
    jkc, tkc = _given(4)
    out = []
    for cls, params, obs, pr, kc in ((JPOD, JPODParams(), jobs, jpr, jkc),
                                      (TPOD, TPODParams(), tobs, tpr, tkc)):
        params["sample_per_process"], params["rank"] = N, rank
        params["oversampling"], params["chunk_size"] = OVERSAMPLING, 6
        params["verbose"] = False
        pod = cls(obs, pr, parameters=params)
        pod.keychain = kc
        res = {"subspace": pod.construct_subspace()}
        ranks = _separated(res["subspace"][0], range(1, rank + 1))
        res["ranks"] = ranks
        res["errors"] = pod.test_output_errors(ranks=ranks)
        res["io"] = pod.input_output_error_test(
            V, Cinv_matmat=pr.R_matmat, rank_pairs=[(r, r) for r in ranks[:3]])
        out.append((pod, res))
    return out, V


def test_pod_subspace_matches_jax():
    ((jpod, jr), (tpod, tr)), _ = _pod_runs()
    _close(tpod.samples.ms, jpod.samples.ms, 1e-12)
    _close(tpod.samples.qs, jpod.samples.qs, 1e-10)
    d_j, U_j, _ = map(np.asarray, jr["subspace"])
    d_t, U_t, E_t = map(_np, tr["subspace"])
    assert d_t.shape == d_j.shape
    assert np.abs(d_t - d_j).max() <= 1e-9 * d_j[0]
    np.testing.assert_array_equal(U_t, E_t)
    for r in tr["ranks"]:
        _close(U_t[:, :r] @ U_t[:, :r].T, U_j[:, :r] @ U_j[:, :r].T, 1e-9)
    assert len(tr["ranks"]) >= 3


def test_pod_error_tests_match_jax():
    ((jpod, jr), (tpod, tr)), V = _pod_runs()
    for a, b in zip(tr["errors"], jr["errors"]):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    assert np.all(np.diff(tr["errors"][0]) < 0)
    np.testing.assert_allclose(tr["io"][0], jr["io"][0], rtol=1e-9)
    np.testing.assert_allclose(tr["io"][1], jr["io"][1], rtol=1e-9)
    # the re-solves at the projected parameters take JAX's Newton steps
    jpr = jpod.prior
    for (r, _), its, failed in zip([(r, r) for r in tr["ranks"][:3]],
                                   tpod.io_iterations, tpod.io_failed):
        Vr = jnp.asarray(V[:, :r])
        ms = jnp.asarray(jpod.samples.ms[:N])
        m_proj = (Vr @ (Vr.T @ jpr.R_matmat(ms.T))).T
        _, ok_j, its_j = _j_solve(jpod.observable, m_proj)
        np.testing.assert_array_equal(its.numpy(), its_j)
        assert failed == int((~ok_j).sum()) == 0


def test_solve_at_mean_matches_jax():
    ((jpod, _), (tpod, _)), _ = _pod_runs()
    _close(tpod.solve_at_mean(), jpod.solve_at_mean(), 1e-10)


# -- DataGenerator ------------------------------------------------------------------

def _replayed_noise(seed, tag, n, chunk, noise_dim):
    """The JAX package's first draw of every chunk of a chunked generator."""
    parts = [np.asarray(jdg.chunk_keychain(seed, tag, i).normal(
        (min(chunk, n - i), noise_dim), dtype=jnp.float64))
        for i in range(0, n, chunk)]
    return torch.as_tensor(np.concatenate(parts))


@pytest.mark.parametrize("kind", ["JstarPhi", "JPsi", "Jsvd"])
def test_data_generator_payloads_match_jax(kind, tmp_path):
    jobs, jpr, tobs, tpr = _problems()
    n, chunk = 7, 4
    rng = np.random.default_rng(6)
    Phi, _ = np.linalg.qr(rng.standard_normal((tobs.dQ, 3)))
    Psi, _ = np.linalg.qr(rng.standard_normal((tobs.dM, 5)))
    kw = {"JstarPhi": dict(output_decoder=Phi), "JPsi": dict(input_decoder=Psi),
          "Jsvd": {}}[kind]
    settings = dict(chunk_size=chunk, verbose=False, rM=3)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JDataGenerator(jobs, jpr, settings=settings).generate(
        n, derivatives=(1, 0), data_dir=jdir, **kw)
    TDataGenerator(tobs, tpr, settings=settings).generate(
        n, derivatives=(1, 0), data_dir=tdir,
        noise=_replayed_noise(0, 0, n, chunk, tpr.noise_dim), **kw)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    mq_j, mq_t = np.load(os.path.join(jdir, "mq_data.npz")), np.load(
        os.path.join(tdir, "mq_data.npz"))
    assert sorted(mq_t.files) == sorted(mq_j.files) == ["m_data", "q_data"]
    _close(mq_t["m_data"], mq_j["m_data"], 1e-12)
    _close(mq_t["q_data"], mq_j["q_data"], 1e-10)
    name = {"JstarPhi": "JstarPhi_data", "JPsi": "JPsi_data", "Jsvd": "Jsvd_data"}[kind]
    zj, zt = (np.load(os.path.join(d, name + ".npz")) for d in (jdir, tdir))
    assert sorted(zt.files) == sorted(zj.files)
    if kind == "Jsvd":
        assert zt["U_data"].shape == (n, tobs.dQ, 3)
        _close(zt["sigma_data"], zj["sigma_data"], 1e-9)
        _close(np.einsum("nqr,nr,nmr->nqm", zt["U_data"], zt["sigma_data"],
                         zt["V_data"]),
               np.einsum("nqr,nr,nmr->nqm", zj["U_data"], zj["sigma_data"],
                         zj["V_data"]), 1e-9)
    else:
        for key in zj.files:
            _close(zt[key], zj[key], 1e-9)


def test_jacobians_in_subspace_match_jax(tmp_path):
    """compute_jacobians_in_subspace linearizes at stored states (q = u)."""
    jobs, jpr, tobs, tpr = _problems()
    rng = np.random.default_rng(8)
    m = tpr.sample(torch.as_tensor(rng.standard_normal((5, tpr.noise_dim))))
    u, _ = tobs.problem.solve_fwd(m)
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
        np.savez(tmp_path / d / "mu.npz", m_data=m.numpy(), q_data=u.numpy())
    np.savez(tmp_path / "t" / "mq.npz", m_data=m.numpy(),
             q_data=tobs.evalu(u).numpy())
    Phi, _ = np.linalg.qr(rng.standard_normal((tobs.dQ, 3)))
    settings = dict(chunk_size=3, verbose=False)
    JDataGenerator(jobs, jpr, settings=settings).compute_jacobians_in_subspace(
        (1, 0), Phi, "mu.npz", str(tmp_path / "j"))
    TDataGenerator(tobs, tpr, settings=settings).compute_jacobians_in_subspace(
        (1, 0), Phi, "mu.npz", str(tmp_path / "t"))
    zj = np.load(tmp_path / "j" / "JstarPhi_data.npz")
    zt = np.load(tmp_path / "t" / "JstarPhi_data.npz")
    assert zt["JstarPhi_data"].shape == (5, tobs.dM, 3)
    for key in zj.files:
        _close(zt[key], zj[key], 1e-9)
    with pytest.raises(ValueError, match="full-state"):
        TDataGenerator(tobs, tpr, settings=settings).compute_jacobians_in_subspace(
            (1, 0), Phi, "mq.npz", str(tmp_path / "t"))


def test_chunk_bookkeeping_matches_jax(tmp_path):
    """The resume helpers on the same chunk directories."""
    for name, chunks in (("ok", [(0, 3), (3, 6)]), ("gap", [(0, 3), (4, 6)]),
                         ("stale", [(0, 3), (3, 6), (2, 5), (8, 9)])):
        dirs = []
        for pkg in ("j", "t"):
            d = tmp_path / pkg / name
            d.mkdir(parents=True)
            for a, b in chunks:
                np.savez(d / f"chunk_{a}_{b}.npz", x=np.arange(a, b))
            dirs.append(str(d))
        assert (tdg.contiguous_prefix_end(tdg._scan_chunks(dirs[1]))
                == jdg.contiguous_prefix_end(jdg.DataGenerator._scan_chunks(dirs[0])))
        assert tdg.prune_stale_chunks(dirs[1]) == jdg.prune_stale_chunks(dirs[0])
        assert sorted(os.listdir(dirs[1])) == sorted(os.listdir(dirs[0]))
        try:
            want = jdg.load_chunks_validated(dirs[0])["x"]
        except ValueError as e:  # an overlap inside the kept prefix
            kind = "overlap" if "overlap" in str(e) else "gap"
            with pytest.raises(ValueError, match=kind):
                tdg.load_chunks_validated(dirs[1])
            continue
        np.testing.assert_array_equal(tdg.load_chunks_validated(dirs[1])["x"], want)
    gap = tmp_path / "t" / "gap2"
    gap.mkdir()
    for a, b in ((0, 2), (3, 4)):
        np.savez(gap / f"chunk_{a}_{b}.npz", x=np.arange(a, b))
    with pytest.raises(ValueError, match="gap"):
        tdg.load_chunks_validated(str(gap))
    with pytest.raises(ValueError, match="cover only"):
        tdg.load_chunks_validated(str(tmp_path / "t" / "ok"), n=9)


def test_unported_cases_raise(tmp_path):
    """What is still not ported raises, naming its ROADMAP item; what was
    ported since refuses only what the JAX package refuses (the setup
    driver's Navier-Stokes velocity no longer refuses any nx): a control
    Jacobian without a control distribution, the POD input-output error
    test of a control problem, and the two-step generation of an
    observable that is not the full state."""
    from hippyflow_tpu_torch.models import UniformDistribution

    _, _, tobs, tpr = _problems()
    gen = TDataGenerator(tobs, tpr, settings=dict(verbose=False))
    with pytest.raises(ValueError, match="control distribution"):
        gen.generate(2, derivatives=(0, 1), data_dir=str(tmp_path))
    with pytest.raises(TypeError, match="full-state"):
        gen.two_step_generate(2, pod_rank=1)
    pod = TPOD(tobs, tpr, control_distribution=UniformDistribution(3, -1, 1))
    with pytest.raises(ValueError, match="control"):
        pod.input_output_error_test(np.eye(tobs.dM)[:, :2])
    # the Navier-Stokes velocity is ported: the driver reads the JAX
    # package's cached field where there is one and solves elsewhere
    assert confusion_setup._velocity("ns", 12) == "navier_stokes"
    assert confusion_setup._velocity("ns", 64).shape == (65 * 65, 2)
    assert confusion_setup._velocity("analytic", 64) == "analytic"


# -- bit-exact resume within the port ----------------------------------------------

class Killed(Exception):
    pass


def _kill_on_call(monkeypatch, module, name, at):
    """Make module.name raise on its ``at``-th call (a killed process)."""
    real, calls = getattr(module, name), [0]

    def wrapped(*args, **kwargs):
        calls[0] += 1
        if calls[0] == at:
            raise Killed
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_training_data_resume_is_bit_exact(tmp_path, monkeypatch):
    _, _, tobs, tpr = _problems()

    def pod():
        p = TPODParams()
        p["data_per_process"], p["chunk_size"], p["verbose"] = 9, 4, False
        return TPOD(tobs, tpr, parameters=p)

    pod().generate_training_data(str(tmp_path / "ref"))
    with monkeypatch.context() as mp:
        _kill_on_call(mp, tpod_module, "sample_until_solved", 3)
        with pytest.raises(Killed):
            pod().generate_training_data(str(tmp_path / "run"))
    assert sorted(os.listdir(tmp_path / "run" / "chunks_pod")) == [
        "chunk_0_4.npz", "chunk_4_8.npz"]
    # a stale chunk of another grid beyond the gap is pruned
    np.savez(tmp_path / "run" / "chunks_pod" / "chunk_9_12.npz", m_data=0)
    pod().generate_training_data(str(tmp_path / "run"))
    assert not os.path.exists(tmp_path / "run" / "chunks_pod")
    _assert_same_bits(_arrays(tmp_path / "run" / "mq_data.npz"),
                      _arrays(tmp_path / "ref" / "mq_data.npz"))


def test_low_rank_jacobians_resume_is_bit_exact(tmp_path, monkeypatch):
    _, _, tobs, tpr = _problems()

    def as_proj():
        p = TASParams()
        p["samples_per_process"], p["chunk_size"], p["jacobian_rank"] = 7, 3, 4
        p["verbose"] = False
        return TAS(tobs, tpr, parameters=p)

    ref = as_proj().construct_low_rank_Jacobians(str(tmp_path / "ref"))
    with monkeypatch.context() as mp:
        _kill_on_call(mp, tdg, "_svd_payload", 2)
        with pytest.raises(Killed):
            as_proj().construct_low_rank_Jacobians(str(tmp_path / "run"))
    assert os.listdir(tmp_path / "run" / "chunks") == ["chunk_0_3.npz"]
    got = as_proj().construct_low_rank_Jacobians(str(tmp_path / "run"))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for f in ("Jsvd_data.npz", "mq_m_data.npy", "mq_q_data.npy"):
        load = _arrays if f.endswith("npz") else (lambda p: {"a": np.load(p)})
        _assert_same_bits(load(tmp_path / "run" / f), load(tmp_path / "ref" / f))
    assert not os.path.exists(tmp_path / "run" / "chunks")


def test_data_generator_resume_is_bit_exact(tmp_path, monkeypatch):
    _, _, tobs, tpr = _problems()
    Phi = np.linalg.qr(np.random.default_rng(9).standard_normal((tobs.dQ, 3)))[0]

    def run(d):
        TDataGenerator(tobs, tpr, settings=dict(chunk_size=3, verbose=False)
                       ).generate(8, derivatives=(1, 0), output_decoder=Phi,
                                  data_dir=str(d))

    run(tmp_path / "ref")
    with monkeypatch.context() as mp:
        _kill_on_call(mp, tdg, "materialize_jacobians", 2)
        with pytest.raises(Killed):
            run(tmp_path / "run")
    assert os.listdir(tmp_path / "run" / "chunks") == ["chunk_0_3.npz"]
    run(tmp_path / "run")
    for f in ("mq_data.npz", "JstarPhi_data.npz"):
        _assert_same_bits(_arrays(tmp_path / "run" / f), _arrays(tmp_path / "ref" / f))


# -- the driver ----------------------------------------------------------------------

def test_setup_driver_layout_then_training(tmp_path, capsys):
    """The port's driver at nx=12 writes the files the JAX driver's test
    checks, and the port's training driver trains one sweep from them."""
    out = str(tmp_path / "conf") + "/"
    confusion_setup.main([
        "--nx", "12", "--sqrt_n_obs", "4", "--rank", "6", "--oversampling", "4",
        "--n_samples", "10", "--n_data", "10", "--jacobian_rank", "4",
        "--output", out, "--error_test", "--velocity", "analytic",
        "--device", "cpu", "--dtype", "float64",
    ])
    for f in ("AS_10_input_decoder.npy", "AS_10_d_GN.npy",
              "AS_10_output_decoder.npy", "AS_10_d_NG.npy", "KLE_decoder.npy",
              "KLE_d.npy", "POD_projector.npy", "POD_d.npy", "mq_data.npz",
              "error_data.pkl", "metadata.pkl"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "error_data.pkl"), "rb") as fh:
        err = pickle.load(fh)
    assert set(err) == {"as", "kle", "pod", "input_output"}
    assert len(err["input_output"]["avg"]) >= 1
    assert err["as"][("output_discarded", None)] == 0
    with open(os.path.join(out, "metadata.pkl"), "rb") as fh:
        meta = pickle.load(fh)
    assert set(meta) == {f"{s}_time" for s in confusion_setup.STAGES}
    assert meta["as_input_time"] > 0
    jd = np.load(os.path.join(out, "jacobian_data", "Jsvd_data.npz"))
    assert jd["U_data"].shape == (10, 16, 4)
    assert not os.path.exists(os.path.join(out, "jacobian_data", "chunks"))
    capsys.readouterr()
    logger = confusion_training.main([
        "--data_dir", out, "--fixed_input_rank", "4", "--fixed_output_rank", "4",
        "--epochs", "1", "--batch_size", "5", "--device", "cpu",
    ])
    assert len(logger["train_acc"]) >= 1
    assert all(np.isfinite(logger["loss"]))
    assert "final: train_acc" in capsys.readouterr().out
