"""The port's application drivers against the JAX package, in float64 on
the CPU:

* ``helmholtz_prior(use_bilaplacian=False)`` (the Laplacian prior): samples
  on given noise, R and its solve, to 1e-12;
* the helmholtz setup pieces at nx=10 (the fused pass on the permuted
  band): the input and output active subspaces, the KLE and the POD on
  given noise, to 1e-9;
* ``load_helmholtz_data`` with every option, and its refusal, exactly;
* the helmholtz DIPResNet the training driver builds (sigmoid residual,
  the data mean as output shift), with the JAX weights carried over by
  ``interop.flax_params``, to 1e-12;
* the drivers on the CPU (``--device cpu``) at small nx: the helmholtz
  setup writes the JAX driver's layout and metadata, the training driver
  trains from it, the confusion setup solves Navier-Stokes where no field
  is cached (nx=12), and both sweeps write ``repr((arch, n, seed))`` keys,
  skip sizes above the data and resume.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applications import helmholtz_training as j_training
from applications.confusion_training import modify_projectors as j_modify
from applications.helmholtz import (
    helmholtz_linear_observable as j_observable,
    helmholtz_prior as j_prior,
)
from hippyflow_tpu import models as jm
from hippyflow_tpu import nn as jnn
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch import models as tm
from hippyflow_tpu_torch.applications import (
    confusion_multirun,
    confusion_setup,
    helmholtz_multirun,
    helmholtz_setup,
    helmholtz_training,
)
from hippyflow_tpu_torch.applications.confusion_training import build_model
from hippyflow_tpu_torch.applications.helmholtz import (
    helmholtz_linear_observable as t_observable,
    helmholtz_prior as t_prior,
)
from hippyflow_tpu_torch.utils import GivenNoise

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, SQRT_OBS, N, RANK, OVERSAMPLING = 10, 3, 6, 4, 3
SETUP_FILES = ("AS_6_input_decoder.npy", "AS_6_d_GN.npy", "AS_6_output_decoder.npy",
               "AS_6_d_NG.npy", "KLE_decoder.npy", "KLE_d.npy", "POD_projector.npy",
               "POD_d.npy", "mq_data.npz", "error_data.pkl", "metadata.pkl")


class JaxGivenNoise:
    """The JAX side's keychain: the same numpy stream as ``GivenNoise``."""

    def __init__(self, rng):
        self.rng = rng

    def normal(self, shape, dtype=None, sigma=1.0):
        return sigma * jnp.asarray(self.rng.standard_normal(shape),
                                   dtype=dtype or jnp.float64)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _projectors_close(U_t, U_j, d, tol):
    """V V^T of the first r columns at every r whose eigenvalue is above
    1e-4 d[0] and apart from the next."""
    d = np.abs(np.asarray(d))
    U_t = U_t.numpy() if isinstance(U_t, torch.Tensor) else U_t
    U_j = np.asarray(U_j)
    ranks = [r for r in range(1, len(d) + 1) if d[r - 1] > 1e-4 * d[0]
             and (r == len(d) or abs(d[r - 1] - d[r]) > 1e-6 * d[0])]
    assert ranks
    for r in ranks:
        _close(U_t[:, :r] @ U_t[:, :r].T, U_j[:, :r] @ U_j[:, :r].T, tol)


@functools.lru_cache(maxsize=None)
def _helmholtz():
    jobs, jV = j_observable(nx=NX, sqrt_n_obs=SQRT_OBS, frequency=600.0)
    tobs, tV = t_observable(nx=NX, sqrt_n_obs=SQRT_OBS, frequency=600.0, **F64)
    return jobs, j_prior(jV), tobs, t_prior(tV, **F64)


def test_laplacian_helmholtz_prior_matches_jax():
    _, jV = j_observable(nx=NX, sqrt_n_obs=SQRT_OBS)
    _, tV = t_observable(nx=NX, sqrt_n_obs=SQRT_OBS, **F64)
    jpr = j_prior(jV, use_bilaplacian=False)
    tpr = t_prior(tV, use_bilaplacian=False, **F64)
    assert type(tpr).__name__ == type(jpr).__name__ == "LaplacianPrior"
    rng = np.random.default_rng(0)
    noise = rng.standard_normal((3, tpr.noise_dim))
    X = rng.standard_normal((tpr.dim, 4))
    _close(tpr.sample(torch.tensor(noise)), jpr.sample(jnp.asarray(noise)), 1e-12)
    for name in ("R_matmat", "Rsolver_matmat"):
        _close(getattr(tpr, name)(torch.tensor(X)),
               getattr(jpr, name)(jnp.asarray(X)), 1e-12)


@functools.lru_cache(maxsize=None)
def _pieces():
    """AS (input, output), KLE and POD of both packages on given noise."""
    jobs, jpr, tobs, tpr = _helmholtz()
    rng = np.random.default_rng(2)
    xi = rng.standard_normal((N, tpr.noise_dim))
    om_gn = rng.standard_normal((tobs.dM, RANK + OVERSAMPLING))
    om_ng = rng.standard_normal((tobs.dQ, RANK + OVERSAMPLING))
    out = []
    for mod, obs, pr, kc, arr in (
        (jm, jobs, jpr, lambda s: JaxGivenNoise(np.random.default_rng(s)),
         jnp.asarray),
        (tm, tobs, tpr, lambda s: GivenNoise(np.random.default_rng(s), "cpu"),
         torch.as_tensor),
    ):
        p = mod.ActiveSubspaceParameterList()
        p["rank"], p["oversampling"], p["samples_per_process"] = RANK, OVERSAMPLING, N
        p["ms_given"], p["verbose"] = True, False
        AS = mod.ActiveSubspaceProjector(obs, pr, parameters=p)
        AS.ms = pr.sample(arr(xi))
        AS.Omega_GN, AS.Omega_NG = arr(om_gn), arr(om_ng)
        AS.keychain = kc(3)
        res = {"in": AS.construct_input_subspace(),
               "out": AS.construct_output_subspace()}
        p = mod.KLEParameterList()
        p["rank"], p["oversampling"], p["verbose"] = RANK, OVERSAMPLING, False
        KLE = mod.KLEProjector(pr, parameters=p)
        KLE.keychain = kc(4)
        res["kle"] = KLE.construct_input_subspace("mass")
        p = mod.PODParameterList()
        p["rank"], p["sample_per_process"], p["verbose"] = RANK, N, False
        POD = mod.PODProjector(obs, pr, parameters=p)
        POD.keychain = kc(5)
        res["pod"] = POD.construct_subspace()
        out.append(res)
    return out


@pytest.mark.parametrize("piece", ["in", "out", "kle", "pod"])
def test_helmholtz_setup_pieces_match_jax(piece):
    jr, tr = _pieces()
    d_j, U_j = np.asarray(jr[piece][0]), np.asarray(jr[piece][1])
    d_t, U_t = tr[piece][0], tr[piece][1]
    assert d_t.shape == d_j.shape and U_t.shape == U_j.shape
    _close(d_t, d_j, 1e-9)
    _projectors_close(U_t, U_j, d_j, 1e-9)


def _write_data(path, n=10, dM=7, dQ=5, with_jsvd=True):
    rng = np.random.default_rng(0)
    np.savez(os.path.join(path, "mq_data.npz"), m_data=rng.standard_normal((n, dM)),
             q_data=rng.standard_normal((n, dQ)))
    if with_jsvd:
        np.savez(os.path.join(path, "Jsvd_data.npz"),
                 U_data=rng.standard_normal((n, dQ, 2)),
                 sigma_data=rng.standard_normal((n, 2)),
                 V_data=rng.standard_normal((n, dM, 2)))


@pytest.mark.parametrize("with_jsvd", [True, False])
def test_load_helmholtz_data_matches_jax(tmp_path, with_jsvd):
    _write_data(str(tmp_path), with_jsvd=with_jsvd)
    for kw in (dict(), dict(n_data=4), dict(rescale=True),
               dict(rescale=True, n_data=6), dict(derivatives=True),
               dict(derivatives=True, n_data=3)):
        got = helmholtz_training.load_helmholtz_data(str(tmp_path), **kw)
        want = j_training.load_helmholtz_data(str(tmp_path), **kw)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    for loader in (helmholtz_training.load_helmholtz_data,
                   j_training.load_helmholtz_data):
        with pytest.raises(NotImplementedError, match="rescale"):
            loader(str(tmp_path), rescale=True, derivatives=True)


def test_helmholtz_network_matches_jax():
    rng = np.random.default_rng(1)
    dM, dQ = 30, 12
    projectors = {"AS_input": rng.standard_normal((dM, 8)),
                  "POD": rng.standard_normal((dQ, 6))}
    q = rng.standard_normal((20, dQ))
    m = rng.standard_normal((5, dM))
    tmodel, P = build_model("as_resnet", projectors, q, dM, dQ, 8, dtype=torch.float64,
                            device="cpu", residual_activation="sigmoid")
    Pj, Phij = j_modify(projectors, "AS_input")
    np.testing.assert_array_equal(P, Pj)
    jmodel = jnn.projected_low_rank_residual_network(
        Pj, Phij, ranks=[8, 8], residual_activation="sigmoid",
        output_shift=q.mean(axis=0))
    jparams = jax.tree_util.tree_map(
        lambda x: np.asarray(x, dtype=np.float64),
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(m[:1])))
    interop.flax_params(tmodel, jparams)
    with torch.no_grad():
        got = tmodel(torch.tensor(m))
    _close(got, jmodel.apply(jparams, jnp.asarray(m)), 1e-12)


@pytest.fixture(scope="module")
def helmholtz_output(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("helm") / "out") + "/"
    helmholtz_setup.main([
        "--nx", str(NX), "--sqrt_n_obs", str(SQRT_OBS), "--rank", str(RANK),
        "--oversampling", str(OVERSAMPLING), "--n_samples", str(N), "--n_data", "12",
        "--output", out, "--error_test", "--device", "cpu"])
    return out


def test_helmholtz_setup_driver_writes_the_jax_layout(helmholtz_output):
    out = helmholtz_output
    for f in SETUP_FILES:
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "metadata.pkl"), "rb") as fh:
        meta = pickle.load(fh)
    assert set(meta) == {f"{s}_time" for s in confusion_setup.STAGES}
    with open(os.path.join(out, "error_data.pkl"), "rb") as fh:
        err = pickle.load(fh)
    assert set(err) == {"as", "kle", "pod"}
    assert err["as"][("output_discarded", None)] == 0
    jd = np.load(os.path.join(out, "jacobian_data", "Jsvd_data.npz"))
    assert jd["U_data"].shape[0] == N
    with np.load(os.path.join(out, "mq_data.npz")) as z:
        assert z["m_data"].shape == (12, 99) and z["q_data"].shape == (12, 18)


def test_helmholtz_training_driver_trains_one_epoch(helmholtz_output, capsys):
    for optimizer in ("adamw", "incg"):
        logger = helmholtz_training.main([
            "--data_dir", helmholtz_output, "--fixed_input_rank", "4",
            "--fixed_output_rank", "4", "--epochs", "1", "--batch_size", "4",
            "--optimizer", optimizer, "--device", "cpu"])
        assert len(logger["loss"]) == 1 and np.isfinite(logger["loss"]).all()
    assert "final: train_acc" in capsys.readouterr().out


def _sweep_checks(main, data_dir, archs, argv_extra=()):
    """Seed the pickle with one key, sweep data sizes 4, 8 and 64 (above
    the data), and sweep again."""
    path = os.path.join(data_dir, "master_logger.pkl")
    seeded = repr((archs[0], 4, 0))
    with open(path, "wb") as f:
        pickle.dump({seeded: {"train_acc": ["kept"], "val_acc": ["kept"]}}, f)
    argv = ["--data_dir", data_dir, "--architectures", ",".join(archs),
            "--data_sizes", "4,8,64", "--n_seeds", "1", "--epochs", "1",
            "--fixed_input_rank", "4", "--fixed_output_rank", "4",
            "--device", "cpu", *argv_extra]
    master, trained = main(argv)
    want = {repr((a, n, 0)) for a in archs for n in (4, 8)}
    assert set(master) == want and set(trained) == want - {seeded}
    assert master[seeded]["val_acc"] == ["kept"]
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == want
    again, trained2 = main(argv)
    assert trained2 == [] and set(again) == want


def test_helmholtz_multirun_resumes(helmholtz_output):
    _sweep_checks(helmholtz_multirun.main, helmholtz_output,
                  ["as_resnet", "kle_dense", "generic_dense"])


def test_confusion_setup_solves_navier_stokes_then_sweep(tmp_path):
    out = str(tmp_path / "conf") + "/"
    confusion_setup.main([
        "--nx", "12", "--sqrt_n_obs", "3", "--rank", "4", "--oversampling", "3",
        "--n_samples", "10", "--n_data", "10", "--jacobian_rank", "4",
        "--output", out, "--velocity", "ns", "--device", "cpu",
        "--dtype", "float64"])
    for f in SETUP_FILES:
        if f != "error_data.pkl":
            assert os.path.exists(os.path.join(out, f.replace("AS_6", "AS_10"))), f
    _sweep_checks(confusion_multirun.main, out, ["as_dense", "generic_dense"])
