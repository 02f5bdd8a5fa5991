"""The PyTorch port's input active subspace, end to end, against the JAX
package and against the stored f64 parity reference.

* nx=12: both packages run ``ActiveSubspaceProjector`` on the same 8 given
  prior samples and the same probe block Omega (rank 10, oversampling 10);
  head eigenvalues agree to 1e-8 relative and decoder columns up to sign.
* nx=64: the port alone, in float64, on the 16 samples and the probe block
  of ``.bench/parity_ref.npz`` with the steady Navier-Stokes velocity;
  eigenvalues above 1e-4 lambda_0 agree with ``d_ref`` to 1e-8 relative
  (the north-star check of ``bench.py``).
* ``import hippyflow_tpu_torch`` and its applications pull in no jax.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applications.confusion import (
    confusion_linear_observable as j_observable,
    confusion_prior as j_prior,
)
from hippyflow_tpu.models import (
    ActiveSubspaceParameterList as JParams,
    ActiveSubspaceProjector as JProjector,
)
from hippyflow_tpu.ops.randomized import double_pass_g as j_double_pass_g
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable as t_observable,
    confusion_prior as t_prior,
    load_ns_velocity,
)
from hippyflow_tpu_torch.models import (
    ActiveSubspaceParameterList as TParams,
    ActiveSubspaceProjector as TProjector,
)
from hippyflow_tpu_torch.ops import double_pass_g, orthogonalize

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, N_SAMPLES, RANK, OVERSAMPLING = 12, 8, 10, 10


def _head(d_ref, frac=1e-4):
    return np.abs(d_ref) > frac * abs(d_ref[0])


@functools.lru_cache(maxsize=None)
def _small_runs():
    jobs, jV = j_observable(nx=NX, velocity="analytic")
    jpr = j_prior(jV)
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((N_SAMPLES, jV.dim))
    omega = rng.standard_normal((jV.dim, RANK + OVERSAMPLING))

    jp = JParams()
    tp = TParams()
    for p in (jp, tp):
        p["rank"], p["oversampling"] = RANK, OVERSAMPLING
        p["samples_per_process"] = N_SAMPLES
        p["ms_given"], p["verbose"] = True, False
    jproj = JProjector(jobs, jpr, parameters=jp)
    jproj.ms = jpr.sample(jnp.asarray(xi))
    jproj.Omega_GN = jnp.asarray(omega)
    d_j, V_j, E_j = map(np.asarray, jproj.construct_input_subspace())

    tobs, tV = t_observable(nx=NX, velocity="analytic", **F64)
    tpr = t_prior(tV, **F64)
    tproj = TProjector(tobs, tpr, parameters=tp)
    tproj.ms = tpr.sample(interop.tensor(xi, **F64))
    tproj.Omega_GN = interop.tensor(omega, **F64)
    d_t, V_t, E_t = (x.numpy() for x in tproj.construct_input_subspace())
    return (d_j, V_j, E_j), (d_t, V_t, E_t), tpr


def test_slice_head_eigenvalues_match_jax():
    (d_j, _, _), (d_t, _, _), _ = _small_runs()
    assert d_t.shape == (RANK,)
    head = _head(d_j)
    assert head.sum() >= 3
    rel = np.abs(d_t - d_j) / np.abs(d_j)
    assert rel[head].max() <= 1e-8
    assert np.all(np.diff(d_t) <= 0)


def test_slice_decoder_matches_jax_up_to_sign():
    (d_j, V_j, E_j), (_, V_t, E_t), tpr = _small_runs()
    head = _head(d_j)
    # columns of well-separated eigenvalues are determined up to sign
    gap = np.abs(np.diff(d_j))
    sep = head & np.concatenate([[True], gap > 1e-3 * abs(d_j[0])]) & (
        np.concatenate([gap > 1e-3 * abs(d_j[0]), [True]])
    )
    assert sep.sum() >= 2
    for i in np.flatnonzero(sep):
        sign = np.sign(V_t[:, i] @ V_j[:, i])
        np.testing.assert_allclose(
            sign * V_t[:, i], V_j[:, i], rtol=0, atol=1e-6 * np.abs(V_j[:, i]).max()
        )
        np.testing.assert_allclose(
            sign * E_t[:, i], E_j[:, i], rtol=0, atol=1e-6 * np.abs(E_j[:, i]).max()
        )
    # the decoder is R-orthonormal and the encoder is R @ decoder
    R = tpr.R_matmat(torch.as_tensor(V_t)).numpy()
    np.testing.assert_allclose(E_t, R, rtol=0, atol=1e-10 * np.abs(R).max())
    np.testing.assert_allclose(V_t.T @ E_t, np.eye(RANK), atol=1e-10)


def test_double_pass_g_matches_jax():
    """The randomized GHEP on a small SPD pencil (A, B) with one probe."""
    rng = np.random.default_rng(3)
    n, k, p = 40, 5, 5
    X = rng.standard_normal((n, n))
    A = X @ X.T / n
    Y = rng.standard_normal((n, n))
    B = Y @ Y.T / n + np.eye(n)
    Binv = np.linalg.inv(B)
    Om = rng.standard_normal((n, k + p))
    d_j, U_j = j_double_pass_g(
        lambda Z: jnp.asarray(A) @ Z, lambda Z: jnp.asarray(B) @ Z,
        lambda Z: jnp.asarray(Binv) @ Z, jnp.asarray(Om), k,
    )
    At, Bt, Bit = (torch.as_tensor(M) for M in (A, B, Binv))
    d_t, U_t = double_pass_g(
        lambda Z: At @ Z, lambda Z: Bt @ Z, lambda Z: Bit @ Z,
        torch.as_tensor(Om), k,
    )
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-10)
    np.testing.assert_allclose(
        np.abs(U_t.numpy().T @ B @ np.asarray(U_j)), np.eye(k), atol=1e-8
    )
    Q = orthogonalize(torch.as_tensor(Om), lambda Z: Bt @ Z).numpy()
    np.testing.assert_allclose(Q.T @ B @ Q, np.eye(k + p), atol=1e-12)


def test_parity_reference_nx64():
    """The port in float64 reproduces the stored reference spectrum at
    nx=64 (16 samples, rank 100) on the CPU."""
    data = np.load(os.path.join(REPO, ".bench", "parity_ref.npz"))
    nx, rank = int(data["nx"]), int(data["rank"])
    obs, Vh = t_observable(nx=nx, velocity=load_ns_velocity(nx), **F64)
    prior = t_prior(Vh, **F64)
    params = TParams()
    params["rank"], params["oversampling"] = rank, 10
    params["samples_per_process"] = data["xi"].shape[0]
    params["ms_given"], params["verbose"] = True, False
    proj = TProjector(obs, prior, parameters=params)
    proj.ms = prior.sample(interop.tensor(data["xi"], **F64))
    proj.Omega_GN = interop.tensor(data["Omega"], **F64)
    d, _, _ = proj.construct_input_subspace()
    d, d_ref = d.numpy()[:rank], data["d_ref"][:rank]
    head = _head(d_ref)
    rel = np.abs(d - d_ref) / np.abs(d_ref)
    assert head.sum() >= 5
    assert rel[head].max() <= 1e-8


_NO_JAX = """
import sys
FORBIDDEN = ("jax", "jaxlib", "hippyflow_tpu", "applications", "matplotlib")
for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
    del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("the port imported " + name)

sys.meta_path.insert(0, Refuse())
import hippyflow_tpu_torch, hippyflow_tpu_torch.interop
import hippyflow_tpu_torch.applications.confusion
import hippyflow_tpu_torch.applications.helmholtz
import hippyflow_tpu_torch.nn, hippyflow_tpu_torch.models.pod
import hippyflow_tpu_torch.applications.confusion_training
import hippyflow_tpu_torch.models.kle, hippyflow_tpu_torch.models.data_generator
import hippyflow_tpu_torch.ops.operators
import hippyflow_tpu_torch.applications.confusion_setup
import hippyflow_tpu_torch.testing, hippyflow_tpu_torch.utils.mesh_utils
import hippyflow_tpu_torch.models.pde_problem, hippyflow_tpu_torch.models.jacobian
import hippyflow_tpu_torch.models.sampling, hippyflow_tpu_torch.ops.linalg
import hippyflow_tpu_torch.models.model_wrapper, hippyflow_tpu_torch.models.multi_pde
import hippyflow_tpu_torch.models.cminimization, hippyflow_tpu_torch.utils.mv_utilities
import hippyflow_tpu_torch.applications.navier_stokes
import hippyflow_tpu_torch.applications.helmholtz_setup
import hippyflow_tpu_torch.applications.helmholtz_training
import hippyflow_tpu_torch.applications.confusion_multirun
import hippyflow_tpu_torch.applications.helmholtz_multirun
import hippyflow_tpu_torch.utils.plotting
import hippyflow_tpu_torch.parallel, hippyflow_tpu_torch.parallel.dist_banded
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
sys.exit(f"loaded {bad}" if bad else 0)
"""


def test_import_pulls_in_no_jax():
    """In a fresh interpreter that refuses to import jax, the JAX package
    or its applications, the port, its surrogate layer, its KLE, data
    generator and operator modules, its solvers and control paths, its
    inverse-problem wrapper, multi-source problems and constrained Newton,
    its Poisson control fixture (``testing``), mesh I/O and multivector
    shims, its plots, and its confusion, confusion-setup,
    confusion-training, helmholtz, Navier-Stokes, helmholtz-setup,
    helmholtz-training and both multirun applications, and its parallel
    layer import, and matplotlib is not imported with them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_public_model_name_has_a_counterpart():
    """Each public name of ``hippyflow_tpu.models`` (classes, functions and
    submodules) exists in ``hippyflow_tpu_torch.models``."""
    import hippyflow_tpu.models as jax_models
    import hippyflow_tpu_torch.models as port_models

    names = [n for n in vars(jax_models) if not n.startswith("_")
             and n not in ("annotations",)]
    assert len(names) > 50
    missing = [n for n in names if not hasattr(port_models, n)]
    assert not missing, missing


APPLICATIONS = ("confusion", "helmholtz", "navier_stokes", "helmholtz_setup",
                "helmholtz_training", "confusion_multirun", "helmholtz_multirun")


@pytest.mark.parametrize("module", [f"applications.{m}" for m in APPLICATIONS]
                         + ["hippyflow_tpu.utils.plotting"])
def test_every_public_application_function_has_a_counterpart(module):
    """Each public function and class that a JAX application module (or
    the JAX plotting module) defines exists in the port's module of the
    same name."""
    import importlib
    import inspect

    mod = importlib.import_module(module)
    port = importlib.import_module(
        "hippyflow_tpu_torch." + module.replace("hippyflow_tpu.", ""))
    names = [n for n, o in vars(mod).items() if not n.startswith("_")
             and (inspect.isfunction(o) or inspect.isclass(o))
             and o.__module__ == mod.__name__]
    assert names
    missing = [n for n in names if not callable(getattr(port, n, None))]
    assert not missing, missing
