"""The port's inverse-problem wrapper (``models/model_wrapper.py``) against
the JAX package, in float64 on the CPU, on the Poisson problem of the JAX
package's own wrapper test (the control fixed inside the form) at nx=8
with 12 pointwise observations.

Both wrappers see the same data: ``setUpInverseProblem`` gets the same
true parameter, and the port's keychain replays the normals that the JAX
wrapper's key draws, so the noise agrees.  The port runs its batch of
samples at once; the JAX package one sample at a time.

* the costs, the variational gradients (misfit only and full), the mass-
  and R-preconditioned gradients, J, J^T and the Gauss-Newton Hessian
  (single directions and blocks): 1e-10 relative to the largest entry;
* ``setUpInverseProblem`` on the same noise (and ``rel_noise=0`` falling
  through to the setting, as in JAX), and ``samplePrior``: 1e-12;
* the low-rank Jacobian U S V^T as a product, and its singular values:
  1e-10; the port's full gradient against a central difference of its
  cost.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu as hf
from hippyflow_tpu import testing as jt
from hippyflow_tpu.models import ModelWrapper as JWrapper
from hippyflow_tpu.utils import KeyChain as JKeyChain
from hippyflow_tpu_torch import testing as tt
from hippyflow_tpu_torch.fem import DirichletBC, GalerkinForm
from hippyflow_tpu_torch.models import ModelWrapper, VariationalPDEProblem
from hippyflow_tpu_torch.utils import GivenNoise

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N_OBS, N = 8, 12, 3
Z_FIXED = np.linspace(-1.0, 1.0, 25)


def _settings():
    st = jt.poisson_control_settings()
    st["nx"] = st["ny"] = NX
    return st


def _top_bottom(x):
    return (x[:, 1] < 1e-12) | (x[:, 1] > 1 - 1e-12)


class Replay:
    """A numpy-Generator stand-in whose ``standard_normal`` hands out given
    arrays in order (the JAX side's draws, for ``GivenNoise``)."""

    def __init__(self, *arrays):
        self.arrays = [np.asarray(a) for a in arrays]

    def standard_normal(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return a


def _jax_wrapper():
    pde, prior, _, Vh = jt.setup_poisson_control_problem(_settings())
    base = jt.make_poisson_varf(_settings())
    z = jnp.asarray(Z_FIXED)
    form = hf.GalerkinForm(
        flux=lambda x, u, gu, m, _z, c: base.flux(x, u, gu, m, z, c),
        source=lambda x, u, gu, m, _z, c: base.source(x, u, gu, m, z, c),
        quad_degree=4, symmetric=True)
    bc = hf.DirichletBC.from_predicate(Vh, _top_bottom, lambda x: x[:, 1])
    pde2 = hf.VariationalPDEProblem(Vh, Vh, form, bc, is_fwd_linear=True)
    return JWrapper(jt.poisson_pointwise_observable(pde2, Vh, n_obs=N_OBS), prior)


def _torch_wrapper():
    _, prior, _, Vh = tt.setup_poisson_control_problem(_settings(), **F64)
    base = tt.make_poisson_varf(_settings())
    z = torch.as_tensor(Z_FIXED, **F64)

    def source(x, u, gu, m, _z, c):
        return base.source(x, u, gu, m, z.expand(m.shape[0], -1), c)

    form = GalerkinForm(flux=base.flux, source=source, quad_degree=4,
                        symmetric=True)
    bc = DirichletBC.from_predicate(Vh, _top_bottom, lambda x: x[:, 1])
    pde2 = VariationalPDEProblem(Vh, Vh, form, bc, is_fwd_linear=True, **F64)
    return ModelWrapper(tt.poisson_pointwise_observable(pde2, Vh, n_obs=N_OBS),
                        prior)


def _set_up(jw, tw, mtrue, rel_noise=0.01, key_seed=7):
    """The same data in both wrappers: JAX draws its noise from a known
    key, and the port's keychain replays those normals."""
    jw.keychain = JKeyChain(key_seed)
    noise = jax.random.normal(JKeyChain(key_seed).next_key(), (N_OBS,),
                              dtype=jnp.float64)
    tw.keychain = GivenNoise(Replay(noise), "cpu")
    jmis = jw.setUpInverseProblem(mtrue=jnp.asarray(mtrue), rel_noise=rel_noise)
    tmis = tw.setUpInverseProblem(mtrue=torch.as_tensor(mtrue, **F64),
                                  rel_noise=rel_noise)
    return jmis, tmis


@functools.lru_cache(maxsize=None)
def _wrappers():
    jw, tw = _jax_wrapper(), _torch_wrapper()
    rng = np.random.default_rng(0)
    mtrue = np.asarray(tw.prior.sample(torch.as_tensor(
        rng.standard_normal(tw.prior.noise_dim), **F64)))
    _set_up(jw, tw, mtrue)
    ms = np.asarray(tw.prior.sample(torch.as_tensor(
        rng.standard_normal((N, tw.prior.noise_dim)), **F64)))
    return jw, tw, ms, rng


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


GRADS = {
    "grad_misfit": lambda w, m: w.evalVariationalGradient(m),
    "grad_full": lambda w, m: w.evalVariationalGradient(m, misfit_only=False),
    "grad_mass": lambda w, m: w.evalGradient(m),
    "grad_R": lambda w, m: w.evalGradient(m, invert_regularization=True),
    "grad_R_full": lambda w, m: w.evalGradient(
        m, misfit_only=False, invert_regularization=True),
}
VALUES = ("evalCost", "evalMisfitCost", "evalRegularizationCost", "evalMisfit",
          "evalObs")
RANK = 5


def _directions(k):
    """Seeded directions dm (N, dM[, k]) and dq (N, dQ[, k])."""
    _, tw, _, _ = _wrappers()
    rng = np.random.default_rng(1 if k is None else k)
    tail = () if k is None else (k,)
    return (rng.standard_normal((N, tw.dM) + tail),
            rng.standard_normal((N, tw.dQ) + tail))


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """Every compared JAX value at each sample, from three jitted vmaps of
    the per-sample wrapper (the costs, the gradients, and the Jacobian
    products at one linearization)."""
    jw, _, ms, _ = _wrappers()
    dirs = {k: _directions(k) for k in (None, 4)}

    def products(m, dm1, dq1, dm4, dq4):
        lin = jw.observable.linearize(m)
        out = {}
        for k, dm, dq in ((None, dm1, dq1), (4, dm4, dq4)):
            out[f"J_{k}"] = jw.evalJ(dm, lin=lin)
            out[f"Jt_{k}"] = jw.evalJt(dq, lin=lin)
            out[f"H_{k}"] = jw.evalGNHessian(dm, lin=lin)
        U, sig, V = jw.evalLowRankJacobian(RANK, lin=lin)
        out["low_rank"], out["sigma"] = (U * sig[None, :]) @ V.T, sig
        out["jacobian"] = jw.evalJacobian(lin=lin)
        return out

    m = jnp.asarray(ms)
    run = lambda f, *args: jax.jit(jax.vmap(f))(m, *args)
    out = run(lambda m: {name: getattr(jw, name)(m) for name in VALUES})
    out.update(run(lambda m: {name: f(jw, m) for name, f in GRADS.items()}))
    out.update(run(products, *(jnp.asarray(x) for x in (*dirs[None], *dirs[4]))))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", VALUES + tuple(GRADS))
def test_costs_and_gradients_match_jax(name):
    _, tw, ms, _ = _wrappers()
    m = torch.as_tensor(ms, **F64)
    got = GRADS[name](tw, m) if name in GRADS else getattr(tw, name)(m)
    assert _rel(got, _jax_reference()[name]) < 1e-10


@pytest.mark.parametrize("k", [None, 4])
def test_jacobian_actions_and_gn_hessian_match_jax(k):
    """J, J^T and the GN Hessian on one direction (k=None) and on blocks
    of 4, at the port's batched linearization and JAX's per sample."""
    _, tw, ms, _ = _wrappers()
    dm, dq = (torch.as_tensor(x, **F64) for x in _directions(k))
    lin = tw.observable.linearize(torch.as_tensor(ms, **F64))
    got = {"J": tw.evalJ(dm, lin=lin), "Jt": tw.evalJt(dq, lin=lin),
           "H": tw.evalGNHessian(dm, lin=lin)}
    for key, value in got.items():
        assert _rel(value, _jax_reference()[f"{key}_{k}"]) < 1e-10, key


@pytest.mark.parametrize("rel_noise", [0.01, 0.0])
def test_set_up_inverse_problem_matches_jax(rel_noise):
    """The same mtrue and noise give the same data and variance; with
    rel_noise 0 both fall through to the setting (0.02 here)."""
    jw, tw = _jax_wrapper(), _torch_wrapper()
    jw.settings["rel_noise"] = tw.settings["rel_noise"] = 0.02
    mtrue = np.asarray(tw.prior.sample(torch.as_tensor(
        np.random.default_rng(3).standard_normal(tw.prior.noise_dim), **F64)))
    jmis, tmis = _set_up(jw, tw, mtrue, rel_noise=rel_noise, key_seed=11)
    assert _rel(tmis.d, jmis.d) < 1e-12
    assert abs(tmis.noise_variance / jmis.noise_variance - 1.0) < 1e-12
    q = np.asarray(tw.evalObs(torch.as_tensor(mtrue[None], **F64)))[0]
    want_std = (rel_noise or 0.02) * np.abs(q).max()
    assert abs(np.sqrt(tmis.noise_variance) / want_std - 1.0) < 1e-12
    np.testing.assert_array_equal(tw.mtrue.numpy(), mtrue)


def test_sample_prior_matches_jax():
    jw, tw = _jax_wrapper(), _torch_wrapper()
    jw.keychain = JKeyChain(4)
    noise = jax.random.normal(JKeyChain(4).next_key(), (5, tw.prior.noise_dim),
                              dtype=jnp.float64)
    tw.keychain = GivenNoise(Replay(noise), "cpu")
    assert _rel(tw.samplePrior(5), jw.samplePrior(5)) < 1e-12


def test_low_rank_jacobian_matches_jax():
    _, tw, ms, _ = _wrappers()
    m = torch.as_tensor(ms, **F64)
    U, s, V = tw.evalLowRankJacobian(RANK, m=m)
    ref = _jax_reference()
    assert _rel((U * s[:, None, :]) @ V.mT, ref["low_rank"]) < 1e-10
    assert _rel(s, ref["sigma"]) < 1e-10
    assert _rel(tw.evalJacobian(m=m), ref["jacobian"]) < 1e-10


def test_gradient_central_difference():
    """The port's full gradient against a central difference of its cost,
    sample by sample (the JAX package's own wrapper check)."""
    _, tw, ms, _ = _wrappers()
    m = torch.as_tensor(ms, **F64)
    g = tw.evalVariationalGradient(m, misfit_only=False)
    dm = torch.as_tensor(np.random.default_rng(2).standard_normal(m.shape), **F64)
    eps = 1e-6
    fd = (tw.evalCost(m + eps * dm) - tw.evalCost(m - eps * dm)) / (2 * eps)
    an = (g * dm).sum(dim=1)
    assert ((fd - an).abs() / an.abs()).max() < 1e-6
