"""The port's KLE (``models/kle.py``) against the JAX package, in float64 on
the CPU, with the dense BiLaplacian prior of a P1 space at nx=12 (169
dofs) and the same numpy draws: both projectors' ``keychain`` is replaced
by a generator of the same numpy stream, so the probe block and the test
samples agree.

* the three orthogonalities (mass, prior, identity): eigenvalues to 1e-10
  relative to the largest, decoders and encoders to 1e-9 through their
  projectors at ranks that split no near-degenerate pair (columns are
  free in sign, and within such pairs), and each basis's orthonormality
  to 1e-10;
* ``KLESubspaceConstructor``'s dense branch and its Lanczos branch, forced
  with ``dense_cutoff=0``: the same tolerances, and the two branches agree
  with each other to 1e-8;
* ``test_errors`` for the mass and the identity modes: averages and
  standard deviations to 1e-9 relative;
* ``BoundaryRestrictedKLEProjector`` on a shared probe: the boundary mass
  matrices exactly, eigenvalues to 1e-9 relative to the largest, the
  decoder through V V^T at separated cuts to 1e-9, B-orthonormality and
  encoder = M_b decoder;
* ``LaplacianPrior`` (and ``Laplacian2D``): R, its solve, the mass
  operators and samples on the same noise to 1e-12, and its KLE in the
  three modes against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu.fem import FunctionSpace as JSpace, unit_square_mesh as j_mesh
from hippyflow_tpu.models import (
    BiLaplacian2D as JBiLaplacian,
    BoundaryRestrictedKLEProjector as JBoundaryKLE,
    Laplacian2D as JLaplacian2D,
    LaplacianPrior as JLaplacian,
    KLEParameterList as JParams,
    KLEProjector as JKLE,
)
from hippyflow_tpu.models.kle import KLESubspaceConstructor as JConstructor
from hippyflow_tpu_torch.fem import FunctionSpace as TSpace, unit_square_mesh as t_mesh
from hippyflow_tpu_torch.models import (
    BiLaplacian2D as TBiLaplacian,
    BoundaryRestrictedKLEProjector as TBoundaryKLE,
    Laplacian2D as TLaplacian2D,
    LaplacianPrior as TLaplacian,
    KLEParameterList as TParams,
    KLEProjector as TKLE,
    KLESubspaceConstructor as TConstructor,
)
from hippyflow_tpu_torch.utils import GivenNoise

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, RANK, OVERSAMPLING = 12, 20, 10
SEED = 5


class JaxGivenNoise:
    """The JAX side's keychain: the same numpy stream as ``GivenNoise``."""

    def __init__(self, rng):
        self.rng = rng

    def normal(self, shape, dtype=None, sigma=1.0):
        return sigma * jnp.asarray(self.rng.standard_normal(shape),
                                   dtype=dtype or jnp.float64)


@pytest.fixture(scope="module")
def priors():
    jprior = JBiLaplacian(JSpace(j_mesh(NX)), gamma=0.1, delta=1.0)
    tprior = TBiLaplacian(TSpace(t_mesh(NX)), gamma=0.1, delta=1.0, **F64)
    return jprior, tprior


def _projectors(priors, rank=RANK):
    jprior, tprior = priors
    out = []
    for cls, params, prior, noise in (
        (JKLE, JParams(), jprior, JaxGivenNoise(np.random.default_rng(SEED))),
        (TKLE, TParams(), tprior, GivenNoise(np.random.default_rng(SEED), "cpu")),
    ):
        params["rank"], params["oversampling"] = rank, OVERSAMPLING
        params["verbose"], params["error_test_samples"] = False, 12
        proj = cls(prior, parameters=params)
        proj.keychain = noise
        out.append(proj)
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _separated(d, ranks, rel=1e-6):
    """The ranks r with d[r-1] and d[r] apart by more than rel * d[0]."""
    d = np.abs(d)
    return [r for r in ranks if r == len(d) or abs(d[r - 1] - d[r]) > rel * d[0]]


def _check_pair(j_out, t_out, W):
    """Eigenvalues, and the projectors decoder @ encoder^T at separated cuts;
    W is the basis's inner product (decoder^T W decoder = I)."""
    d_j, V_j, E_j = map(np.asarray, j_out)
    d_t, V_t, E_t = map(_np, t_out)
    assert d_t.shape == d_j.shape and V_t.shape == V_j.shape
    assert np.abs(d_t - d_j).max() <= 1e-10 * abs(d_j[0])
    np.testing.assert_allclose(V_t.T @ E_t, np.eye(V_t.shape[1]), atol=1e-10)
    np.testing.assert_allclose(E_t, W @ V_t, atol=1e-10 * np.abs(E_t).max())
    cuts = _separated(d_j, range(1, len(d_j) + 1))
    assert len(cuts) >= len(d_j) // 2
    for r in cuts:
        Pj = V_j[:, :r] @ E_j[:, :r].T
        Pt = V_t[:, :r] @ E_t[:, :r].T
        assert np.abs(Pt - Pj).max() <= 1e-9 * np.abs(Pj).max(), r


@pytest.mark.parametrize("mode", ["mass", "prior", "identity"])
def test_orthogonality_modes_match_jax(priors, mode):
    jkle, tkle = _projectors(priors)
    tprior = priors[1]
    t_out = tkle.construct_input_subspace(mode)
    j_out = jkle.construct_input_subspace(mode)
    M, K = tprior.M.numpy(), tprior.K.numpy()
    W = {"mass": M, "prior": K @ np.linalg.solve(M, K),
         "identity": np.eye(M.shape[0])}[mode]
    _check_pair(j_out, t_out, W)
    assert tkle.M_orthogonal == jkle.M_orthogonal == (mode == "mass")
    assert np.all(np.diff(_np(t_out[0])) <= 0)


@pytest.mark.parametrize("cutoff", [2048, 0])
def test_kle_constructor_branches_match_jax(priors, cutoff):
    """dense_cutoff=2048 takes the dense GHEP at 169 dofs, 0 the Lanczos."""
    jprior, tprior = priors
    j_out = JConstructor(jprior, dense_cutoff=cutoff).compute_kle_subspace(RANK)
    t_out = TConstructor(tprior, dense_cutoff=cutoff).compute_kle_subspace(RANK)
    M, K = tprior.M.numpy(), tprior.K.numpy()
    _check_pair(j_out, t_out, K @ np.linalg.solve(M, K))
    if cutoff == 0:
        d_dense = _np(TConstructor(tprior).compute_kle_subspace(RANK)[0])
        np.testing.assert_allclose(_np(t_out[0]), d_dense, rtol=1e-8)


@pytest.mark.parametrize("mode", ["mass", "identity"])
def test_test_errors_match_jax(priors, mode):
    jkle, tkle = _projectors(priors)
    d_j = np.asarray(jkle.construct_input_subspace(mode)[0])
    tkle.construct_input_subspace(mode)
    ranks = _separated(d_j, (2, 4, 8, 12, 16, 20))
    assert len(ranks) >= 3
    avg_j, std_j = jkle.test_errors(ranks=ranks)
    avg_t, std_t = tkle.test_errors(ranks=ranks)
    assert avg_t.shape == (len(ranks),)
    np.testing.assert_allclose(avg_t, avg_j, rtol=1e-9)
    np.testing.assert_allclose(std_t, std_j, rtol=1e-9)
    assert np.all(np.diff(avg_t) < 0)


def test_unknown_orthogonality_raises(priors):
    _, tkle = _projectors(priors)
    with pytest.raises(ValueError, match="unknown orthogonality"):
        tkle.construct_input_subspace("nonsense")


def test_boundary_restricted_kle_matches_jax(priors):
    jprior, tprior = priors
    out = []
    for cls, params, prior, noise in (
        (JBoundaryKLE, JParams(), jprior, JaxGivenNoise(np.random.default_rng(SEED))),
        (TBoundaryKLE, TParams(), tprior, GivenNoise(np.random.default_rng(SEED), "cpu")),
    ):
        params["rank"], params["oversampling"], params["verbose"] = (
            RANK, OVERSAMPLING, False)
        proj = cls(prior, parameters=params)
        proj.keychain = noise
        out.append((proj, proj.construct_input_subspace()))
    (jproj, (d_j, V_j, E_j)), (tproj, (d_t, V_t, E_t)) = out
    np.testing.assert_array_equal(tproj.M_b.numpy(), np.asarray(jproj.M_b))
    np.testing.assert_array_equal(tproj.B.numpy(), np.asarray(jproj.B))
    d_j, V_j = np.asarray(d_j), np.asarray(V_j)
    d_t, V_t, E_t = _np(d_t), _np(V_t), _np(E_t)
    assert np.abs(d_t - d_j).max() <= 1e-9 * abs(d_j[0])
    assert np.all(np.diff(d_t) <= 0)
    B = tproj.B.numpy()
    np.testing.assert_allclose(V_t.T @ B @ V_t, np.eye(RANK), atol=1e-10)
    np.testing.assert_allclose(E_t, tproj.M_b.numpy() @ V_t, atol=1e-12)
    cuts = _separated(d_j, range(1, RANK + 1))
    assert len(cuts) >= RANK // 2
    for r in cuts:
        Pj, Pt = V_j[:, :r] @ V_j[:, :r].T, V_t[:, :r] @ V_t[:, :r].T
        assert np.abs(Pt - Pj).max() <= 1e-9 * np.abs(Pj).max(), r


@pytest.fixture(scope="module")
def laplacian_priors():
    mean = np.linspace(-1.0, 1.0, (NX + 1) ** 2)
    jprior = JLaplacian(JSpace(j_mesh(NX)), gamma=0.3, delta=1.5,
                        mean=jnp.asarray(mean))
    tprior = TLaplacian(TSpace(t_mesh(NX)), gamma=0.3, delta=1.5,
                        mean=torch.as_tensor(mean), **F64)
    return jprior, tprior


def test_laplacian_prior_matches_jax(laplacian_priors):
    jprior, tprior = laplacian_priors
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((tprior.dim, 3))
    noise = rng.standard_normal((4, tprior.noise_dim))
    assert tprior.dim == tprior.noise_dim == jprior.dim
    for name in ("R_matmat", "Rsolver_matmat", "C_matmat", "M_matmat",
                 "Msolver_matmat", "sqrtM_matmat"):
        want = np.asarray(getattr(jprior, name)(jnp.asarray(X)))
        got = getattr(tprior, name)(torch.as_tensor(X)).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), name
    np.testing.assert_allclose(tprior.R.numpy(), np.asarray(jprior.R), rtol=0,
                               atol=1e-14 * np.abs(np.asarray(jprior.R)).max())
    want = np.asarray(jprior.sample(jnp.asarray(noise)))
    got = tprior.sample(torch.as_tensor(noise)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(tprior.sample(torch.as_tensor(noise[0])).numpy(),
                               got[0], rtol=0, atol=1e-13 * np.abs(got).max())
    # the factory drops the anisotropy arguments, as the reference does
    t2 = TLaplacian2D(TSpace(t_mesh(NX)), gamma=0.3, delta=1.5, theta0=5.0,
                      theta1=0.1, alpha=1.0, **F64)
    j2 = JLaplacian2D(JSpace(j_mesh(NX)), gamma=0.3, delta=1.5, theta0=5.0,
                      theta1=0.1, alpha=1.0)
    np.testing.assert_array_equal(t2.R.numpy(), tprior.R.numpy())
    np.testing.assert_allclose(t2.R.numpy(), np.asarray(j2.R), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["mass", "prior", "identity"])
def test_laplacian_prior_kle_matches_jax(laplacian_priors, mode):
    jkle, tkle = _projectors(laplacian_priors)
    d_j, V_j, E_j = map(np.asarray, jkle.construct_input_subspace(mode))
    d_t, V_t, E_t = map(_np, tkle.construct_input_subspace(mode))
    assert np.abs(d_t - d_j).max() <= 1e-10 * abs(d_j[0])
    for r in _separated(d_j, range(1, RANK + 1)):
        Pj, Pt = V_j[:, :r] @ E_j[:, :r].T, V_t[:, :r] @ E_t[:, :r].T
        assert np.abs(Pt - Pj).max() <= 1e-9 * np.abs(Pj).max(), r
