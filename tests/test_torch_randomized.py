"""The port's randomized eigensolvers and operator combinators against the
JAX package, in float64 on the CPU, on the same numpy matrices and probe
blocks.

* ``double_pass`` (randomized HEP) and ``accuracy_enhanced_svd``
  (randomized SVD, s = 0, 1, 2 power iterations): values to 1e-10
  relative to the largest, vectors to 1e-10 through their projectors (the
  columns' signs are free);
* ``lanczos_ghep`` on an SPD pencil: eigenvalues to 1e-10 relative,
  vectors to 1e-10 through their B-weighted projectors, for two Krylov
  dimensions;
* the operators of ``ops/operators.py`` on the same blocks, to 1e-12
  relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu.ops import operators as jops
from hippyflow_tpu.ops.randomized import (
    accuracy_enhanced_svd as j_aesvd,
    double_pass as j_double_pass,
    lanczos_ghep as j_lanczos,
)
from hippyflow_tpu_torch.ops import (
    accuracy_enhanced_svd,
    averaged_operator,
    dense_operator,
    double_pass,
    lanczos_ghep,
    low_rank_operator,
    low_rank_rectangular_operator,
    mean_jtj_from_data_operator,
    prior_preconditioned_projector,
    solver_to_operator,
    transpose_operator,
)

torch.set_num_threads(2)

TOL = 1e-10


def _spd(rng, n, decay):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ np.diag(1.0 / np.arange(1, n + 1) ** decay) @ Q.T


def _proj(U):
    return U @ U.T


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_double_pass_matches_jax():
    rng = np.random.default_rng(0)
    n, k = 60, 8
    A = _spd(rng, n, 2.0)
    Om = rng.standard_normal((n, k + 6))
    d_j, U_j = map(np.asarray, j_double_pass(lambda X: jnp.asarray(A) @ X,
                                             jnp.asarray(Om), k, s=1))
    At = torch.as_tensor(A)
    d_t, U_t = map(_np, double_pass(lambda X: At @ X, torch.as_tensor(Om), k, s=1))
    assert d_t.shape == (k,) and U_t.shape == (n, k)
    assert np.abs(d_t - d_j).max() <= TOL * d_j[0]
    assert np.abs(_proj(U_t) - _proj(U_j)).max() <= TOL
    assert np.all(np.diff(d_t) <= 0)


@pytest.mark.parametrize("s", [0, 1, 2])
def test_accuracy_enhanced_svd_matches_jax(s):
    rng = np.random.default_rng(1 + s)
    dq, dm, k = 20, 50, 6
    A = (rng.standard_normal((dq, 12)) / np.arange(1, 13) ** 1.5) @ \
        rng.standard_normal((12, dm))
    Om = rng.standard_normal((dm, k + 5))
    Aj = jnp.asarray(A)
    U_j, s_j, V_j = map(np.asarray, j_aesvd(lambda X: Aj @ X, lambda X: Aj.T @ X,
                                            jnp.asarray(Om), k, s=s))
    At = torch.as_tensor(A)
    U_t, s_t, V_t = map(_np, accuracy_enhanced_svd(
        lambda X: At @ X, lambda X: At.T @ X, torch.as_tensor(Om), k, s=s))
    assert U_t.shape == (dq, k) and s_t.shape == (k,) and V_t.shape == (dm, k)
    assert np.abs(s_t - s_j).max() <= TOL * s_j[0]
    # U diag(s) V^T is sign-free
    np.testing.assert_allclose((U_t * s_t) @ V_t.T, (U_j * s_j) @ V_j.T,
                               rtol=0, atol=TOL * s_j[0])
    assert np.abs(_proj(U_t) - _proj(U_j)).max() <= TOL
    assert np.abs(_proj(V_t) - _proj(V_j)).max() <= TOL


@pytest.mark.parametrize("m_iters", [None, 40])
def test_lanczos_ghep_matches_jax(m_iters):
    """The k smallest eigenpairs of A v = lambda B v through A^{-1}."""
    rng = np.random.default_rng(7)
    n, k = 50, 5
    A = _spd(rng, n, -1.0)  # eigenvalues 1..n: the small ones separated
    X = rng.standard_normal((n, n))
    B = X @ X.T / n + np.eye(n)
    Ainv = np.linalg.inv(A)
    v0 = np.ones(n)
    lam_j, V_j = map(np.asarray, j_lanczos(
        lambda Z: jnp.asarray(Ainv) @ Z, lambda Z: jnp.asarray(B) @ Z,
        jnp.asarray(v0), k, m_iters=m_iters))
    Ait, Bt = torch.as_tensor(Ainv), torch.as_tensor(B)
    lam_t, V_t = map(_np, lanczos_ghep(lambda Z: Ait @ Z, lambda Z: Bt @ Z,
                                       torch.as_tensor(v0), k, m_iters=m_iters))
    assert lam_t.shape == (k,) and V_t.shape == (n, k)
    np.testing.assert_allclose(lam_t, lam_j, rtol=TOL)
    assert np.all(np.diff(lam_t) >= 0)
    # B-orthonormal, and the same B-weighted projectors
    np.testing.assert_allclose(V_t.T @ B @ V_t, np.eye(k), atol=TOL)
    np.testing.assert_allclose(V_t @ V_t.T @ B, V_j @ V_j.T @ B, atol=TOL)
    # against the dense GHEP
    w = np.sort(np.linalg.eigvals(np.linalg.solve(B, A)).real)[:k]
    np.testing.assert_allclose(lam_t, w, rtol=1e-8)


def test_operators_match_jax():
    rng = np.random.default_rng(11)
    n, k = 30, 4
    A = rng.standard_normal((n, n))
    U, _ = np.linalg.qr(rng.standard_normal((n, k)))
    W = rng.standard_normal((20, k))
    d = rng.random(k) + 0.5
    X = rng.standard_normal((n, 3))
    C = _spd(rng, n, 0.5) + np.eye(n)
    Jd = rng.standard_normal((5, 7, n))
    P = _spd(rng, 7, 0.0)
    jj, tt = jnp.asarray, torch.as_tensor
    pairs = [
        (jops.dense_operator(jj(A)), dense_operator(tt(A))),
        (jops.low_rank_operator(jj(d), jj(U)), low_rank_operator(tt(d), tt(U))),
        (jops.prior_preconditioned_projector(jj(U), lambda Z: jj(C) @ Z),
         prior_preconditioned_projector(tt(U), lambda Z: tt(C) @ Z)),
        (jops.mean_jtj_from_data_operator(jj(Jd)), mean_jtj_from_data_operator(tt(Jd))),
        (jops.mean_jtj_from_data_operator(jj(Jd), jj(P)),
         mean_jtj_from_data_operator(tt(Jd), tt(P))),
        (jops.solver_to_operator(lambda Z: jnp.linalg.solve(jj(C), Z)),
         solver_to_operator(lambda Z: torch.linalg.solve(tt(C), Z))),
        (jops.transpose_operator(jj(A)), transpose_operator(tt(A))),
        (jops.averaged_operator([jops.dense_operator(jj(A)),
                                 jops.dense_operator(jj(C))]),
         averaged_operator([dense_operator(tt(A)), dense_operator(tt(C))])),
        (jops.averaged_operator([jops.dense_operator(jj(A))] * 2, average=False),
         averaged_operator([dense_operator(tt(A))] * 2, average=False)),
    ]
    for i, (fj, ft) in enumerate(pairs):
        want = np.asarray(fj(jj(X)))
        got = _np(ft(tt(X)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max(), err_msg=str(i))
    # the rectangular low-rank pair and its transpose
    mj, rj = jops.low_rank_rectangular_operator(jj(W), jj(d), jj(U))
    mt, rt = low_rank_rectangular_operator(tt(W), tt(d), tt(U))
    np.testing.assert_allclose(_np(mt(tt(X))), np.asarray(mj(jj(X))), atol=1e-12)
    Y = rng.standard_normal((20, 2))
    np.testing.assert_allclose(_np(rt(tt(Y))), np.asarray(rj(jj(Y))), atol=1e-12)
    np.testing.assert_allclose(
        _np(transpose_operator((mt, rt))(tt(Y))), np.asarray(rj(jj(Y))), atol=1e-12)
