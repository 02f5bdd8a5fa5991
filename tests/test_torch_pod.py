"""The port's POD from data against the JAX package.

``PODProjectorFromData`` with the mass matrix of a P1 space at nx=8, in
float64 on the CPU, on the same numpy data: the three methods (hep, ghep,
inverse_ghep), shifted or not.  Eigenvalues agree to 1e-10 relative to the
largest, the basis phi (and M phi) to 1e-9 up to column signs, the shift
exactly up to rounding.  Also ``generalized_eigh`` on a small pencil, and
M = I as the training lane calls it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu.fem import FunctionSpace as JSpace, unit_square_mesh as j_mesh
from hippyflow_tpu.models import PODProjectorFromData as JPOD
from hippyflow_tpu.ops.linalg import generalized_eigh as j_generalized_eigh
from hippyflow_tpu_torch.fem import FunctionSpace as TSpace, unit_square_mesh as t_mesh
from hippyflow_tpu_torch.models import PODProjectorFromData as TPOD
from hippyflow_tpu_torch.ops import generalized_eigh

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N_DATA, RANK = 8, 40, 8


@pytest.fixture(scope="module")
def pods():
    Vj, Vt = JSpace(j_mesh(NX)), TSpace(t_mesh(NX))
    rng = np.random.default_rng(4)
    x = Vt.dof_coords
    modes = np.stack([
        np.sin((i + 1) * np.pi * x[:, 0]) * np.sin((j + 1) * np.pi * x[:, 1])
        / (1.0 + i + 2 * j) ** 2
        for i in range(5) for j in range(5)
    ])
    u = rng.standard_normal((N_DATA, modes.shape[0])) @ modes + 0.7
    return JPOD([Vj]), TPOD([Vt], **F64), u


def _match_columns(got, want, tol):
    for i in range(want.shape[1]):
        sign = np.sign(got[:, i] @ want[:, i])
        err = np.abs(sign * got[:, i] - want[:, i]).max() / np.abs(want[:, i]).max()
        assert err <= tol, f"column {i}: {err:.3e}"


@pytest.mark.parametrize("method", ["hep", "ghep", "inverse_ghep"])
@pytest.mark.parametrize("shifted", [True, False])
def test_pod_from_data_matches_jax(pods, method, shifted):
    jpod, tpod, u = pods
    np.testing.assert_allclose(tpod.M.numpy(), np.asarray(jpod.M), rtol=0, atol=1e-15)
    dj, phij, Mphij, shiftj = map(np.asarray, jpod.construct_subspace(
        jnp.asarray(u), RANK, shifted=shifted, method=method))
    dt, phit, Mphit, shiftt = (a.numpy() for a in tpod.construct_subspace(
        torch.as_tensor(u), RANK, shifted=shifted, method=method))
    assert dt.shape == (RANK,) and phit.shape == (u.shape[1], RANK)
    assert np.abs(dt - dj).max() <= 1e-10 * abs(dj[0])
    np.testing.assert_allclose(shiftt, shiftj, rtol=1e-14, atol=1e-15)
    _match_columns(phit, phij, 1e-9)
    _match_columns(Mphit, Mphij, 1e-9)
    # M-orthonormal
    np.testing.assert_allclose(phit.T @ tpod.M.numpy() @ phit, np.eye(RANK), atol=1e-9)


def test_pod_verify_prints(pods, capsys):
    _, tpod, u = pods
    tpod.construct_subspace(torch.as_tensor(u), RANK, verify=True)
    out = capsys.readouterr().out
    assert "Basis Orthogonality error" in out and "Mean reconstruction error" in out


def test_pod_identity_weight_matches_jax():
    """M = I, shifted, hep: the output POD of the training lane."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((50, 12)) @ rng.standard_normal((12, 12)) + 3.0
    dj, phij, _, sj = map(np.asarray, JPOD(None, M_output=np.eye(12)).construct_subspace(
        jnp.asarray(q), 6, shifted=True, method="hep"))
    tpod = TPOD(None, M_output=torch.eye(12, dtype=torch.float64))
    dt, phit, _, st = (a.numpy() for a in tpod.construct_subspace(
        torch.as_tensor(q), 6, shifted=True, method="hep"))
    assert np.abs(dt - dj).max() <= 1e-10 * abs(dj[0])
    np.testing.assert_allclose(st, sj, rtol=1e-14)
    _match_columns(phit, phij, 1e-9)
    with pytest.raises(ValueError):
        tpod.construct_subspace(torch.as_tensor(q), 6, method="svd")


def test_generalized_eigh_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((15, 15))
    A = X @ X.T
    Y = rng.standard_normal((15, 15))
    B = Y @ Y.T / 15 + np.eye(15)
    dj, Vj = map(np.asarray, j_generalized_eigh(jnp.asarray(A), jnp.asarray(B)))
    dt, Vt = (a.numpy() for a in generalized_eigh(torch.as_tensor(A), torch.as_tensor(B)))
    np.testing.assert_allclose(dt, dj, rtol=1e-12)
    assert np.all(np.diff(dt) <= 0)
    np.testing.assert_allclose(Vt.T @ B @ Vt, np.eye(15), atol=1e-12)
    _match_columns(Vt, Vj, 1e-10)
    da, _ = generalized_eigh(torch.as_tensor(A), torch.as_tensor(B), descending=False)
    np.testing.assert_allclose(da.numpy(), dj[::-1], rtol=1e-12)
