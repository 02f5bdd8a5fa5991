"""The structured (banded) BiLaplacian prior of the PyTorch port against the
JAX package, on the same numpy inputs, in float64 on the CPU.

* banded mass, stiffness and boundary-mass matrices: exactly equal;
* K3/K4 ``batched_inverse`` (plain version, pivot width 13 and 1) against
  the Pallas kernels in interpret mode (``force="pallas"`` /
  ``"pallas_rank1"``), ``blocked_inverse`` and ``torch.linalg.inv``;
* cyclic reduction: the factor's levels and its forward and transposed
  solves, and the port's solve on the JAX factor itself (``interop``);
* block Cholesky, the prior's operators and samples, ``confusion_prior``;
* the row-panel design of K1 (Schur step, then the K3 inverse);
* the input active subspace with the structured prior: at nx=12 against
  the JAX pipeline and the port's dense-prior run, and at nx=64 against
  the stored parity reference.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applications.confusion import (
    confusion_linear_observable as j_observable,
)
from hippyflow_tpu import fem as jfem
from hippyflow_tpu.models import (
    ActiveSubspaceParameterList as JParams,
    ActiveSubspaceProjector as JProjector,
    StructuredBiLaplacianPrior as JStructuredPrior,
)
from hippyflow_tpu.models.prior import aniso_tensor_2d
from hippyflow_tpu.ops.pallas_kernels import batched_inverse as j_batched_inverse
from hippyflow_tpu.ops.pallas_kernels import blocked_inverse as j_blocked_inverse
from hippyflow_tpu.ops.structured import (
    block_cholesky_tridiag as j_block_cholesky,
    factorize_block_cyclic_banded as j_factorize_cr,
)
from hippyflow_tpu_torch import fem as tfem
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable as t_observable,
    confusion_prior as t_prior,
    load_ns_velocity,
)
from hippyflow_tpu_torch.models import (
    ActiveSubspaceParameterList as TParams,
    ActiveSubspaceProjector as TProjector,
    BiLaplacianPrior,
    StructuredBiLaplacianPrior,
    VariationalPDEProblem,
    auto_chunk_size,
)
from hippyflow_tpu_torch.ops import hopper_kernels as hk
from hippyflow_tpu_torch.ops.structured import (
    block_cholesky_tridiag,
    factorize_block_cyclic_banded,
)

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float64 throughout: Gauss-Jordan without pivoting (port) and LU with
# pivoting (the JAX package's CPU path) differ by a few ulps of the
# diagonally dominant blocks
TOL = 1e-12
PRIOR = dict(gamma=0.1, delta=1.0)


def _spaces(nx: int):
    return (jfem.FunctionSpace(jfem.unit_square_mesh(nx)),
            tfem.FunctionSpace(tfem.unit_square_mesh(nx)))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# banded canonical matrices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["mass", "stiffness", "boundary_mass"])
def test_banded_matrices_equal_jax(which):
    from hippyflow_tpu.fem.assembly import (
        boundary_mass_matrix_banded,
        mass_matrix_banded,
        stiffness_matrix_banded,
    )

    jV, tV = _spaces(12)
    if which == "mass":
        want, got = mass_matrix_banded(jV), tfem.mass_matrix_banded(tV, **F64)
    elif which == "stiffness":
        tensor = aniso_tensor_2d(2.0, 0.5, np.pi / 4)
        want = stiffness_matrix_banded(jV, tensor)
        got = tfem.stiffness_matrix_banded(tV, tensor, **F64)
    else:
        want = boundary_mass_matrix_banded(jV)
        got = tfem.boundary_mass_matrix_banded(tV, **F64)
    assert got.shape == (13, 13, 39) and got.dtype == torch.float64
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# K3/K4: batched Gauss-Jordan inverse
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fem_blocks(s: int) -> np.ndarray:
    """Diagonal blocks (s of them, s x s) of the bc-symmetrized confusion
    Newton operator at nx = s - 1, as ``tests/test_structured.py`` builds
    them."""
    obs, V = j_observable(nx=s - 1, velocity="analytic")
    pde = obs.problem
    band = pde.bound.assemble_A_banded(
        jnp.zeros(V.dim), jnp.zeros(V.dim), None, s
    )
    band = jfem.bc_symmetrize_banded(band, *jfem.band_bc_masks(pde.bc, s, band.dtype))
    return np.asarray(band[:, :, s : 2 * s])


def _inverse_inputs(kind: str, s: int, n: int) -> np.ndarray:
    if kind == "fem":
        return np.resize(_fem_blocks(s), (n, s, s))
    rng = np.random.default_rng(10 * s + n)
    return rng.standard_normal((n, s, s)) + s * np.eye(s)


@pytest.mark.parametrize("kind", ["random", "fem"])
@pytest.mark.parametrize("rank1", [False, True])
@pytest.mark.parametrize("s,n", [(5, 11), (13, 8), (17, 3), (33, 1)])
def test_batched_inverse_matches_pallas_interpret(kind, rank1, s, n):
    """K3 (width 13) and K4 (width 1) against the Pallas kernel each one
    replaces, run in interpret mode; N=11 is not a multiple of the
    interpret tile (8), s=5 and s=13 are narrower than or equal to one
    pivot block, s=17 and 33 end on a ragged block."""
    X = _inverse_inputs(kind, s, n)
    got = _np(hk.batched_inverse(interop.tensor(X, **F64), rank1=rank1))
    want = np.asarray(j_batched_inverse(
        jnp.asarray(X), force="pallas_rank1" if rank1 else "pallas"))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    ref = torch.linalg.inv(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())
    if not rank1:
        blk = np.asarray(j_blocked_inverse(jnp.asarray(X), 13))
        np.testing.assert_allclose(got, blk, rtol=0, atol=TOL * np.abs(blk).max())


@functools.lru_cache(maxsize=None)
def _jax_blocked_inverses(s: int):
    """Two diagonally dominant s x s matrices, and their inverses by the
    Pallas kernel K3 replaces (interpret mode) and by ``blocked_inverse``."""
    X = _inverse_inputs("random", s, 2)
    return (X, np.asarray(j_batched_inverse(jnp.asarray(X), force="pallas")),
            np.asarray(j_blocked_inverse(jnp.asarray(X), 13)))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("s", [17, 65, 193])
def test_batched_inverse_cluster_schedule_matches_jax(s, c):
    """K3's schedule for a cluster of c blocks per matrix (pivot columns
    staged first, the column slices updated one after another, the pivot
    columns' owners last) against the Pallas kernel and ``blocked_inverse``;
    s=17 has one 32-column chunk (c - 1 slices are empty), s=193 seven with
    a ragged last one; the wrapper takes the same schedule on the CPU."""
    X, want_pallas, want_blocked = _jax_blocked_inverses(s)
    Xt = interop.tensor(X, **F64)
    got = hk.batched_inverse_plain(Xt, 13, slices=c)
    for want in (want_pallas, want_blocked):
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    assert torch.equal(hk.batched_inverse(Xt, cluster=c), got)


def test_batched_inverse_widths_agree_and_keep_input():
    X = interop.tensor(_inverse_inputs("random", 29, 4), **F64)
    X0 = X.clone()
    a = hk.batched_inverse_plain(X, 13)
    for w in (1, 4, 16, 29, 40):
        np.testing.assert_allclose(_np(hk.batched_inverse_plain(X, w)), _np(a),
                                   rtol=0, atol=1e-13)
    assert torch.equal(X, X0)


# ---------------------------------------------------------------------------
# cyclic reduction and block Cholesky
# ---------------------------------------------------------------------------


def _random_band(nb: int, s: int, seed: int) -> np.ndarray:
    """(nb, s, 3s) nonsymmetric, diagonally dominant band; A_0 = B_{nb-1} = 0."""
    rng = np.random.default_rng(seed)
    band = 0.3 * rng.standard_normal((nb, s, 3 * s))
    band[:, :, s : 2 * s] += 4.0 * np.eye(s)
    band[0, :, :s] = 0.0
    band[-1, :, 2 * s :] = 0.0
    return band


def _dense(band: np.ndarray) -> np.ndarray:
    nb, s, _ = band.shape
    A = np.zeros((nb * s, nb * s))
    for j in range(nb):
        rows = slice(j * s, (j + 1) * s)
        A[rows, j * s : (j + 1) * s] = band[j, :, s : 2 * s]
        if j > 0:
            A[rows, (j - 1) * s : j * s] = band[j, :, :s]
        if j < nb - 1:
            A[rows, (j + 1) * s : (j + 2) * s] = band[j, :, 2 * s :]
    return A


def _levels_np(levels):
    return None if levels is None else [
        tuple(np.asarray(a) for a in lv) for lv in levels
    ]


@pytest.mark.parametrize("nb", [1, 2, 5, 8, 13])
def test_block_cyclic_matches_jax(nb):
    """Levels, roots and solves of the port's cyclic reduction against the
    JAX package's, forward, transposed and adjoint-only, at odd and even
    block counts (the padded neighbour tables); then the port's solve on
    the converted JAX factor."""
    s = 4
    band = _random_band(nb, s, seed=nb)
    rhs = np.random.default_rng(100 + nb).standard_normal((nb * s, 3))
    A = _dense(band)
    jfac = j_factorize_cr(jnp.asarray(band), with_transpose=True)
    tfac = factorize_block_cyclic_banded(interop.tensor(band, **F64),
                                         with_transpose=True)
    assert len(tfac.levels) == len(jfac.levels) == int(np.ceil(np.log2(nb)))
    for tl, jl in zip(tfac.levels + tfac.trans_levels,
                      jfac.levels + jfac.trans_levels):
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tfac.Dinv_root), np.asarray(jfac.Dinv_root),
                               rtol=0, atol=TOL)
    r = interop.tensor(rhs, **F64)
    for trans in (False, True):
        want = np.asarray(jfac.solve(jnp.asarray(rhs), trans=trans))
        np.testing.assert_allclose(_np(tfac.solve(r, trans=trans)), want,
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(want, np.linalg.solve(A.T if trans else A, rhs),
                                   rtol=0, atol=1e-10)
        # 1-d rhs
        np.testing.assert_allclose(_np(tfac.solve(r[:, 0], trans=trans)),
                                   want[:, 0], rtol=0, atol=TOL)
    adj = factorize_block_cyclic_banded(interop.tensor(band, **F64),
                                        with_forward=False)
    assert adj.levels is None
    np.testing.assert_allclose(_np(adj.solve(r, trans=True)),
                               _np(tfac.solve(r, trans=True)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="not factorized"):
        adj.solve(r)
    conv = interop.block_cyclic_factor(
        _levels_np(jfac.levels), np.asarray(jfac.Dinv_root),
        _levels_np(jfac.trans_levels), np.asarray(jfac.Dinv_root_T), **F64,
    )
    for trans in (False, True):
        np.testing.assert_allclose(
            _np(conv.solve(r, trans=trans)),
            np.asarray(jfac.solve(jnp.asarray(rhs), trans=trans)),
            rtol=0, atol=TOL,
        )


@pytest.mark.parametrize("robin", [False, True])
def test_block_cholesky_matches_jax(robin):
    """L of the K band (SPD), L @ X against the JAX package's and L L^T
    against the dense matrix."""
    jV, tV = _spaces(9)
    jpr = JStructuredPrior(jV, robin_bc=robin, **PRIOR)
    band = np.asarray(jpr.K_band)
    jL = j_block_cholesky(jnp.asarray(band))
    tL = block_cholesky_tridiag(interop.tensor(band, **F64))
    X = np.random.default_rng(7).standard_normal((jV.dim, 4))
    got = _np(tL.matvec_L(interop.tensor(X, **F64)))
    np.testing.assert_allclose(got, np.asarray(jL.matvec_L(jnp.asarray(X))),
                               rtol=0, atol=TOL * np.abs(got).max())
    L = _np(tL.matvec_L(torch.eye(jV.dim, dtype=torch.float64)))
    np.testing.assert_allclose(L @ L.T, _dense(band), rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# the structured prior
# ---------------------------------------------------------------------------

_OPERATORS = ("M_matmat", "Msolver_matmat", "sqrtM_matmat", "K_matmat",
              "Ksolver_matmat", "R_matmat", "Rsolver_matmat", "C_matmat")


@functools.lru_cache(maxsize=None)
def _priors(robin: bool):
    jV, tV = _spaces(12)
    return (JStructuredPrior(jV, robin_bc=robin, **PRIOR),
            StructuredBiLaplacianPrior(tV, robin_bc=robin, **PRIOR, **F64))


@pytest.mark.parametrize("robin", [False, True])
@pytest.mark.parametrize("op", _OPERATORS + ("sample",))
def test_structured_prior_matches_jax(robin, op):
    jpr, tpr = _priors(robin)
    assert tpr.dim == tpr.noise_dim == jpr.dim
    np.testing.assert_array_equal(_np(tpr.mean), np.asarray(jpr.mean))
    rng = np.random.default_rng(3)
    if op == "sample":
        X = rng.standard_normal((5, jpr.noise_dim))
        for x in (X, X[0]):
            want = np.asarray(jpr.sample(jnp.asarray(x)))
            got = _np(tpr.sample(interop.tensor(x, **F64)))
            np.testing.assert_allclose(got, want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max())
        return
    X = rng.standard_normal((jpr.dim, 5))
    want = np.asarray(getattr(jpr, op)(jnp.asarray(X)))
    got = _np(getattr(tpr, op)(interop.tensor(X, **F64)))
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_structured_prior_matches_dense():
    """robin_bc off: the banded prior is the port's dense prior, to the
    JAX package's own limits (``tests/test_prior.py``)."""
    _, tV = _spaces(12)
    _, banded = _priors(False)
    dense = BiLaplacianPrior(tV, **PRIOR, **F64)
    X = interop.tensor(np.random.default_rng(0).standard_normal((tV.dim, 5)), **F64)
    for op in _OPERATORS:
        np.testing.assert_allclose(_np(getattr(banded, op)(X)),
                                   _np(getattr(dense, op)(X)),
                                   rtol=1e-9, atol=1e-11, err_msg=op)
    np.testing.assert_allclose(_np(banded.sample(X.T)), _np(dense.sample(X.T)),
                               rtol=1e-9, atol=1e-11)


def test_confusion_prior_switches_above_20000_dofs():
    _, tV = _spaces(12)
    small = t_prior(tV, **F64)
    assert type(small) is BiLaplacianPrior
    big_V = tfem.FunctionSpace(tfem.unit_square_mesh(142))
    assert big_V.dim == 20449
    big = t_prior(big_V, **F64)
    assert type(big) is StructuredBiLaplacianPrior
    assert (big.gamma, big.delta) == (0.1, 1.0)
    assert big.K_band.shape == (143, 143, 429)
    assert len(big._K_fac.levels) == 8 and big._K_fac.trans_levels is None


# ---------------------------------------------------------------------------
# K1's row-panel design, chunking at nx=192
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [6, 17])
def test_factorize_rows_plain_matches_chain(s):
    """The algorithm of K1's large-s design (Schur step per block row, then
    the width-13 inverse) against the plain block-Thomas factorization."""
    rng = np.random.default_rng(s)
    band = 0.1 * rng.standard_normal((3, s, s, 3 * s))
    band[:, :, :, s : 2 * s] += 4.0 * np.eye(s)
    band[:, 0, :, :s] = 0.0
    band[:, -1, :, 2 * s :] = 0.0
    band = interop.tensor(band, **F64)
    M, Dinv = hk.banded_factorize_rows_plain(band)
    M_p, D_p = hk.banded_factorize_plain(band)
    assert not M[:, 0].any()
    np.testing.assert_allclose(_np(M), _np(M_p), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(Dinv), _np(D_p), rtol=0, atol=TOL)


class _Problem:
    state_dim, _block_size = 37249, 193  # confusion at nx=192
    bytes_per_sample = VariationalPDEProblem.bytes_per_sample


def test_auto_chunk_size_at_nx192():
    """16 n s bytes per sample: 460 MB in float32 at nx=192, so a 2 GB
    budget (the CPU's) takes 4 samples and a quarter of an 80 GB card
    would take 43, rounded down to 32."""
    per_sample = 16 * 37249 * 193 * 4
    assert 4.5e8 < per_sample < 4.7e8
    assert auto_chunk_size(_Problem.state_dim, torch.float32, problem=_Problem(),
                           device="cpu") == 4
    assert auto_chunk_size(_Problem.state_dim, torch.float64, problem=_Problem(),
                           device="cpu") == 2
    assert 1 << (int(20e9 / per_sample).bit_length() - 1) == 32


def test_chunk_sizes_are_honoured():
    """chunk_size bounds every forward Newton batch and jac_chunk_size every
    linearization (the nx=192 lane runs 32 and 16)."""
    obs, tV = t_observable(nx=8, velocity="analytic", **F64)
    prior = t_prior(tV, **F64)
    pde = obs.problem
    seen = {"fwd": [], "lin": []}
    solve_fwd, linearize = pde.solve_fwd, pde.linearize

    def spy_fwd(m, z=None, u0=None):
        seen["fwd"].append(m.shape[0])
        return solve_fwd(m, z=z, u0=u0)

    def spy_lin(u, m, z=None, needs="both"):
        seen["lin"].append(u.shape[0])
        return linearize(u, m, z, needs=needs)

    pde.solve_fwd, pde.linearize = spy_fwd, spy_lin
    p = TParams()
    p["samples_per_process"], p["rank"], p["oversampling"] = 12, 4, 2
    p["chunk_size"], p["jac_chunk_size"], p["verbose"] = 8, 4, False
    d, _, _ = TProjector(obs, prior, parameters=p).construct_input_subspace()
    assert seen["fwd"] == [8, 4] and seen["lin"] == [4, 4, 4]
    assert torch.isfinite(d).all()


# ---------------------------------------------------------------------------
# the pipeline with the structured prior
# ---------------------------------------------------------------------------

NX, N_SAMPLES, RANK, OVERSAMPLING = 12, 8, 10, 10


def _head(d_ref, frac=1e-4):
    return np.abs(d_ref) > frac * abs(d_ref[0])


@functools.lru_cache(maxsize=None)
def _pipeline_runs():
    jobs, jV = j_observable(nx=NX, velocity="analytic")
    jpr = JStructuredPrior(jV, **PRIOR)
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((N_SAMPLES, jV.dim))
    omega = rng.standard_normal((jV.dim, RANK + OVERSAMPLING))

    def params(P):
        p = P()
        p["rank"], p["oversampling"] = RANK, OVERSAMPLING
        p["samples_per_process"] = N_SAMPLES
        p["ms_given"], p["verbose"] = True, False
        return p

    jproj = JProjector(jobs, jpr, parameters=params(JParams))
    jproj.ms = jpr.sample(jnp.asarray(xi))
    jproj.Omega_GN = jnp.asarray(omega)
    d_j = np.asarray(jproj.construct_input_subspace()[0])

    tobs, tV = t_observable(nx=NX, velocity="analytic", **F64)
    out = []
    for prior in (StructuredBiLaplacianPrior(tV, **PRIOR, **F64),
                  BiLaplacianPrior(tV, **PRIOR, **F64)):
        tproj = TProjector(tobs, prior, parameters=params(TParams))
        tproj.ms = prior.sample(interop.tensor(xi, **F64))
        tproj.Omega_GN = interop.tensor(omega, **F64)
        out.append(tproj.construct_input_subspace()[0].numpy())
    return d_j, out[0], out[1]


def test_pipeline_structured_prior_matches_jax():
    d_j, d_t, _ = _pipeline_runs()
    head = _head(d_j)
    assert head.sum() >= 3
    assert np.all(np.diff(d_t) <= 0)
    assert (np.abs(d_t - d_j) / np.abs(d_j))[head].max() <= 1e-8


def test_pipeline_structured_prior_matches_dense_prior():
    _, d_t, d_dense = _pipeline_runs()
    head = _head(d_dense)
    assert (np.abs(d_t - d_dense) / np.abs(d_dense))[head].max() <= 1e-10


def test_parity_reference_nx64_structured_prior():
    """The nx=64 parity check of ``bench.py`` with the structured prior in
    place of the dense one: eigenvalues above 1e-4 lambda_0 within 1e-8."""
    data = np.load(os.path.join(REPO, ".bench", "parity_ref.npz"))
    nx, rank = int(data["nx"]), int(data["rank"])
    obs, Vh = t_observable(nx=nx, velocity=load_ns_velocity(nx), **F64)
    prior = StructuredBiLaplacianPrior(Vh, **PRIOR, **F64)
    params = TParams()
    params["rank"], params["oversampling"] = rank, 10
    params["samples_per_process"] = data["xi"].shape[0]
    params["ms_given"], params["verbose"] = True, False
    proj = TProjector(obs, prior, parameters=params)
    proj.ms = prior.sample(interop.tensor(data["xi"], **F64))
    proj.Omega_GN = interop.tensor(data["Omega"], **F64)
    d = proj.construct_input_subspace()[0].numpy()[:rank]
    d_ref = data["d_ref"][:rank]
    head = _head(d_ref)
    assert head.sum() >= 5
    assert (np.abs(d - d_ref) / np.abs(d_ref))[head].max() <= 1e-8
