"""The port's CUDA kernels K1-K4 on a card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
card.  The file imports no jax, so on a machine with a card and no jax it
runs without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hippyflow_tpu_torch.fem import FunctionSpace, unit_square_mesh
from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior
from hippyflow_tpu_torch.ops import hopper_kernels as hk
from hippyflow_tpu_torch.ops.structured import (
    block_tridiag_matmat,
    block_tridiag_matmat_trans,
    factorize_thomas_inv_banded,
)

pytestmark = pytest.mark.cuda

# kernel vs plain, relative to the largest plain entry.  float64: Gauss-
# Jordan without pivoting (kernel) and pivoted LU (plain) differ by a few
# ulps times the growth along the row chain; float32: plain IEEE float32
# accumulation on both sides (no TF32), 1e-4 is ~1e3 ulps.
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _band(s: int, n_batch: int, dtype, device, seed: int = 0, nb=None):
    """(N, nb, s, 3s) diagonally dominant band, nb = s unless given,
    A_0 = B_{nb-1} = 0."""
    rng = np.random.default_rng(seed)
    band = 0.1 * rng.standard_normal((n_batch, nb or s, s, 3 * s))
    band[:, :, :, s : 2 * s] += 4.0 * np.eye(s)
    band[:, 0, :, :s] = 0.0
    band[:, -1, :, 2 * s :] = 0.0
    return torch.tensor(band, dtype=dtype, device=device)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [17, 33, 65])
def test_kernels_match_plain(cuda, dtype, s):
    """K1 and K2 at the block sizes of the main path (65) and of its
    coarse grids (33, 17), for the Newton (k=1) and Jacobian (k=100,
    transposed) solves and a ragged column tile (k=40)."""
    band = _band(s, 5, dtype, cuda)
    hk.reset_launch_counts()
    M, Dinv = hk.banded_factorize(band)
    M_p, D_p = hk.banded_factorize_plain(band)
    torch.cuda.synchronize()
    assert hk.banded_factorize.launches == 1
    assert _rel(M, M_p) < TOL[dtype] and _rel(Dinv, D_p) < TOL[dtype]
    assert not M[:, 0].any()
    B = band[..., 2 * s :].contiguous()
    gen = torch.Generator(device=cuda).manual_seed(1)
    for k, trans in ((1, False), (1, True), (40, False), (100, True)):
        bb = torch.randn(band.shape[:3] + (k,), dtype=dtype, device=cuda,
                         generator=gen)
        x = hk.banded_solve(M, Dinv, B, bb, trans)
        x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
        torch.cuda.synchronize()
        assert _rel(x, x_p) < TOL[dtype], (k, trans)
    assert hk.banded_solve.launches == 4


@pytest.mark.parametrize("trans", [False, True])
def test_factor_solves_the_system(cuda, trans):
    band = _band(65, 3, torch.float64, cuda, seed=2)
    N, nb, s, _ = band.shape
    b = torch.randn(N, nb * s, 7, dtype=torch.float64, device=cuda)
    x = factorize_thomas_inv_banded(band).solve(b, trans=trans)
    apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
    res = torch.linalg.vector_norm(apply(band, x) - b) / torch.linalg.vector_norm(b)
    assert res.item() < 1e-13


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    band = _band(17, 2, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        hk.banded_factorize(band.half())
    with pytest.raises(ValueError, match="contiguous"):
        hk.banded_factorize(torch.zeros((2, 17, 17, 102), device=cuda)[..., ::2])
    # s=193 (the nx=192 lane) is too wide for the one-block chain; the
    # wrapper takes the row panels there unless told otherwise
    with pytest.raises(ValueError, match="shared memory"):
        hk.banded_factorize(torch.zeros((1, 2, 193, 579), device=cuda),
                            design="chain")
    # no design takes row panels this wide in float64
    with pytest.raises(ValueError, match="shared memory"):
        hk.banded_factorize(torch.zeros((1, 1, 1000, 3000), dtype=torch.float64,
                                        device=cuda))
    M, Dinv = hk.banded_factorize(band)
    B = band[..., 34:].contiguous()
    bb = torch.zeros((2, 17, 17, 3), device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        hk.banded_solve(M, Dinv, B, bb.double(), False)
    with pytest.raises(ValueError, match="shape"):
        hk.banded_solve(M, Dinv, B[:1], bb, False)
    X = torch.eye(5, device=cuda).expand(3, 5, 5)
    with pytest.raises(ValueError, match="contiguous"):
        hk.batched_inverse(X)
    with pytest.raises(TypeError, match="float32 or float64"):
        hk.batched_inverse(X.contiguous().half())
    with pytest.raises(ValueError, match="want"):
        hk.batched_inverse(torch.zeros((3, 5, 4), device=cuda))
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        hk.batched_inverse(torch.zeros((3, 5, 5), device="meta"))


def _dd_batch(n, s, dtype, device, seed=0):
    """(n, s, s) diagonally dominant batch: the contract of K3/K4."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, s, s)) + 2.0 * np.sqrt(s) * np.eye(s)
    return torch.tensor(X, dtype=dtype, device=device)


@pytest.mark.parametrize("rank1", [False, True])
@pytest.mark.parametrize("n", [1, 3, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [17, 33, 65, 193])
def test_batched_inverse_matches_plain(cuda, s, dtype, n, rank1):
    """K3 (width 13) and K4 (width 1) at the cyclic-reduction block sizes of
    the coarse grids (17, 33), nx=64 (65) and nx=192 (193), with the
    identity residual of the result."""
    X = _dd_batch(n, s, dtype, cuda, seed=s + n)
    X0 = X.clone()
    hk.reset_launch_counts()
    Y = hk.batched_inverse(X, rank1=rank1)
    Y_p = hk.batched_inverse_plain(X, 1 if rank1 else hk.GJ_WIDTH)
    torch.cuda.synchronize()
    assert (hk.batched_inverse.rank1_launches, hk.batched_inverse.launches) == (
        (1, 0) if rank1 else (0, 1))
    assert torch.equal(X, X0)
    assert _rel(Y, Y_p) < TOL[dtype]
    eye = torch.eye(s, dtype=dtype, device=cuda)
    assert (X @ Y - eye).abs().max().item() < 1e3 * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,nb,design", [(193, 4, None), (65, 65, "rows")])
def test_factorize_rows_design(cuda, dtype, s, nb, design):
    """K1's row-panel design: at s=193 (picked by shape) and at s=65 (forced),
    against the plain factorization, its plain decomposition and, at s=65,
    the one-block chain."""
    band = _band(s, 3, dtype, cuda, seed=3, nb=nb)
    M, Dinv = hk.banded_factorize(band, design=design)
    M_p, D_p = hk.banded_factorize_plain(band)
    M_r, D_r = hk.banded_factorize_rows_plain(band)
    torch.cuda.synchronize()
    for got in ((M, M_p), (Dinv, D_p), (M, M_r), (Dinv, D_r)):
        assert _rel(*got) < TOL[dtype]
    assert not M[:, 0].any()
    if design == "rows":
        M_c, D_c = hk.banded_factorize(band, design="chain")
        assert _rel(M, M_c) < TOL[dtype] and _rel(Dinv, D_c) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,trans", [(1, False), (1, True), (100, False),
                                     (100, True)])
def test_solve_at_s193(cuda, dtype, k, trans):
    """K2 at the nx=192 block size (the streamed design at k=1, the panels
    at k=100): the Newton and Jacobian solves, against the plain version and
    as a residual of the band."""
    s, nb = 193, 6
    band = _band(s, 2, torch.float64, cuda, seed=4, nb=nb)
    M, Dinv = hk.banded_factorize(band.to(dtype))
    B = band[..., 2 * s :].to(dtype).contiguous()
    bb = torch.randn(2, nb, s, k, dtype=torch.float64, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(k))
    x = hk.banded_solve(M, Dinv, B, bb.to(dtype), trans)
    x_p = hk.banded_solve_plain(M, Dinv, B, bb.to(dtype), trans)
    torch.cuda.synchronize()
    assert _rel(x, x_p) < TOL[dtype]
    apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
    b = bb.reshape(2, nb * s, k)
    res = torch.linalg.vector_norm(
        apply(band, x.double().reshape(2, nb * s, k)) - b
    ) / torch.linalg.vector_norm(b)
    assert res.item() < (1e-4 if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("k", [1, 7, 8, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_designs_at_s65(cuda, dtype, k):
    """K2's streamed (k < 8) and panel (k >= 8) designs at s=65, against the
    plain version: ragged column tiles (k=40) and a panel that is not full
    (65 = 64 + 1 rows) included."""
    band = _band(65, 2, dtype, cuda, seed=5)
    M, Dinv = hk.banded_factorize(band)
    B = band[..., 130:].contiguous()
    bb = torch.randn(2, 65, 65, k, dtype=dtype, device=cuda)
    for trans in (False, True):
        x = hk.banded_solve(M, Dinv, B, bb, trans)
        x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
        torch.cuda.synchronize()
        assert _rel(x, x_p) < TOL[dtype], trans


def test_structured_prior_runs_its_cyclic_reduction_through_k3(cuda):
    """On the card the prior's K and M factorizations invert their blocks
    with K3: one launch per reduction level and one for the root, so at
    nb=17 (5 levels) 6 for K and 6 for M.  Every operator matches the same
    prior on the CPU."""
    V = FunctionSpace(unit_square_mesh(16))
    hk.reset_launch_counts()
    gpu = StructuredBiLaplacianPrior(V, 0.1, 1.0, robin_bc=True,
                                     dtype=torch.float64, device=cuda)
    assert hk.batched_inverse.launches == 12
    cpu = StructuredBiLaplacianPrior(V, 0.1, 1.0, robin_bc=True,
                                     dtype=torch.float64, device="cpu")
    X = torch.randn(V.dim, 3, dtype=torch.float64)
    for op in ("Msolver_matmat", "Ksolver_matmat", "R_matmat",
               "Rsolver_matmat", "sqrtM_matmat"):
        got = getattr(gpu, op)(X.to(cuda)).cpu()
        want = getattr(cpu, op)(X)
        assert _rel(got, want) < 1e-12, op
