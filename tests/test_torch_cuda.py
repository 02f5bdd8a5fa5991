"""The port's CUDA kernels K1/K2 on a card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
card.  The file imports no jax, so on a machine with a card and no jax it
runs without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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


def _band(s: int, n_batch: int, dtype, device, seed: int = 0):
    """(N, nb, s, 3s) diagonally dominant band, nb = s, A_0 = B_{nb-1} = 0."""
    rng = np.random.default_rng(seed)
    band = 0.1 * rng.standard_normal((n_batch, s, s, 3 * s))
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
    # s=193 (the nx=192 lane) needs more shared memory than a block has
    with pytest.raises(ValueError, match="shared memory"):
        hk.banded_factorize(torch.zeros((1, 2, 193, 579), device=cuda))
    M, Dinv = hk.banded_factorize(band)
    B = band[..., 34:].contiguous()
    bb = torch.zeros((2, 17, 17, 3), device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        hk.banded_solve(M, Dinv, B, bb.double(), False)
    with pytest.raises(ValueError, match="shape"):
        hk.banded_solve(M, Dinv, B[:1], bb, False)
