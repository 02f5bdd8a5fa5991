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
    # s=193 (the nx=192 lane) is too wide for the chain; the wrapper takes
    # the row panels there unless told otherwise
    with pytest.raises(ValueError, match="shared memory"):
        hk.banded_factorize(torch.zeros((1, 2, 193, 579), device=cuda),
                            design="chain")
    # no design takes block rows this wide in float64: the Schur step's
    # panels fit, K3's pivot columns (16 x 1500) do not
    with pytest.raises(ValueError, match="shared memory"):
        hk.banded_factorize(torch.zeros((1, 1, 1500, 4500), dtype=torch.float64,
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


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, None])
@pytest.mark.parametrize("rank1", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [17, 65, 193, 516])
def test_batched_inverse_clusters_match_plain(cuda, s, dtype, rank1, cluster):
    """K3 and K4 with each forced number of blocks per matrix (and the
    picked one, None) against the plain version, with the identity
    residual: one 32-column chunk at s=17 (blocks without columns), a
    ragged last chunk and pivot blocks across chunk edges at 65, 193, 516."""
    X = _dd_batch(3, s, dtype, cuda, seed=s + 7)
    hk.reset_launch_counts()
    Y = hk.batched_inverse(X, rank1=rank1, cluster=cluster)
    Y_p = hk.batched_inverse_plain(X, 1 if rank1 else hk.GJ_WIDTH)
    torch.cuda.synchronize()
    assert (hk.batched_inverse.rank1_launches, hk.batched_inverse.launches) == (
        (1, 0) if rank1 else (0, 1))
    assert _rel(Y, Y_p) < TOL[dtype]
    eye = torch.eye(s, dtype=dtype, device=cuda)
    assert (X @ Y - eye).abs().max().item() < 1e3 * torch.finfo(dtype).eps


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s", [(32, 193), (16, 193), (4, 65)])
def test_batched_inverse_row_strided_in_a_factor(cuda, n, s, dtype, cluster):
    """K3 on one block row of an (N, nb, s, s) buffer, as K1's row design
    calls it: the row is inverted in place and its neighbours come out
    bit for bit untouched."""
    nb, j = 8, 5
    buf = torch.stack([_dd_batch(n, s, dtype, cuda, seed=q) for q in range(nb)],
                      dim=1).contiguous()
    before = buf.clone()
    hk.reset_launch_counts()
    hk.batched_inverse_row_(buf, j, cluster=cluster)
    want = hk.batched_inverse_plain(before[:, j])
    torch.cuda.synchronize()
    assert hk.batched_inverse.launches == 1
    assert _rel(buf[:, j], want) < TOL[dtype]
    for q in range(nb):
        if q != j:
            assert torch.equal(buf[:, q], before[:, q]), q


@pytest.mark.parametrize("cluster", [0, 9, -1])
def test_batched_inverse_refuses_a_bad_cluster(cuda, cluster):
    """The kernel takes 1 to 8 blocks per matrix; any other count is
    refused at the launch and the wrapper raises (no other path runs)."""
    X = _dd_batch(2, 65, torch.float32, cuda)
    hk.reset_launch_counts()
    for rank1 in (False, True):
        with pytest.raises(RuntimeError, match="launch failed"):
            hk.batched_inverse(X, rank1=rank1, cluster=cluster)
    buf = X.reshape(1, 2, 65, 65).contiguous()
    with pytest.raises(RuntimeError, match="launch failed"):
        hk.batched_inverse_row_(buf, 0, cluster=cluster)
    assert hk.batched_inverse.launches == hk.batched_inverse.rank1_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,nb,design", [(193, 4, None), (65, 65, "rows")])
def test_factorize_rows_design(cuda, dtype, s, nb, design):
    """K1's row-panel design: at s=193 (picked by shape) and at s=65 (forced),
    against the plain factorization, its plain decomposition and, at s=65,
    the chain."""
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


def _schur_case(s, n, dtype, device, nb=3, seed=0):
    """A band (n, nb, s, 3s) and M, Dinv buffers (n, nb, s, s) filled with
    random entries (rows the step must leave alone), Dinv's rows scaled
    like inverses of the band's diagonal blocks."""
    band = _band(s, n, dtype, device, seed=seed, nb=nb)
    gen = torch.Generator(device=device).manual_seed(seed)
    M = torch.randn(n, nb, s, s, dtype=dtype, device=device, generator=gen)
    Dinv = torch.randn(n, nb, s, s, dtype=dtype, device=device,
                       generator=gen) / s**0.5
    return band, M, Dinv


def _check_schur(band, M, Dinv, j, dtype, want=None):
    """The Schur step at row j against its plain version (``want``: its
    (M_j, T_j), else computed here); every other row of M and Dinv bit for
    bit untouched."""
    M0, D0 = M.clone(), Dinv.clone()
    if want is None:
        want = hk.schur_step_plain(band, D0[:, j - 1] if j else None, j)
    hk.schur_step_(band, M, Dinv, j)
    torch.cuda.synchronize()
    assert _rel(M[:, j], want[0]) < TOL[dtype] if j else not M[:, j].any()
    assert _rel(Dinv[:, j], want[1]) < TOL[dtype]
    others = [q for q in range(M.shape[1]) if q != j]
    assert torch.equal(M[:, others], M0[:, others])
    assert torch.equal(Dinv[:, others], D0[:, others])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 16, 32])
@pytest.mark.parametrize("s", [17, 25, 33, 65, 97, 193, 516])
def test_schur_step_matches_plain(cuda, s, n, dtype):
    """K1's Schur step at the block sizes of every K1 shape of the lanes
    and ragged panels, at j = 0 (M_0 = 0, T_0 = D_0) and at later rows."""
    band, M, Dinv = _schur_case(s, n, dtype, cuda, seed=s + n)
    hk.reset_launch_counts()
    for j in (0, 1, 2):
        _check_schur(band, M, Dinv, j, dtype)
    assert hk.schur_step_.launches == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [128, 129, 161, 193, 225, 256, 257, 516])
def test_schur_step_last_column_group(cuda, s, dtype):
    """Block sizes whose last 128-column group holds 1, 2, 3 or 4 chunks of
    32 columns (a group of one chunk its warp loads and multiplies alone),
    whole groups, and a group of one column, at j = 1 and 2."""
    band, M, Dinv = _schur_case(s, 3, dtype, cuda, seed=s)
    for j in (1, 2):
        _check_schur(band, M, Dinv, j, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [17, 65, 193, 516])
def test_schur_geometry_mirrors_the_library(cuda, s, dtype):
    """The wrapper's shared-memory count is the library's, and the library
    refuses a row outside the band and a block size that needs more
    threads than a block takes, before any launch."""
    lib = hk._library()
    item = torch.finfo(dtype).bits // 8
    assert lib.hf_schur_smem_bytes(s, item) == hk.schur_smem_bytes(s, item)
    band, M, Dinv = _schur_case(s, 1, dtype, cuda, nb=2)
    fn = getattr(lib, f"hf_schur_step_{hk._suffix(dtype)}")
    for width, j in ((s, 2), (s, -1), (2049, 1), (0, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            hk._launch(lib, fn, "schur_step_", cuda, band.data_ptr(),
                       M.data_ptr(), Dinv.data_ptr(), 1, 2, width, j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,nb,n", [(25, 6, 32), (97, 5, 3), (193, 6, 16),
                                    (193, 4, 32), (516, 3, 16)])
def test_factorize_rows_end_to_end(cuda, dtype, s, nb, n):
    """K1's row design (a Schur step and a K3 launch per block row) against
    the plain factorization and its plain schedule in the picked panels,
    with its launch counts."""
    band = _band(s, n, dtype, cuda, seed=s + nb, nb=nb)
    hk.reset_launch_counts()
    M, Dinv = hk.banded_factorize(band, design="rows")
    M_p, D_p = hk.banded_factorize_plain(band)
    M_r, D_r = hk.banded_factorize_rows_plain(band, rows=hk.SCHUR_ROWS)
    torch.cuda.synchronize()
    assert (hk.schur_step_.launches, hk.batched_inverse.launches) == (nb, nb)
    assert not M[:, 0].any()
    for got, want in ((M, M_p), (Dinv, D_p), (M, M_r), (Dinv, D_r)):
        assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,nb", [(17, 17), (25, 25), (33, 6), (49, 49), (64, 5),
                                  (65, 65), (84, 4), (96, 3), (97, 5), (120, 3)])
def test_factorize_chain(cuda, dtype, s, nb):
    """K1's chain against the plain version, the schedule's plain version
    and the row design: one 32-column chunk (17, 25), pivot blocks across
    chunk edges and ragged last chunks (33, 49, 65, 97), strides that need
    padding (64, 96) and the largest sizes that fit (84 in float64, 120 in
    float32).  Tiles that do not fit raise before any launch."""
    band = _band(s, 3, dtype, cuda, seed=s, nb=nb)
    hk.reset_launch_counts()
    if hk.chain_geometry(s, band.element_size(), hk._smem_limit(cuda)) is None:
        with pytest.raises(ValueError, match="shared memory"):
            hk.banded_factorize(band, design="chain")
        assert hk.banded_factorize.launches == 0
        return
    M, Dinv = hk.banded_factorize(band, design="chain")
    M_p, D_p = hk.banded_factorize_plain(band)
    M_s, D_s = hk.banded_factorize_rows_plain(band)
    M_r, D_r = hk.banded_factorize(band, design="rows")
    torch.cuda.synchronize()
    assert hk.banded_factorize.launches_by_design == {"chain": 1, "rows": 1}
    assert not M[:, 0].any()
    for got, want in ((M, M_p), (Dinv, D_p), (M, M_s), (Dinv, D_s), (M, M_r),
                      (Dinv, D_r)):
        assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("s,dtype", [(65, torch.float32), (97, torch.float32),
                                     (120, torch.float32), (33, torch.float64),
                                     (84, torch.float64), (65, torch.float64)])
def test_chain_geometry_mirrors_the_library(cuda, s, dtype):
    """The wrapper's shared-memory count is the library's, and the library
    refuses a stride that is no whole vector or too narrow, and a thread
    count that is no whole warp, leaves warp 0 alone or is too large."""
    lib = hk._library()
    item = torch.finfo(dtype).bits // 8
    ld, need = hk.chain_geometry(s, item, hk._smem_limit(cuda))
    assert lib.hf_factorize_smem_bytes(s, ld, item) == need
    band = _band(s, 1, dtype, cuda, nb=2)
    M, Dinv = torch.empty_like(band[..., :s]), torch.empty_like(band[..., :s])
    fn = getattr(lib, f"hf_banded_factorize_{hk._suffix(dtype)}")
    for bad in ((ld + 1, 256), (s - 1, 256), (ld, 250), (ld, 32),
                (ld, hk.CHAIN_MAX_THREADS + 32)):
        with pytest.raises(RuntimeError, match="launch failed"):
            hk._launch(lib, fn, "banded_factorize", cuda, band.data_ptr(),
                       M.data_ptr(), Dinv.data_ptr(), 1, 2, s, *bad)


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


def _factor(s, n, nb, dtype, device, seed):
    """A factor (M, Dinv, B) of a diagonally dominant band and the band in
    float64."""
    band = _band(s, n, torch.float64, device, seed=seed, nb=nb)
    M, Dinv = hk.banded_factorize(band.to(dtype))
    return M, Dinv, band[..., 2 * s :].to(dtype).contiguous(), band


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [17, 25, 33, 49, 65, 97, 193, 516])
def test_solve_streamed_clusters_match_plain(cuda, s, dtype, trans, cluster):
    """K2's streamed design at every block size of the lanes with each
    forced number of blocks per sample, at k=1, 5 and 7 (the k=1 template
    and the general one), against the plain version and as a residual of
    the band: slabs of one to three chunks, ragged last chunks, and slabs
    that start off 16 bytes (odd s)."""
    nb = 3 if s == 516 else 6
    M, Dinv, B, band = _factor(s, 3, nb, dtype, cuda, seed=s)
    gen = torch.Generator(device=cuda).manual_seed(s)
    apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
    for k in (1, 5, 7):
        bb = torch.randn(3, nb, s, k, dtype=torch.float64, device=cuda,
                         generator=gen)
        hk.reset_launch_counts()
        x = hk.banded_solve(M, Dinv, B, bb.to(dtype), trans, tiles=(0, k),
                            cluster=cluster)
        x_p = hk.banded_solve_plain(M, Dinv, B, bb.to(dtype), trans)
        torch.cuda.synchronize()
        assert hk.banded_solve.launches == 1
        assert _rel(x, x_p) < TOL[dtype], k
        bf = bb.reshape(3, nb * s, k)
        res = torch.linalg.vector_norm(
            apply(band, x.double().reshape(3, nb * s, k)) - bf
        ) / torch.linalg.vector_norm(bf)
        assert res.item() < (1e-4 if dtype == torch.float32 else 1e-12), k


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s,nb", [(300, 65, 5), (1100, 33, 5), (1100, 17, 17),
                                    (40, 193, 4), (1, 65, 1), (2, 33, 2)])
def test_solve_streamed_on_a_full_card(cuda, n, s, nb, dtype, trans):
    """The streamed design where several blocks share an SM (more samples
    than SMs: the nx=64 chunk and its coarse levels), with the picked
    cluster size, and at one and two block rows; a column tile narrower
    than k."""
    M, Dinv, B, _ = _factor(s, n, nb, dtype, cuda, seed=n)
    for k, tiles in ((1, None), (5, (0, 2))):
        bb = torch.randn(n, nb, s, k, dtype=dtype, device=cuda)
        x = hk.banded_solve(M, Dinv, B, bb, trans, tiles=tiles)
        x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
        torch.cuda.synchronize()
        assert _rel(x, x_p) < TOL[dtype], k


@pytest.mark.parametrize("args", [
    (16, 516, 1, 4, 1, True), (16, 516, 1, 8, 8, False), (32, 193, 1, 4, 4, True),
    (256, 65, 1, 4, 1, False), (1024, 33, 1, 4, 1, True), (2, 516, 7, 8, 3, True)])
def test_stream_geometry_mirrors_the_library(cuda, args):
    """The wrapper's count of the streamed design's shared memory is the
    library's, and fits a block."""
    blocks, s, kt, item, c, trans = args
    limit = hk._smem_limit(cuda)
    rows, nstage, threads, rsplit, fgroup, need = hk.stream_geometry(
        blocks, s, kt, item, c, trans, hk._sm_count(cuda), limit, hk._sm_smem(cuda))
    assert need <= limit and threads <= 32 * (
        hk.STREAM_MAX_WARPS if c > 1 else hk.STREAM_MAX_WARPS_ONE)
    assert hk._library().hf_stream_smem_bytes(
        s, kt, c, rows, nstage, rsplit, int(trans), item) == need


def test_solve_streamed_refuses_what_it_does_not_take(cuda):
    """A cluster size outside 1 to 8 is refused at the launch; a forced
    cluster whose shared memory does not fit, a column tile above 7 and a
    cluster size for the panel design raise before it; no other path runs."""
    M, Dinv, B, _ = _factor(65, 2, 3, torch.float32, cuda, seed=1)
    bb = torch.randn(2, 3, 65, 1, device=cuda)
    hk.reset_launch_counts()
    for cluster in (0, 9, -1):
        with pytest.raises(RuntimeError, match="launch failed"):
            hk.banded_solve(M, Dinv, B, bb, False, cluster=cluster)
    with pytest.raises(ValueError, match="at most 7"):
        hk.banded_solve(M, Dinv, B, bb.expand(2, 3, 65, 8).contiguous(), False,
                        tiles=(0, 8))
    with pytest.raises(ValueError, match="streamed"):
        hk.banded_solve(M, Dinv, B, bb.expand(2, 3, 65, 8).contiguous(), False,
                        tiles=(16, 8), cluster=2)
    s = 2000
    fac = torch.zeros((1, 1, s, s), dtype=torch.float64, device=cuda)
    wide = torch.zeros((1, 1, s, 7), dtype=torch.float64, device=cuda)
    for cluster in (1, 2):
        with pytest.raises(ValueError, match="shared memory"):
            hk.banded_solve(fac, fac, fac, wide, True, tiles=(0, 7),
                            cluster=cluster)
    assert hk.banded_solve.launches == 0


def _designs(s, k, item, device):
    """K2's tiles for the streamed design (0, its widest column tile) and
    the panel design (panel rows, column tiles) at two samples of s and k,
    as the wrapper picks them."""
    return [hk.solve_tiles(2, s, k, item, hk._sm_count(device),
                           hk._smem_limit(device), hk._sm_smem(device), panels=p)
            for p in (False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [17, 25, 33, 49, 97, 516])
def test_kernels_at_the_new_block_sizes(cuda, dtype, s):
    """The grid-sequencing levels (17, 33 at nx=64; 25, 49, 97 at nx=192)
    and the helmholtz lane (516): K1 in both designs where the chain fits
    (rows only above it), K2 at k=1 and k=200 in both designs and both
    directions, K3, each against its plain version, with the residual of
    the kernels' solve."""
    nb = 3 if s == 516 else 8
    band = _band(s, 2, torch.float64, cuda, seed=s, nb=nb)
    b = band.to(dtype)
    B = b[..., 2 * s :].contiguous()
    limit = hk._smem_limit(cuda)
    item = b.element_size()
    M_p, D_p = hk.banded_factorize_plain(b)
    designs = ["rows"]
    if hk.chain_geometry(s, item, limit) is not None:
        designs.append("chain")
    for design in designs:
        M, Dinv = hk.banded_factorize(b, design=design)
        torch.cuda.synchronize()
        assert _rel(M, M_p) < TOL[dtype] and _rel(Dinv, D_p) < TOL[dtype], design
    gen = torch.Generator(device=cuda).manual_seed(s)
    for k in (1, 200):
        bb = torch.randn(2, nb, s, k, dtype=torch.float64, device=cuda,
                         generator=gen)
        for tiles in _designs(s, k, item, cuda):
            for trans in (False, True):
                x = hk.banded_solve(M, Dinv, B, bb.to(dtype), trans, tiles=tiles)
                x_p = hk.banded_solve_plain(M, Dinv, B, bb.to(dtype), trans)
                torch.cuda.synchronize()
                assert _rel(x, x_p) < TOL[dtype], (k, tiles, trans)
                apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
                bf = bb.reshape(2, nb * s, k)
                res = torch.linalg.vector_norm(
                    apply(band, x.double().reshape(2, nb * s, k)) - bf
                ) / torch.linalg.vector_norm(bf)
                assert res.item() < (1e-4 if dtype == torch.float32 else 1e-12)
    X = _dd_batch(3, s, dtype, cuda, seed=s)
    Y = hk.batched_inverse(X)
    Y_p = hk.batched_inverse_plain(X)
    torch.cuda.synchronize()
    assert _rel(Y, Y_p) < TOL[dtype]


@pytest.mark.parametrize("dtype,tiles", [(torch.float32, (48, 8)),
                                         (torch.float64, (16, 13))])
def test_solve_panel_choice_at_s516(cuda, dtype, tiles):
    """At s=516 (helmholtz, N=16, k=200) the wrapper takes the geometry
    ``panel_geometry`` picks for the card (on the H100: 8 column tiles and
    48-row panels in float32; in float64 13 tiles and 16-row panels, as 10
    to 12 tiles fit only 8-row ones); every geometry that fits at its
    column split and one tile fewer and more gives the same solve, and a
    forced panel that does not fit raises before any launch."""
    s, nb, k, N = 516, 2, 200, 16
    item = torch.finfo(dtype).bits // 8
    limit, sm, sm_smem = hk._smem_limit(cuda), hk._sm_count(cuda), hk._sm_smem(cuda)
    picked = hk.panel_geometry(N, s, k, item, sm, limit, sm_smem)
    assert hk.solve_tiles(N, s, k, item, sm, limit, sm_smem) == (picked.rows,
                                                                 picked.tiles)
    if (sm, limit) == (132, 232448):
        assert (picked.rows, picked.tiles) == tiles
    M, Dinv, B, _ = _factor(s, N, nb, dtype, cuda, seed=6)
    bb = torch.randn(N, nb, s, k, dtype=dtype, device=cuda)
    x_p = hk.banded_solve_plain(M, Dinv, B, bb, True)
    hk.reset_launch_counts()
    x = hk.banded_solve(M, Dinv, B, bb, True)
    torch.cuda.synchronize()
    assert hk.banded_solve.launches_by_design == {"panels": 1, "streamed": 0}
    assert _rel(x, x_p) < TOL[dtype]
    for t in (picked.tiles - 1, picked.tiles, picked.tiles + 1):
        for g in hk.panel_fits(s, k, t, item, limit, sm_smem):
            y = hk.banded_solve(M, Dinv, B, bb, True, tiles=(g.rows, t, g.row_tile))
            torch.cuda.synchronize()
            assert _rel(y, x_p) < TOL[dtype], g
    with pytest.raises(ValueError, match="shared memory"):
        hk.banded_solve(M, Dinv, B, bb, True, tiles=(520, 1))


@pytest.mark.parametrize("k", [8, 13, 100, 200])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [17, 25, 33, 49, 65, 97, 193, 516])
def test_solve_panel_geometries_match_plain(cuda, s, dtype, trans, k):
    """K2's panel design at every block size of the lanes with forced
    column splits (1 tile, 3, the picked one, one column a tile) and every
    panel width and register tile that fits, against the plain version and
    as a residual of the band: ragged and one-column tiles, padded panels,
    register tiles past the last row or column."""
    nb = 2 if s == 516 else 3
    M, Dinv, B, band = _factor(s, 2, nb, dtype, cuda, seed=s + k)
    bb = torch.randn(2, nb, s, k, dtype=torch.float64, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(k))
    x_p = hk.banded_solve_plain(M, Dinv, B, bb.to(dtype), trans)
    limit, sm_smem = hk._smem_limit(cuda), hk._sm_smem(cuda)
    item = torch.finfo(dtype).bits // 8
    picked = hk.panel_geometry(2, s, k, item, hk._sm_count(cuda), limit, sm_smem)
    apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
    bf = bb.reshape(2, nb * s, k)
    hk.reset_launch_counts()
    count = 0
    for t in sorted({1, min(3, k), picked.tiles, k}):
        fits = hk.panel_fits(s, k, t, item, limit, sm_smem)
        assert fits or t < picked.tiles, t
        for g in fits:
            x = hk.banded_solve(M, Dinv, B, bb.to(dtype), trans,
                               tiles=(g.rows, t, g.row_tile))
            torch.cuda.synchronize()
            count += 1
            assert _rel(x, x_p) < TOL[dtype], g
            res = torch.linalg.vector_norm(
                apply(band, x.double().reshape(2, nb * s, k)) - bf
            ) / torch.linalg.vector_norm(bf)
            assert res.item() < (1e-4 if dtype == torch.float32 else 1e-12), g
    assert hk.banded_solve.launches_by_design == {"panels": count, "streamed": 0}


@pytest.mark.parametrize("s,k,item", [(65, 100, 4), (193, 100, 8), (516, 200, 4),
                                      (516, 200, 8), (17, 13, 8), (97, 8, 4)])
def test_panel_geometry_mirrors_the_library(cuda, s, k, item):
    """The wrapper's count of the panel design's shared memory and threads
    is the library's at every geometry that fits."""
    lib = hk._library()
    for t in (1, 2, 7, 8, 13, k):
        for g in hk.panel_fits(s, k, min(t, k), item, hk._smem_limit(cuda),
                               hk._sm_smem(cuda)):
            assert lib.hf_solve_smem_bytes(s, k, g.tiles, g.rows, g.lsplit,
                                           item) == g.smem_bytes
            assert lib.hf_solve_threads_of(k, g.tiles, g.rows, g.row_tile,
                                           g.lsplit) == g.threads


def test_solve_panels_refuse_what_they_do_not_take(cuda):
    """The library refuses a panel width that is not a multiple of 8, a
    register tile it was not built for, column splits outside 1 to k, no
    slices or more than s, and more threads than a block takes; the
    wrapper raises on a forced geometry it cannot place before any launch;
    no other path runs."""
    M, Dinv, B, _ = _factor(65, 2, 3, torch.float32, cuda, seed=1)
    bb = torch.randn(2, 3, 65, 40, device=cuda)
    out = torch.empty_like(bb)
    lib = hk._library()
    hk.reset_launch_counts()
    for bad in ((2, 12, 4, 1), (2, 72, 6, 1), (0, 72, 4, 1), (41, 72, 4, 1),
                (2, 72, 4, 0), (2, 72, 4, 66), (1, 72, 4, 3)):
        t, rows, rt, ls = bad
        with pytest.raises(RuntimeError, match="launch failed"):
            hk._launch(lib, lib.hf_banded_solve_f32, "banded_solve", cuda,
                       M.data_ptr(), Dinv.data_ptr(), B.data_ptr(), bb.data_ptr(),
                       out.data_ptr(), 2, 3, 65, 40, t, 1, rows, rt, ls)
    for tiles in ((12, 2), (72, 41), (72, 0), (72, 2, 6), (72, 2, 4, 9),
                  (72, 2, 4, 1, 1)):
        with pytest.raises(ValueError, match="tiles"):
            hk.banded_solve(M, Dinv, B, bb, True, tiles=tiles)
    assert hk.banded_solve.launches == 0


def test_solve_refuses_a_size_no_design_takes(cuda):
    """s=2000 in float64: even a 16-row panel and one column (288 KB) is
    above the card's shared memory, so the k=200 solve raises (it never
    runs the plain version on the card); the streamed k=1 solve fits."""
    s = 2000
    fac = torch.zeros((1, 1, s, s), dtype=torch.float64, device=cuda)
    eye = torch.eye(s, dtype=torch.float64, device=cuda).expand(1, 1, s, s)
    Dinv = eye.contiguous()
    bb = torch.randn(1, 1, s, 200, dtype=torch.float64, device=cuda)
    hk.reset_launch_counts()
    with pytest.raises(ValueError, match="no panel and column tile"):
        hk.banded_solve(fac, Dinv, fac, bb, True)
    assert hk.banded_solve.launches == 0
    x = hk.banded_solve(fac, Dinv, fac, bb[..., :1].contiguous(), False)
    torch.cuda.synchronize()
    assert torch.equal(x, bb[..., :1])


def test_helmholtz_bands_at_s516(cuda):
    """K1 (rows), K2 and K3 on the helmholtz lane's own band (nx=64,
    600 Hz, 2 prior samples): indefinite blocks, no pivoting.  Against the
    pivoted plain versions, K3's identity residual on the Schur complements
    stays within 10x of torch.linalg.inv's, in both dtypes."""
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
        helmholtz_prior,
    )
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked

    f64 = dict(dtype=torch.float64, device=cuda)
    obs, Vh = helmholtz_linear_observable(nx=64, frequency=600.0, **f64)
    pde = obs.problem
    m = helmholtz_prior(Vh, **f64).sample(
        torch.randn(2, Vh.dim, generator=torch.Generator(device=cuda).manual_seed(0),
                    **f64))
    band64 = bc_symmetrize_banded_masked(pde.bound.assemble_A_banded_ordered(
        torch.zeros(2, pde.state_dim, **f64), m, None, pde._band_order),
        pde._band_mask).contiguous()
    N, nb, s, _ = band64.shape
    assert (s, nb) == (516, 52)
    M64, _ = hk.banded_factorize_plain(band64)
    T64 = band64[..., s : 2 * s].clone()
    T64[:, 1:] -= M64[:, 1:] @ band64[:, :-1, :, 2 * s :]
    eye = torch.eye(s, **f64)
    bb = torch.randn(N, nb, s, 1, **f64)
    for dtype in (torch.float32, torch.float64):
        band = band64.to(dtype)
        M, Dinv = hk.banded_factorize(band)
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        assert max(_rel(M, M_p), _rel(Dinv, D_p)) < TOL[dtype]
        T = T64.to(dtype).reshape(N * nb, s, s)
        res_k3 = (T64.reshape(-1, s, s) @ hk.batched_inverse(T).double() - eye)
        res_inv = (T64.reshape(-1, s, s) @ torch.linalg.inv(T).double() - eye)
        assert res_k3.abs().max() <= 10 * res_inv.abs().max()
        B = band[..., 2 * s :].contiguous()
        res = []
        for x in (hk.banded_solve(M, Dinv, B, bb.to(dtype), False),
                  hk.banded_solve_plain(M_p, D_p, B, bb.to(dtype), False)):
            res.append(torch.linalg.vector_norm(block_tridiag_matmat(
                band64, x.double().reshape(N, nb * s, 1)) - bb.reshape(N, -1, 1)
            ).item())
        assert res[0] <= 10 * res[1]


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


def _surrogate(device, dtype, arch):
    from hippyflow_tpu_torch import nn as tnn

    rng = np.random.default_rng(8)
    P = np.linalg.qr(rng.standard_normal((40, 6)))[0]
    Phi = np.linalg.qr(rng.standard_normal((12, 4)))[0]
    kw = dict(generator=torch.Generator().manual_seed(2), dtype=dtype, device=device)
    if arch == "dipnet":
        return tnn.projected_dense(P, Phi, output_shift=np.ones(12), **kw)
    return tnn.projected_low_rank_residual_network(
        P, Phi, ranks=(3, 3), residual_activation=arch.split("_")[1], **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("arch", ["dipnet", "dipresnet_softplus", "dipresnet_sigmoid"])
def test_surrogate_networks_on_card_match_cpu(cuda, dtype, arch):
    """The same weights (drawn on the CPU from one generator) and inputs
    give the same outputs on the card and on the CPU."""
    cpu, gpu = _surrogate("cpu", dtype, arch), _surrogate(cuda, dtype, arch)
    m = 30.0 * torch.randn(16, 40, dtype=dtype, generator=torch.Generator().manual_seed(1))
    assert _rel(gpu(m.to(cuda)).detach().cpu(), cpu(m).detach()) < TOL[dtype]


def test_incg_step_on_card_matches_cpu(cuda):
    """One Newton-CG step (refresh, CG, Armijo ladder) in float64 on the
    card against the CPU from the same weights, data and probe block."""
    from hippyflow_tpu_torch import nn as tnn
    from hippyflow_tpu_torch.nn.training import NewtonCG

    gen = torch.Generator().manual_seed(4)
    m = torch.randn(32, 40, dtype=torch.float64, generator=gen)
    q = torch.tanh(m[:, :12]) + 0.5
    Omega = torch.randn(sum(p.numel() for p in _surrogate("cpu", torch.float64,
                                                          "dipnet").parameters()),
                        11, dtype=torch.float64, generator=gen)
    out = []
    for device in ("cpu", cuda):
        model = _surrogate(device, torch.float64, "dipnet")
        apply_fn = tnn.apply_fn_of(model)
        params = tnn.parameters_of(model)
        nc = NewtonCG(apply_fn, lambda p, mb, qb, jb: tnn.l2_loss(apply_fn, p, mb, qb),
                      params, hess_batch=16, cg_iters=6, hessian_low_rank=6,
                      damping=1e-2)
        w = nc.ravel(params)
        md, qd = m.to(device), q.to(device)
        U, d = nc.refresh(w, md[:16], qd[:16], Omega.to(device))
        out.append([t.cpu() for t in nc.step(w, md, qd, None, U, d)] + [d.cpu()])
    for got, want in zip(out[1], out[0]):
        assert _rel(got, want) < 1e-9


def _setup_lane_nx16(device, out):
    """The setup lane in float64 at nx=16 (289 dofs, 100 observations) from
    given noise: rank 16, 32 samples and data, 8 error-test samples."""
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
    )
    from hippyflow_tpu_torch.applications.confusion_setup import setup_lane

    kw = dict(dtype=torch.float64, device=device)
    obs, Vh = confusion_linear_observable(nx=16, velocity="analytic", **kw)
    return setup_lane(obs, confusion_prior(Vh, **kw), str(out), rank=16,
                      n_samples=32, n_data=32, jacobian_rank=16,
                      error_test_samples=8, noise_rng=np.random.default_rng(0))


def test_setup_lane_on_card_matches_cpu(cuda, tmp_path):
    """The reduced-basis setup on the card (K1, K2) against the CPU, in
    float64 from the same given noise: every spectrum above 1e-4 lambda_0
    and every basis's projector within 1e-8 relative, the same error-test
    discards, and the same training data to 1e-10."""
    from hippyflow_tpu_torch.applications.confusion_setup import lane_difference

    hk.reset_launch_counts()
    gpu = _setup_lane_nx16(cuda, tmp_path / "gpu")
    assert hk.banded_factorize.launches > 0 and hk.banded_solve.launches > 0
    cpu = _setup_lane_nx16("cpu", tmp_path / "cpu")
    for name, err in lane_difference(gpu, cpu).items():
        assert err <= 1e-8, (name, err)
    assert gpu["errors"]["as"][("output_discarded", None)] == 0
    data = [np.load(tmp_path / d / "mq_data.npz") for d in ("gpu", "cpu")]
    for key in ("m_data", "q_data"):
        want = data[1][key]
        assert np.abs(data[0][key] - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,nb", [(9, 301), (21, 22), (65, 65)])
def test_batched_cyclic_reduction_through_k3(cuda, s, nb, dtype):
    """The batched cyclic reduction of the block_cyclic solver on the
    card: one K3 launch per level and one at the root for all samples of
    each direction, and its solves (forward, transposed, adjoint-only)
    against the same factorization on the CPU (K3's plain version)."""
    from hippyflow_tpu_torch.ops.structured import factorize_block_cyclic_banded

    band = _band(s, 3, torch.float64, "cpu", seed=s, nb=nb)
    levels = int(np.ceil(np.log2(nb)))
    hk.reset_launch_counts()
    gpu = factorize_block_cyclic_banded(band.to(cuda, dtype))
    adj = factorize_block_cyclic_banded(band.to(cuda, dtype), with_forward=False)
    torch.cuda.synchronize()
    assert hk.batched_inverse.launches == 3 * (levels + 1)
    cpu = factorize_block_cyclic_banded(band.to(dtype))
    rhs = torch.randn(3, nb * s, 4, dtype=dtype)
    for trans in (False, True):
        want = cpu.solve(rhs, trans=trans)
        assert _rel(gpu.solve(rhs.to(cuda), trans=trans).cpu(), want) < TOL[dtype]
    assert _rel(adj.solve(rhs.to(cuda), trans=True).cpu(),
                cpu.solve(rhs, trans=True)) < TOL[dtype]


def _control_lane_nx16(device, solver, out):
    """DataGenerator on the nonlinear Poisson control problem at nx=16 in
    float64 from given noise and controls, derivatives (1, 1) with a fixed
    output decoder: the arrays it writes."""
    from hippyflow_tpu_torch.models import DataGenerator
    from hippyflow_tpu_torch.testing import (
        poisson_control_settings,
        poisson_pointwise_observable,
        setup_poisson_control_problem,
    )

    st = poisson_control_settings()
    st["nx"] = st["ny"] = 16
    st["LINEAR"] = False
    pde, prior, dist, Vh = setup_poisson_control_problem(
        st, dtype=torch.float64, device=device, solver=solver)
    obs = poisson_pointwise_observable(pde, Vh)
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.standard_normal((8, prior.noise_dim)),
                            device=device)
    controls = torch.as_tensor(rng.uniform(-1, 1, (8, 25)), device=device)
    Phi = np.linalg.qr(rng.standard_normal((obs.dQ, obs.dQ)))[0]
    DataGenerator(obs, prior, control_distribution=dist,
                  settings=dict(verbose=False)).generate(
        8, derivatives=(1, 1), output_decoder=Phi, data_dir=str(out),
        noise=noise, controls=controls)
    arrays = {}
    for name in ("mzq_data", "JstarPhi_data", "JzstarPhi_data"):
        with np.load(out / f"{name}.npz") as z:
            arrays.update({k: z[k] for k in z.files})
    return arrays


@pytest.mark.parametrize("solver", ["auto", "block_cyclic"])
def test_control_lane_on_card_matches_cpu(cuda, tmp_path, solver):
    """The control lane (forward solves, dq/dm and dq/dz sketches) on the
    card against the CPU in float64: every array within 1e-8 relative."""
    hk.reset_launch_counts()
    gpu = _control_lane_nx16(cuda, solver, tmp_path / "gpu")
    if solver == "auto":
        assert hk.banded_factorize.launches > 0 and hk.banded_solve.launches > 0
    else:
        assert hk.batched_inverse.launches > 0
    cpu = _control_lane_nx16("cpu", solver, tmp_path / "cpu")
    for key, want in cpu.items():
        assert np.abs(gpu[key] - want).max() <= 1e-8 * np.abs(want).max(), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_panels_at_the_full_state_column_count(cuda, dtype):
    """K2 transposed with k = 4225 columns (the full-state Jacobian of
    ``two_step_generate`` at nx=64: one column per state dof) at N=16,
    s=nb=65, through the panel design, against the plain version, with
    the residual of A^T x = b."""
    s, n, k = 65, 16, 65 * 65
    band = _band(s, n, dtype, cuda)
    M, Dinv = hk.banded_factorize(band)
    B = band[..., 2 * s :].contiguous()
    gen = torch.Generator(device=cuda).manual_seed(2)
    bb = torch.randn((n, s, s, k), dtype=dtype, device=cuda, generator=gen)
    hk.reset_launch_counts()
    x = hk.banded_solve(M, Dinv, B, bb, True)
    torch.cuda.synchronize()
    assert hk.banded_solve.launches_by_design["panels"] == 1
    x_p = hk.banded_solve_plain(M, Dinv, B, bb, True)
    assert _rel(x, x_p) < TOL[dtype]
    b = bb.reshape(n, s * s, k).double()
    r = block_tridiag_matmat_trans(band.double(), x.reshape(n, s * s, k).double()) - b
    assert (torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)).item() < {
        torch.float32: 1e-4, torch.float64: 1e-12}[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_serialized_operator_on_card_matches_plain(cuda, dtype, monkeypatch):
    """The full-state input subspace of the Poisson control problem at
    nx=16 (8 given samples, chunks of 3), serialized: through K1/K2, and
    with K1/K2's plain versions in their place on the same card; then the
    batched matrix-free strategy through K1/K2.  The spectra agree."""
    from hippyflow_tpu_torch import testing as tt
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )
    from hippyflow_tpu_torch.ops import structured

    st = tt.poisson_control_settings()
    st["nx"] = st["ny"] = 16
    pde, prior, dist, Vh = tt.setup_poisson_control_problem(
        st, dtype=dtype, device=cuda)
    obs = tt.poisson_full_state_observable(pde, Vh)
    rng = np.random.default_rng(3)
    ms = prior.sample(torch.as_tensor(rng.standard_normal((8, Vh.dim)),
                                      dtype=dtype, device=cuda))
    zs = torch.as_tensor(rng.uniform(-1, 1, (8, 25)), dtype=dtype, device=cuda)
    Omega = torch.as_tensor(rng.standard_normal((Vh.dim, 10)), dtype=dtype,
                            device=cuda)

    def spectrum(serialized):
        p = ActiveSubspaceParameterList()
        p["rank"], p["oversampling"], p["samples_per_process"] = 6, 4, 8
        p["serialized_sampling"], p["chunk_size"] = serialized, 3
        p["ms_given"], p["verbose"] = True, False
        proj = ActiveSubspaceProjector(obs, prior, parameters=p,
                                       control_distribution=dist)
        proj.ms, proj.zs, proj.Omega_GN = ms, zs, Omega
        hk.reset_launch_counts()
        d = proj.construct_input_subspace()[0]
        torch.cuda.synchronize()
        return d, hk.banded_factorize.launches, hk.banded_solve.launches

    d, k1, k2 = spectrum(True)
    # forward solve + 3 chunks x 2 applications; each chunk's J and J^T
    assert k1 == 1 + 6 and k2 == 1 + 12
    with monkeypatch.context() as mp:
        mp.setattr(structured, "banded_factorize", hk.banded_factorize_plain)
        mp.setattr(structured, "banded_solve",
                   lambda M, Dinv, B, bb, trans, *a, **kw:
                   hk.banded_solve_plain(M, Dinv, B, bb, trans))
        d_plain, k1_plain, k2_plain = spectrum(True)
    assert k1_plain == k2_plain == 0
    d_batched = spectrum(False)[0]
    tol = {torch.float32: 1e-4, torch.float64: 1e-10}[dtype]
    assert _rel(d, d_plain) < tol and _rel(d, d_batched) < tol


def test_navier_stokes_on_card_matches_cpu(cuda):
    """Steady Navier-Stokes at nx=16 (s=51, an indefinite saddle-point
    band through K1's chain, K3-free, and K2) on the card against the CPU,
    float64: the same Newton steps at every Reynolds number, velocity and
    pressure within 1e-10."""
    from hippyflow_tpu_torch.applications.navier_stokes import steady_navier_stokes

    V = FunctionSpace(unit_square_mesh(16))
    hk.reset_launch_counts()
    v, p, info = steady_navier_stokes(V, dtype=torch.float64, device=cuda)
    assert hk.banded_factorize.launches > 0 and hk.banded_solve.launches > 0
    v_c, p_c, info_c = steady_navier_stokes(V, dtype=torch.float64, device="cpu")
    assert info.history == info_c.history
    assert _rel(v.cpu(), v_c) <= 1e-10 and _rel(p.cpu(), p_c) <= 1e-10


def test_k3_on_navier_stokes_schur_complements(cuda):
    """K3 without pivoting on the Schur complements T_j = D_j - M_j B_{j-1}
    of the Navier-Stokes Jacobian at nx=64 (s=195, Re=100, at the
    converged state): max|T T^-1 - I| within 10x of torch.linalg.inv's,
    and K1's rows against the pivoted plain factorization."""
    from hippyflow_tpu_torch.applications.navier_stokes import (
        _ns_bc,
        _ns_form,
        steady_navier_stokes,
    )
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked
    from hippyflow_tpu_torch.models import VariationalPDEProblem

    V = FunctionSpace(unit_square_mesh(64))
    f64 = dict(dtype=torch.float64, device=cuda)
    v, p, _ = steady_navier_stokes(V, **f64)
    pde = VariationalPDEProblem(V, V, _ns_form(V, 100.0), _ns_bc(V), **f64)
    u = torch.cat([v[:, 0], v[:, 1], p])[None]
    band = bc_symmetrize_banded_masked(pde.bound.assemble_A_banded_ordered(
        u, torch.zeros((1, V.dim), **f64), None, pde._band_order), pde._band_mask)
    N, nb, s, _ = band.shape
    assert s == 195
    M_p, D_p = hk.banded_factorize_plain(band)
    T = band[..., s : 2 * s].clone()
    T[:, 1:] -= M_p[:, 1:] @ band[:, :-1, :, 2 * s :]
    T = T.reshape(N * nb, s, s)
    eye = torch.eye(s, **f64)
    res_k3 = (T @ hk.batched_inverse(T) - eye).abs().max().item()
    res_inv = (T @ torch.linalg.inv(T) - eye).abs().max().item()
    assert res_k3 <= 10.0 * res_inv, (res_k3, res_inv)
    M, Dinv = hk.banded_factorize(band)
    assert _rel(M, M_p) <= TOL[torch.float64] and _rel(Dinv, D_p) <= TOL[torch.float64]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_on_a_p2_band_at_s258(cuda, dtype):
    """K1's rows (a Schur step and K3 per block row), the Schur step alone,
    K3 on the Schur complements and K2 (streamed k=1 both ways, the panels
    at k=100 transposed) on the ordered band of a scalar P2 state at
    nx=64 (s=258; ny=4, so nb=5), held against their plain versions."""
    from hippyflow_tpu_torch.fem import (
        DirichletBC,
        GalerkinForm,
        bc_symmetrize_banded_masked,
    )
    from hippyflow_tpu_torch.models import VariationalPDEProblem

    mesh = unit_square_mesh(64, 4)
    V2, V1 = FunctionSpace(mesh, degree=2), FunctionSpace(mesh)
    f64 = dict(dtype=torch.float64, device=cuda)
    form = GalerkinForm(
        flux=lambda x, u, gu, m, z, c: torch.exp(m)[..., None] * gu,
        source=lambda x, u, gu, m, z, c: u**3 - 1.0, quad_degree=4)
    pde = VariationalPDEProblem(V2, V1, form,
                                DirichletBC.from_predicate(V2, None, 0.0), **f64)
    gen = torch.Generator(device=cuda).manual_seed(0)
    m = 0.3 * torch.randn(3, V1.dim, generator=gen, **f64)
    u = 0.5 * torch.randn(3, V2.dim, generator=gen, **f64)
    band64 = bc_symmetrize_banded_masked(pde.bound.assemble_A_banded_ordered(
        u, m, None, pde._band_order), pde._band_mask).contiguous()
    N, nb, s, _ = band64.shape
    assert (nb, s, pde.fwd_solver) == (5, 258, "thomas_inv")
    assert hk.factorize_design(s, torch.finfo(dtype).bits // 8,
                               hk._smem_limit(cuda))[0] == "rows"
    band = band64.to(dtype)
    hk.reset_launch_counts()
    M, Dinv = hk.banded_factorize(band)
    assert (hk.schur_step_.launches, hk.batched_inverse.launches) == (nb, nb)
    M_p, D_p = hk.banded_factorize_plain(band)
    torch.cuda.synchronize()
    assert _rel(M, M_p) < TOL[dtype] and _rel(Dinv, D_p) < TOL[dtype]
    # the Schur step alone at block row 2 on the plain factor's Dinv_1
    Ms, Ds = torch.zeros_like(M), torch.zeros_like(Dinv)
    Ds[:, 1] = D_p[:, 1]
    hk.schur_step_(band, Ms, Ds, 2)
    M2, T2 = hk.schur_step_plain(band, D_p[:, 1], 2)
    assert _rel(Ms[:, 2], M2) < TOL[dtype] and _rel(Ds[:, 2], T2) < TOL[dtype]
    # K3 on that Schur complement
    assert _rel(hk.batched_inverse(T2.contiguous()),
                hk.batched_inverse_plain(T2.contiguous())) < 10 * TOL[dtype]
    B = band[..., 2 * s :].contiguous()
    for k, trans in ((1, False), (1, True), (100, True)):
        bb = torch.randn(N, nb, s, k, generator=gen, **f64).to(dtype)
        x = hk.banded_solve(M, Dinv, B, bb, trans)
        x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
        torch.cuda.synchronize()
        assert _rel(x, x_p) < TOL[dtype], (k, trans)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_on_the_vector_form_band_at_s516(cuda, dtype):
    """K1's rows and K2 on the ordered band of the helmholtz form scaled by
    a P1 dof-valued coefficient, with a P2 parameter space (nx=64, 600 Hz:
    s=516, nb=52), 2 samples: K2 against its plain version on K1's factor
    (k=1 both ways, k=3 transposed), and the K1+K2 solve's residual within
    10x the pivoted plain pair's (the band is indefinite and K1 does not
    pivot)."""
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
    )
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked, prolong_p1_to_p2
    from hippyflow_tpu_torch.fem.vector_assembly import VectorGalerkinForm
    from hippyflow_tpu_torch.models import VariationalPDEProblem

    f64 = dict(dtype=torch.float64, device=cuda)
    lane = helmholtz_linear_observable(nx=64, frequency=600.0, **f64)[0].problem
    x = lane.Vu.mesh.vertices
    base = lane.form
    form = VectorGalerkinForm(
        2, lambda x, u, gu, m, z, c: c["a"][..., None, None]
        * base.flux(x, u, gu, m, z, c),
        lambda x, u, gu, m, z, c: c["a"][..., None]
        * base.source(x, u, gu, m, z, c), 4, False,
        {"a": 1.0 + 0.2 * np.sin(x[:, 0]) * np.cos(x[:, 1])})
    V2 = FunctionSpace(lane.Vu.mesh, 2)
    pde = VariationalPDEProblem(lane.Vu, V2, form, lane.bc, True,
                                rhs_vector=lane.rhs_vector,
                                operator_symmetric=True, **f64)
    gen = torch.Generator(device=cuda).manual_seed(0)
    m1 = 0.2 * torch.randn(2, lane.Vm.dim, generator=gen, **f64)
    m = prolong_p1_to_p2(m1, lane.Vm, V2)
    band64 = bc_symmetrize_banded_masked(pde.bound.assemble_A_banded_ordered(
        torch.zeros(2, pde.state_dim, **f64), m, None, pde._band_order),
        pde._band_mask).contiguous()
    N, nb, s, _ = band64.shape
    assert (nb, s) == (52, 516)
    band = band64.to(dtype)
    hk.reset_launch_counts()
    M, Dinv = hk.banded_factorize(band)
    assert hk.banded_factorize.launches_by_design == {"chain": 0, "rows": 1}
    assert (hk.schur_step_.launches, hk.batched_inverse.launches) == (nb, nb)
    M_p, D_p = hk.banded_factorize_plain(band)
    B = band[..., 2 * s :].contiguous()
    for k, trans in ((1, False), (1, True), (3, True)):
        bb = torch.randn(N, nb, s, k, generator=gen, **f64)
        x = hk.banded_solve(M, Dinv, B, bb.to(dtype), trans)
        assert _rel(x, hk.banded_solve_plain(M, Dinv, B, bb.to(dtype), trans)) \
            < TOL[dtype], (k, trans)
        x_p = hk.banded_solve_plain(M_p, D_p, B, bb.to(dtype), trans)
        apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
        res = [(apply(band64, y.double().reshape(N, nb * s, k))
                - bb.reshape(N, nb * s, k)).abs().max().item() for y in (x, x_p)]
        assert res[0] <= 10.0 * res[1], (k, trans, res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spike_at_nx64_on_card(cuda, dtype):
    """The partitioned SPIKE factor with P=4 (K3 on every cyclic-reduction
    level of the 17-row partitions) on the confusion Newton bands at nx=64
    (N=8, nb=s=65, padded to 68 rows), forward and transposed, k=1 and 100:
    against the same factor on the CPU and against K1+K2 on the card."""
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
    )
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_masked
    from hippyflow_tpu_torch.parallel import factorize_distributed_banded

    obs, V = confusion_linear_observable(nx=64, velocity="analytic",
                                         dtype=torch.float64, device="cpu")
    prior = confusion_prior(V, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(0)
    m = prior.sample(torch.randn(8, V.dim, generator=g, dtype=torch.float64))
    pde = obs.problem
    u = torch.zeros(8, V.dim, dtype=torch.float64)
    band64 = bc_symmetrize_banded_masked(pde.bound.assemble_A_banded(u, m),
                                         pde._mask)
    tol = TOL[dtype] * (10.0 if dtype == torch.float32 else 100.0)
    F_cpu = factorize_distributed_banded(band64.to(dtype), 4)
    band = band64.to(device=cuda, dtype=dtype)
    F = factorize_distributed_banded(band, 4)
    T = factorize_thomas_inv_banded(band)
    for k in (1, 100):
        B = torch.randn(8, V.dim, k, generator=g, dtype=torch.float64)
        for trans in (False, True):
            x = F.solve(B.to(device=cuda, dtype=dtype), trans=trans)
            assert _rel(x.cpu(), F_cpu.solve(B.to(dtype), trans=trans)) < tol
            assert _rel(x, T.solve(B.to(device=cuda, dtype=dtype), trans=trans)) < tol


def test_tf32_reaches_cyclic_reduction_and_one_sweep_recovers(cuda):
    """``ops.tf32_sweep`` on the Poisson control band at nx=32, float32:
    with TF32 the cyclic reduction's library products lose accuracy (the
    residual rises above the IEEE one), one refinement sweep with an IEEE
    residual brings it back within 10x; K3 runs in every mode, and the
    CUDA setting reads "ieee" after."""
    from hippyflow_tpu_torch.ops import tf32_sweep

    band, b = tf32_sweep.control_band(32, 32, 8, cuda)
    res = tf32_sweep.measure("block_cyclic", band, b, rounds=1)
    assert all(res[m]["k3"] > 0 for m in tf32_sweep.MODES)
    assert torch.backends.cuda.matmul.fp32_precision == "ieee"
    ieee, tf32, refined = (res[m]["residual"] for m in tf32_sweep.MODES)
    assert tf32 > ieee, (tf32, ieee)
    assert refined <= 10.0 * ieee, (refined, ieee)


def test_component_transpmult_on_card_matches_cpu(cuda):
    """J^T dq through a ComponentObservation of the helmholtz problem's
    real part (nx=8, s=68, K1's rows, the Schur step, K3 and K2), float64:
    on the card against the materialized product and against the CPU."""
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable,
        helmholtz_prior,
    )
    from hippyflow_tpu_torch.fem import ComponentObservation
    from hippyflow_tpu_torch.models import (
        LinearStateObservable,
        ObservableJacobian,
        PointwiseObservation,
    )

    out = {}
    for dev in (cuda, torch.device("cpu")):
        kw = dict(dtype=torch.float64, device=dev)
        obs, Vh = helmholtz_linear_observable(nx=8, frequency=600.0, **kw)
        B = ComponentObservation(PointwiseObservation(obs.problem.Vu,
                                                      obs.B.targets, **kw), 2, 0)
        comp = LinearStateObservable(obs.problem, B)
        xi = np.random.default_rng(31).standard_normal((3, Vh.dim))
        m = helmholtz_prior(Vh, **kw).sample(torch.tensor(xi, **kw))
        u, info = obs.problem.solve_fwd(m)
        assert info.converged.all()
        dq = torch.tensor(np.random.default_rng(32).standard_normal(
            (3, comp.dQ, 2)), **kw)
        J = ObservableJacobian(comp)
        hk.reset_launch_counts()
        lin = obs.problem.linearize(u, m)
        got = J.transpmult(lin, dq)
        if dev.type == "cuda":
            assert hk.banded_factorize.launches > 0 and hk.banded_solve.launches > 0
        assert _rel(got, J.materialize(lin).mT @ dq) < 1e-10
        out[dev.type] = got.cpu()
    assert _rel(out["cuda"], out["cpu"]) < 1e-8


def _by_design(tally):
    out = {}
    for key, n in tally.items():
        out[key[0]] = out.get(key[0], 0) + n
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["chain", "rows", "streamed", "panels", "k3",
                                  "k4", "schur"])
def test_launches_by_shape_agree_with_launches_by_design(cuda, dtype, case):
    """Each wrapper's ``launches_by_shape`` sums, key by key of its design,
    to the counts it had (``launches_by_design``, ``launches``,
    ``rank1_launches``), at shapes of the kernels' tests above; a
    row-design call of K1 counts once under 'rows' and its nb Schur steps
    and K3 launches under their own keys."""
    s, nb, n = {"rows": (193, 6, 16), "chain": (65, 65, 5)}.get(case, (65, 5, 4))
    band = _band(s, n, dtype, cuda, seed=s, nb=nb)
    hk.reset_launch_counts()
    if case in ("chain", "rows"):
        hk.banded_factorize(band, design=case)
    elif case in ("streamed", "panels"):
        M, Dinv = hk.banded_factorize_plain(band)
        k = 1 if case == "streamed" else 100
        bb = torch.randn(n, nb, s, k, dtype=dtype, device=cuda)
        hk.banded_solve(M, Dinv, band[..., 2 * s:].contiguous(), bb,
                        trans=case == "panels")
    elif case in ("k3", "k4"):
        hk.batched_inverse(band[:, 0, :, s:2 * s].contiguous(),
                           rank1=case == "k4")
    else:
        M = torch.zeros(n, nb, s, s, dtype=dtype, device=cuda)
        Dinv = torch.zeros_like(M)
        for j in range(nb):
            hk.schur_step_(band, M, Dinv, j)
    torch.cuda.synchronize()
    item = str(dtype).split(".")[-1]
    assert (_by_design(hk.banded_factorize.launches_by_shape)
            == {d: v for d, v in hk.banded_factorize.launches_by_design.items()
                if v})
    assert (_by_design(hk.banded_solve.launches_by_shape)
            == {d: v for d, v in hk.banded_solve.launches_by_design.items() if v})
    assert sum(hk.schur_step_.launches_by_shape.values()) == hk.schur_step_.launches
    inv = _by_design(hk.batched_inverse.launches_by_shape)
    assert inv.get("k3", 0) == hk.batched_inverse.launches
    assert inv.get("k4", 0) == hk.batched_inverse.rank1_launches
    want = {
        "chain": (hk.banded_factorize, {("chain", n, s, nb, 0, item): 1}),
        "rows": (hk.batched_inverse, {("k3", n, s, nb, 0, item): nb}),
        "streamed": (hk.banded_solve, {("streamed", n, s, nb, 1, item): 1}),
        "panels": (hk.banded_solve, {("panels", n, s, nb, 100, item): 1}),
        "k3": (hk.batched_inverse, {("k3", n, s, 1, 0, item): 1}),
        "k4": (hk.batched_inverse, {("k4", n, s, 1, 0, item): 1}),
        "schur": (hk.schur_step_, {("schur", n, s, nb, 0, item): nb}),
    }
    fn, shapes = want[case]
    assert fn.launches_by_shape == shapes
    if case == "rows":
        assert hk.banded_factorize.launches_by_shape == {
            ("rows", n, s, nb, 0, item): 1}
        assert hk.schur_step_.launches_by_shape == {
            ("schur", n, s, nb, 0, item): nb}
    hk.reset_launch_counts()
    assert not any(f.launches_by_shape for f in (
        hk.banded_factorize, hk.schur_step_, hk.batched_inverse, hk.banded_solve))


@pytest.mark.parametrize("dtype,n,s,rows,cluster", [
    (torch.float32, 32, 193, True, None),  # K1's rows, nx=192 chunk: c=3
    (torch.float32, 16, 193, True, None),  # the Jacobian's rows: c=4
    (torch.float64, 16, 193, True, None),
    (torch.float32, 96, 193, False, None),  # the prior's CR level 0: c=1
    (torch.float32, 32, 258, True, None),  # P2 rows: c=3
    (torch.float32, 2048, 65, False, None),  # many matrices, c=1
    (torch.float64, 2048, 65, False, None),
    (torch.float32, 3, 193, False, 7),  # a pivot block across two owners
    (torch.float32, 3, 17, False, 8),  # blocks that own no column
])
def test_k3_resident_matches_the_l2_design_bit_for_bit(cuda, dtype, n, s, rows,
                                                        cluster):
    """K3 with each matrix resident in the cluster's shared memory against
    the L2 design on the same input, through ``batched_inverse_row_`` with
    K1's stride or ``batched_inverse``: the two do the same arithmetic in
    the same order, so their results are equal bit for bit (and within
    the plain version's limit); the resident launch is counted."""
    if rows:
        buf = torch.stack([_dd_batch(n, s, dtype, cuda, seed=q) for q in range(8)],
                          dim=1).contiguous()
        before = buf.clone()
        hk.reset_launch_counts()
        hk.batched_inverse_row_(buf, 5, cluster=cluster, resident=True)
        got, X = buf[:, 5].clone(), before[:, 5].contiguous()
        buf.copy_(before)
        hk.batched_inverse_row_(buf, 5, cluster=cluster, resident=False)
        want = buf[:, 5]
        others = [q for q in range(8) if q != 5]
        assert torch.equal(buf[:, others], before[:, others])
        nb = 8
    else:
        X = _dd_batch(n, s, dtype, cuda, seed=s)
        hk.reset_launch_counts()
        got = hk.batched_inverse(X, cluster=cluster, resident=True)
        want = hk.batched_inverse(X, cluster=cluster, resident=False)
        nb = 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    m = min(n, 4)
    assert _rel(got[:m], hk.batched_inverse_plain(X[:m])) < TOL[dtype]
    key = ("k3", n, s, nb, 0, str(dtype).split(".")[-1])
    assert hk.batched_inverse.launches_by_shape == {key: 2}
    assert hk.batched_inverse.resident_by_shape == {key: 1}


def test_k1_rows_at_nx192_equal_their_steps_with_the_l2_inverse(cuda):
    """K1's row design at s=nb=193 (the nx=192 lane, float32), whose K3
    launches take the resident design, equals bit for bit its Schur steps
    followed by K3 forced to the L2 design, row by row: the factor the
    row design gave before the resident design existed."""
    s, nb, n = 193, 193, 16
    band = _band(s, n, torch.float32, cuda, seed=3, nb=nb)
    hk.reset_launch_counts()
    M, Dinv = hk.banded_factorize(band)
    assert hk.banded_factorize.launches_by_design == {"chain": 0, "rows": 1}
    assert hk.batched_inverse.resident_by_shape == {
        ("k3", n, s, nb, 0, "float32"): nb}
    M2, D2 = torch.zeros_like(M), torch.zeros_like(Dinv)
    for j in range(nb):
        hk.schur_step_(band, M2, D2, j)
        hk.batched_inverse_row_(D2, j, resident=False)
    torch.cuda.synchronize()
    assert torch.equal(M, M2) and torch.equal(Dinv, D2)


def test_resident_by_shape_counts_the_resident_launches_alone(cuda):
    """``resident_by_shape`` counts the K3/K4 launches that ran resident,
    under ``launches_by_shape``'s keys, and none of those that kept the L2
    design: helmholtz's (16, 516) block rows in both dtypes (and the
    forced ones)."""
    hk.reset_launch_counts()
    f32, f64 = torch.float32, torch.float64
    for dtype in (f32, f64):
        buf = torch.stack([_dd_batch(16, 516, dtype, cuda, seed=q) for q in range(2)],
                          dim=1).contiguous()
        hk.batched_inverse_row_(buf, 1)
    X = _dd_batch(16, 193, f32, cuda)
    hk.batched_inverse(X)
    hk.batched_inverse(X, rank1=True)
    hk.batched_inverse(X, resident=False)
    hk.banded_factorize(_band(193, 4, f32, cuda, nb=3))
    torch.cuda.synchronize()
    assert hk.batched_inverse.launches_by_shape == {
        ("k3", 16, 516, 2, 0, "float32"): 1, ("k3", 16, 516, 2, 0, "float64"): 1,
        ("k3", 16, 193, 1, 0, "float32"): 2, ("k4", 16, 193, 1, 0, "float32"): 1,
        ("k3", 4, 193, 3, 0, "float32"): 3}
    assert hk.batched_inverse.resident_by_shape == {
        ("k3", 16, 193, 1, 0, "float32"): 1, ("k4", 16, 193, 1, 0, "float32"): 1,
        ("k3", 4, 193, 3, 0, "float32"): 3}
    with pytest.raises(ValueError, match="shared memory"):
        hk.batched_inverse(_dd_batch(16, 516, f32, cuda), resident=True)


def test_k3_footprint_mirrors_the_library(cuda):
    """``gj_smem_bytes`` gives what the kernel asks for, in both designs."""
    lib = hk._library()
    for s, w, c, item in [(193, 13, 3, 4), (193, 13, 1, 8), (516, 13, 6, 4),
                          (258, 1, 3, 8), (9, 13, 1, 4), (65, 13, 8, 8)]:
        for resident in (False, True):
            assert lib.hf_gj_smem_bytes(s, w, c, int(resident), item) == (
                hk.gj_smem_bytes(s, w, c, item, resident))
