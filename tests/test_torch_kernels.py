"""K1/K2 of the PyTorch port against the JAX package's Pallas kernels.

The port's banded inverse-Thomas factorization (K1, ``banded_factorize``)
and back-solve (K2, ``banded_solve``) run their plain PyTorch versions on
CPU tensors; here they are held against the Pallas kernels they replace
(``banded_factorize_batch`` / ``banded_solve_batch`` in interpret mode) and
the JAX package's XLA scans, on the same numpy inputs, in float64.  The
CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu.ops.pallas_kernels import (
    banded_factorize_batch,
    banded_solve_batch,
)
from hippyflow_tpu.ops.structured import (
    _factorize_thomas_inv_banded,
    _thomas_solve_scan,
)
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch.ops import hopper_kernels as hk
from hippyflow_tpu_torch.ops.structured import (
    block_tridiag_matmat,
    block_tridiag_matmat_trans,
    factorize_thomas_inv_banded,
)

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
# float64 throughout; both sides invert diagonally dominant blocks (the
# Pallas kernel by Gauss-Jordan without pivoting, the plain version by
# pivoted LU), which agree to a few ulps of the block entries
TOL = 1e-12


def _random_band(nx: int, n_batch: int, seed: int) -> np.ndarray:
    """(N, nb, s, 3s) band, nb = s = nx + 1, diagonally dominant, with the
    structurally absent blocks A_0 and B_{nb-1} zero."""
    rng = np.random.default_rng(seed)
    s = nb = nx + 1
    band = 0.1 * rng.standard_normal((n_batch, nb, s, 3 * s))
    band[:, :, :, s : 2 * s] += 4.0 * np.eye(s)
    band[:, 0, :, :s] = 0.0
    band[:, -1, :, 2 * s :] = 0.0
    return band


@functools.lru_cache(maxsize=None)
def _confusion_band(nx: int, n_batch: int, seed: int) -> np.ndarray:
    """bc-symmetrized confusion bands assembled by the JAX package at
    random (u, m) states."""
    from applications.confusion import confusion_linear_observable
    from hippyflow_tpu.fem import bc_symmetrize_banded_from_mask

    obs, Vh = confusion_linear_observable(nx=nx, velocity="analytic")
    pde = obs.problem
    s = nx + 1
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n_batch, Vh.dim))
    m = 0.5 * rng.standard_normal((n_batch, Vh.dim))
    bands = jax.vmap(
        lambda uu, mm: bc_symmetrize_banded_from_mask(
            pde.bound.assemble_A_banded(uu, mm, None, s), pde.bc
        )
    )(jnp.asarray(u), jnp.asarray(m))
    return np.asarray(bands)


def _band(kind: str, nx: int = 8, n_batch: int = 3, seed: int = 0):
    if kind == "random":
        return _random_band(nx, n_batch, seed)
    return _confusion_band(nx, n_batch, seed)


def _rhs(band: np.ndarray, k: int, seed: int) -> np.ndarray:
    N, nb, s, _ = band.shape
    return np.random.default_rng(seed).standard_normal((N, nb, s, k))


@pytest.mark.parametrize("kind", ["random", "confusion"])
def test_factorize_plain_matches_pallas_interpret(kind):
    band = _band(kind)
    M_ref, D_ref = banded_factorize_batch(jnp.asarray(band), interpret=True)
    M, Dinv = hk.banded_factorize_plain(interop.tensor(band, **F64))
    np.testing.assert_allclose(M.numpy(), np.asarray(M_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        Dinv.numpy(), np.asarray(D_ref), rtol=TOL, atol=TOL
    )


@pytest.mark.parametrize("kind", ["random", "confusion"])
def test_factorize_plain_matches_scan(kind):
    band = _band(kind)
    ref = jax.vmap(_factorize_thomas_inv_banded)(jnp.asarray(band))
    fac = factorize_thomas_inv_banded(interop.tensor(band, **F64))
    for got, want in zip(fac, ref):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=TOL, atol=TOL
        )


@pytest.mark.parametrize("kind", ["random", "confusion"])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k", [1, 5])
def test_solve_plain_matches_pallas_interpret(kind, trans, k):
    """The JAX factor carried over by interop: the plain K2 equals the
    interpret-mode Pallas sweeps and the XLA scan."""
    band = _band(kind, nx=10)
    ref_fac = jax.vmap(_factorize_thomas_inv_banded)(jnp.asarray(band))
    rhs = _rhs(band, k, seed=1)
    want = banded_solve_batch(
        ref_fac.M, ref_fac.Dinv, ref_fac.B, jnp.asarray(rhs), trans,
        interpret=True,
    )
    want_scan = jax.vmap(
        lambda M, D, B, r: _thomas_solve_scan(M, D, B, r, trans)
    )(ref_fac.M, ref_fac.Dinv, ref_fac.B, jnp.asarray(rhs))
    fac = interop.inverse_thomas_factor(*map(np.asarray, ref_fac), **F64)
    got = hk.banded_solve_plain(
        fac.M, fac.Dinv, fac.B, interop.tensor(rhs, **F64), trans
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want_scan), rtol=TOL, atol=TOL
    )


@pytest.mark.parametrize("slices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("nx", [16, 32, 64])
def test_solve_plain_in_cluster_slabs_matches_pallas_interpret(nx, k, trans, slices):
    """The schedule of K2's streamed design in clusters of ``slices`` blocks
    (every product formed slab by slab: rows of the output forward, partial
    sums over slabs of rows transposed) equals the interpret-mode Pallas
    sweeps, at the block sizes s = nx + 1 of the nx=64 lane and its coarse
    levels (4 block rows of each band)."""
    band = _random_band(nx, 2, seed=nx)[:, :4]
    band[:, -1, :, 2 * (nx + 1):] = 0.0
    ref_fac = jax.vmap(_factorize_thomas_inv_banded)(jnp.asarray(band))
    rhs = _rhs(band, k, seed=k)
    want = banded_solve_batch(
        ref_fac.M, ref_fac.Dinv, ref_fac.B, jnp.asarray(rhs), trans,
        interpret=True,
    )
    fac = interop.inverse_thomas_factor(*map(np.asarray, ref_fac), **F64)
    bb = interop.tensor(rhs, **F64)
    got = hk.banded_solve_plain(fac.M, fac.Dinv, fac.B, bb, trans, slices=slices)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the wrapper on the CPU runs the same schedule for cluster=slices
    via = hk.banded_solve(fac.M, fac.Dinv, fac.B, bb, trans, cluster=slices)
    assert torch.equal(via, got)


def test_solve_plain_refuses_more_slabs_than_rows():
    blk = torch.zeros((1, 2, 3, 3), **F64)
    for slices in (0, 4):
        with pytest.raises(ValueError, match="slices"):
            hk.banded_solve_plain(blk, blk, blk, blk[..., :1], False, slices=slices)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k", [8, 13, 100])
@pytest.mark.parametrize("nx", [16, 32, 64])
def test_solve_plain_in_column_tiles_matches_pallas_interpret(nx, k, trans):
    """The schedule of K2's panel design (the column tiles of its even
    split solved one after another, every product summed over slices of
    its inner index) equals the interpret-mode Pallas sweeps, at the split
    ``panel_geometry`` picks for 2 samples in float64 on the H100 and at 3
    tiles and 2 slices, at the block sizes s = nx + 1 of the nx=64 lane and
    its coarse levels (4 block rows of each band)."""
    band = _random_band(nx, 2, seed=nx + k)[:, :4]
    band[:, -1, :, 2 * (nx + 1):] = 0.0
    ref_fac = jax.vmap(_factorize_thomas_inv_banded)(jnp.asarray(band))
    rhs = _rhs(band, k, seed=k)
    want = np.asarray(banded_solve_batch(
        ref_fac.M, ref_fac.Dinv, ref_fac.B, jnp.asarray(rhs), trans,
        interpret=True,
    ))
    fac = interop.inverse_thomas_factor(*map(np.asarray, ref_fac), **F64)
    bb = interop.tensor(rhs, **F64)
    geo = hk.panel_geometry(2, nx + 1, k, 8, 132, H100_SMEM, H100_SM_SMEM)
    for tiles, lsplit in {(geo.tiles, geo.lsplit), (3, 2)}:
        got = hk.banded_solve_plain(fac.M, fac.Dinv, fac.B, bb, trans,
                                    column_tiles=tiles, lsplit=lsplit)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_solve_plain_refuses_splits_it_does_not_take():
    blk = torch.zeros((1, 2, 3, 3), **F64)
    bb = torch.zeros((1, 2, 3, 4), **F64)
    for kw in (dict(column_tiles=0), dict(column_tiles=5), dict(lsplit=0),
               dict(lsplit=4), dict(lsplit=2, slices=2)):
        with pytest.raises(ValueError, match="column_tiles|lsplit"):
            hk.banded_solve_plain(blk, blk, blk, bb, True, **kw)


@pytest.mark.parametrize("kind", ["random", "confusion"])
@pytest.mark.parametrize("trans", [False, True])
def test_factor_solves_the_system(kind, trans):
    """End to end on the CPU: factorize, solve, and check A x = b (or
    A^T x = b) with the banded matvec."""
    band = interop.tensor(_band(kind, nx=10), **F64)
    N, nb, s, _ = band.shape
    b = torch.as_tensor(
        np.random.default_rng(2).standard_normal((N, nb * s, 4)), **F64
    )
    x = factorize_thomas_inv_banded(band).solve(b, trans=trans)
    apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
    res = torch.linalg.vector_norm(apply(band, x) - b) / torch.linalg.vector_norm(b)
    assert res.item() < 1e-12
    # 1-d right-hand sides keep their shape
    x1 = factorize_thomas_inv_banded(band).solve(b[..., 0], trans=trans)
    np.testing.assert_allclose(
        x1.numpy(), x[..., 0].numpy(), rtol=1e-13, atol=1e-13
    )


def test_banded_matvecs_match_dense():
    """block_tridiag_matmat(_trans) against the dense operator the band
    stores."""
    band = _random_band(4, 2, seed=3)
    N, nb, s, _ = band.shape
    dense = np.zeros((N, nb * s, nb * s))
    for j in range(nb):
        for o in range(3):
            jj = j + o - 1
            if 0 <= jj < nb:
                dense[:, j * s : (j + 1) * s, jj * s : (jj + 1) * s] = band[
                    :, j, :, o * s : (o + 1) * s
                ]
    X = np.random.default_rng(4).standard_normal((N, nb * s, 3))
    bt, Xt = interop.tensor(band, **F64), interop.tensor(X, **F64)
    np.testing.assert_allclose(
        block_tridiag_matmat(bt, Xt).numpy(), dense @ X, rtol=1e-13, atol=1e-13
    )
    np.testing.assert_allclose(
        block_tridiag_matmat_trans(bt, Xt).numpy(),
        np.swapaxes(dense, 1, 2) @ X,
        rtol=1e-13,
        atol=1e-13,
    )


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and count no launch."""
    band = interop.tensor(_random_band(4, 2, seed=5), **F64)
    hk.reset_launch_counts()
    M, Dinv = hk.banded_factorize(band)
    M_p, D_p = hk.banded_factorize_plain(band)
    assert torch.equal(M, M_p) and torch.equal(Dinv, D_p)
    B = band[..., 2 * band.shape[2] :].contiguous()
    bb = torch.ones(band.shape[:3] + (2,), **F64)
    for trans in (False, True):
        assert torch.equal(
            hk.banded_solve(M, Dinv, B, bb, trans),
            hk.banded_solve_plain(M, Dinv, B, bb, trans),
        )
    assert hk.banded_factorize.launches == 0
    assert hk.banded_solve.launches == 0


def test_library_path_is_keyed_on_the_sources():
    """The build directory is ignored by git and named by a hash of the
    kernel sources and nvcc flags, so an edit rebuilds."""
    path = hk.library_path()
    assert path.parent.parent == hk.BUILD_DIR
    assert path == hk.library_path()
    for name in hk.SOURCES + hk.HEADERS:
        assert (hk.CSRC / name).exists()


@pytest.mark.parametrize("call", ["factorize", "solve", "inverse", "inverse_row"])
def test_non_cpu_tensors_never_take_the_plain_versions(call):
    """A tensor that is not on the CPU goes to the kernel or raises: a
    "meta" tensor (no data, no card needed) is refused, not computed by
    the plain version."""
    band = torch.empty((2, 5, 5, 15), dtype=torch.float64, device="meta")
    blk = torch.empty((2, 5, 5, 5), dtype=torch.float64, device="meta")
    hk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="meta"):
        if call == "factorize":
            hk.banded_factorize(band)
        elif call == "solve":
            hk.banded_solve(blk, blk, blk, blk[..., :2], False)
        elif call == "inverse":
            hk.batched_inverse(blk[:, 0], cluster=2)
        else:
            hk.batched_inverse_row_(blk, 1, cluster=2)
    assert hk.banded_factorize.launches == hk.banded_solve.launches == 0
    assert hk.batched_inverse.launches == 0


H100_SMEM = 232448  # shared memory one block may opt into on the H100
H100_SM_SMEM = 233472  # shared memory of one of its SMs


# samples of the lanes' solves at each block size: the nx=64 chunk, the
# nx=192 Jacobian chunk, the helmholtz chunk, one
LANE_SAMPLES = {65: 256, 193: 16, 516: 16, 2000: 1}


@pytest.mark.parametrize("s,k,itemsize,want", [
    (65, 100, 4, (72, 1)),  # the nx=64 Jacobian solve: one tile, one panel
    (65, 1, 4, (0, 1)),  # the Newton solves: streamed
    (193, 100, 8, (72, 8)),  # the nx=192 Jacobian: 8 tiles of 12-13
    (516, 200, 4, (48, 8)),  # helmholtz: 8 tiles of 25
    (516, 200, 8, (16, 13)),  # 10-12 tiles fit only 8-row panels
    (516, 1, 8, (0, 1)),
    (516, 4, 8, (0, 4)),
    (516, 7, 4, (0, 7)),  # the streamed design's widest column tile
    (2000, 7, 8, (0, 1)),  # a transposed carry of 2 to 7 columns does not fit
    (2000, 200, 8, None),  # no panel fits: the wrapper raises
])
def test_solve_tiles_pick_the_widest_tile_then_panel(s, k, itemsize, want):
    """K2's design and geometry under the H100's shared memory at the
    lanes' sample counts: the streamed design's widest column tile below
    PANELS_MIN_K columns, the panel design's (panel rows, column tiles)
    from ``panel_geometry`` from it, within the limit."""
    n = LANE_SAMPLES[s]
    got = hk.solve_tiles(n, s, k, itemsize, 132, H100_SMEM, H100_SM_SMEM)
    assert got == want
    if got is not None and got[0] > 0:
        geo = hk.panel_geometry(n, s, k, itemsize, 132, H100_SMEM, H100_SM_SMEM)
        assert (geo.rows, geo.tiles) == got and geo.smem_bytes <= H100_SMEM
    elif got is not None:
        for trans in (False, True):
            assert hk.stream_geometry(1, s, got[1], itemsize, 1, trans, 132,
                                      H100_SMEM, H100_SM_SMEM) is not None


def test_solve_tiles_stream_many_columns_in_tiles_of_seven():
    """The streamed design forced at many columns takes column tiles of at
    most STREAM_MAX_COLS."""
    for s, item in ((65, 4), (516, 8)):
        assert hk.solve_tiles(16, s, 200, item, 132, H100_SMEM, H100_SM_SMEM,
                              panels=False) == (0, 7)


# the panel design's shapes: the lanes' (nx=64 Jacobian chunk, nx=192
# Jacobian chunk, helmholtz), their coarse block sizes, small and ragged ones
PANEL_SHAPES = [(256, 65, 100), (16, 193, 100), (16, 516, 200), (32, 193, 100),
                (1024, 33, 100), (1024, 17, 100), (32, 97, 100), (2, 65, 8),
                (2, 17, 13), (5, 49, 40), (3, 516, 8), (1, 25, 200)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n,s,k", PANEL_SHAPES)
def test_panel_geometry_splits_and_fits(n, s, k, itemsize):
    """The picked geometry: column tiles that cover k in order with widths
    that differ by at most one (the widest within the padded tile), panels
    whose rows past s are at most s / 8 where a width allows it, the block
    within the card's shared memory (and two of them within an SM's where
    it counts two an SM), whole warps of at most SOLVE_MAX_THREADS threads
    that cover every output tile and slice; the column split, the threads
    and the panel as the rule takes them."""
    geo = hk.panel_geometry(n, s, k, itemsize, 132, H100_SMEM, H100_SM_SMEM)
    t, rows, rt, ls = geo.tiles, geo.rows, geo.row_tile, geo.lsplit
    cols = hk.column_split(k, t)
    assert cols[0][0] == 0 and cols[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    widths = [hi - lo for lo, hi in cols]
    assert min(widths) >= 1 and max(widths) - min(widths) <= 1
    kp = hk.solve_tile_cols(k, t)
    assert kp % hk.SOLVE_COL_TILE == 0 and max(widths) <= kp < max(widths) + 4
    assert rows % hk.PANEL_ROW_STEP == 0 and rows % rt == 0
    assert rows in hk.panel_row_options(s)
    past = -(-s // rows) * rows - s
    assert 8 * past <= s or s < 64
    assert geo.smem_bytes == hk.solve_smem_bytes(s, k, t, rows, ls, itemsize)
    assert geo.smem_bytes <= H100_SMEM
    assert geo.share * (geo.smem_bytes + hk.BLOCK_SMEM_RESERVE) <= H100_SM_SMEM
    work = rows // rt * kp // hk.SOLVE_COL_TILE * ls
    assert geo.threads % 32 == 0 and work <= geo.threads < work + 32
    assert geo.threads <= hk.SOLVE_MAX_THREADS and 1 <= ls <= max(1, s // 16)

    # the fewest column tiles from one block an SM at which a panel of
    # PANEL_MIN_ROWS rows fits; every fewer tile count fits narrower panels
    # only, or none
    base = min(k, max(1, 132 // n))
    assert t >= base and (rows >= hk.PANEL_MIN_ROWS or t == base)
    for fewer in range(base, t):
        assert all(g.rows < hk.PANEL_MIN_ROWS for g in hk.panel_fits(
            s, k, fewer, itemsize, H100_SMEM, H100_SM_SMEM))
    # among the geometries at t: 8 warps where any has them, then the
    # widest panel
    fits = [g for ls in range(1, max(1, s // 16) + 1)
            for g in hk.panel_fits(s, k, t, itemsize, H100_SMEM, H100_SM_SMEM,
                                   lsplit=ls)]
    assert geo in fits
    if any(g.threads >= hk.SOLVE_GOOD_THREADS for g in fits):
        assert geo.threads >= hk.SOLVE_GOOD_THREADS
        waves = -(-n * t // 132)
        assert rows == max(g.rows for g in fits
                           if g.threads >= hk.SOLVE_GOOD_THREADS
                           and min(g.share, waves) == min(geo.share, waves))


@pytest.mark.parametrize("s", list(range(1, 80)) + [97, 129, 193, 257, 516, 1031])
def test_panel_row_options_split_s_evenly(s):
    """Panel widths are whole multiples of PANEL_ROW_STEP, widest first,
    one for each number of panels; from s = 64 every one leaves at most s /
    8 rows past s, below it those that leave the fewest."""
    opts = hk.panel_row_options(s)
    assert opts == sorted(set(opts), reverse=True) and opts
    assert all(r % hk.PANEL_ROW_STEP == 0 and r >= hk.PANEL_ROW_STEP for r in opts)
    past = [-(-s // r) * r - s for r in opts]
    if s >= 64:
        assert all(8 * p <= s for p in past)
    assert len({-(-s // r) for r in opts}) == len(opts)


@pytest.mark.parametrize("s,want", [(65, 72), (193, 40), (516, 40)])
def test_panel_row_options_hold_the_even_splits(s, want):
    """One panel of 72 rows at s=65, five of 40 at s=193, thirteen of 40 at
    s=516 are among the widths."""
    assert want in hk.panel_row_options(s)


@pytest.mark.parametrize("forced", [
    dict(rows=20), dict(rows=12), dict(tiles=0), dict(tiles=101),
    dict(row_tile=6), dict(row_tile=2), dict(rows=600),
])
def test_panel_geometry_refuses_what_the_kernel_does_not_take(forced):
    """A forced panel width that is not a multiple of PANEL_ROW_STEP, a
    column split outside 1 to k, a register tile the kernel was not built
    for, or a panel too large for shared memory: no geometry."""
    assert hk.panel_geometry(16, 193, 100, 8, 132, H100_SMEM, H100_SM_SMEM,
                             **forced) is None


def test_panel_geometry_gives_up_where_nothing_fits():
    """s=2000 in float64: the panel of one register tile's rows and the
    carry of one column group alone exceed a block's shared memory."""
    assert hk.panel_geometry(1, 2000, 200, 8, 132, H100_SMEM, H100_SM_SMEM) is None
    assert hk.solve_smem_bytes(2000, 200, 200, 8, 1, 8) > H100_SMEM


@pytest.mark.parametrize("n,s,want", [
    (16, 516, 6),  # helmholtz Schur complements: 96 of the 99 blocks
    (32, 193, 3),  # K1's rows in the nx=192 lane, chunk 32
    (16, 193, 4),  # the same at N=16: at least 48 columns a block
    (96, 193, 1),  # the prior's cyclic reduction
    (32, 65, 1),  # nx=64 cyclic reduction: too narrow to split
    (67, 193, 1),  # n > 132 / 2: one block per matrix
    (1, 17, 1),  # s < 32: one chunk
    (1, 31, 1),
    (2, 96, 2),
    (1, 1024, 8),  # capped at the portable cluster size
    (0, 516, 8),
    (1000, 516, 1),  # more matrices than SMs
])
def test_gj_cluster_keeps_a_margin_of_sms_and_columns(n, s, want):
    c = hk.gj_cluster(n, s, 132)
    assert c == want
    assert 1 <= c <= hk.GJ_MAX_CLUSTER
    assert c == 1 or (4 * n * c <= 3 * 132 and c * hk.GJ_MIN_COLS <= s)


# the H100's shared memory a block may opt into
H100_SMEM = 232448


@pytest.mark.parametrize("n,s,itemsize,resident", [
    (32, 193, 4, True),  # K1's rows, nx=192 chunk (c=3): 92288 bytes
    (16, 193, 4, True),  # the Jacobian's rows (c=4): 65920
    (96, 193, 4, True),  # the prior's cyclic reduction (c=1): 197760
    (32, 258, 4, True),  # P2 rows (c=3): 121408
    (16, 516, 4, False),  # helmholtz (c=6): 236992
    (16, 516, 8, False),  # 473984
    (32, 258, 8, False),  # 242816
])
def test_gj_resident_where_the_footprint_fits(n, s, itemsize, resident):
    """K3 keeps its matrix in the cluster's shared memory where the
    resident design's footprint (the staged pivot columns, P^-1, the new
    pivot rows and the own columns, in rows of whole chunks) fits a
    block's limit at the c that ``gj_cluster`` picks, and only there."""
    c = hk.gj_cluster(n, s, 132)
    need = hk.gj_smem_bytes(s, hk.GJ_WIDTH, c, itemsize, True)
    ld = hk.gj_res_ld(s, c)
    assert need == (hk.GJ_ROW * (s + hk.GJ_WIDTH) + (hk.GJ_WIDTH + s) * ld) * itemsize
    assert hk.gj_resident(s, c, itemsize, H100_SMEM) == resident
    assert resident == (need <= H100_SMEM)
    assert hk.gj_resident(s, c, itemsize, need) and not hk.gj_resident(
        s, c, itemsize, need - 1)
    for bad in (0, -1, hk.GJ_MAX_CLUSTER + 1):  # the kernel refuses the launch
        assert not hk.gj_resident(s, bad, itemsize, H100_SMEM)


@pytest.mark.parametrize("s,c", [(193, 3), (193, 1), (258, 3), (516, 6), (17, 8),
                                 (9, 1)])
def test_gj_own_cols_and_resident_rows_hold_the_widest_slice(s, c):
    """A block's own columns (the L2 design's slices of the pivot rows)
    are the most whole 32-column chunks a slice takes, capped at s; the
    resident design's rows hold as many whole chunks."""
    chunks = max(-(-(hi - lo) // 32) for lo, hi in hk.gj_slices(s, c))
    assert hk.gj_own_cols(s, c) == min(s, 32 * chunks)
    assert hk.gj_res_ld(s, c) == 32 * chunks


def test_reset_launch_counts_zeroes_the_resident_tally():
    key = ("k3", 16, 193, 193, 0, "float32")
    hk.batched_inverse.resident_by_shape.add(key, 5)
    hk.reset_launch_counts()
    assert not hk.batched_inverse.resident_by_shape
    assert not hk.batched_inverse.resident_by_shape.traced


@pytest.mark.parametrize("s,c", [(516, 8), (193, 4), (193, 7), (65, 3),
                                 (17, 8), (33, 2), (5, 3)])
def test_gj_slices_split_a_row_into_whole_chunks(s, c):
    """The column slices of a K3 cluster tile [0, s) in order, each a run
    of whole 32-column chunks (the last ragged), balanced to one chunk."""
    sl = hk.gj_slices(s, c)
    assert len(sl) == c and sl[0][0] == 0 and sl[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    assert all(lo % 32 == 0 and (hi % 32 == 0 or hi == s) for lo, hi in sl)
    chunks = [-(-(hi - lo) // 32) for lo, hi in sl]
    assert max(chunks) - min(chunks) <= 1


@pytest.mark.parametrize("blocks,s,want", [
    (16, 516, 6),  # helmholtz chunk: 96 of the 132 SMs
    (16, 193, 6),  # the nx=192 Jacobian chunk
    (32, 193, 3),  # the nx=192 chunk
    (32, 97, 3),  # its first coarse level
    (32, 49, 1),  # fewer than STREAM_MIN_ROWS rows a rank
    (32, 25, 1),
    (256, 65, 1),  # more samples than SMs
    (1024, 33, 1),
    (1, 17, 1),
    (1, 2000, 8),  # capped at the portable cluster size
    (0, 516, 8),
    (50, 516, 1),  # 2 blocks a sample would pass 3/4 of the card
    (49, 516, 2),
])
def test_stream_cluster_fills_the_card_with_slabs_worth_a_split(blocks, s, want):
    c = hk.stream_cluster(blocks, s, 132)
    assert c == want
    assert 1 <= c <= hk.STREAM_MAX_CLUSTER
    assert c == 1 or (4 * blocks * c <= 3 * 132 and c * hk.STREAM_MIN_ROWS <= s)


@pytest.mark.parametrize("s,c", [(516, 8), (516, 6), (193, 8), (193, 3),
                                 (65, 4), (17, 8), (17, 17), (5, 3)])
def test_stream_slabs_split_the_rows_evenly(s, c):
    """The row slabs of a streamed cluster tile [0, s) in order, none
    empty, balanced to one row, and ((i + 1) c - 1) // s (what the kernel
    computes) is the rank that owns row i."""
    sl = hk.stream_slabs(s, c)
    assert len(sl) == c and sl[0][0] == 0 and sl[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    sizes = [hi - lo for lo, hi in sl]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(sizes) == -(-s // c)
    for r, (lo, hi) in enumerate(sl):
        assert all(((i + 1) * c - 1) // s == r for i in range(lo, hi))


@pytest.mark.parametrize("blocks,s,kt,itemsize,c,trans", [
    (16, 516, 1, 4, 8, True), (16, 516, 1, 4, 1, False), (16, 516, 1, 8, 6, True),
    (16, 193, 1, 4, 8, False), (32, 193, 1, 4, 4, True), (32, 97, 1, 4, 4, False),
    (256, 65, 1, 4, 1, True), (256, 65, 1, 8, 1, False), (1024, 33, 1, 4, 1, True),
    (1024, 17, 1, 4, 1, False), (32, 25, 1, 4, 1, True), (2, 516, 7, 8, 1, True),
    (1, 2000, 1, 8, 1, False), (1, 2000, 1, 8, 1, True),
])
def test_stream_geometry_fits_the_card(blocks, s, kt, itemsize, c, trans):
    """Ring and threads of the streamed design on the H100: a stage of
    whole rows within STREAM_STAGE_BYTES (one row where a row is longer),
    equal chunks of the widest slab, at least two stages, the block within
    its share of an SM's shared memory and threads, whole warps."""
    rows, nstage, threads, rsplit, fgroup, need = hk.stream_geometry(
        blocks, s, kt, itemsize, c, trans, 132, H100_SMEM, H100_SM_SMEM)
    slab = -(-s // c)
    assert 1 <= rows <= slab
    assert rows == 1 or rows * s * itemsize + 16 <= hk.STREAM_STAGE_BYTES
    assert 2 <= nstage <= hk.STREAM_MAX_STAGES
    assert threads % 32 == 0 and 32 <= threads <= 32 * (
        hk.STREAM_MAX_WARPS if c > 1 else hk.STREAM_MAX_WARPS_ONE)
    assert need == hk.stream_smem_bytes(s, kt, c, rows, nstage, rsplit, trans,
                                        itemsize) <= H100_SMEM
    share = min(8, -(-blocks * c // 132))
    if share > 1:  # one wave: the blocks of an SM fit it together
        assert share * (need + hk.BLOCK_SMEM_RESERVE) <= H100_SM_SMEM
        assert share * threads <= 1024
    if trans:
        assert rsplit >= 1 and threads // 32 - 1 <= -(-s // 32) * rsplit
    else:
        assert rsplit == 1
    assert fgroup in (1, 2, 4, 8, 16, 32) and fgroup < max(2, s // 8)
    assert fgroup == 1 or rows * fgroup <= 32 * (threads // 32 - 1)


def test_stream_geometry_gives_up_where_nothing_fits():
    assert hk.stream_geometry(1, 2000, 7, 8, 1, True, 132, H100_SMEM,
                              H100_SM_SMEM) is None


def test_batched_inverse_row_inverts_one_block_row_in_place():
    """The strided call of K1's row design: buf[:, j] is inverted in place
    (with any column schedule) and every other block row is untouched."""
    rng = np.random.default_rng(3)
    buf = interop.tensor(rng.standard_normal((3, 4, 40, 40)) + 40 * np.eye(40),
                         **F64)
    want = buf.clone()
    want[:, 2] = torch.linalg.inv(buf[:, 2])
    for c in (None, 1, 2):
        got = hk.batched_inverse_row_(buf.clone(), 2, cluster=c)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-13)
        for j in (0, 1, 3):
            assert torch.equal(got[:, j], buf[:, j])
    with pytest.raises(ValueError, match="slices"):
        hk.batched_inverse(buf[:, 0], cluster=0)


def test_wrappers_reject_malformed_shapes():
    with pytest.raises(ValueError, match="band shape"):
        hk.banded_factorize(torch.empty((2, 5, 5, 14), device="meta"))
    with pytest.raises(ValueError, match="4-d"):
        blk = torch.empty((5, 5, 5), device="meta")
        hk.banded_solve(blk, blk, blk, blk, True)
