"""K1's chain of the PyTorch port: its schedule and its launch geometry.

The CUDA chain (``csrc/banded_factorize.cu``) runs a sample's block rows in
one launch: per row the Schur step, then the blocked Gauss-Jordan inverse
in place.  ``banded_factorize_rows_plain(band, slices=c)`` runs that
schedule on the CPU (c = 1), and with c > 1 the row-panel design's, whose
inverse splits the columns over a cluster of c thread blocks; here it is
held against the Pallas kernel it replaces (``banded_factorize_batch`` in
interpret mode) and against the pivoted plain version, on the same numpy
inputs, in float64.  The launch geometry (row stride, shared memory,
threads, design) is plain Python and is checked as such.  The kernels
themselves run only on a card: ``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu.ops.pallas_kernels import banded_factorize_batch
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch.ops import hopper_kernels as hk

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
# relative to the largest entry of the reference: Gauss-Jordan without
# pivoting in 13-wide blocks on both sides (the Pallas kernel on the
# augmented tile, the port in place, slice by slice) and pivoted LU in
# the plain version agree to a few ulps on diagonally dominant blocks
TOL = 1e-12
H100_SMEM = 232448  # shared memory one block may opt into on the H100
H100_SMS = 132
H100_SM_SMEM = 233472  # shared memory of one SM


def _random_band(s: int, nb: int, n_batch: int = 2) -> np.ndarray:
    """(N, nb, s, 3s) diagonally dominant band, A_0 = B_{nb-1} = 0."""
    rng = np.random.default_rng(1000 * s + nb)
    band = 0.1 * rng.standard_normal((n_batch, nb, s, 3 * s))
    band[:, :, :, s : 2 * s] += 4.0 * np.eye(s)
    band[:, 0, :, :s] = 0.0
    band[:, -1, :, 2 * s :] = 0.0
    return band


def _confusion_band(s: int, nb: int, n_batch: int = 2) -> np.ndarray:
    """The first nb block rows of bc-symmetrized confusion Newton bands at
    nx = s - 1, assembled by the JAX package at random (u, m) states."""
    from applications.confusion import confusion_linear_observable
    from hippyflow_tpu.fem import bc_symmetrize_banded_from_mask

    obs, Vh = confusion_linear_observable(nx=s - 1, velocity="analytic")
    pde = obs.problem
    rng = np.random.default_rng(s)
    u = rng.standard_normal((n_batch, Vh.dim))
    m = 0.5 * rng.standard_normal((n_batch, Vh.dim))
    bands = jax.vmap(
        lambda uu, mm: bc_symmetrize_banded_from_mask(
            pde.bound.assemble_A_banded(uu, mm, None, s), pde.bc
        )
    )(jnp.asarray(u), jnp.asarray(m))
    return np.ascontiguousarray(np.asarray(bands)[:, :nb])


@functools.lru_cache(maxsize=None)
def _case(kind: str, s: int, nb: int):
    """(band, Pallas M, Pallas Dinv, plain M, plain Dinv) of one input."""
    band = (_random_band if kind == "random" else _confusion_band)(s, nb)
    M_ref, D_ref = banded_factorize_batch(jnp.asarray(band), interpret=True)
    M_p, D_p = hk.banded_factorize_plain(interop.tensor(band, **F64))
    return band, np.asarray(M_ref), np.asarray(D_ref), M_p.numpy(), D_p.numpy()


CASES = [("random", 17, 3), ("random", 25, 4), ("random", 33, 5),
         ("random", 49, 6), ("random", 64, 3), ("random", 65, 4),
         ("confusion", 17, 4), ("confusion", 25, 3)]


@pytest.mark.parametrize("c", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kind,s,nb", CASES)
def test_chain_schedule_matches_pallas_and_plain(kind, s, nb, c):
    """K1's schedule with the inverse in c column slices (blocks without
    columns included: c=8 at s <= 65) against the interpret-mode Pallas
    kernel and the pivoted plain version."""
    band, M_ref, D_ref, M_p, D_p = _case(kind, s, nb)
    M, Dinv = hk.banded_factorize_rows_plain(interop.tensor(band, **F64), c)
    assert not M[:, 0].any()
    for got, ref, plain in ((M.numpy(), M_ref, M_p), (Dinv.numpy(), D_ref, D_p)):
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= TOL * scale
        assert np.abs(got - plain).max() <= TOL * scale


def test_rows_plain_rejects_no_slices():
    band = interop.tensor(_random_band(5, 2), **F64)
    with pytest.raises(ValueError, match="slices"):
        hk.banded_factorize_rows_plain(band, 0)


@pytest.mark.parametrize("n,itemsize,want,want_unpadded", [
    (65, 4, 68, 68),  # 17 vectors: odd already
    (64, 4, 68, 64),  # 16 vectors -> 17: a column walk leaves bank 0
    (96, 4, 100, 96),
    (97, 4, 100, 100),
    (17, 4, 20, 20),
    (120, 4, 124, 120),
    (65, 8, 70, 68),  # whole 4-column tiles, then an odd count of 2-vectors
    (64, 8, 66, 64),
    (33, 8, 38, 36),
])
def test_chain_ld_pads_to_an_odd_count_of_vectors(n, itemsize, want, want_unpadded):
    vec = 16 // itemsize
    for padded, expect in ((True, want), (False, want_unpadded)):
        ld = hk.chain_ld(n, itemsize, padded)
        assert ld == expect
        assert ld % vec == 0 and ld >= -(-n // 4) * 4
    assert (hk.chain_ld(n, itemsize) // vec) % 2 == 1


@pytest.mark.parametrize("s,itemsize,want", [
    (65, 4, 70720),  # four 65 x 68 tiles: three blocks share an SM
    (33, 4, 21184),  # the scratch outgrows the M tile: 3 tiles + scratch
    (17, 4, 8128),
    (97, 4, 155200),
    (120, 4, 230400),  # unpadded: the padded stride (124) does not fit
    (65, 8, 145600),
    (84, 8, 231168),
])
def test_chain_shared_memory_of_one_block(s, itemsize, want):
    ld, need = hk.chain_geometry(s, itemsize, H100_SMEM)
    assert need == want <= H100_SMEM
    tile = s * ld
    scratch = 2 * 16 * s + 16 * 13 + 13 * ld
    assert hk.chain_smem_elems(s, ld) * itemsize == need
    assert need == (3 * tile + max(tile, scratch)) * itemsize


def test_chain_fits_to_s120_in_float32_and_s84_in_float64():
    """The largest block sizes one block takes on the H100, with no gap
    below them; 3 (s=65 float32) blocks of 70720 + 1024 bytes fit one SM."""
    for itemsize, most in ((4, 120), (8, 84)):
        fits = [s for s in range(1, 200)
                if hk.chain_geometry(s, itemsize, H100_SMEM) is not None]
        assert fits == list(range(1, most + 1))
    assert 3 * (70720 + hk.BLOCK_SMEM_RESERVE) <= H100_SM_SMEM
    assert H100_SMEM + hk.BLOCK_SMEM_RESERVE == H100_SM_SMEM


@pytest.mark.parametrize("n,s,itemsize,want", [
    (1024, 65, 4, 192),  # the main path: three blocks per SM, two passes
    (256, 65, 4, 320),  # two per SM: a thread per tile (289)
    (32, 97, 4, 640),  # an SM each: 625 tiles
    (32, 49, 4, 256),  # an SM each: at least 256
    (32, 25, 4, 256),
    (1024, 33, 4, 64),
    (1024, 17, 4, 64),
    (1024, 65, 8, 320),  # float64: one block per SM by shared memory
    (300, 97, 4, 320),  # two passes over 625 tiles
])
def test_chain_threads_follow_the_tiles_and_the_occupancy(n, s, itemsize, want):
    _, need = hk.chain_geometry(s, itemsize, H100_SMEM)
    got = hk.chain_threads(n, s, H100_SMS, need, H100_SM_SMEM)
    assert got == want
    assert got % 32 == 0 and 64 <= got <= hk.CHAIN_MAX_THREADS


@pytest.mark.parametrize("s,itemsize,want", [
    (65, 4, "chain"),
    (97, 4, "chain"),
    (97, 8, "rows"),  # float64 tiles fit to s=84
    (84, 8, "chain"),
    (193, 4, "rows"),
    (516, 4, "rows"),
    (120, 4, "chain"),
    (121, 4, "rows"),
])
def test_factorize_design_takes_the_chain_where_it_fits(s, itemsize, want):
    design, geometry = hk.factorize_design(s, itemsize, H100_SMEM)
    assert design == want
    assert geometry == (hk.chain_geometry(s, itemsize, H100_SMEM)
                        if want == "chain" else None)
    # a forced design is kept where the shape takes it
    assert hk.factorize_design(s, itemsize, H100_SMEM, "rows") == ("rows", None)
    if want == "chain":
        assert hk.factorize_design(s, itemsize, H100_SMEM, "chain") == (
            design, geometry)


@pytest.mark.parametrize("s,itemsize,design,match", [
    (193, 4, "chain", "shared memory"),
    (97, 8, "chain", "shared memory"),
    (121, 4, "chain", "shared memory"),
    (65, 4, "panels", "design="),
])
def test_factorize_design_refuses_before_any_launch(s, itemsize, design, match):
    with pytest.raises(ValueError, match=match):
        hk.factorize_design(s, itemsize, H100_SMEM, design)


# K1's row design: the Schur step's panel schedule and its launch geometry

SCHUR_CASES = [("random", 17, 4), ("random", 33, 5), ("random", 65, 4),
               ("confusion", 17, 4), ("confusion", 33, 3)]


@functools.lru_cache(maxsize=None)
def _schur_case(kind: str, s: int, nb: int):
    """(band, Pallas M, Pallas Dinv) of one input, at its own nb."""
    band = (_random_band if kind == "random" else _confusion_band)(s, nb)
    M_ref, D_ref = banded_factorize_batch(jnp.asarray(band), interpret=True)
    return band, np.asarray(M_ref), np.asarray(D_ref)


@pytest.mark.parametrize("rows", [4, 8, 12, None])
@pytest.mark.parametrize("kind,s,nb", SCHUR_CASES)
def test_schur_step_schedule_matches_pallas(kind, s, nb, rows):
    """The Schur step on the kernel's schedule (row panels of ``rows``, no
    divisor of s; None: one panel) at j = 0, 1 and the last row, on the
    Pallas kernel's Dinv_{j-1}: M_j against the Pallas M_j, and T_j against
    D_j - M_j B_{j-1} of the Pallas M_j and, inverted as the row design
    inverts it, against the Pallas Dinv_j."""
    band, M_ref, D_ref = _schur_case(kind, s, nb)
    assert rows is None or s % rows
    t = interop.tensor(band, **F64)
    scale = max(np.abs(M_ref).max(), np.abs(D_ref).max())
    for j in (0, 1, nb - 1):
        dinv_prev = interop.tensor(D_ref[:, j - 1], **F64) if j else None
        M, T = hk.schur_step_plain(t, dinv_prev, j, rows=rows)
        T_ref = band[:, j, :, s : 2 * s].copy()
        if j:
            T_ref -= M_ref[:, j] @ band[:, j - 1, :, 2 * s :]
        assert np.abs(M.numpy() - M_ref[:, j]).max() <= TOL * scale
        assert np.abs(T.numpy() - T_ref).max() <= TOL * np.abs(T_ref).max()
        Dinv = hk.batched_inverse_plain(T)
        assert np.abs(Dinv.numpy() - D_ref[:, j]).max() <= TOL * scale


@pytest.mark.parametrize("rows", [4, 8, 12])
@pytest.mark.parametrize("kind,s,nb", SCHUR_CASES)
def test_rows_schedule_in_panels_matches_pallas(kind, s, nb, rows):
    """``banded_factorize_rows_plain`` with the Schur step in row panels of
    ``rows`` against the interpret-mode Pallas kernel."""
    band, M_ref, D_ref = _schur_case(kind, s, nb)
    M, Dinv = hk.banded_factorize_rows_plain(interop.tensor(band, **F64),
                                             rows=rows)
    for got, ref in ((M.numpy(), M_ref), (Dinv.numpy(), D_ref)):
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_schur_step_plain_refuses_a_row_outside_the_band():
    band = interop.tensor(_random_band(5, 2), **F64)
    for j in (-1, 2):
        with pytest.raises(ValueError, match="row"):
            hk.schur_step_plain(band, None, j)
    with pytest.raises(ValueError, match="rows"):
        hk.schur_step_plain(band, band[:, 0, :, :5], 1, rows=0)


def test_schur_step_on_the_cpu_writes_its_row_only():
    """``schur_step_`` on CPU tensors runs the plain step in place: row j of
    M and Dinv becomes (M_j, T_j), the other rows stay as they were."""
    band = interop.tensor(_random_band(9, 3), **F64)
    rng = np.random.default_rng(0)
    M = interop.tensor(rng.standard_normal((2, 3, 9, 9)), **F64)
    Dinv = interop.tensor(rng.standard_normal((2, 3, 9, 9)), **F64)
    M0, D0 = M.clone(), Dinv.clone()
    hk.schur_step_(band, M, Dinv, 1)
    M_p, T_p = hk.schur_step_plain(band, D0[:, 0], 1)
    assert torch.allclose(M[:, 1], M_p, rtol=0, atol=1e-13)
    assert torch.allclose(Dinv[:, 1], T_p, rtol=0, atol=1e-13)
    for q in (0, 2):
        assert torch.equal(M[:, q], M0[:, q]) and torch.equal(Dinv[:, q], D0[:, q])


# every block size up to 48 (ragged panels and column groups of every
# width), the lanes' and the edges of the column groups and of the block
SCHUR_SIZES = [(s, item) for item in (4, 8)
               for s in (*range(1, 49), 49, 65, 97, 120, 128, 129, 193, 256,
                         257, 516, 1500, 2047, 2048)]


@pytest.mark.parametrize("s,item", SCHUR_SIZES)
def test_schur_geometry_is_one_the_kernel_takes(s, item):
    """At every block size up to the widest the kernel takes: a warp per
    128 columns, at most SCHUR_MAX_THREADS, the mirror's shared memory
    (the transposed 8-row panel) within the card's."""
    threads, need = hk.schur_geometry(s, item, H100_SMEM)
    assert threads == 32 * -(-s // 128) <= hk.SCHUR_MAX_THREADS
    assert need == hk.schur_smem_bytes(s, item) == s * 12 * item <= H100_SMEM


@pytest.mark.parametrize("s,item,want", [
    (193, 4, (64, 9264)),  # the nx=192 lane: two column groups
    (193, 8, (64, 18528)),
    (516, 4, (160, 24768)),  # helmholtz: five, the last of 4 columns
    (516, 8, (160, 49536)),
    (17, 4, (32, 816)),
    (65, 8, (32, 6240)),
])
def test_schur_geometry_at_the_lane_shapes(s, item, want):
    assert hk.schur_geometry(s, item, H100_SMEM) == want


@pytest.mark.parametrize("s,item,smem", [
    (2049, 4, H100_SMEM),  # 17 warps, more than a block takes
    (3000, 8, H100_SMEM),
    (0, 4, H100_SMEM),
    (193, 4, 193 * 12 * 4 - 1),  # one byte short
    (516, 8, 40000),
])
def test_schur_geometry_refuses_before_any_launch(s, item, smem):
    with pytest.raises(ValueError, match="shared memory"):
        hk.schur_geometry(s, item, smem)


def test_schur_geometry_refuses_a_block_row_too_wide():
    """s=3000: a panel needs 24 warps, more than a block has, so the row
    design raises before any launch; s=1500 still fits, with 12 warps."""
    for item in (4, 8):
        with pytest.raises(ValueError, match="shared memory"):
            hk.schur_geometry(3000, item, H100_SMEM)
    assert hk.schur_geometry(1500, 8, H100_SMEM) == (384, 144000)


@pytest.mark.parametrize("s,item,want", [
    (193, 4, 193 * 12 * 4),
    (516, 8, 516 * 12 * 8),
    (17, 8, 17 * 12 * 8),
])
def test_schur_smem_mirror(s, item, want):
    assert hk.schur_smem_bytes(s, item) == want
