"""Galerkin assembly of the PyTorch port against the JAX package.

The confusion form (analytic velocity, nx=8) is assembled by both packages
on the same numpy (u, m) samples, in float64: residual, banded Jacobian,
Dirichlet masking and symmetrization, C^T products, and the dense mass and
stiffness matrices of the prior.  Tolerance 1e-12 (float64 sums taken in
another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu.fem as jfem
from applications.confusion import confusion_form as j_confusion_form
from hippyflow_tpu.models.prior import aniso_tensor_2d
from hippyflow_tpu_torch import fem as tfem
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch.applications.confusion import (
    confusion_form as t_confusion_form,
)

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-12
NX = 8
N_SAMPLES = 3


@functools.lru_cache(maxsize=None)
def _setup():
    jV = jfem.FunctionSpace(jfem.unit_square_mesh(NX))
    tV = tfem.FunctionSpace(tfem.unit_square_mesh(NX))
    jb = jfem.BoundGalerkinForm(jV, jV, j_confusion_form(jV, velocity="analytic"))
    tb = tfem.BoundGalerkinForm(
        tV, tV, t_confusion_form(tV, velocity="analytic"), **F64
    )
    jbc = jfem.DirichletBC.from_predicate(jV, None, 0.0)
    tbc = tfem.DirichletBC.from_predicate(tV, None, 0.0)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((N_SAMPLES, tV.dim))
    m = 0.5 * rng.standard_normal((N_SAMPLES, tV.dim))
    return jV, tV, jb, tb, jbc, tbc, u, m


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=tol, atol=tol
    )


def test_copied_host_modules_agree():
    """The port's numpy copies of mesh/space/observation give the same
    tables as the JAX package's."""
    jV, tV, *_ = _setup()
    np.testing.assert_array_equal(tV.mesh.cells, jV.mesh.cells)
    np.testing.assert_array_equal(tV.dof_coords, jV.dof_coords)
    np.testing.assert_array_equal(
        tV.boundary_dofs(None), jV.boundary_dofs(None)
    )
    targets = jfem.grid_targets(0.2, 0.8, 3)
    np.testing.assert_array_equal(tfem.grid_targets(0.2, 0.8, 3), targets)
    np.testing.assert_array_equal(
        tfem.assemble_pointwise_observation(tV, targets),
        jfem.assemble_pointwise_observation(jV, targets),
    )


def test_residual():
    _, _, jb, tb, _, _, u, m = _setup()
    want = jax.vmap(lambda uu, mm: jb.residual(uu, mm))(u, m)
    got = tb.residual(interop.tensor(u, **F64), interop.tensor(m, **F64))
    assert got.shape == (N_SAMPLES, tb.n)
    _close(got, want)


def test_residual_mask():
    _, _, jb, tb, jbc, tbc, u, m = _setup()
    r = np.random.default_rng(1).standard_normal(u.shape)
    want = jax.vmap(lambda rr, uu: jfem.mask_residual(rr, uu, jbc))(r, u)
    got = tfem.mask_residual(
        interop.tensor(r, **F64), interop.tensor(u, **F64), tbc
    )
    _close(got, want, tol=0.0)


def test_band():
    jV, _, jb, tb, _, _, u, m = _setup()
    s = NX + 1
    want = jax.vmap(lambda uu, mm: jb.assemble_A_banded(uu, mm, None, s))(u, m)
    got = tb.assemble_A_banded(
        interop.tensor(u, **F64), interop.tensor(m, **F64)
    )
    assert got.shape == (N_SAMPLES, NX + 1, s, 3 * s)
    _close(got, want)


def test_band_is_the_dense_jacobian():
    """The band holds exactly dr/du of the JAX package's dense assembly."""
    jV, _, jb, tb, _, _, u, m = _setup()
    s = NX + 1
    A = np.asarray(jb.assemble_A(u[0], m[0]))
    band = tb.assemble_A_banded(
        interop.tensor(u[:1], **F64), interop.tensor(m[:1], **F64)
    )[0].numpy()
    nb = band.shape[0]
    for j in range(nb):
        for o in range(3):
            jj = j + o - 1
            blk = band[j, :, o * s : (o + 1) * s]
            if 0 <= jj < nb:
                _close(blk, A[j * s : (j + 1) * s, jj * s : (jj + 1) * s])
            else:
                assert not blk.any()


def test_band_bc_symmetrize():
    _, _, jb, tb, jbc, tbc, u, m = _setup()
    s = NX + 1
    band = np.asarray(
        jax.vmap(lambda uu, mm: jb.assemble_A_banded(uu, mm, None, s))(u, m)
    )
    want = jax.vmap(lambda b: jfem.bc_symmetrize_banded_from_mask(b, jbc))(band)
    got = tfem.bc_symmetrize_banded_from_mask(interop.tensor(band, **F64), tbc)
    _close(got, want, tol=0.0)


@pytest.mark.parametrize("k", [None, 4])
def test_apply_Ct(k):
    """C^T dp from the gathered element blocks equals the JAX package's vjp
    of the residual in m, for one and for several columns."""
    _, _, jb, tb, _, _, u, m = _setup()
    shape = u.shape if k is None else u.shape + (k,)
    dp = np.random.default_rng(2).standard_normal(shape)
    pull = lambda uu, mm, d: jb.apply_Ct(uu, mm, d)
    if k is None:
        want = jax.vmap(pull)(u, m, dp)
    else:
        want = jax.vmap(
            lambda uu, mm, d: jax.vmap(
                lambda col: pull(uu, mm, col), in_axes=1, out_axes=1
            )(d)
        )(u, m, dp)
    got = tb.apply_Ct(
        interop.tensor(u, **F64), interop.tensor(m, **F64),
        interop.tensor(dp, **F64),
    )
    _close(got, want)


def test_mass_matrix():
    jV, tV, *_ = _setup()
    _close(tfem.mass_matrix(tV, **F64), jfem.mass_matrix(jV, dtype=jnp.float64))


@pytest.mark.parametrize("aniso", [False, True])
def test_stiffness_matrix(aniso):
    jV, tV, *_ = _setup()
    tensor = aniso_tensor_2d(2.0, 0.5, np.pi / 4) if aniso else None
    _close(
        tfem.stiffness_matrix(tV, tensor, **F64),
        jfem.stiffness_matrix(jV, tensor, dtype=jnp.float64),
    )
