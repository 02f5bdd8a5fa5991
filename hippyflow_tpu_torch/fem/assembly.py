"""Galerkin assembly on structured P1 meshes, batched over samples.

Port of ``hippyflow_tpu/fem/assembly.py``.  A weak form is given by
pointwise flux/source callables,

    r(u; v) = sum_e int_e F(x, u, grad u, m, z, c) . grad v
                        + S(x, u, grad u, m, z, c) v dx,

which here act on whole tensors: every argument carries leading axes
(samples, cells, quadrature points) and the callables broadcast over them.
Element residuals are computed for all samples and cells at once; the
element Jacobians dr_e/du_e and dr_e/dm_e are forward-mode derivatives of
the element residual (``torch.func.jvp``, one tangent per local dof), so
they agree with the residual by construction, as ``jax.jacfwd`` does in the
JAX package.

Global assembly uses the structured plan of the JAX package: on a
``rectangle_mesh`` every element-matrix entry lands on one of seven fixed
matrix diagonals, so residual, band and C^T assembly are shifted slice-adds
of (ny, nx) element grids, with no scatter.  The band's diagonals are
written into the (nb, s, 3s) block-tridiagonal storage directly.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from .. import config
from .mesh import boundary_edges
from .space import FunctionSpace


@dataclass(frozen=True)
class GalerkinForm:
    """Weak form ``int F . grad(v) + S v dx``.

    flux(x, u, grad_u, m, z, c)   -> (..., 2)   [optional]
    source(x, u, grad_u, m, z, c) -> (...)      [optional]

    evaluated on tensors broadcast over leading (sample, cell, quadrature
    point) axes: ``x`` (..., 2) positions, ``u`` state values, ``grad_u``
    (..., 2) state gradients, ``m`` parameter values, ``z`` the control
    (always None here) and ``c`` a dict of coefficient values at the points
    (``c[name]`` (...) or (..., k); ``c['grad_' + name]`` (..., 2) or
    (..., k, 2)).

    coefficients: name -> (n,) or (n, k) dof values on the P1 space.
    cell_coefficients: name -> (nc,) per-cell constants.
    """

    flux: Callable | None = None
    source: Callable | None = None
    quad_degree: int = 2
    coefficients: Mapping[str, np.ndarray] = field(default_factory=dict)
    cell_coefficients: Mapping[str, np.ndarray] = field(default_factory=dict)


def structured_plan(V: FunctionSpace):
    """Scatter-free assembly plan of a structured P1 space, or None.

    On ``rectangle_mesh`` the cells are (ny, nx, 2, 3) with constant grid
    offsets per (triangle type t, local vertex a), so entry (t, a, b) of
    every element matrix lies on the matrix diagonal d = g(b) - g(a).
    Returns (nx, ny, s, {d: [(t, a, b, dy, dx), ...]}, offs (2, 3, 2)) with
    (dy, dx) the grid offset of local vertex a."""
    shape = V.mesh.structured_shape
    cells = np.asarray(V.cell_dofs)
    if shape is None or V.degree != 1 or cells.shape[1] != 3:
        return None
    nx, ny = shape
    s = nx + 1
    if cells.shape[0] != 2 * nx * ny:
        return None
    C = cells.reshape(ny, nx, 2, 3)
    base = np.arange(ny)[:, None] * s + np.arange(nx)[None, :]
    offs = np.zeros((2, 3, 2), dtype=int)
    for t in range(2):
        for a in range(3):
            rel = C[:, :, t, a] - base
            if not (rel == rel[0, 0]).all():
                return None
            offs[t, a] = divmod(int(rel[0, 0]), s)
    plan = defaultdict(list)
    for t in range(2):
        for a in range(3):
            for b in range(3):
                d = (offs[t, b, 0] - offs[t, a, 0]) * s + (
                    offs[t, b, 1] - offs[t, a, 1]
                )
                plan[int(d)].append(
                    (t, a, b, int(offs[t, a, 0]), int(offs[t, a, 1]))
                )
    return nx, ny, s, dict(plan), offs


class BoundGalerkinForm:
    """A GalerkinForm bound to (state space, parameter space) on one device.

    Entry points, all batched over a leading sample axis:
      residual(u, m)           (N, n)  -> (N, n)
      assemble_A_banded(u, m)  -> dr/du in (N, nb, s, 3s) band storage
      apply_Ct(u, m, dp)       -> (dr/dm)^T dp, dp (N, n) or (N, n, k)
    """

    def __init__(self, Vu: FunctionSpace, Vm: FunctionSpace,
                 form: GalerkinForm, dtype=None, device=None):
        if Vu.mesh is not Vm.mesh:
            raise ValueError("state/parameter spaces must share a mesh")
        if Vu.degree != 1 or Vm.degree != 1:
            raise NotImplementedError("only P1 state and parameter spaces")
        plan = structured_plan(Vu)
        if plan is None:
            raise NotImplementedError("only structured rectangle meshes")
        self.dtype, self.device = config.resolve(dtype, device)
        self.Vu, self.Vm, self.form = Vu, Vm, form
        self.plan = plan
        self.n = Vu.dim
        self.n_m = Vm.dim
        mesh = Vu.mesh
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        self.cells = torch.as_tensor(
            np.asarray(Vu.cell_dofs), dtype=torch.long, device=self.device
        )
        phi, gphi, xq, wdet = Vu.quad_data(form.quad_degree)
        nq = phi.shape[0]
        self._phi = t(phi)  # (nq, 3)
        self._grads = t(gphi[:, 0])  # (nc, 3, 2): constant P1 gradients
        self._xq = t(xq)  # (nc, nq, 2)
        self._wdet = t(wdet)  # (nc, nq)
        lam, _, _ = Vu.quad_points(form.quad_degree)
        geo = Vu.geometry
        coef = {}
        for name, dofs in form.coefficients.items():
            de = np.asarray(dofs)[mesh.cells]  # (nc, 3) or (nc, 3, k)
            coef[name] = t(np.einsum("qi,ci...->cq...", lam, de))
            g = np.einsum("cid,ci...->c...d", geo.grads, de)
            coef["grad_" + name] = t(np.repeat(g[:, None], nq, axis=1))
        for name, vals in form.cell_coefficients.items():
            coef[name] = t(np.repeat(np.asarray(vals)[:, None], nq, axis=1))
        self._coef = coef  # each (nc, nq, ...)

    # -- element kernel ----------------------------------------------------
    def _r_elem(self, u_e, m_e):
        """Element residuals (N, nc, 3) from element dof values (N, nc, 3)."""
        uq = u_e @ self._phi.T  # (N, nc, nq)
        mq = m_e @ self._phi.T
        gu = torch.einsum("nci,cid->ncd", u_e, self._grads)[:, :, None, :]
        out = 0.0
        if self.form.flux is not None:
            F = self.form.flux(self._xq, uq, gu, mq, None, self._coef)
            F = F * self._wdet[..., None]
            out = out + torch.einsum("cid,ncqd->nci", self._grads, F)
        if self.form.source is not None:
            S = self.form.source(self._xq, uq, gu, mq, None, self._coef)
            out = out + (S * self._wdet) @ self._phi
        return out

    def _elements(self, x):
        return x[:, self.cells]  # (N, nc, 3)

    def _elem_jacobian(self, u, m, wrt: str):
        """(N, nc, 3, 3) element blocks d r_e[a] / d x_e[b], x = u or m."""
        u_e, m_e = self._elements(u), self._elements(m)
        if wrt == "u":
            f, x = (lambda xx: self._r_elem(xx, m_e)), u_e
        else:
            f, x = (lambda xx: self._r_elem(u_e, xx)), m_e
        cols = []
        for b in range(3):
            tangent = torch.zeros_like(x)
            tangent[..., b] = 1.0
            cols.append(torch.func.jvp(f, (x,), (tangent,))[1])
        return torch.stack(cols, dim=-1)

    # -- structured scatter-free assembly ------------------------------------
    def residual(self, u, m):
        """Global residual r(u, m): (N, n)."""
        nx, ny, s, _, offs = self.plan
        E = self._r_elem(self._elements(u), self._elements(m))
        E = E.reshape(-1, ny, nx, 2, 3)
        r = torch.zeros((E.shape[0], ny + 1, s), dtype=E.dtype, device=E.device)
        for t in range(2):
            for a in range(3):
                dy, dx = int(offs[t, a, 0]), int(offs[t, a, 1])
                r[:, dy : dy + ny, dx : dx + nx] += E[..., t, a]
        return r.reshape(-1, self.n)

    def assemble_A_banded(self, u, m):
        """dr/du in block-tridiagonal band storage (N, nb, s, 3s):
        band[:, j, i, o*s + i2] = A[j*s + i, (j + o - 1)*s + i2]."""
        nx, ny, s, dplan, _ = self.plan
        nb = ny + 1
        E = self._elem_jacobian(u, m, "u").reshape(-1, ny, nx, 2, 3, 3)
        N = E.shape[0]
        band = torch.zeros((N, nb, s, 3 * s), dtype=E.dtype, device=E.device)
        ii = np.arange(s)
        for d in sorted(dplan):
            acc = torch.zeros((N, nb, s), dtype=E.dtype, device=E.device)
            for t, a, b, dy, dx in dplan[d]:
                acc[:, dy : dy + ny, dx : dx + nx] += E[..., t, a, b]
            # entry (j, i) of diagonal d sits at band column s + i + d; the
            # entries that fall outside [0, 3s) are structurally zero
            col = s + ii + d
            ok = (col >= 0) & (col < 3 * s)
            rows = torch.as_tensor(ii[ok], device=band.device)
            band[:, :, rows, torch.as_tensor(col[ok], device=band.device)] = (
                acc[:, :, rows]
            )
        return band

    def apply_Ct(self, u, m, dp):
        """(dr/dm)^T dp for dp (N, n) or (N, n, k), from the element blocks
        dr_e/dm_e assembled once: gather, contract, slice-add."""
        nx, ny, s, _, offs = self.plan
        squeeze = dp.ndim == 2
        if squeeze:
            dp = dp[..., None]
        C = self._elem_jacobian(u, m, "m").reshape(-1, ny, nx, 2, 3, 3)
        P = dp.reshape(dp.shape[0], ny + 1, s, dp.shape[-1])
        out = torch.zeros_like(P)
        for t in range(2):
            for b in range(3):
                acc = 0.0
                for a in range(3):
                    dy, dx = int(offs[t, a, 0]), int(offs[t, a, 1])
                    acc = acc + C[..., t, a, b, None] * P[
                        :, dy : dy + ny, dx : dx + nx
                    ]
                dy, dx = int(offs[t, b, 0]), int(offs[t, b, 1])
                out[:, dy : dy + ny, dx : dx + nx] += acc
        out = out.reshape(dp.shape[0], self.n_m, dp.shape[-1])
        return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Canonical matrices (dense, for the dense BiLaplacian prior)
# ---------------------------------------------------------------------------


def _scatter_dense(V: FunctionSpace, vals_e: np.ndarray, dtype, device):
    cells = np.asarray(V.mesh.cells)
    rows = np.broadcast_to(cells[:, :, None], vals_e.shape).reshape(-1)
    cols = np.broadcast_to(cells[:, None, :], vals_e.shape).reshape(-1)
    A = np.zeros((V.dim, V.dim))
    np.add.at(A, (rows, cols), vals_e.reshape(-1))
    return torch.as_tensor(A, dtype=dtype, device=device)


def mass_matrix(V: FunctionSpace, dtype=None, device=None) -> torch.Tensor:
    """Dense consistent P1 mass matrix (n, n)."""
    dtype, device = config.resolve(dtype, device)
    if V.degree != 1:
        raise NotImplementedError("P1 only")
    local = (np.full((3, 3), 1.0) + np.eye(3)) / 12.0
    M_e = V.geometry.volumes[:, None, None] * local[None]
    return _scatter_dense(V, M_e, dtype, device)


def stiffness_matrix(V: FunctionSpace, tensor=None, dtype=None,
                     device=None) -> torch.Tensor:
    """Dense P1 stiffness matrix int (Theta grad u) . grad v dx with an
    optional constant (2, 2) tensor Theta."""
    dtype, device = config.resolve(dtype, device)
    if V.degree != 1:
        raise NotImplementedError("P1 only")
    tensor = np.eye(2) if tensor is None else np.asarray(tensor)
    g = V.geometry.grads
    K_e = np.einsum("cid,de,cje,c->cij", g, tensor, g, V.geometry.volumes)
    return _scatter_dense(V, K_e, dtype, device)


# ---------------------------------------------------------------------------
# Canonical matrices in (nb, s, 3s) band storage (the structured prior)
# ---------------------------------------------------------------------------


def _numpy_dtype(dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def banded_from_elements(V: FunctionSpace, vals_e, connectivity=None) -> np.ndarray:
    """Scatter (ncell, a, a) element matrices into (nb, s, 3s) band storage
    on a structured P1 mesh (numpy host work, as in the JAX package).
    ``connectivity`` defaults to the triangle cells; pass boundary edges
    (ne, 2) with 2x2 element matrices for boundary mass terms."""
    if V.degree != 1 or V.mesh.structured_shape is None:
        raise NotImplementedError("band storage needs a structured P1 space")
    s = V.mesh.structured_shape[0] + 1
    conn = np.asarray(V.mesh.cells if connectivity is None else connectivity)
    a = conn.shape[1]
    vals_e = np.asarray(vals_e)
    g1 = np.repeat(conn, a, axis=1).reshape(-1).astype(np.int64)
    g2 = np.tile(conn, (1, a)).reshape(-1).astype(np.int64)
    o = g2 // s - g1 // s + 1
    if not ((o >= 0) & (o <= 2)).all():
        raise ValueError("connectivity exceeds the band")
    idx = g1 * (3 * s) + o * s + (g2 % s)
    flat = np.zeros(V.dim * 3 * s, dtype=vals_e.dtype)
    np.add.at(flat, idx, vals_e.reshape(-1))
    return flat.reshape(V.dim // s, s, 3 * s)


def mass_matrix_banded(V: FunctionSpace, dtype=None, device=None) -> torch.Tensor:
    """(nb, s, 3s) band of the consistent P1 mass matrix."""
    dtype, device = config.resolve(dtype, device)
    local = (np.full((3, 3), 1.0) + np.eye(3)) / 12.0
    M_e = V.geometry.volumes[:, None, None] * local[None]
    band = banded_from_elements(V, M_e.astype(_numpy_dtype(dtype)))
    return torch.as_tensor(band, device=device)


def stiffness_matrix_banded(V: FunctionSpace, tensor=None, dtype=None,
                            device=None) -> torch.Tensor:
    """(nb, s, 3s) band of the P1 stiffness matrix (optional tensor)."""
    dtype, device = config.resolve(dtype, device)
    tensor = np.eye(2) if tensor is None else np.asarray(tensor)
    g = V.geometry.grads
    K_e = np.einsum("cid,de,cje,c->cij", g, tensor, g, V.geometry.volumes)
    band = banded_from_elements(V, K_e.astype(_numpy_dtype(dtype)))
    return torch.as_tensor(band, device=device)


def boundary_mass_matrix_banded(V: FunctionSpace, dtype=None,
                                device=None) -> torch.Tensor:
    """(nb, s, 3s) band of the boundary mass matrix int_dOmega u v ds."""
    dtype, device = config.resolve(dtype, device)
    edges = boundary_edges(V.mesh)
    x = V.mesh.vertices[edges]
    lens = np.sqrt(((x[:, 1] - x[:, 0]) ** 2).sum(-1))
    local = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    Me = (lens[:, None, None] * local[None]).astype(_numpy_dtype(dtype))
    band = banded_from_elements(V, Me, connectivity=edges)
    return torch.as_tensor(band, device=device)


# ---------------------------------------------------------------------------
# Dirichlet boundary conditions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DirichletBC:
    """Dirichlet condition u = g on masked dofs (numpy, host data).

    mask: (n,) bool array of constrained dofs; value: (n,) values of g."""

    mask: np.ndarray
    value: np.ndarray

    @staticmethod
    def from_predicate(V: FunctionSpace, predicate, value=0.0) -> "DirichletBC":
        mask = V.boundary_dofs(predicate)
        if callable(value):
            g = np.asarray(value(V.dof_coords), dtype=np.float64)
        else:
            g = np.full(V.dim, float(value))
        return DirichletBC(mask=mask, value=np.where(mask, g, 0.0))


def mask_residual(r, u, bc: DirichletBC):
    """Replace constrained rows of the residual (N, n) with (u - g)."""
    mask = torch.as_tensor(bc.mask, device=r.device)
    g = torch.as_tensor(bc.value, dtype=r.dtype, device=r.device)
    return torch.where(mask, u - g, r)


def bc_symmetrize_banded_from_mask(band, bc: DirichletBC):
    """Symmetric elimination on (..., nb, s, 3s) band storage: zero the
    constrained rows and columns and put ones on their diagonal."""
    return bc_symmetrize_banded_masked(
        band, torch.as_tensor(bc.mask, device=band.device)
    )


def bc_symmetrize_banded_masked(band, mask):
    """bc_symmetrize on band storage from an (nb*s,) constrained-dof mask."""
    nb, s = band.shape[-3], band.shape[-2]
    mask01 = mask.to(band.dtype).reshape(nb, s)
    keep = 1.0 - mask01
    zero = torch.zeros((1, s), dtype=band.dtype, device=band.device)
    keep_up = torch.cat([zero, keep[:-1]], dim=0)  # row j-1
    keep_dn = torch.cat([keep[1:], zero], dim=0)  # row j+1
    keep_col = torch.cat([keep_up, keep, keep_dn], dim=1)[:, None, :]
    band = band * keep[:, :, None] * keep_col
    ii = torch.arange(s, device=band.device)
    band[..., ii, s + ii] += mask01
    return band
