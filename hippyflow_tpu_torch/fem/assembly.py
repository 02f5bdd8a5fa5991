"""Galerkin assembly of scalar P1 and P2 forms, batched over samples.

Port of ``hippyflow_tpu/fem/assembly.py``.  A weak form is given by
pointwise flux/source callables,

    r(u; v) = sum_e int_e F(x, u, grad u, m, z, c) . grad v
                        + S(x, u, grad u, m, z, c) v dx,

which here act on whole tensors: every argument carries leading axes
(samples, cells, quadrature points) and the callables broadcast over them;
the control z is given as it is, (N, dz), for the callable to contract
against its own fields at the points.  Element residuals are computed for
all samples and cells at once; the element Jacobians dr_e/du_e, dr_e/dm_e
and dr_e/dz are forward-mode derivatives of the element residual
(``torch.func.jvp``, one tangent per local dof or control), so they agree
with the residual by construction, as ``jax.jacfwd`` does in the JAX
package.

Global assembly on a ``rectangle_mesh`` uses the structured plan of the
JAX package: every element-matrix entry lands on one of seven fixed
matrix diagonals, so residual, band and C^T assembly are shifted
slice-adds of (ny, nx) element grids, with no scatter, and the band's
diagonals are written into the (nb, s, 3s) block-tridiagonal storage
directly.  On any other mesh, and for a P2 state (its own dofmap, basis
gradients per quadrature point, and a P1 parameter evaluated with the
P1 basis), the element contributions are summed by ``index_add_`` (the
JAX package's segment sums), dense matrices are scattered the same way,
and the band is gathered into the permuted storage of a ``BandOrder``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from .. import config
from .band_order import ordered_band_indices
from .mesh import boundary_edges
from .space import FunctionSpace


@dataclass(frozen=True)
class GalerkinForm:
    """Weak form ``int F . grad(v) + S v dx``.

    flux(x, u, grad_u, m, z, c)   -> (..., 2)   [optional]
    source(x, u, grad_u, m, z, c) -> (...)      [optional]

    evaluated on tensors broadcast over leading (sample, cell, quadrature
    point) axes: ``x`` (cells, points, 2) positions, ``u`` state values,
    ``grad_u`` (..., 2) state gradients (a P1 state's have a point axis of
    length 1: they are constant on a cell), ``m`` parameter values, ``z`` the
    control (N, dz) of each sample or None, and ``c`` a dict of
    coefficient values at the points (``c[name]`` (...) or (..., k);
    ``c['grad_' + name]`` (..., 2) or (..., k, 2)).

    symmetric: dr/du is symmetric positive definite, so the ``dense``
    solver factorizes it by Cholesky (else pivoted LU).
    coefficients: name -> (n,) or (n, k) vertex values (P1 on the mesh).
    cell_coefficients: name -> (nc,) per-cell constants.

    The fields are in the JAX package's order, so a positional
    ``GalerkinForm(flux, source, 4, True)`` means the same on both.
    """

    flux: Callable | None = None
    source: Callable | None = None
    quad_degree: int = 2
    symmetric: bool = False
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


class _OrderedBand:
    """dr/du gathered into the permuted (nb, s, 3s) band storage of a
    ``BandOrder`` (``fem/band_order.py``): each nonzero band slot sums its
    element contributions, with no scatter.  The form supplies
    ``_band_dofs`` (nc, L), the stacked dof id of each local row of its
    element Jacobians dr_e/du_e (N, nc, L, L), and ``_elem_jacobian``."""

    _ordered_gather = None

    def prepare_banded_ordered(self, border) -> None:
        """Build the gather tables of the permuted band (host numpy work,
        once)."""
        if self._ordered_gather is None:
            idx = ordered_band_indices(self._band_dofs, border)
            self._ordered_gather = _build_gather_tables(
                idx, border.nb * border.s * 3 * border.s, self.device)

    def assemble_A_banded_ordered(self, u, m, z=None, border=None):
        """dr/du in the band order of ``border``: (N, nb, s, 3s).  The
        JAX package's order (u, m, z, border); ``border`` is required."""
        if border is None:
            raise TypeError("assemble_A_banded_ordered() needs the BandOrder "
                            "'border'")
        self.prepare_banded_ordered(border)
        A_e = self._elem_jacobian(u, m, z, "u")
        N = u.shape[0]
        flat = _gather_assemble(A_e.reshape(N, -1), self._ordered_gather,
                                border.nb * border.s * 3 * border.s)
        return flat.reshape(N, border.nb, border.s, 3 * border.s)


class BoundGalerkinForm(_OrderedBand):
    """A GalerkinForm bound to (state space, parameter space) on one device.

    Entry points, all batched over a leading sample axis (u (N, n), m
    (N, n_m), z (N, dz) or None):
      residual(u, m, z)             -> (N, n)
      assemble_A_banded(u, m, z[, s]) -> dr/du in (N, nb, s, 3s) band storage
      assemble_A_banded_ordered(u, m, z, border) -> dr/du in the permuted
          band storage of a BandOrder (P2 states)
      assemble_A / assemble_C       -> dense dr/du (N, n, n), dr/dm (N, n, n_m)
      assemble_Cz(u, m, z)          -> dense dr/dz (N, n, dz)
      assemble_A_diag(u, m, z)      -> the diagonal of dr/du (N, n)
      apply_C, apply_Ct, apply_Cz, apply_Czt: (dr/dm) dm, (dr/dm)^T dp,
          (dr/dz) dz, (dr/dz)^T dp, each on (N, ., k) blocks or vectors.

    The state space is P1 or P2 and the parameter space P1 (or equal to
    the state space), each with its own dofmap (``cells``, ``cells_m``).
    A P1 state on a ``rectangle_mesh`` takes the structured scatter-free
    plan for residual, band, C and C^T; elsewhere (``structured_plan`` is
    None: any other mesh, or a P2 state) the element contributions are
    summed by ``index_add_``, the JAX package's segment sums, and the band
    is the ordered one."""

    def __init__(self, Vu: FunctionSpace, Vm: FunctionSpace,
                 form: GalerkinForm, dtype=None, device=None):
        if Vu.mesh is not Vm.mesh:
            raise ValueError("state/parameter spaces must share a mesh")
        self.dtype, self.device = config.resolve(dtype, device)
        self.Vu, self.Vm, self.form = Vu, Vm, form
        self.plan = structured_plan(Vu) if Vm.degree == Vu.degree else None
        self._band_idx_cache = {}  # block size -> band indices
        self.n = Vu.dim
        self.n_m = Vm.dim
        mesh = Vu.mesh
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        # state and parameter dofmaps may differ (a P2 state, a P1 parameter)
        self._band_dofs = np.asarray(Vu.cell_dofs, dtype=np.int64)
        self.cells = torch.as_tensor(self._band_dofs, device=self.device)
        self.cells_m = torch.as_tensor(
            np.asarray(Vm.cell_dofs, dtype=np.int64), device=self.device)
        self._cells_flat = self.cells.reshape(-1)
        self._cells_m_flat = self.cells_m.reshape(-1)
        phi, gphi, xq, wdet = Vu.quad_data(form.quad_degree)
        nq = phi.shape[0]
        self._phi = t(phi)  # (nq, ndu)
        self._phi_m = t(Vm.quad_data(form.quad_degree)[0])  # (nq, ndm)
        # P1: the gradients are constant on a cell, (nc, 3, 2), and gu is
        # (N, nc, 1, 2); P2: per point, (nc, nq, 6, 2), gu (N, nc, nq, 2)
        self._const_grad = gphi.shape[1] == 1
        self._grads = t(gphi[:, 0] if self._const_grad else gphi)
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
    def _r_elem(self, u_e, m_e, z=None):
        """Element residuals (N, nc, ndu) from element dof values u_e
        (N, nc, ndu), m_e (N, nc, ndm) and the control z (N, dz) or None,
        given to the form as it is."""
        uq = u_e @ self._phi.T  # (N, nc, nq)
        mq = m_e @ self._phi_m.T
        if self._const_grad:
            gu = torch.einsum("nci,cid->ncd", u_e, self._grads)[:, :, None, :]
        else:
            gu = torch.einsum("nci,cqid->ncqd", u_e, self._grads)
        out = 0.0
        if self.form.flux is not None:
            F = self.form.flux(self._xq, uq, gu, mq, z, self._coef)
            F = F * self._wdet[..., None]
            if self._const_grad:
                out = out + torch.einsum("cid,ncqd->nci", self._grads, F)
            else:
                out = out + torch.einsum("cqid,ncqd->nci", self._grads, F)
        if self.form.source is not None:
            S = self.form.source(self._xq, uq, gu, mq, z, self._coef)
            out = out + (S * self._wdet) @ self._phi
        return out

    def _elem_jacobian(self, u, m, z, wrt: str):
        """Element blocks d r_e[a] / d x[b] with x = u_e (N, nc, ndu, ndu),
        m_e (N, nc, ndu, ndm) or z (N, nc, ndu, dz): forward-mode
        derivatives, one tangent each."""
        u_e, m_e = u[:, self.cells], m[:, self.cells_m]
        f, x = {
            "u": (lambda xx: self._r_elem(xx, m_e, z), u_e),
            "m": (lambda xx: self._r_elem(u_e, xx, z), m_e),
            "z": (lambda xx: self._r_elem(u_e, m_e, xx), z),
        }[wrt]
        cols = []
        for b in range(x.shape[-1]):
            tangent = torch.zeros_like(x)
            tangent[..., b] = 1.0
            cols.append(torch.func.jvp(f, (x,), (tangent,))[1])
        return torch.stack(cols, dim=-1)

    def _scatter(self, vals_e, n, flat=None):
        """Sum element values (N, nc, nd, ...) into (N, n, ...) by dof of
        the dofmap ``flat`` (the state's by default)."""
        N = vals_e.shape[0]
        out = vals_e.new_zeros((N, n) + vals_e.shape[3:])
        return out.index_add_(1, self._cells_flat if flat is None else flat,
                              vals_e.reshape((N, -1) + vals_e.shape[3:]))

    def _dense(self, vals_e, n_cols, col_cells):
        """Dense (N, n, n_cols) from element matrices (N, nc, ndu, nd) on
        the state cells (rows) and ``col_cells`` (columns), one
        index_add_."""
        N = vals_e.shape[0]
        flat = self.cells[:, :, None] * n_cols + col_cells[:, None, :]
        out = vals_e.new_zeros((N, self.n * n_cols))
        out.index_add_(1, flat.reshape(-1), vals_e.reshape(N, -1))
        return out.reshape(N, self.n, n_cols)

    # -- residual and matrices ----------------------------------------------
    def residual(self, u, m, z=None):
        """Global residual r(u, m, z): (N, n)."""
        E = self._r_elem(u[:, self.cells], m[:, self.cells_m], z)
        if self.plan is None:
            return self._scatter(E, self.n)
        nx, ny, s, _, offs = self.plan
        E = E.reshape(-1, ny, nx, 2, 3)
        r = torch.zeros((E.shape[0], ny + 1, s), dtype=E.dtype, device=E.device)
        for t in range(2):
            for a in range(3):
                dy, dx = int(offs[t, a, 0]), int(offs[t, a, 1])
                r[:, dy : dy + ny, dx : dx + nx] += E[..., t, a]
        return r.reshape(-1, self.n)

    def assemble_A(self, u, m, z=None):
        """Dense dr/du (N, n, n)."""
        return self._dense(self._elem_jacobian(u, m, z, "u"), self.n,
                           self.cells)

    def assemble_C(self, u, m, z=None):
        """Dense dr/dm (N, n, n_m)."""
        return self._dense(self._elem_jacobian(u, m, z, "m"), self.n_m,
                           self.cells_m)

    def assemble_Cz(self, u, m, z):
        """Dense dr/dz (N, n, dz)."""
        return self._scatter(self._elem_jacobian(u, m, z, "z"), self.n)

    def assemble_A_diag(self, u, m, z=None):
        """The diagonal of dr/du (N, n), one element pass: the Jacobi
        preconditioner of the iterative solver."""
        A_e = self._elem_jacobian(u, m, z, "u")
        return self._scatter(torch.diagonal(A_e, dim1=-2, dim2=-1), self.n)

    def prepare_banded(self, s: int) -> None:
        """Build the band indices of block size ``s`` (host numpy work,
        once), unless the structured plan covers s."""
        if self.plan is None or self.plan[2] != s:
            self._band_indices(s)

    def _band_indices(self, s: int):
        """(nc * L * L,) flat index into (nb, s, 3s) band storage of each
        element-matrix entry (row-major), for a numbering in which every
        coupling spans at most one block row at block size s."""
        cache = self._band_idx_cache
        if s not in cache:
            cells, L = self._band_dofs, self._band_dofs.shape[1]
            g1 = np.repeat(cells, L, axis=1).reshape(-1)
            g2 = np.tile(cells, (1, L)).reshape(-1)
            o = g2 // s - g1 // s + 1
            if not ((o >= 0) & (o <= 2)).all() or self.n % s:
                raise ValueError(
                    f"the numbering is not block-tridiagonal at s={s}")
            cache[s] = torch.as_tensor(g1 * (3 * s) + o * s + g2 % s,
                                       device=self.device)
        return cache[s]

    def assemble_A_banded(self, u, m, z=None, s: int | None = None):
        """dr/du in block-tridiagonal band storage (N, nb, s, 3s):
        band[:, j, i, o*s + i2] = A[j*s + i, (j + o - 1)*s + i2].  The
        structured plan's block size by default; another ``s`` (or a mesh
        without the plan) sums the element matrices into the band by
        index (``prepare_banded``), as the JAX package's segment sums do."""
        if self.plan is None or (s is not None and s != self.plan[2]):
            if s is None:
                raise ValueError(
                    "band storage needs a structured rectangle mesh or a "
                    "block size s")
            A_e = self._elem_jacobian(u, m, z, "u")
            N = A_e.shape[0]
            flat = A_e.new_zeros((N, self.n * 3 * s))
            flat.index_add_(1, self._band_indices(s), A_e.reshape(N, -1))
            return flat.reshape(N, self.n // s, s, 3 * s)
        nx, ny, s, dplan, _ = self.plan
        nb = ny + 1
        E = self._elem_jacobian(u, m, z, "u").reshape(-1, ny, nx, 2, 3, 3)
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

    # -- products with C = dr/dm and Cz = dr/dz --------------------------------
    def apply_C(self, u, m, dm, z=None):
        """(dr/dm) dm for dm (N, n_m, k) or (N, n_m): the element blocks
        dr_e/dm_e contracted with the element values of dm, summed."""
        squeeze = dm.ndim == 2
        if squeeze:
            dm = dm[..., None]
        C = self._elem_jacobian(u, m, z, "m")
        if self.plan is None:
            out = self._scatter(torch.einsum("ncab,ncbk->ncak", C,
                                             dm[:, self.cells_m]), self.n)
            return out[..., 0] if squeeze else out
        nx, ny, s, _, offs = self.plan
        C = C.reshape(-1, ny, nx, 2, 3, 3)
        P = dm.reshape(dm.shape[0], ny + 1, s, dm.shape[-1])
        out = torch.zeros_like(P)
        for t in range(2):
            for a in range(3):
                acc = 0.0
                for b in range(3):
                    dy, dx = int(offs[t, b, 0]), int(offs[t, b, 1])
                    acc = acc + C[..., t, a, b, None] * P[
                        :, dy : dy + ny, dx : dx + nx
                    ]
                dy, dx = int(offs[t, a, 0]), int(offs[t, a, 1])
                out[:, dy : dy + ny, dx : dx + nx] += acc
        out = out.reshape(dm.shape[0], self.n, dm.shape[-1])
        return out[..., 0] if squeeze else out

    def apply_Ct(self, u, m, dp, z=None):
        """(dr/dm)^T dp for dp (N, n) or (N, n, k), from the element blocks
        dr_e/dm_e assembled once: gather, contract, sum."""
        squeeze = dp.ndim == 2
        if squeeze:
            dp = dp[..., None]
        C = self._elem_jacobian(u, m, z, "m")
        if self.plan is None:
            out = self._scatter(torch.einsum("ncab,ncak->ncbk", C,
                                             dp[:, self.cells]), self.n_m,
                                self._cells_m_flat)
            return out[..., 0] if squeeze else out
        nx, ny, s, _, offs = self.plan
        C = C.reshape(-1, ny, nx, 2, 3, 3)
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

    def apply_Cz(self, u, m, z, dz):
        """(dr/dz) dz for dz (N, dz) or (N, dz, k)."""
        squeeze = dz.ndim == 2
        if squeeze:
            dz = dz[..., None]
        Cz = self._elem_jacobian(u, m, z, "z")  # (N, nc, 3, dz)
        out = self._scatter(torch.einsum("ncaz,nzk->ncak", Cz, dz), self.n)
        return out[..., 0] if squeeze else out

    def apply_Czt(self, u, m, z, dp):
        """(dr/dz)^T dp for dp (N, n) or (N, n, k): (N, dz) or (N, dz, k)."""
        squeeze = dp.ndim == 2
        if squeeze:
            dp = dp[..., None]
        Cz = self._elem_jacobian(u, m, z, "z")
        out = torch.einsum("ncaz,ncak->nzk", Cz, dp[:, self.cells])
        return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Gather tables of permuted band assembly (P2 / vector states)
# ---------------------------------------------------------------------------


def _build_gather_tables(idx_np: np.ndarray, out_size: int, device=None):
    """Static tables that turn a scatter-add assembly into a gather.

    idx_np: (ne,) flat band index of each element-matrix entry, all below
    ``out_size``.  Returns (contrib (nnz, cmax): the element-entry ids of
    each nonzero band slot, padded with ne, which reads a zero pad value;
    slots (nnz,): the band position of each nonzero slot)."""
    idx_np = np.asarray(idx_np, dtype=np.int64)
    if idx_np.size and idx_np.max() >= out_size:
        raise ValueError("band index beyond the band")
    ne = idx_np.size
    slots, inv = np.unique(idx_np, return_inverse=True)
    nnz = slots.size
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv, minlength=nnz)
    starts = np.zeros(nnz, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    cmax = int(counts.max())
    contrib = np.full((nnz, cmax), ne, dtype=np.int64)
    for c in range(cmax):
        sel = counts > c
        contrib[sel, c] = order[starts[sel] + c]
    return (torch.as_tensor(contrib, device=device),
            torch.as_tensor(slots, device=device))


def _gather_assemble(A_e_flat, tables, out_size: int):
    """Band assembly by gathers: each nonzero slot sums its (<= cmax)
    element contributions, and the sums land on their band positions
    (zeros elsewhere).  A_e_flat (N, ne) -> (N, out_size)."""
    contrib, slots = tables
    N = A_e_flat.shape[0]
    pad = torch.zeros((N, 1), dtype=A_e_flat.dtype, device=A_e_flat.device)
    vals = torch.cat([A_e_flat, pad], dim=1)[:, contrib].sum(dim=-1)
    out = torch.zeros((N, out_size), dtype=A_e_flat.dtype,
                      device=A_e_flat.device)
    out[:, slots] = vals
    return out


# ---------------------------------------------------------------------------
# Canonical matrices (dense, for the dense BiLaplacian prior)
# ---------------------------------------------------------------------------


def _scatter_dense(V: FunctionSpace, vals_e: np.ndarray, dtype, device,
                   connectivity=None):
    """Sum element matrices (nc, a, a) into a dense (n, n) matrix by the
    space's dofmap (or ``connectivity``, e.g. boundary edges)."""
    conn = np.asarray(V.cell_dofs if connectivity is None else connectivity)
    rows = np.broadcast_to(conn[:, :, None], vals_e.shape).reshape(-1)
    cols = np.broadcast_to(conn[:, None, :], vals_e.shape).reshape(-1)
    A = np.zeros((V.dim, V.dim))
    np.add.at(A, (rows, cols), vals_e.reshape(-1))
    return torch.as_tensor(A, dtype=dtype, device=device)


def _boundary_mass_elements(V: FunctionSpace):
    """(boundary edges (ne, 2), their 2 x 2 P1 mass matrices)."""
    edges = boundary_edges(V.mesh)
    x = V.mesh.vertices[edges]
    lens = np.sqrt(((x[:, 1] - x[:, 0]) ** 2).sum(-1))
    local = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    return edges, lens[:, None, None] * local[None]


def boundary_mass_matrix(V: FunctionSpace, dtype=None,
                         device=None) -> torch.Tensor:
    """Dense boundary mass matrix int_dOmega u v ds (n, n), P1."""
    dtype, device = config.resolve(dtype, device)
    if V.degree != 1:
        raise NotImplementedError("P1 only")
    edges, Me = _boundary_mass_elements(V)
    return _scatter_dense(V, Me, dtype, device, connectivity=edges)


def mass_matrix(V: FunctionSpace, dtype=None, device=None) -> torch.Tensor:
    """Dense consistent mass matrix (n, n): P1 in closed form, P2 by
    quadrature of degree 4."""
    dtype, device = config.resolve(dtype, device)
    if V.degree == 1:
        local = (np.full((3, 3), 1.0) + np.eye(3)) / 12.0
        M_e = V.geometry.volumes[:, None, None] * local[None]
    else:
        phi, _, _, wdet = V.quad_data(2 * V.degree)
        M_e = np.einsum("qi,qj,cq->cij", phi, phi, wdet)
    return _scatter_dense(V, M_e, dtype, device)


def stiffness_matrix(V: FunctionSpace, tensor=None, dtype=None,
                     device=None) -> torch.Tensor:
    """Dense stiffness matrix int (Theta grad u) . grad v dx with an
    optional constant (2, 2) tensor Theta: P1 in closed form, P2 by
    quadrature of degree 4."""
    dtype, device = config.resolve(dtype, device)
    tensor = np.eye(2) if tensor is None else np.asarray(tensor)
    if V.degree == 1:
        g = V.geometry.grads
        K_e = np.einsum("cid,de,cje,c->cij", g, tensor, g, V.geometry.volumes)
    else:
        _, gphi, _, wdet = V.quad_data(2 * V.degree)
        K_e = np.einsum("cqid,de,cqje,cq->cij", gphi, tensor, gphi, wdet)
    return _scatter_dense(V, K_e, dtype, device)


# ---------------------------------------------------------------------------
# Canonical matrices in (nb, s, 3s) band storage (the structured prior)
# ---------------------------------------------------------------------------


def _numpy_dtype(dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def p1_mass_elements(V: FunctionSpace) -> np.ndarray:
    """(ncell, 3, 3) consistent P1 mass element matrices (float64)."""
    local = (np.full((3, 3), 1.0) + np.eye(3)) / 12.0
    return V.geometry.volumes[:, None, None] * local[None]


def p1_stiffness_elements(V: FunctionSpace, tensor=None) -> np.ndarray:
    """(ncell, 3, 3) P1 stiffness element matrices of div(tensor grad)
    (float64; the identity tensor where None)."""
    tensor = np.eye(2) if tensor is None else np.asarray(tensor)
    g = V.geometry.grads
    return np.einsum("cid,de,cje,c->cij", g, tensor, g, V.geometry.volumes)


def band_indices(V: FunctionSpace, connectivity=None) -> np.ndarray:
    """(ncell, a * a) flat indices into (nb, s, 3s) band storage of each
    cell's element-matrix entries (row-major), on a structured P1 mesh.
    ``connectivity`` defaults to the triangle cells; boundary edges (ne, 2)
    give the entries of 2x2 boundary element matrices."""
    if V.degree != 1 or V.mesh.structured_shape is None:
        raise NotImplementedError("band storage needs a structured P1 space")
    s = V.mesh.structured_shape[0] + 1
    conn = np.asarray(V.mesh.cells if connectivity is None else connectivity)
    a = conn.shape[1]
    g1 = np.repeat(conn, a, axis=1).astype(np.int64)
    g2 = np.tile(conn, (1, a)).astype(np.int64)
    o = g2 // s - g1 // s + 1
    if not ((o >= 0) & (o <= 2)).all():
        raise ValueError("connectivity exceeds the band")
    return g1 * (3 * s) + o * s + (g2 % s)


def banded_from_elements(V: FunctionSpace, vals_e, connectivity=None) -> np.ndarray:
    """Scatter (ncell, a, a) element matrices into (nb, s, 3s) band storage
    on a structured P1 mesh (numpy host work, as in the JAX package), at
    the indices of ``band_indices``."""
    idx = band_indices(V, connectivity)
    s = V.mesh.structured_shape[0] + 1
    vals_e = np.asarray(vals_e)
    flat = np.zeros(V.dim * 3 * s, dtype=vals_e.dtype)
    np.add.at(flat, idx.reshape(-1), vals_e.reshape(-1))
    return flat.reshape(V.dim // s, s, 3 * s)


def mass_matrix_banded(V: FunctionSpace, dtype=None, device=None) -> torch.Tensor:
    """(nb, s, 3s) band of the consistent P1 mass matrix."""
    dtype, device = config.resolve(dtype, device)
    band = banded_from_elements(V, p1_mass_elements(V).astype(_numpy_dtype(dtype)))
    return torch.as_tensor(band, device=device)


def stiffness_matrix_banded(V: FunctionSpace, tensor=None, dtype=None,
                            device=None) -> torch.Tensor:
    """(nb, s, 3s) band of the P1 stiffness matrix (optional tensor)."""
    dtype, device = config.resolve(dtype, device)
    K_e = p1_stiffness_elements(V, tensor)
    band = banded_from_elements(V, K_e.astype(_numpy_dtype(dtype)))
    return torch.as_tensor(band, device=device)


def boundary_mass_matrix_banded(V: FunctionSpace, dtype=None,
                                device=None) -> torch.Tensor:
    """(nb, s, 3s) band of the boundary mass matrix int_dOmega u v ds."""
    dtype, device = config.resolve(dtype, device)
    edges, Me = _boundary_mass_elements(V)
    band = banded_from_elements(V, Me.astype(_numpy_dtype(dtype)),
                                connectivity=edges)
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

    def homogenized(self) -> "DirichletBC":
        """The same dofs with zero values (hippylib's bc0)."""
        return DirichletBC(mask=self.mask, value=np.zeros_like(self.value))


def mask_residual(r, u, bc: DirichletBC):
    """Replace constrained rows of the residual (N, n) with (u - g)."""
    mask = torch.as_tensor(bc.mask, device=r.device)
    g = torch.as_tensor(bc.value, dtype=r.dtype, device=r.device)
    return torch.where(mask, u - g, r)


def bc_symmetrize(A, bc: DirichletBC):
    """Symmetric elimination on dense (..., n, n): zero the constrained
    rows and columns and put ones on their diagonal."""
    mask = torch.as_tensor(bc.mask, device=A.device)
    keep = (~mask).to(A.dtype)
    A = A * keep[:, None] * keep[None, :]
    return A + torch.diag(mask.to(A.dtype))


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


def band_bc_masks(bc: DirichletBC, s: int, dtype=None, device=None):
    """(keep_row (nb, s, 1), keep_col (nb, 1, 3s), diag (nb, s, 3s)):
    bc_symmetrize on the band layout of ``assemble_A_banded``, built once
    on ``device``; they broadcast over a leading sample axis."""
    dtype, device = config.resolve(dtype, device)
    mask = np.asarray(bc.mask)
    nb = mask.shape[0] // s
    keep = (~mask).astype(np.float64).reshape(nb, s)
    # column (j, o*s + i2) refers to global dof (j + o - 1)*s + i2
    keep_col = np.zeros((nb, 3 * s))
    for o in range(3):
        jj = np.arange(nb) + o - 1
        valid = (jj >= 0) & (jj < nb)
        keep_col[valid, o * s : (o + 1) * s] = keep[jj[valid]]
    diag = np.zeros((nb, s, 3 * s))
    ii = np.arange(s)
    diag[:, ii, s + ii] = mask.reshape(nb, s)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(keep[:, :, None]), t(keep_col[:, None, :]), t(diag)


def bc_symmetrize_banded(band, keep_row, keep_col, diag):
    """Apply ``band_bc_masks`` to band storage (..., nb, s, 3s): zero the
    constrained rows and columns and put ones on their diagonal."""
    return band * keep_row * keep_col + diag


def bc_zero_rows(Mat, bc: DirichletBC):
    """Zero the constrained rows of a matrix (n, k) or of a batch of them
    (N, n, k)."""
    keep = torch.as_tensor(~np.asarray(bc.mask), device=Mat.device)
    return Mat * keep.to(Mat.dtype)[:, None]


def bc_apply_rhs(b, bc: DirichletBC, A_unconstrained=None):
    """Lift inhomogeneous values: b' = (I - Z) g + Z (b - A g), g on the
    mask, for b (n,) or (N, n) and A (n, n) or (N, n, n).  Without A the
    coupling term is left out (right for g = 0)."""
    mask = torch.as_tensor(bc.mask, device=b.device)
    g = torch.where(mask, torch.as_tensor(bc.value, dtype=b.dtype,
                                          device=b.device), 0.0)
    if A_unconstrained is not None:
        b = b - A_unconstrained @ g
    return torch.where(mask, g, b)
