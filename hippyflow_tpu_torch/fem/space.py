"""Lagrange function spaces (P1 / P2) on triangle meshes.

Replaces ``dl.FunctionSpace(mesh, 'Lagrange', k)`` used throughout the
reference (P1 parameters everywhere; P2 states in
`applications/helmholtz_2d/helmholtz_linear_observable.py:70` and the
Taylor-Hood velocity of `confusion_linear_observable.py:55`).  Degrees of
freedom are vertex values (P1) plus edge-midpoint values (P2); fields are
flat tensors of length ``space.dim``.

The per-cell geometric factors (physical basis gradients at quadrature
points, cell volumes) are precomputed once in numpy and captured as
device tensors by the assembly module once: static shapes, zero
host<->device traffic per solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .mesh import Mesh2D
from .quadrature import triangle_rule

# Reference P1 basis on the unit triangle.
_REF_GRADS = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)


def _ref_values(points: np.ndarray) -> np.ndarray:
    """P1 shape functions at reference points (nq, 2) -> (nq, 3)."""
    lam0 = 1.0 - points[:, 0] - points[:, 1]
    return np.stack([lam0, points[:, 0], points[:, 1]], axis=1)


def _lambdas(points: np.ndarray) -> np.ndarray:
    """Barycentric coordinates (nq, 3) at reference points."""
    return _ref_values(points)


def _p2_values(points: np.ndarray) -> np.ndarray:
    """P2 shape functions (nq, 6): vertex modes lam_i (2 lam_i - 1), edge
    modes 4 lam_i lam_j with local edge k opposite vertex k (FEniCS
    convention: edge 3 = (v1,v2), 4 = (v0,v2), 5 = (v0,v1))."""
    lam = _lambdas(points)  # (nq, 3)
    vertex = lam * (2.0 * lam - 1.0)
    edges = np.stack(
        [
            4.0 * lam[:, 1] * lam[:, 2],
            4.0 * lam[:, 0] * lam[:, 2],
            4.0 * lam[:, 0] * lam[:, 1],
        ],
        axis=1,
    )
    return np.concatenate([vertex, edges], axis=1)


def _p2_ref_grads(points: np.ndarray) -> np.ndarray:
    """P2 reference gradients (nq, 6, 2)."""
    lam = _lambdas(points)
    dlam = _REF_GRADS  # (3, 2): gradients of lam_0, lam_1, lam_2
    nq = points.shape[0]
    g = np.zeros((nq, 6, 2))
    for i in range(3):
        g[:, i, :] = (4.0 * lam[:, i : i + 1] - 1.0) * dlam[i][None, :]
    pairs = [(1, 2), (0, 2), (0, 1)]
    for k, (i, j) in enumerate(pairs):
        g[:, 3 + k, :] = 4.0 * (
            lam[:, j : j + 1] * dlam[i][None, :]
            + lam[:, i : i + 1] * dlam[j][None, :]
        )
    return g


def _basis(degree: int, points: np.ndarray) -> np.ndarray:
    return _ref_values(points) if degree == 1 else _p2_values(points)


def _basis_grads(degree: int, points: np.ndarray) -> np.ndarray:
    """(nq, nd, 2) reference gradients."""
    if degree == 1:
        return np.broadcast_to(
            _REF_GRADS[None], (points.shape[0], 3, 2)
        ).copy()
    return _p2_ref_grads(points)


@dataclass(frozen=True)
class Geometry:
    """Per-cell geometric factors (all numpy, static)."""

    grads: np.ndarray  # (nc, 3, 2) physical gradients of the P1 basis
    volumes: np.ndarray  # (nc,) triangle areas
    detJ: np.ndarray  # (nc,) |det of affine map| = 2 * area
    invJ: np.ndarray  # (nc, 2, 2) inverse affine Jacobian


@dataclass(frozen=True, eq=False)
class FunctionSpace:
    """Scalar Lagrange space of degree 1 (vertex dofs) or 2 (+edge dofs)."""

    mesh: Mesh2D
    degree: int = 1

    def __post_init__(self):
        assert self.degree in (1, 2), "P1 and P2 supported"

    @property
    def nd(self) -> int:
        """Local dofs per cell."""
        return 3 if self.degree == 1 else 6

    @cached_property
    def _edge_data(self):
        """(unique_edges (ne, 2) sorted, cell_edge_ids (nc, 3)) with local
        edge k opposite vertex k."""
        c = self.mesh.cells
        tri_edges = np.stack(
            [c[:, [1, 2]], c[:, [0, 2]], c[:, [0, 1]]], axis=1
        )  # (nc, 3, 2)
        key = np.sort(tri_edges.reshape(-1, 2), axis=1)
        unique, inv = np.unique(key, axis=0, return_inverse=True)
        return unique, inv.reshape(-1, 3)

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """(nc, nd) global dof indices per cell."""
        if self.degree == 1:
            return self.mesh.cells
        edges, cell_edge = self._edge_data
        return np.concatenate(
            [self.mesh.cells, self.mesh.num_vertices + cell_edge], axis=1
        ).astype(np.int64)

    @property
    def dim(self) -> int:
        if self.degree == 1:
            return self.mesh.num_vertices
        return self.mesh.num_vertices + self._edge_data[0].shape[0]

    @cached_property
    def dof_coords(self) -> np.ndarray:
        if self.degree == 1:
            return self.mesh.vertices
        edges, _ = self._edge_data
        mids = 0.5 * (self.mesh.vertices[edges[:, 0]] + self.mesh.vertices[edges[:, 1]])
        return np.concatenate([self.mesh.vertices, mids], axis=0)

    @cached_property
    def geometry(self) -> Geometry:
        x = self.mesh.vertices[self.mesh.cells]  # (nc, 3, 2)
        # Affine map F(xi) = x0 + J xi, J columns = edge vectors.
        J = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]], axis=2)  # (nc,2,2)
        detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        invJ = (
            np.stack(
                [
                    np.stack([J[:, 1, 1], -J[:, 0, 1]], axis=1),
                    np.stack([-J[:, 1, 0], J[:, 0, 0]], axis=1),
                ],
                axis=1,
            )
            / detJ[:, None, None]
        )
        # physical grad phi_i = invJ^T @ ref_grad_i  (P1)
        grads = np.einsum("cdk,id->cik", invJ, _REF_GRADS)
        return Geometry(
            grads=grads, volumes=np.abs(detJ) / 2.0, detJ=np.abs(detJ), invJ=invJ
        )

    def basis(self, points: np.ndarray) -> np.ndarray:
        """Shape functions at reference points: (nq, nd)."""
        return _basis(self.degree, np.atleast_2d(points))

    def quad_points(self, degree: int):
        """Backward-compatible P1 rule: (phi (nq,3), xq (nc,nq,2), wdet)."""
        pts, w = triangle_rule(degree)
        phi = _ref_values(pts)
        x = self.mesh.vertices[self.mesh.cells]
        xq = np.einsum("qi,cid->cqd", phi, x)
        wdet = 2.0 * w[None, :] * self.geometry.volumes[:, None]
        return phi, xq, wdet

    def quad_data(self, degree: int):
        """Degree-aware quadrature pack:
        (phi (nq, nd), gphi (nc, nq_g, nd, 2), xq (nc, nq, 2), wdet (nc, nq)).
        gphi are *physical* basis gradients at the quadrature points; for P1
        they are constant in q and returned with nq_g = 1 so assembly kernels
        keep the original constant-gradient cost."""
        pts, w = triangle_rule(degree)
        phi = _basis(self.degree, pts)  # (nq, nd)
        geo = self.geometry
        if self.degree == 1:
            gphi = geo.grads[:, None]  # (nc, 1, 3, 2)
        else:
            gref = _basis_grads(self.degree, pts)  # (nq, nd, 2)
            gphi = np.einsum("cdk,qid->cqik", geo.invJ, gref)
        lam = _ref_values(pts)
        x = self.mesh.vertices[self.mesh.cells]
        xq = np.einsum("qi,cid->cqd", lam, x)
        wdet = 2.0 * w[None, :] * geo.volumes[:, None]
        return phi, gphi, xq, wdet

    def boundary_dofs(self, predicate=None) -> np.ndarray:
        """Boolean mask of boundary dofs, optionally filtered by a predicate
        ``predicate(x) -> bool`` over coordinates (vectorized over (n,2))."""
        if self.degree == 1:
            mask = self.mesh.boundary_mask.copy()
        else:
            edges, _ = self._edge_data
            # an edge dof is on the boundary iff both endpoints are AND the
            # edge itself is a boundary edge (appears in exactly one cell)
            from .mesh import boundary_edges as _bedges

            be = np.sort(_bedges(self.mesh), axis=1)
            keys = edges[:, 0].astype(np.int64) * self.mesh.num_vertices + edges[:, 1]
            bkeys = be[:, 0].astype(np.int64) * self.mesh.num_vertices + be[:, 1]
            edge_on_boundary = np.isin(keys, bkeys)
            mask = np.concatenate([self.mesh.boundary_mask, edge_on_boundary])
        if predicate is not None:
            mask &= np.asarray(predicate(self.dof_coords), dtype=bool)
        return mask

    def interpolate(self, fn) -> np.ndarray:
        """Nodal interpolation of ``fn((n,2) coords) -> (n,)``."""
        return np.asarray(fn(self.dof_coords), dtype=np.float64)
