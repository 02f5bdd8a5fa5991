"""Structured 2D simplicial meshes (numpy copy of `hippyflow_tpu/fem/mesh.py`).

The reference builds meshes through dolfin (`dl.UnitSquareMesh(nx, ny)` in
`hippyflow/test/test_KLEProjector.py` and the application drivers).  Here a
mesh is a plain frozen container of numpy arrays: vertex coordinates,
cell connectivity, and boundary metadata.  Meshes are *static* host data;
the assembly modules turn the tables they need into device tensors once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Mesh2D:
    """An unstructured 2D triangle mesh (P1 geometry).

    Attributes:
        vertices: (nv, 2) float64 vertex coordinates.
        cells: (nc, 3) int32 triangle connectivity (CCW orientation).
        boundary_mask: (nv,) bool, True for vertices on the domain boundary.
    """

    vertices: np.ndarray
    cells: np.ndarray
    boundary_mask: np.ndarray
    # (nx, ny) for structured rectangle meshes with row-major numbering:
    # enables the block-tridiagonal direct solver (ops/structured.py).
    structured_shape: tuple | None = None

    def __post_init__(self):
        assert self.vertices.ndim == 2 and self.vertices.shape[1] == 2
        assert self.cells.ndim == 2 and self.cells.shape[1] == 3

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    def hmin(self) -> float:
        x = self.vertices[self.cells]  # (nc, 3, 2)
        e = np.stack(
            [x[:, 1] - x[:, 0], x[:, 2] - x[:, 1], x[:, 0] - x[:, 2]], axis=1
        )
        return float(np.sqrt((e**2).sum(-1)).min())

    def cell_diameters(self) -> np.ndarray:
        """Longest edge per cell (dolfin CellDiameter equivalent)."""
        x = self.vertices[self.cells]
        e = np.stack(
            [x[:, 1] - x[:, 0], x[:, 2] - x[:, 1], x[:, 0] - x[:, 2]], axis=1
        )
        return np.sqrt((e**2).sum(-1)).max(axis=1)


def rectangle_mesh(
    nx: int,
    ny: int,
    x0: float = 0.0,
    y0: float = 0.0,
    x1: float = 1.0,
    y1: float = 1.0,
    diagonal: str = "right",
) -> Mesh2D:
    """Structured triangulation of a rectangle, matching dolfin RectangleMesh.

    Each of the nx*ny grid quads is split into two triangles along the chosen
    diagonal. Vertices are numbered row-major: v(i, j) = j*(nx+1) + i.
    """
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")  # shape (ny+1, nx+1)
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1).astype(np.float64)

    if diagonal == "crossed":
        raise NotImplementedError("crossed diagonal not supported")
    if diagonal not in ("right", "left"):
        raise ValueError(f"unknown diagonal {diagonal!r}")

    from . import native

    cells = native.build_rectangle_cells(nx, ny, diagonal)
    if cells is None:  # numpy fallback (vectorized)
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
        v00 = (jj * (nx + 1) + ii).ravel()
        v10, v01 = v00 + 1, v00 + (nx + 1)
        v11 = v01 + 1
        if diagonal == "right":
            tris = np.stack(
                [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)], 1
            )
        else:
            tris = np.stack(
                [np.stack([v00, v10, v01], 1), np.stack([v10, v11, v01], 1)], 1
            )
        cells = tris.reshape(-1, 3).astype(np.int32)

    eps = 1e-12 * max(abs(x1 - x0), abs(y1 - y0), 1.0)
    bm = (
        (np.abs(vertices[:, 0] - x0) < eps)
        | (np.abs(vertices[:, 0] - x1) < eps)
        | (np.abs(vertices[:, 1] - y0) < eps)
        | (np.abs(vertices[:, 1] - y1) < eps)
    )
    return Mesh2D(
        vertices=vertices,
        cells=cells,
        boundary_mask=bm,
        structured_shape=(nx, ny),
    )


def unit_square_mesh(nx: int, ny: int | None = None) -> Mesh2D:
    """dolfin ``UnitSquareMesh(nx, ny)`` equivalent."""
    if ny is None:
        ny = nx
    return rectangle_mesh(nx, ny)


def boundary_edges(mesh: Mesh2D) -> np.ndarray:
    """Return (ne, 2) vertex pairs of edges lying on the mesh boundary.

    An edge is on the boundary iff it appears in exactly one cell.  Used for
    boundary mass matrices (Robin terms of the BiLaplacian prior and the
    boundary-restricted KLE of `hippyflow/modeling/KLEProjector.py:364`).
    """
    from . import native

    out = native.boundary_edges(mesh.cells)
    if out is not None:
        return out
    c = mesh.cells
    edges = np.concatenate([c[:, [0, 1]], c[:, [1, 2]], c[:, [2, 0]]], axis=0)
    key = np.sort(edges, axis=1)
    _, idx, counts = np.unique(
        key, axis=0, return_index=True, return_counts=True
    )
    return edges[idx[counts == 1]]
