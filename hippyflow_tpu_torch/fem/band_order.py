"""Row-ordered banded numbering for P2 and vector states on structured meshes
(numpy copy of ``hippyflow_tpu/fem/band_order.py``).

The P1-scalar fast path (`assembly.py::assemble_A_banded`) relies on the
mesh's native row-major vertex numbering being block-tridiagonal with block
size nx+1.  P2 spaces break that (edge dofs are numbered after all
vertices, `space.py::cell_dofs`) and multi-component states break it again
(components are stacked, coupling (i, i+n)).  This module restores the band
through a static PERMUTATION instead of renumbering the space:

* every Lagrange dof of a structured rectangle mesh lies on the refined
  grid with row spacing h_y/degree; sorting dofs by (refined row, x) and
  interleaving the ``ncomp`` state components per node gives an ordering in
  which any two dofs sharing a cell are at most ``degree`` refined rows
  apart;
* grouping ``degree`` refined rows per block row therefore yields a
  block-tridiagonal operator with block size
  ``s = ncomp * degree * (degree*nx + 1)`` — e.g. the Helmholtz split
  real/imaginary P2 state at nx=64 becomes (52, 516, 1548) band storage
  instead of a 26574^2 dense matrix.

The permutation lives only inside the solver path: assembly gathers
element matrices straight into permuted band storage, factorization runs on
the band, and ``ops.structured.PermutedFactor`` gathers rhs/solution
vectors between the public dof order and the band order (one gather each
way).

Reference anchor: this replaces the sparse reordered MUMPS factorizations
hippylib obtains from PETSc for P2/vector problems
(`applications/helmholtz_2d/HelmholtzProblem.py:137-150`).
"""

from __future__ import annotations

import numpy as np


class BandOrder:
    """Static banded-ordering data for one (space, ncomp) pair.

    Attributes:
        order: (n_total,) stacked-layout dof ids in band order —
            ``band_vec[p] = x[order[p]]`` for p < n_total.
        inv: (n_total,) band position of each stacked dof.
        s: block size; nb: block rows; n_pad = nb*s - n_total >= 0
            (pad positions sit at the band tail).
    """

    def __init__(self, order, inv, s, nb, n_total):
        self.order = order
        self.inv = inv
        self.s = int(s)
        self.nb = int(nb)
        self.n_total = int(n_total)
        self.n_pad = self.nb * self.s - self.n_total


def structured_band_order(V, ncomp: int = 1) -> BandOrder:
    """Build the banded ordering for a P1/P2 space on a structured mesh."""
    mesh = V.mesh
    assert mesh.structured_shape is not None, "structured meshes only"
    nx, ny = mesh.structured_shape
    deg = V.degree
    n = V.dim
    coords = np.asarray(V.dof_coords)
    y0, y1 = mesh.vertices[:, 1].min(), mesh.vertices[:, 1].max()
    x0, x1 = mesh.vertices[:, 0].min(), mesh.vertices[:, 0].max()
    hy = (y1 - y0) / (deg * ny)
    hx = (x1 - x0) / (deg * nx)
    rows = np.rint((coords[:, 1] - y0) / hy).astype(np.int64)
    cols = np.rint((coords[:, 0] - x0) / hx).astype(np.int64)
    assert rows.min() >= 0 and rows.max() == deg * ny, "off-grid dof rows"
    node_ids = np.lexsort((cols, rows))  # (n,) node ids in band order

    # interleave components per node: position p = node_rank*ncomp + comp
    # maps to stacked dof id comp*n + node_ids[node_rank]
    order = (
        node_ids[:, None] + np.arange(ncomp)[None, :] * n
    ).reshape(-1).astype(np.int64)
    inv = np.argsort(order).astype(np.int64)

    nodes_per_row = deg * nx + 1
    counts = np.bincount(rows, minlength=deg * ny + 1)
    assert (counts == nodes_per_row).all(), (
        "structured band ordering requires equal-length dof rows"
    )
    s = ncomp * deg * nodes_per_row
    n_total = n * ncomp
    nb = -(-n_total // s)
    return BandOrder(order=order, inv=inv, s=s, nb=nb, n_total=n_total)


def ordered_band_indices(stacked_cell_dofs: np.ndarray, border: BandOrder):
    """Flat scatter indices mapping element-matrix entries into permuted
    (nb, s, 3s) band storage.

    stacked_cell_dofs: (nc, a) stacked-layout dof ids per cell (for vector
    states, a = nd*ncomp with entries comp*n + node).  Asserts every
    coupled pair lands within one block row of the ordering."""
    s, nb = border.s, border.nb
    pos = border.inv[np.asarray(stacked_cell_dofs, dtype=np.int64)]  # (nc, a)
    a = pos.shape[1]
    p1 = np.repeat(pos, a, axis=1).reshape(-1)  # rows
    p2 = np.tile(pos, (1, a)).reshape(-1)  # cols
    o = p2 // s - p1 // s + 1
    assert ((o >= 0) & (o <= 2)).all(), (
        "ordering is not block-tridiagonal at this block size"
    )
    return p1 * (3 * s) + o * s + (p2 % s)


def ordered_band_mask(mask: np.ndarray, border: BandOrder):
    """(nb*s,) Dirichlet mask in band order; pad positions are marked
    constrained so pad rows factorize as identity."""
    m = np.asarray(mask, dtype=bool)
    out = np.ones(border.nb * border.s, dtype=bool)
    out[: border.n_total] = m[border.order]
    return out
