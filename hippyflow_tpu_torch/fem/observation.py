"""Pointwise observation operators.

Replaces ``hp.assemblePointwiseObservation(Vh[STATE], targets)`` used by the
reference to build the B matrix (`hippyflow/test/test_derivativeSubspace.py:72`,
`applications/confusion/confusion_linear_observable.py:146`).

For P1 elements, observing u at a point x inside triangle T is the
barycentric interpolation  q_k = sum_i lambda_i(x_k) u[T_i].  Point location
runs once on the host in numpy; the operator itself is a small dense
(n_targets, n_dofs) matrix so that B u and B^T q are single matmuls.
"""

from __future__ import annotations

import numpy as np

from .space import FunctionSpace


def locate_points(space: FunctionSpace, targets: np.ndarray, tol: float = 1e-10):
    """Find containing cell and barycentric weights for each target point.

    Returns (cell_ids (nt,), weights (nt, 3)). Raises if a point lies outside
    the mesh (matching the hard failure of dolfin point observation).
    """
    mesh = space.mesh
    targets = np.atleast_2d(np.asarray(targets, dtype=np.float64))

    from . import native

    located = native.locate_points(mesh.vertices, mesh.cells, targets, tol=tol)
    if located is not None:
        cell_ids, weights = located
        if (cell_ids < 0).any():
            bad = targets[np.argmax(cell_ids < 0)]
            raise ValueError(f"target point {bad} is outside the mesh")
        return cell_ids, weights

    x = mesh.vertices[mesh.cells]  # (nc, 3, 2)
    x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
    # Affine barycentric solve: lambda1, lambda2 from 2x2 system per cell.
    T = np.stack([x1 - x0, x2 - x0], axis=2)  # (nc, 2, 2)
    det = T[:, 0, 0] * T[:, 1, 1] - T[:, 0, 1] * T[:, 1, 0]
    inv = (
        np.stack(
            [
                np.stack([T[:, 1, 1], -T[:, 0, 1]], axis=1),
                np.stack([-T[:, 1, 0], T[:, 0, 0]], axis=1),
            ],
            axis=1,
        )
        / det[:, None, None]
    )  # (nc, 2, 2)

    cell_ids = np.empty(len(targets), dtype=np.int64)
    weights = np.empty((len(targets), 3), dtype=np.float64)
    for k, p in enumerate(targets):
        rel = p[None, :] - x0  # (nc, 2)
        lam12 = np.einsum("cij,cj->ci", inv, rel)  # (nc, 2)
        lam0 = 1.0 - lam12.sum(axis=1)
        lam = np.concatenate([lam0[:, None], lam12], axis=1)  # (nc, 3)
        inside = (lam >= -tol).all(axis=1)
        if not inside.any():
            raise ValueError(f"target point {p} is outside the mesh")
        c = int(np.argmax(inside))
        cell_ids[k] = c
        weights[k] = np.clip(lam[c], 0.0, None)
        weights[k] /= weights[k].sum()
    return cell_ids, weights


def assemble_pointwise_observation(
    space: FunctionSpace, targets: np.ndarray
) -> np.ndarray:
    """Dense observation matrix B (n_targets, n_dofs); degree-aware (P1
    barycentric weights, P2 quadratic shape functions at the located
    barycentric coordinates)."""
    cell_ids, weights = locate_points(space, targets)
    if space.degree > 1:
        # reference coordinates from barycentric (lam1, lam2) = (x, y)
        ref_pts = weights[:, 1:]
        vals = np.stack(
            [space.basis(ref_pts[t : t + 1])[0] for t in range(len(cell_ids))]
        )  # (nt, nd)
    else:
        vals = weights
    B = np.zeros((len(cell_ids), space.dim), dtype=np.float64)
    dofs = np.asarray(space.cell_dofs)[cell_ids]  # (nt, nd)
    rows = np.repeat(np.arange(len(cell_ids)), dofs.shape[1])
    B[rows, dofs.reshape(-1)] = vals.reshape(-1)
    return B


def vector_to_function(space: FunctionSpace, dofs):
    """Field evaluator from dof values: the analog of hp.vector2Function
    (a dolfin Function object); returns ``f(points) -> values`` interpolating
    at arbitrary points inside the mesh (degree-aware)."""
    dofs = np.asarray(dofs)

    def f(points):
        B = assemble_pointwise_observation(space, np.atleast_2d(points))
        return B @ dofs

    return f


def grid_targets(lo: float, hi: float, sqrt_n: int) -> np.ndarray:
    """The reference's observation-target layout: a sqrt_n x sqrt_n grid in
    [lo, hi]^2 (`confusion_linear_observable.py:121-127`)."""
    xs = np.linspace(lo, hi, sqrt_n)
    pts = [(xi, yi) for xi in xs for yi in xs]
    return np.asarray(pts)
