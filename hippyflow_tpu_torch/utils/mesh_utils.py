"""Mesh serialization utilities (numpy copy of
``hippyflow_tpu/utils/mesh_utils.py``).

The reference's `hippyflow/utilities/mesh_utils.py`
(`read_serial_write_parallel_mesh`, XDMF serial-read -> parallel-partition
rewrite) becomes plain static data here: persistence is one npz, and
there is nothing to repartition.
"""

from __future__ import annotations

import numpy as np

from ..fem.mesh import Mesh2D


def save_mesh(mesh: Mesh2D, path: str) -> None:
    """Serialize a Mesh2D to an npz file."""
    np.savez_compressed(
        path,
        vertices=mesh.vertices,
        cells=mesh.cells,
        boundary_mask=mesh.boundary_mask,
        structured_shape=(
            np.asarray(mesh.structured_shape)
            if mesh.structured_shape is not None
            else np.zeros(0, dtype=np.int64)
        ),
    )


def load_mesh(path: str) -> Mesh2D:
    """Load a Mesh2D written by save_mesh."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    ss = data["structured_shape"]
    return Mesh2D(
        vertices=data["vertices"],
        cells=data["cells"],
        boundary_mask=data["boundary_mask"],
        structured_shape=tuple(int(v) for v in ss) if ss.size else None,
    )


def export_vtk(
    path: str,
    mesh: Mesh2D,
    point_data: dict[str, "np.ndarray"] | None = None,
) -> str:
    """Write a ParaView-readable legacy-VTK (ASCII UNSTRUCTURED_GRID) file.

    The analog of the reference's ``dl.File('x.pvd') << function`` exports
    (`PODProjector.py:490-537`, `blockVector.py:93-96`): the reference
    relies on dolfin's VTK writer; here the mesh is plain numpy so the
    writer is ~40 lines of the documented legacy format.  ``point_data``
    maps field name -> per-dof array; Lagrange dof layouts in this library
    order vertex dofs first (`fem/space.py`), so P2 / stacked fields are
    truncated to their leading ``num_vertices`` entries (the piecewise-
    linear visualization ParaView renders anyway).

    Returns the path written (with '.vtk' appended when missing).
    """
    if not str(path).endswith(".vtk"):
        path = str(path) + ".vtk"
    nv = mesh.num_vertices
    nc = mesh.num_cells
    lines = [
        "# vtk DataFile Version 3.0",
        "hippyflow_tpu_torch export",
        "ASCII",
        "DATASET UNSTRUCTURED_GRID",
        f"POINTS {nv} double",
    ]
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    lines += [f"{x:.16g} {y:.16g} 0" for x, y in verts]
    cells = np.asarray(mesh.cells, dtype=np.int64)
    lines.append(f"CELLS {nc} {4 * nc}")
    lines += [f"3 {a} {b} {c}" for a, b, c in cells]
    lines.append(f"CELL_TYPES {nc}")
    lines += ["5"] * nc  # VTK_TRIANGLE
    if point_data:
        lines.append(f"POINT_DATA {nv}")
        for name, arr in point_data.items():
            a = np.asarray(arr, dtype=np.float64).reshape(-1)
            assert a.size >= nv, (
                f"field '{name}' has {a.size} entries < {nv} vertices"
            )
            lines.append(f"SCALARS {name} double 1")
            lines.append("LOOKUP_TABLE default")
            lines += [f"{v:.16g}" for v in a[:nv]]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
