"""ctypes bindings for the native FEM graph-builder (native/fem_graph.cpp).

The shared library is compiled lazily with g++ the first time it is needed
and cached next to the source; import never fails — callers check
``available()`` and fall back to the numpy implementations.  This is the
host-runtime analog of the reference's dolfin C++ mesh/dofmap layer
(SURVEY.md section 2.5).  Both packages share the one source and build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC = os.path.join(_NATIVE_DIR, "fem_graph.cpp")
_LIB = os.path.join(_NATIVE_DIR, "build", "libfemgraph.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", _LIB,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        return res.returncode == 0
    except Exception:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("HIPPYFLOW_TPU_NO_NATIVE"):
            return None
        try:
            stale = (not os.path.exists(_LIB)) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
            )
            if stale and not _compile():
                return None
            lib = ctypes.CDLL(_LIB)
        except Exception:
            return None

        i64, i32p, i64p, f64p = (
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        )
        lib.build_rectangle_cells.restype = ctypes.c_int
        lib.build_rectangle_cells.argtypes = [i64, i64, ctypes.c_int, i32p]
        lib.boundary_edges.restype = i64
        lib.boundary_edges.argtypes = [i32p, i64, i32p]
        lib.band_indices.restype = ctypes.c_int
        lib.band_indices.argtypes = [i32p, i64, i64, i64p]
        lib.locate_points.restype = ctypes.c_int
        lib.locate_points.argtypes = [
            f64p, i64, i32p, i64, f64p, i64, ctypes.c_double, i64p, f64p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_rectangle_cells(nx: int, ny: int, diagonal: str = "right"):
    """(2 nx ny, 3) int32 structured triangulation, or None w/o the lib."""
    lib = _load()
    if lib is None:
        return None
    cells = np.empty((2 * nx * ny, 3), dtype=np.int32)
    code = lib.build_rectangle_cells(
        nx, ny, {"right": 0, "left": 1}[diagonal], cells
    )
    return cells if code == 0 else None


def boundary_edges(cells: np.ndarray):
    """(ne, 2) int32 boundary edge list, or None without the lib."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    out = np.empty((3 * cells.shape[0], 2), dtype=np.int32)
    n = lib.boundary_edges(cells, cells.shape[0], out)
    if n < 0:
        return None
    return out[:n].copy()


def band_indices(cells: np.ndarray, s: int):
    """(nc*9,) int64 band scatter indices, or None (also when the mesh is not
    block-tridiagonal at this block size)."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    out = np.empty(cells.shape[0] * 9, dtype=np.int64)
    code = lib.band_indices(cells, cells.shape[0], s, out)
    return out if code == 0 else None


def locate_points(vertices: np.ndarray, cells: np.ndarray, targets: np.ndarray,
                  tol: float = 1e-10):
    """(cell_ids (nt,) int64 with -1 for outside, weights (nt, 3)) or None."""
    lib = _load()
    if lib is None:
        return None
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    targets = np.ascontiguousarray(np.atleast_2d(targets), dtype=np.float64)
    out_cell = np.empty(targets.shape[0], dtype=np.int64)
    out_w = np.empty((targets.shape[0], 3), dtype=np.float64)
    code = lib.locate_points(
        vertices, vertices.shape[0], cells, cells.shape[0],
        targets, targets.shape[0], tol, out_cell, out_w,
    )
    if code != 0:
        return None
    return out_cell, out_w
