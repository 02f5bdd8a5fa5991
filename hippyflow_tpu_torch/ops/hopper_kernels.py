"""Hand-written Hopper kernels of the banded inverse block-Thomas solver.

Two kernels carry the main path (sources in ``hippyflow_tpu_torch/csrc/``):

* K1 ``banded_factorize`` (``csrc/banded_factorize.cu``) replaces the
  Pallas kernel ``banded_factorize_batch`` of
  ``hippyflow_tpu/ops/pallas_kernels.py``;
* K2 ``banded_solve`` (``csrc/banded_solve.cu``) replaces the Pallas
  kernel ``banded_solve_batch`` of the same file.

Each wrapper takes batched tensors with a leading sample axis.  On a CUDA
tensor it launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version (``banded_factorize_plain`` / ``banded_solve_plain``),
which is the loop of the JAX reference (``_factorize_thomas_inv_banded``
and ``_thomas_solve_scan`` in ``hippyflow_tpu/ops/structured.py``).  The
plain versions are also what the kernels are checked against on the card.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into
``hippyflow_tpu_torch/_build/<hash of the sources and flags>/``, and loaded
with ``ctypes``.  Each wrapper counts its launches in a ``launches``
attribute (``reset_launch_counts`` zeroes them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("banded_factorize.cu", "banded_solve.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Column-tile width of K2: each thread block owns this many rhs columns.
SOLVE_TILE = 32

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Where the library built from the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libhf_kernels.so"


def build_kernels() -> Path:
    """Compile the kernels unless a library of the same sources exists.
    Returns its path; the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it in ``build.log``.  Raises if
    nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(CSRC / name) for name in SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    (out.parent / "build.log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_kernels()))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("hf_banded_factorize_f32", "hf_banded_factorize_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, i, i, i, p]
            fn.restype = i
        for name in ("hf_banded_solve_f32", "hf_banded_solve_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        lib.hf_factorize_smem_bytes.argtypes = [i, i]
        lib.hf_factorize_smem_bytes.restype = ctypes.c_longlong
        lib.hf_solve_smem_bytes.argtypes = [i, i, i]
        lib.hf_solve_smem_bytes.restype = ctypes.c_longlong
        lib.hf_error_string.argtypes = [i]
        lib.hf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def _suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"kernels take float32 or float64 tensors, not {dtype}")


def _check_cuda(name, tensors, shapes):
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {dev} (CPU or CUDA only)")
    _suffix(dtype)
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: mixed devices or dtypes")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _smem_limit(dev) -> int:
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))


def _raise_on(lib, code: int, name: str):
    if code != 0:
        msg = lib.hf_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def reset_launch_counts() -> None:
    banded_factorize.launches = 0
    banded_solve.launches = 0


# ---------------------------------------------------------------------------
# K1: banded factorization
# ---------------------------------------------------------------------------


def banded_factorize_plain(band):
    """Plain PyTorch inverse block-Thomas factorization.
    band (N, nb, s, 3s) -> (M, Dinv), each (N, nb, s, s), M[:, 0] = 0."""
    N, nb, s, _ = band.shape
    A, D, B = band[..., :s], band[..., s : 2 * s], band[..., 2 * s :]
    M = torch.zeros((N, nb, s, s), dtype=band.dtype, device=band.device)
    Dinv = torch.empty_like(M)
    Dinv[:, 0] = torch.linalg.inv(D[:, 0])
    for j in range(1, nb):
        Mj = A[:, j] @ Dinv[:, j - 1]
        M[:, j] = Mj
        Dinv[:, j] = torch.linalg.inv(D[:, j] - Mj @ B[:, j - 1])
    return M, Dinv


def banded_factorize(band):
    """K1.  band (N, nb, s, 3s) -> (M, Dinv), each (N, nb, s, s)."""
    if band.device.type == "cpu":
        return banded_factorize_plain(band)
    if band.ndim != 4 or band.shape[-1] != 3 * band.shape[-2]:
        raise ValueError(f"band shape {tuple(band.shape)}, want (N, nb, s, 3s)")
    N, nb, s, _ = band.shape
    _check_cuda("banded_factorize", [band], [band.shape])
    lib = _library()
    smem = lib.hf_factorize_smem_bytes(s, band.element_size())
    if smem > _smem_limit(band.device):
        raise ValueError(
            f"banded_factorize: s={s} needs {smem} bytes of shared memory "
            f"per block, above the card's {_smem_limit(band.device)}"
        )
    M = torch.empty((N, nb, s, s), dtype=band.dtype, device=band.device)
    Dinv = torch.empty_like(M)
    if N == 0 or nb == 0:
        return M, Dinv
    fn = getattr(lib, f"hf_banded_factorize_{_suffix(band.dtype)}")
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(band.data_ptr(), M.data_ptr(), Dinv.data_ptr(), N, nb, s,
                  stream)
    _raise_on(lib, code, "banded_factorize")
    banded_factorize.launches += 1
    return M, Dinv


banded_factorize.launches = 0


# ---------------------------------------------------------------------------
# K2: banded back-solve
# ---------------------------------------------------------------------------


def banded_solve_plain(M, Dinv, B, bb, trans: bool):
    """Plain PyTorch back-solve through (M, Dinv, B), each (N, nb, s, s);
    bb (N, nb, s, k) -> x (N, nb, s, k) with A x = b, or A^T x = b."""
    nb = M.shape[1]
    xs = [None] * nb
    if not trans:
        ys = [bb[:, 0]]
        for j in range(1, nb):
            ys.append(bb[:, j] - M[:, j] @ ys[-1])
        xs[-1] = Dinv[:, -1] @ ys[-1]
        for j in range(nb - 2, -1, -1):
            xs[j] = Dinv[:, j] @ (ys[j] - B[:, j] @ xs[j + 1])
        return torch.stack(xs, dim=1)
    Dt, Bt, Mt = Dinv.mT, B.mT, M.mT
    zs = [Dt[:, 0] @ bb[:, 0]]
    for j in range(1, nb):
        zs.append(Dt[:, j] @ (bb[:, j] - Bt[:, j - 1] @ zs[-1]))
    xs[-1] = zs[-1]
    for j in range(nb - 2, -1, -1):
        xs[j] = zs[j] - Mt[:, j + 1] @ xs[j + 1]
    return torch.stack(xs, dim=1)


def banded_solve(M, Dinv, B, bb, trans: bool):
    """K2.  M, Dinv, B (N, nb, s, s); bb (N, nb, s, k) -> x (N, nb, s, k)
    with A x = b (trans=False) or A^T x = b (trans=True)."""
    if bb.device.type == "cpu":
        return banded_solve_plain(M, Dinv, B, bb, trans)
    if M.ndim != 4 or bb.ndim != 4:
        raise ValueError("banded_solve takes 4-d factor blocks and rhs")
    N, nb, s, _ = M.shape
    k = bb.shape[-1]
    fac = (N, nb, s, s)
    _check_cuda("banded_solve", [bb, M, Dinv, B], [(N, nb, s, k), fac, fac, fac])
    lib = _library()
    kt = max(1, min(SOLVE_TILE, k))
    smem = lib.hf_solve_smem_bytes(s, kt, bb.element_size())
    if smem > _smem_limit(bb.device):
        raise ValueError(
            f"banded_solve: s={s} needs {smem} bytes of shared memory per "
            f"block, above the card's {_smem_limit(bb.device)}"
        )
    out = torch.empty_like(bb)
    if N == 0 or nb == 0 or k == 0:
        return out
    fn = getattr(lib, f"hf_banded_solve_{_suffix(bb.dtype)}")
    with torch.cuda.device(bb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(M.data_ptr(), Dinv.data_ptr(), B.data_ptr(), bb.data_ptr(),
                  out.data_ptr(), N, nb, s, k, kt, int(bool(trans)), stream)
    _raise_on(lib, code, "banded_solve")
    banded_solve.launches += 1
    return out


banded_solve.launches = 0
