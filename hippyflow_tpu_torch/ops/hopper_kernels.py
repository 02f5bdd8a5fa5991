"""Hand-written Hopper kernels of the banded and block solvers.

Four kernels (sources in ``hippyflow_tpu_torch/csrc/``), one for each
Pallas kernel of ``hippyflow_tpu/ops/pallas_kernels.py``:

* K1 ``banded_factorize`` (``csrc/banded_factorize.cu``) replaces
  ``banded_factorize_batch``: the inverse block-Thomas factorization of
  the Newton operator's band;
* K2 ``banded_solve`` (``csrc/banded_solve.cu``) replaces
  ``banded_solve_batch``: the back-solve through that factor;
* K3 ``batched_inverse`` (``csrc/batched_inverse.cu``) replaces
  ``_batched_inverse_blocked``: blocked Gauss-Jordan inverses of the
  diagonal blocks that cyclic reduction (the structured prior) eliminates;
* K4 ``batched_inverse(..., rank1=True)`` replaces ``_batched_inverse_pallas``
  (``force="pallas_rank1"`` in the JAX package): the same kernel at pivot
  width 1.

Each wrapper takes batched tensors with a leading sample axis.  On a CUDA
tensor it launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version (``banded_factorize_plain``, ``banded_solve_plain``,
``batched_inverse_plain``), which is what the kernels are checked against
on the card.  K1 and K2 have two designs each, picked by shape: K1's one-block
chain (s=65) and row panels (larger s; ``design=`` forces one), and K2's
panel solve (many rhs columns) and streamed solve (few); none is a plain
version.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a``, one process per
source in parallel, and linked into a shared library with a plain C
interface, at first use, into
``hippyflow_tpu_torch/_build/<hash of the sources and flags>/``, and loaded
with ``ctypes``.  Each wrapper counts its launches in a ``launches``
attribute (``batched_inverse.rank1_launches`` for K4;
``reset_launch_counts`` zeroes them all).
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
SOURCES = ("banded_factorize.cu", "banded_solve.cu", "batched_inverse.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Column-tile width of K2: each thread block owns this many rhs columns.
SOLVE_TILE = 32
# Pivot-block widths of K3 (the TPU kernel's 13) and K4.
GJ_WIDTH = 13

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
    """Compile the kernels unless a library of the same sources exists:
    one nvcc process per source, all started together, then one link.
    Returns its path; the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it in ``build.log``.  Raises if
    nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [out.with_name(f"{name}.{tag}.o") for name in SOURCES]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in (
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(SOURCES, objs)
        )
    ]
    tmp = out.with_name(f"{out.name}.{tag}")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    logs = []
    for cmd, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{logs[-1]}")
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {res.returncode}): "
                           f"{' '.join(link)}\n{res.stdout}\n{res.stderr}")
    (out.parent / "build.log").write_text("".join(logs) + res.stdout + res.stderr)
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


def _library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_kernels()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        signatures = {
            "hf_banded_factorize": [p, p, p, i, i, i, p],
            "hf_banded_factorize_rows": [p, p, p, i, i, i, i, p],
            "hf_banded_solve": [p, p, p, p, p, i, i, i, i, i, i, i, p],
            "hf_batched_inverse": [p, i, i, ll, i, p],
        }
        for stem, argtypes in signatures.items():
            for sfx in ("f32", "f64"):
                fn = getattr(lib, f"{stem}_{sfx}")
                fn.argtypes = argtypes
                fn.restype = i
        for name, argtypes in (
            ("hf_factorize_smem_bytes", [i, i]),
            ("hf_schur_smem_bytes", [i, i]),
            ("hf_solve_smem_bytes", [i, i, i, i]),
            ("hf_gj_smem_bytes", [i, i, i]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ll
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


def _smem_check(name: str, need: int, dev, what: str) -> None:
    if need > _smem_limit(dev):
        raise ValueError(
            f"{name}: {what} needs {need} bytes of shared memory per block, "
            f"above the card's {_smem_limit(dev)}"
        )


def _launch(lib, fn, name: str, dev, *args) -> None:
    """fn(*args, stream) on the device's current stream; raises on an error
    code (a refused launch never runs, and a synchronize would not say)."""
    with torch.cuda.device(dev):
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, code, name)


def reset_launch_counts() -> None:
    banded_factorize.launches = 0
    banded_solve.launches = 0
    batched_inverse.launches = 0
    batched_inverse.rank1_launches = 0


# ---------------------------------------------------------------------------
# K3/K4: batched Gauss-Jordan inverse
# ---------------------------------------------------------------------------


def batched_inverse_plain(X, w: int = GJ_WIDTH):
    """Plain PyTorch Gauss-Jordan inverse without pivoting, in pivot blocks
    of width w (the algorithm of the JAX package's ``blocked_inverse`` and
    ``_small_gj_inverse``, written in place as K3/K4 run it): per block
    step, the w x w pivot block P is inverted by w rank-1 steps on
    [P | I]; the pivot rows become P^-1 R (P^-1 on the block itself), and
    the other rows X - C P^-1 R with their pivot columns read as zero.
    X (N, s, s) -> (N, s, s)."""
    N, s, _ = X.shape
    X = X.clone()
    for kb in range(0, s, w):
        p = slice(kb, min(kb + w, s))
        wp = p.stop - kb
        aug = torch.cat(
            [X[:, p, p],
             torch.eye(wp, dtype=X.dtype, device=X.device).expand(N, wp, wp)],
            dim=2,
        )
        for k in range(wp):
            row = aug[:, k : k + 1, :] / aug[:, k : k + 1, k : k + 1]
            col = aug[:, :, k : k + 1].clone()
            col[:, k] = 0.0
            aug = aug - col * row
            aug[:, k : k + 1] = row
        Pinv = aug[:, :, wp:]
        Rn = Pinv @ X[:, p, :]
        Rn[:, :, p] = Pinv
        C = X[:, :, p].clone()
        C[:, p] = 0.0
        X[:, :, p] = 0.0
        X = X - C @ Rn
        X[:, p, :] = Rn
    return X


def batched_inverse(X, rank1: bool = False):
    """K3 (pivot blocks of 13) or, with ``rank1``, K4 (rank-1 updates, the
    JAX package's ``force="pallas_rank1"``).  X (N, s, s) -> X^-1, without
    pivoting: the inputs must be diagonally dominant or SPD."""
    w = 1 if rank1 else GJ_WIDTH
    if X.device.type == "cpu":
        return batched_inverse_plain(X, w)
    if X.ndim != 3 or X.shape[1] != X.shape[2]:
        raise ValueError(f"batched_inverse: shape {tuple(X.shape)}, want (N, s, s)")
    N, s, _ = X.shape
    _check_cuda("batched_inverse", [X], [X.shape])
    lib = _library()
    _smem_check("batched_inverse", lib.hf_gj_smem_bytes(s, w, X.element_size()),
                X.device, f"s={s} at pivot width {w}")
    out = X.clone()
    if N == 0 or s == 0:
        return out
    _launch(lib, getattr(lib, f"hf_batched_inverse_{_suffix(X.dtype)}"),
            "batched_inverse", X.device, out.data_ptr(), N, s, s * s, w)
    if rank1:
        batched_inverse.rank1_launches += 1
    else:
        batched_inverse.launches += 1
    return out


batched_inverse.launches = 0
batched_inverse.rank1_launches = 0


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


def banded_factorize_rows_plain(band):
    """The row-panel design of K1 in plain PyTorch: per block row, the Schur
    step M_j = A_j Dinv_{j-1}, T_j = D_j - M_j B_{j-1}, then the K3
    inverse of T_j.  Same result as ``banded_factorize_plain``."""
    N, nb, s, _ = band.shape
    A, D, B = band[..., :s], band[..., s : 2 * s], band[..., 2 * s :]
    M = torch.zeros((N, nb, s, s), dtype=band.dtype, device=band.device)
    Dinv = torch.empty_like(M)
    for j in range(nb):
        T = D[:, j]
        if j > 0:
            M[:, j] = A[:, j] @ Dinv[:, j - 1]
            T = T - M[:, j] @ B[:, j - 1]
        Dinv[:, j] = batched_inverse_plain(T, GJ_WIDTH)
    return M, Dinv


def banded_factorize(band, design: str | None = None):
    """K1.  band (N, nb, s, 3s) -> (M, Dinv), each (N, nb, s, s).

    On the card, ``design`` 'chain' (one thread block per sample runs the
    whole row chain; s whose five s x s tiles fit in shared memory) or
    'rows' (a Schur-step launch and a K3 launch per block row; any s up
    to the row panels' shared memory); None takes 'chain' where it fits."""
    if band.device.type == "cpu":
        return banded_factorize_plain(band)
    if band.ndim != 4 or band.shape[-1] != 3 * band.shape[-2]:
        raise ValueError(f"band shape {tuple(band.shape)}, want (N, nb, s, 3s)")
    if design not in (None, "chain", "rows"):
        raise ValueError(f"design={design!r}: 'chain', 'rows' or None")
    N, nb, s, _ = band.shape
    _check_cuda("banded_factorize", [band], [band.shape])
    lib = _library()
    item = band.element_size()
    chain = lib.hf_factorize_smem_bytes(s, item)
    if design is None:
        design = "chain" if chain <= _smem_limit(band.device) else "rows"
    if design == "chain":
        _smem_check("banded_factorize", chain, band.device,
                    f"the one-block chain at s={s}")
    else:
        _smem_check("banded_factorize", lib.hf_schur_smem_bytes(s, item),
                    band.device, f"the row-panel Schur step at s={s}")
        _smem_check("banded_factorize", lib.hf_gj_smem_bytes(s, GJ_WIDTH, item),
                    band.device, f"the row-panel inverse at s={s}")
    M = torch.empty((N, nb, s, s), dtype=band.dtype, device=band.device)
    Dinv = torch.empty_like(M)
    if N == 0 or nb == 0:
        return M, Dinv
    args = (band.data_ptr(), M.data_ptr(), Dinv.data_ptr(), N, nb, s)
    if design == "rows":
        args += (GJ_WIDTH,)
    stem = "hf_banded_factorize" + ("" if design == "chain" else "_rows")
    _launch(lib, getattr(lib, f"{stem}_{_suffix(band.dtype)}"),
            "banded_factorize", band.device, *args)
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


# K2 streams its factor blocks through shared-memory panels from this many
# rhs columns (the Jacobian's 100) and reads them where they lie below it
# (the Newton solves' 1); measured on the H100 at s=65 and s=193
PANELS_MIN_K = 8


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
    item, limit = bb.element_size(), _smem_limit(bb.device)
    panels = int(k >= PANELS_MIN_K)
    kt = max(1, min(SOLVE_TILE, k))
    # narrower column tiles where a 32-wide carry does not fit
    while kt > 1 and lib.hf_solve_smem_bytes(s, kt, panels, item) > limit:
        kt //= 2
    _smem_check("banded_solve", lib.hf_solve_smem_bytes(s, kt, panels, item),
                bb.device, f"the solve at s={s}")
    out = torch.empty_like(bb)
    if N == 0 or nb == 0 or k == 0:
        return out
    _launch(lib, getattr(lib, f"hf_banded_solve_{_suffix(bb.dtype)}"),
            "banded_solve", bb.device, M.data_ptr(), Dinv.data_ptr(),
            B.data_ptr(), bb.data_ptr(), out.data_ptr(), N, nb, s, k, kt,
            int(bool(trans)), panels)
    banded_solve.launches += 1
    return out


banded_solve.launches = 0
