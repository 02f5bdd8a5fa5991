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

K3/K4 split each matrix's columns over a cluster of thread blocks; the
cluster size comes from ``gj_cluster`` (``cluster=`` forces one), and
whether each matrix stays resident in the cluster's shared memory or is
updated in L2 from ``gj_resident`` (``resident=`` forces one); K1's row
design passes the same choices down to the K3 launches it makes.  K2's
few-column design splits each factor block's rows over a cluster of thread
blocks per sample; its size comes from ``stream_cluster`` (``cluster=``
forces one) and its ring, threads and lanes from ``stream_geometry``.

Each wrapper takes batched tensors with a leading sample axis.  On a CUDA
tensor it launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version (``banded_factorize_plain``, ``banded_solve_plain``,
``batched_inverse_plain``), which is what the kernels are checked against
on the card.  K1 and K2 have two designs each, picked by shape: K1's
chain (one launch runs each sample's whole row chain in shared memory:
register-tiled products, an in-place Gauss-Jordan in 13-wide pivot blocks
with the next pivot block inverted beside the update; where its four
s x s tiles fit: s <= 120 in float32, 84 in float64) and row panels
(larger s, s=193 and 516; ``design=`` forces one), and K2's panel solve
(many rhs columns: an even split of the columns into tiles, row panels
that split s evenly and register tiles, from ``panel_geometry``) and
streamed solve (fewer than 8: each block draws its slab of every factor
block once through a ring of bulk copies that runs ahead of the
recurrence); none is a plain version.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a``, one process per
source in parallel, and linked into a shared library with a plain C
interface, at first use, into
``hippyflow_tpu_torch/_build/<hash of the sources and flags>/``, and loaded
with ``ctypes``.  Each wrapper counts its launches in a ``launches``
attribute (``batched_inverse.rank1_launches`` for K4,
``banded_factorize.launches_by_design`` and
``banded_solve.launches_by_design`` for K1's and K2's two designs;
``reset_launch_counts`` zeroes them all); K1's row design launches K3 once
per block row from C, and counts those launches in
``batched_inverse.launches``.  Beside them each wrapper's
``launches_by_shape`` (a ``utils.profiling.Tally``) counts by (design, N,
s, nb, k, dtype): 'chain' and 'rows' for K1, 'schur' for its Schur step,
'k3' and 'k4' for the inverses (nb the block rows of the buffer whose row
they invert, 1 for a batch), 'panels' and 'streamed' for K2 (k its
columns; 0 elsewhere).  A row-design call of K1 counts once under 'rows'
and launches its nb Schur steps and nb K3 under their own keys.
``batched_inverse.resident_by_shape`` counts, under the same keys, the
K3/K4 launches that ran the resident design.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils.profiling import Tally

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
# Pivot-block widths of K3 (the TPU kernel's 13) and K4, and the row
# stride of K3's staged pivot columns (``HF_GJ_ROW``).
GJ_WIDTH = 13
GJ_ROW = 16
# Most thread blocks per matrix of K3/K4 (the portable cluster size), and
# the fewest matrix columns per block worth a split (``gj_cluster``).
GJ_MAX_CLUSTER = 8
GJ_MIN_COLS = 48

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
            "hf_banded_factorize": [p, p, p, i, i, i, i, i, p],
            "hf_banded_factorize_rows": [p, p, p, i, i, i, i, i, i, p],
            "hf_schur_step": [p, p, p, i, i, i, i, p],
            "hf_banded_solve": [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p],
            "hf_banded_solve_stream": [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                       i, i, i, i, p],
            "hf_batched_inverse": [p, i, i, ll, i, i, i, p],
        }
        for stem, argtypes in signatures.items():
            for sfx in ("f32", "f64"):
                fn = getattr(lib, f"{stem}_{sfx}")
                fn.argtypes = argtypes
                fn.restype = i
        for name, argtypes in (
            ("hf_factorize_smem_bytes", [i, i, i]),
            ("hf_schur_smem_bytes", [i, i]),
            ("hf_solve_smem_bytes", [i, i, i, i, i, i]),
            ("hf_stream_smem_bytes", [i, i, i, i, i, i, i, i]),
            ("hf_gj_smem_bytes", [i, i, i, i, i]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ll
        lib.hf_solve_threads_of.argtypes = [i, i, i, i, i]
        lib.hf_solve_threads_of.restype = i
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


def _sm_count(dev) -> int:
    return int(torch.cuda.get_device_properties(dev).multi_processor_count)


# What a thread block takes of its SM's shared memory beyond its request
BLOCK_SMEM_RESERVE = 1024


def _sm_smem(dev) -> int:
    """Shared memory of one SM: what one block may opt into, and its
    reserve, where the device properties do not name it."""
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_multiprocessor",
                       _smem_limit(dev) + BLOCK_SMEM_RESERVE))


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
    banded_factorize.launches_by_design = {"chain": 0, "rows": 0}
    schur_step_.launches = 0
    banded_solve.launches = 0
    banded_solve.launches_by_design = {"panels": 0, "streamed": 0}
    batched_inverse.launches = 0
    batched_inverse.rank1_launches = 0
    for fn in (banded_factorize, schur_step_, banded_solve, batched_inverse):
        fn.launches_by_shape.clear()
    batched_inverse.resident_by_shape.clear()


def _shape_key(design: str, N: int, s: int, nb: int, k: int, dtype) -> tuple:
    """A key of ``launches_by_shape``."""
    return (design, int(N), int(s), int(nb), int(k), str(dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# K3/K4: batched Gauss-Jordan inverse
# ---------------------------------------------------------------------------


def gj_cluster(n: int, s: int, sm_count: int) -> int:
    """Thread blocks per matrix of K3/K4 for n matrices of s x s on a card
    of ``sm_count`` SMs: the largest c with n c <= 3/4 sm_count and
    c <= s / GJ_MIN_COLS, at most GJ_MAX_CLUSTER, at least 1.

    Measured on the H100 (``PERF.md``): the cluster scheduler places a
    cluster's blocks inside one GPC, so well before n c reaches the SM count
    some blocks share an SM or wait for a second wave, and the matrix takes
    as long as its slowest block (16 matrices of s=516 ran slower at c=8
    than at 6); and below about GJ_MIN_COLS columns per block the
    per-step costs every block pays (staging all pivot columns, the pivot
    inverse, two cluster barriers) outweigh the split (s=65: c=1).  At
    every K3 shape of the lanes (K1's rows, each cyclic-reduction level of
    the structured prior, the helmholtz Schur complements) the c it picks
    above 1 measured faster than c=1.

    At that c, ``gj_resident`` picks where the matrix lives: in the
    cluster's shared memory (each block holds its own columns for the
    whole inverse) where they fit beside the staging, else in L2 (every
    step a pass over the output buffer)."""
    return max(1, min(GJ_MAX_CLUSTER, 3 * sm_count // (4 * max(n, 1)),
                      s // GJ_MIN_COLS))


def gj_slices(s: int, c: int):
    """The column ranges [lo, hi) that the c blocks of a K3/K4 cluster own:
    rank r takes the 32-column chunks [r m / c, (r + 1) m / c) of the
    m = ceil(s / 32) of a row (possibly none)."""
    m = -(-s // 32)
    return [(min(s, 32 * (r * m // c)), min(s, 32 * ((r + 1) * m // c)))
            for r in range(c)]


def gj_res_ld(s: int, c: int) -> int:
    """Row length of the resident design's own columns in shared memory
    (the mirror of ``hf_gj_res_ld``): the most whole 32-column chunks a
    block of a cluster of c owns."""
    return 32 * -(-(-(-s // 32)) // c)


def gj_own_cols(s: int, c: int) -> int:
    """Columns one block of a K3/K4 cluster of c owns at most (the mirror
    of ``hf_gj_own_cols``)."""
    return min(s, gj_res_ld(s, c))


def gj_smem_bytes(s: int, w: int, c: int, itemsize: int, resident: bool) -> int:
    """Shared memory of one K3/K4 block (the mirror of ``hf_gj_smem_elems``):
    the staged pivot columns (s x GJ_ROW) and P^-1 (w x GJ_ROW); the L2
    design adds the own pivot rows before and after a step (w x own
    columns each), the resident design the new pivot rows and the own
    columns of the matrix, in rows of ``gj_res_ld``."""
    elems = GJ_ROW * (s + w)
    if resident:
        elems += (w + s) * gj_res_ld(s, c)
    else:
        elems += 2 * w * gj_own_cols(s, c)
    return elems * itemsize


def gj_resident(s: int, c: int, itemsize: int, limit: int) -> bool:
    """Whether K3/K4 on matrices of s x s in clusters of c keeps each
    matrix resident in the cluster's shared memory: where a block's
    footprint in that design (at pivot width GJ_WIDTH, for K4 too) fits
    ``limit`` bytes.  Else the L2 design.  On the H100 (232448 bytes) every
    float32 shape of the lanes up to (32, 258) at c=3 (121408 bytes) and
    the prior's (96, 193) at c=1 (197760) is resident; helmholtz's
    (16, 516) at c=6 (236992 bytes, float64 473984), (32, 258) float64
    (242816) and (96, 193) float64 (395520) are not.  Measured on the H100
    (``PERF.md``), the resident design was the faster at every shape it
    takes.  A c the kernel refuses (outside 1 to GJ_MAX_CLUSTER) gives
    False, and its launch raises."""
    return (1 <= c <= GJ_MAX_CLUSTER
            and gj_smem_bytes(s, GJ_WIDTH, c, itemsize, True) <= limit)


def _pivot_block_inverse(P):
    """(N, w, w) -> P^-1 by w rank-1 Gauss-Jordan steps on [P | I]."""
    N, wp, _ = P.shape
    aug = torch.cat(
        [P, torch.eye(wp, dtype=P.dtype, device=P.device).expand(N, wp, wp)],
        dim=2,
    )
    for k in range(wp):
        row = aug[:, k : k + 1, :] / aug[:, k : k + 1, k : k + 1]
        col = aug[:, :, k : k + 1].clone()
        col[:, k] = 0.0
        aug = aug - col * row
        aug[:, k : k + 1] = row
    return aug[:, :, wp:]


def batched_inverse_plain(X, w: int = GJ_WIDTH, slices: int = 1):
    """Plain PyTorch Gauss-Jordan inverse without pivoting, in pivot blocks
    of width w (the algorithm of the JAX package's ``blocked_inverse`` and
    ``_small_gj_inverse``, written in place as K3/K4 run it): per block
    step, the w x w pivot block P is inverted by w rank-1 steps on
    [P | I]; the pivot rows become P^-1 R (P^-1 on the block itself), and
    the other rows X - C P^-1 R with their pivot columns read as zero.

    ``slices`` runs the schedule of a cluster of that many blocks: per
    step, the pivot columns C (P among them) are staged first, then the
    column slices of ``gj_slices`` are updated one after another, those
    that hold pivot columns last.  X (N, s, s) -> (N, s, s)."""
    if slices < 1:
        raise ValueError(f"slices={slices}: at least 1")
    s = X.shape[-1]
    X = X.clone()
    cols = gj_slices(s, slices)
    for kb in range(0, s, w):
        p = slice(kb, min(kb + w, s))
        C = X[:, :, p].clone()
        Pinv = _pivot_block_inverse(C[:, p])
        C[:, p] = 0.0
        owners = [c for c in cols if c[0] < p.stop and kb < c[1]]
        for lo, hi in [c for c in cols if c not in owners] + owners:
            if lo == hi:
                continue
            Rn = Pinv @ X[:, p, lo:hi]
            a, b = max(lo, kb), min(hi, p.stop)
            if a < b:
                Rn[:, :, a - lo : b - lo] = Pinv[:, :, a - kb : b - kb]
                X[:, :, a:b] = 0.0
            X[:, :, lo:hi] -= C @ Rn
            X[:, p, lo:hi] = Rn
    return X


def _inverse_launch(X, n: int, s: int, stride: int, w: int, cluster, resident):
    """K3/K4 on n matrices of s x s at X.data_ptr(), ``stride`` elements
    apart, in place; cluster None takes ``gj_cluster``'s choice, resident
    None ``gj_resident``'s at that cluster."""
    if cluster is None:
        cluster = gj_cluster(n, s, _sm_count(X.device))
    if resident is None:
        resident = gj_resident(s, cluster, X.element_size(), _smem_limit(X.device))
    lib = _library()
    _smem_check("batched_inverse",
                lib.hf_gj_smem_bytes(s, w, cluster, int(resident), X.element_size()),
                X.device, f"s={s} at pivot width {w} in clusters of {cluster}"
                + (" resident" if resident else ""))
    if n == 0 or s == 0:
        return
    _launch(lib, getattr(lib, f"hf_batched_inverse_{_suffix(X.dtype)}"),
            "batched_inverse", X.device, X.data_ptr(), n, s, stride, w, cluster,
            int(resident))
    if w == 1:
        batched_inverse.rank1_launches += 1
    else:
        batched_inverse.launches += 1
    key = _shape_key("k4" if w == 1 else "k3", n, s, stride // (s * s), 0, X.dtype)
    batched_inverse.launches_by_shape.add(key)
    if resident:
        batched_inverse.resident_by_shape.add(key)


def batched_inverse(X, rank1: bool = False, cluster: int | None = None,
                    resident: bool | None = None):
    """K3 (pivot blocks of 13) or, with ``rank1``, K4 (rank-1 updates, the
    JAX package's ``force="pallas_rank1"``).  X (N, s, s) -> X^-1, without
    pivoting: the inputs must not need it (diagonally dominant or SPD
    blocks, and the Schur complements of the helmholtz bands, whose
    identity residuals stay within a few times the pivoted inverse's).

    On the card ``cluster`` forces the thread blocks per matrix (1 to
    GJ_MAX_CLUSTER; the kernel refuses any other); None takes
    ``gj_cluster``'s choice.  ``resident`` forces the design (True: each
    matrix in the cluster's shared memory, ValueError where it does not
    fit; False: in L2); None takes ``gj_resident``'s choice.  Both give the
    same bits.  On the CPU the plain version runs the same schedule with
    ``cluster`` column slices (None: 1) and ``resident`` is not read."""
    w = 1 if rank1 else GJ_WIDTH
    if X.device.type == "cpu":
        return batched_inverse_plain(X, w, 1 if cluster is None else cluster)
    if X.ndim != 3 or X.shape[1] != X.shape[2]:
        raise ValueError(f"batched_inverse: shape {tuple(X.shape)}, want (N, s, s)")
    N, s, _ = X.shape
    _check_cuda("batched_inverse", [X], [X.shape])
    out = X.clone()
    _inverse_launch(out, N, s, s * s, w, cluster, resident)
    return out


def batched_inverse_row_(buf, j: int, cluster: int | None = None,
                         resident: bool | None = None):
    """K3 on block row j of an (N, nb, s, s) buffer, in place: buf[:, j]
    <- buf[:, j]^-1, the other rows untouched (the launch K1's row design
    makes at each block row); ``cluster`` and ``resident`` as in
    ``batched_inverse``.  Returns buf."""
    if buf.device.type == "cpu":
        buf[:, j] = batched_inverse_plain(buf[:, j], GJ_WIDTH,
                                          1 if cluster is None else cluster)
        return buf
    if buf.ndim != 4 or buf.shape[2] != buf.shape[3]:
        raise ValueError(f"batched_inverse_row_: shape {tuple(buf.shape)}, "
                         "want (N, nb, s, s)")
    N, nb, s, _ = buf.shape
    if not 0 <= j < nb:
        raise ValueError(f"batched_inverse_row_: row {j} of {nb}")
    _check_cuda("batched_inverse_row_", [buf], [buf.shape])
    _inverse_launch(buf[:, j], N, s, nb * s * s, GJ_WIDTH, cluster, resident)
    return buf


batched_inverse.launches = 0
batched_inverse.rank1_launches = 0
batched_inverse.launches_by_shape = Tally()
batched_inverse.resident_by_shape = Tally()


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


def schur_step_plain(band, dinv_prev, j: int, rows: int | None = None):
    """The Schur step of K1's row design at block row j in plain PyTorch, on
    its kernel's schedule: row panels of ``rows`` rows (None: one panel).
    band (N, nb, s, 3s), dinv_prev (N, s, s) = Dinv_{j-1} (unused at
    j = 0) -> (M_j, T_j), each (N, s, s), with M_j = A_j Dinv_{j-1} and
    T_j = D_j - M_j B_{j-1}; M_0 = 0, T_0 = D_0."""
    N, nb, s, _ = band.shape
    if not 0 <= j < nb:
        raise ValueError(f"schur_step_plain: row {j} of {nb}")
    D = band[:, j, :, s : 2 * s]
    if j == 0:
        return torch.zeros_like(D), D.clone()
    A, B = band[:, j, :, :s], band[:, j - 1, :, 2 * s :]
    rows = s if rows is None else rows
    if rows < 1:
        raise ValueError(f"schur_step_plain: rows={rows}")
    M, T = torch.empty_like(D), torch.empty_like(D)
    for r0 in range(0, s, rows):
        p = slice(r0, min(r0 + rows, s))
        M[:, p] = A[:, p] @ dinv_prev
        T[:, p] = D[:, p] - M[:, p] @ B
    return M, T


def banded_factorize_rows_plain(band, slices: int = 1, rows: int | None = None):
    """K1's schedule in plain PyTorch (the chain's, and with ``slices`` = c
    the row-panel design's with K3 in clusters of c blocks): per block row,
    the Schur step M_j = A_j Dinv_{j-1}, T_j = D_j - M_j B_{j-1}
    (``schur_step_plain``, in row panels of ``rows`` rows), then the
    blocked Gauss-Jordan inverse of T_j on the column slices of
    ``gj_slices``.  Same result as ``banded_factorize_plain``."""
    N, nb, s, _ = band.shape
    M = torch.zeros((N, nb, s, s), dtype=band.dtype, device=band.device)
    Dinv = torch.empty_like(M)
    for j in range(nb):
        M[:, j], T = schur_step_plain(band, Dinv[:, j - 1] if j else None, j,
                                      rows)
        Dinv[:, j] = batched_inverse_plain(T, GJ_WIDTH, slices)
    return M, Dinv


# K1's chain: outputs per thread of its products (CHAIN_TILE x CHAIN_TILE),
# the row stride of its staged pivot columns, and its most threads a block
# (csrc/banded_factorize.cu, csrc/common.cuh)
CHAIN_TILE = 4
CHAIN_GJ_ROW = 16
CHAIN_MAX_THREADS = 640


def chain_ld(s: int, itemsize: int, padded: bool = True) -> int:
    """Row stride, in elements, of a shared-memory tile of K1's chain with
    s columns: whole 4-column product tiles in whole 16-byte vectors, and
    (``padded``) an odd number of vectors, so that a walk down a column
    spreads over the banks (s = 64 or 96 like s = 65)."""
    vec = 16 // itemsize
    q = -(-s // CHAIN_TILE) * CHAIN_TILE // vec
    if padded and q % 2 == 0:
        q += 1
    return q * vec


def chain_smem_elems(s: int, ld: int) -> int:
    """Shared-memory elements of one block of K1's chain (the mirror of
    ``hf_factorize_smem_elems``): the Dinv_{j-1}, T_j and B_{j-1} tiles
    and the M_j tile, which the Gauss-Jordan scratch overlays."""
    scratch = 2 * CHAIN_GJ_ROW * s + CHAIN_GJ_ROW * GJ_WIDTH + GJ_WIDTH * ld
    return 3 * s * ld + max(s * ld, scratch)


def chain_geometry(s: int, itemsize: int, limit: int):
    """(ld, bytes) of K1's chain at block size s under a shared-memory
    limit in bytes: the tiles' row stride and the block's shared memory;
    the padded stride where it fits, else the unpadded; None where neither
    fits.  On the H100 (232448 bytes) the chain fits s <= 120 in float32
    (70720 bytes at s=65: three blocks per SM) and s <= 84 in float64."""
    for padded in (True, False):
        ld = chain_ld(s, itemsize, padded)
        need = chain_smem_elems(s, ld) * itemsize
        if need <= limit:
            return ld, need
    return None


def chain_threads(n: int, s: int, sm_count: int, need: int, sm_smem: int) -> int:
    """Threads per block of K1's chain for n samples, each block asking
    ``need`` bytes of shared memory on SMs that have ``sm_smem``.  A block
    has one 4 x 4 product tile per thread (in whole warps) where that is
    possible:

    * every block has an SM to itself (n <= SMs): at least 256 threads,
      because the Gauss-Jordan phases are latency-bound and want warps,
      at most CHAIN_MAX_THREADS;
    * more than two blocks per SM, and shared memory lets three share one
      (float32 at s <= 65): half the tiles' threads, in 64s, so that
      registers let them;
    * else the tiles' threads, at most CHAIN_MAX_THREADS / 2 (two passes
      above that).

    The rule follows a sweep of 64 to 640 threads at the lanes' shapes
    (``ops/chain_threads_sweep.py``; ``PERF.md`` has its times)."""
    tiles = (-(-s // CHAIN_TILE)) ** 2
    full = 32 * -(-tiles // 32)
    if n <= sm_count:
        return min(CHAIN_MAX_THREADS, max(256, full))
    if n > 2 * sm_count and sm_smem // (need + BLOCK_SMEM_RESERVE) >= 3:
        return max(64, 64 * -(-tiles // 128))
    return min(CHAIN_MAX_THREADS // 2, max(64, full))


# K1's row-panel Schur step (csrc/banded_factorize.cu, csrc/common.cuh):
# rows of a panel (and of a thread's tile of outputs), columns a warp
# covers, and the most threads a block
SCHUR_ROWS = 8
SCHUR_GROUP_COLS = 128
SCHUR_MAX_THREADS = 512


def schur_smem_bytes(s: int, itemsize: int) -> int:
    """Shared memory of one Schur-step block (the mirror of
    ``hf_schur_smem_bytes``): the panel, transposed, rows of SCHUR_ROWS +
    4."""
    return s * (SCHUR_ROWS + 4) * itemsize


def schur_geometry(s: int, itemsize: int, smem: int):
    """(threads, bytes) of one block of K1's Schur step at block size s on
    a card with ``smem`` bytes of shared memory a block: a warp per
    SCHUR_GROUP_COLS columns (the mirror of ``hf_schur_threads``) and the
    transposed panel.  Raises ValueError where the kernel does not take s,
    before any launch."""
    threads = 32 * -(-s // SCHUR_GROUP_COLS)
    need = schur_smem_bytes(s, itemsize)
    if not (s >= 1 and threads <= SCHUR_MAX_THREADS and need <= smem):
        raise ValueError(
            f"banded_factorize: the Schur step of s={s} does not fit: "
            f"{threads} threads (at most {SCHUR_MAX_THREADS}) and {need} "
            f"bytes of the card's {smem} of shared memory per block")
    return threads, need


def schur_step_(band, M, Dinv, j: int):
    """K1's Schur step alone at block row j, in place, as the row design
    runs it before K3: M[:, j] <- A_j Dinv[:, j - 1] and Dinv[:, j] <-
    D_j - M_j B_{j-1} (M_0 = 0, T_0 = D_0); the other rows untouched.
    band (N, nb, s, 3s); M, Dinv (N, nb, s, s).  On the CPU the plain
    version runs the kernel's panels of SCHUR_ROWS rows.  Returns (M,
    Dinv)."""
    if band.device.type == "cpu":
        M[:, j], Dinv[:, j] = schur_step_plain(
            band, Dinv[:, j - 1] if j > 0 else None, j, SCHUR_ROWS)
        return M, Dinv
    if band.ndim != 4 or band.shape[-1] != 3 * band.shape[-2]:
        raise ValueError(f"band shape {tuple(band.shape)}, want (N, nb, s, 3s)")
    N, nb, s, _ = band.shape
    if not 0 <= j < nb:
        raise ValueError(f"schur_step_: row {j} of {nb}")
    _check_cuda("schur_step_", [band, M, Dinv],
                [band.shape, (N, nb, s, s), (N, nb, s, s)])
    dev = band.device
    schur_geometry(s, band.element_size(), _smem_limit(dev))
    if N == 0:
        return M, Dinv
    lib = _library()
    _launch(lib, getattr(lib, f"hf_schur_step_{_suffix(band.dtype)}"),
            "schur_step_", dev, band.data_ptr(), M.data_ptr(), Dinv.data_ptr(),
            N, nb, s, j)
    schur_step_.launches += 1
    schur_step_.launches_by_shape.add(_shape_key("schur", N, s, nb, 0, band.dtype))
    return M, Dinv


schur_step_.launches = 0
schur_step_.launches_by_shape = Tally()


def factorize_design(s: int, itemsize: int, limit: int,
                     design: str | None = None):
    """(design, chain geometry or None) that ``banded_factorize`` takes at
    block size s under a shared-memory limit in bytes: ``design`` as given,
    else the chain where its tiles fit, else the rows.  Raises ValueError
    for a chain whose tiles do not fit.

    Measured on the H100 (``PERF.md``, ms, float32 / float64): wherever
    the chain fits it is the faster design: N=256, s=65 2.73 / 6.29
    against the rows' 10.42 / 16.57; N=32, s=97 5.79 against 10.81; s=49
    1.02 / 1.55 against 2.67 / 3.05; s=25 0.27 / 0.34 against 0.63 / 0.68;
    N=1024, s=33 1.66 / 3.45 against 7.90 / 11.23; s=17 0.34 / 0.46
    against 2.08 / 2.48."""
    if design not in (None, "chain", "rows"):
        raise ValueError(f"design={design!r}: 'chain', 'rows' or None")
    geometry = None if design == "rows" else chain_geometry(s, itemsize, limit)
    if design == "chain" and geometry is None:
        raise ValueError(
            f"banded_factorize: the chain at s={s} needs more than the "
            f"card's {limit} bytes of shared memory per block")
    return ("rows" if geometry is None else "chain"), geometry


def banded_factorize(band, design: str | None = None):
    """K1.  band (N, nb, s, 3s) -> (M, Dinv), each (N, nb, s, s).

    On the card, ``design`` 'chain' (one thread block per sample runs the
    whole row chain in shared memory; s whose tiles fit: s <= 120 in
    float32, 84 in float64) or 'rows' (a Schur-step launch and a K3 launch
    per block row, in clusters of ``gj_cluster(N, s, SMs)`` blocks per
    matrix, in the design ``gj_resident`` picks; any s up to the row
    panels' shared memory); None takes what
    ``factorize_design`` picks: the chain where it fits, which is where it
    measured faster."""
    if band.device.type == "cpu":
        return banded_factorize_plain(band)
    if band.ndim != 4 or band.shape[-1] != 3 * band.shape[-2]:
        raise ValueError(f"band shape {tuple(band.shape)}, want (N, nb, s, 3s)")
    N, nb, s, _ = band.shape
    _check_cuda("banded_factorize", [band], [band.shape])
    dev, item = band.device, band.element_size()
    design, geometry = factorize_design(s, item, _smem_limit(dev), design)
    lib = _library()
    if design == "chain":
        ld, need = geometry
        _smem_check("banded_factorize", lib.hf_factorize_smem_bytes(s, ld, item),
                    dev, f"the chain at s={s}")
        args = (ld, chain_threads(N, s, _sm_count(dev), need, _sm_smem(dev)))
    else:
        cluster = gj_cluster(N, s, _sm_count(dev))
        resident = gj_resident(s, cluster, item, _smem_limit(dev))
        schur_geometry(s, item, _smem_limit(dev))
        _smem_check("banded_factorize",
                    lib.hf_gj_smem_bytes(s, GJ_WIDTH, cluster, int(resident), item),
                    dev, f"the row-panel inverse at s={s}")
        args = (GJ_WIDTH, cluster, int(resident))
    M = torch.empty((N, nb, s, s), dtype=band.dtype, device=dev)
    Dinv = torch.empty_like(M)
    if N == 0 or nb == 0:
        return M, Dinv
    stem = "hf_banded_factorize" + ("" if design == "chain" else "_rows")
    _launch(lib, getattr(lib, f"{stem}_{_suffix(band.dtype)}"),
            "banded_factorize", dev, band.data_ptr(), M.data_ptr(),
            Dinv.data_ptr(), N, nb, s, *args)
    banded_factorize.launches += 1
    banded_factorize.launches_by_design[design] += 1
    banded_factorize.launches_by_shape.add(
        _shape_key(design, N, s, nb, 0, band.dtype))
    if design == "rows":  # a Schur step and a K3 launch per block row
        schur_step_.launches += nb
        batched_inverse.launches += nb
        schur_step_.launches_by_shape.add(
            _shape_key("schur", N, s, nb, 0, band.dtype), nb)
        key = _shape_key("k3", N, s, nb, 0, band.dtype)
        batched_inverse.launches_by_shape.add(key, nb)
        if resident:
            batched_inverse.resident_by_shape.add(key, nb)
    return M, Dinv


banded_factorize.launches = 0
banded_factorize.launches_by_design = {"chain": 0, "rows": 0}
banded_factorize.launches_by_shape = Tally()


# ---------------------------------------------------------------------------
# K2: banded back-solve
# ---------------------------------------------------------------------------


def stream_slabs(s: int, c: int):
    """The row ranges [lo, hi) of every factor block that the c blocks of a
    cluster of K2's streamed design own: rank r takes [r s / c,
    (r + 1) s / c), a contiguous run of memory."""
    return [(r * s // c, (r + 1) * s // c) for r in range(c)]


def banded_solve_plain(M, Dinv, B, bb, trans: bool, slices: int = 1,
                       column_tiles: int = 1, lsplit: int = 1):
    """Plain PyTorch back-solve through (M, Dinv, B), each (N, nb, s, s);
    bb (N, nb, s, k) -> x (N, nb, s, k) with A x = b, or A^T x = b.

    ``slices`` runs the schedule of a cluster of that many blocks of the
    streamed design: every product is formed slab by slab over the row
    ranges of ``stream_slabs``: H v as the rows of each slab in turn,
    H^T v as the partial sums over each slab's rows, added up.
    ``column_tiles`` and ``lsplit`` run the panel design's: the column
    tiles of ``column_split`` one after another, every product the sum of
    its partial products over ``lsplit`` slices of its inner index (the
    ranges of ``stream_slabs``), added in order."""
    nb, s, k = M.shape[1], M.shape[-1], bb.shape[-1]
    if not 1 <= slices <= max(s, 1):
        raise ValueError(f"slices={slices}: from 1 to s={s}")
    if not 1 <= lsplit <= max(s, 1) or (lsplit > 1 and slices > 1):
        raise ValueError(f"lsplit={lsplit}: from 1 to s={s}, and slices=1")
    if not 1 <= column_tiles <= max(k, 1):
        raise ValueError(f"column_tiles={column_tiles}: from 1 to k={k}")
    if column_tiles > 1:
        return torch.cat([banded_solve_plain(M, Dinv, B, bb[..., lo:hi], trans,
                                             slices, 1, lsplit)
                          for lo, hi in column_split(k, column_tiles)], dim=-1)
    slabs = stream_slabs(s, max(slices, lsplit))

    def mul(H, v):  # H v
        if slices == 1 and lsplit == 1:
            return H @ v
        if lsplit > 1:
            return sum(H[..., lo:hi] @ v[:, lo:hi] for lo, hi in slabs)
        return torch.cat([H[:, lo:hi] @ v for lo, hi in slabs], dim=1)

    def mul_t(H, v):  # H^T v
        if slices == 1 and lsplit == 1:
            return H.mT @ v
        return sum(H[:, lo:hi].mT @ v[:, lo:hi] for lo, hi in slabs)

    xs = [None] * nb
    if not trans:
        ys = [bb[:, 0]]
        for j in range(1, nb):
            ys.append(bb[:, j] - mul(M[:, j], ys[-1]))
        xs[-1] = mul(Dinv[:, -1], ys[-1])
        for j in range(nb - 2, -1, -1):
            xs[j] = mul(Dinv[:, j], ys[j] - mul(B[:, j], xs[j + 1]))
        return torch.stack(xs, dim=1)
    zs = [mul_t(Dinv[:, 0], bb[:, 0])]
    for j in range(1, nb):
        zs.append(mul_t(Dinv[:, j], bb[:, j] - mul_t(B[:, j - 1], zs[-1])))
    xs[-1] = zs[-1]
    for j in range(nb - 2, -1, -1):
        xs[j] = zs[j] - mul_t(M[:, j + 1], xs[j + 1])
    return torch.stack(xs, dim=1)


# K2 streams its factor blocks through shared-memory panels from this many
# rhs columns (the Jacobian's 100 and 200); below it (the Newton and forward
# solves' 1) the streamed design draws each sample's factor once through a
# ring of stages, in clusters of thread blocks; measured on the H100 at
# s=65 and s=193
PANELS_MIN_K = 8
# The panel design (csrc/common.cuh): columns of a thread's register tile,
# its rows (the kernel's two templates), the most threads of a block, the
# multiple of 8 rows a panel has, and the most blocks that share an SM
# (the kernel's launch bounds keep two within the registers)
SOLVE_COL_TILE = 4
SOLVE_ROW_TILES = (4, 8)
SOLVE_MAX_THREADS = 512
PANEL_ROW_STEP = 8
PANEL_MAX_SHARE = 2
# The panel design's rule (``panel_geometry``): the threads of a block it
# prefers (8 warps) and the fewest rows of a panel it takes where a wider
# one fits at more column tiles
SOLVE_GOOD_THREADS = 256
PANEL_MIN_ROWS = 16
# The streamed design (csrc/common.cuh): most columns of a tile, blocks of a
# cluster, stages of a ring and warps of a block (in a cluster, and on its
# own); the bytes of its ring barriers and chunk offsets; the most bytes of
# one ring stage; and the fewest rows of a factor block per cluster rank
# worth a split (``stream_cluster``)
STREAM_MAX_COLS = 7
STREAM_MAX_CLUSTER = 8
STREAM_MAX_STAGES = 16
STREAM_MAX_WARPS = 18
STREAM_MAX_WARPS_ONE = 16
STREAM_BAR_BYTES = 320
STREAM_STAGE_BYTES = 65536
STREAM_MIN_ROWS = 32


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def stream_cluster(blocks: int, s: int, sm_count: int) -> int:
    """Thread blocks per sample of K2's streamed design for ``blocks``
    (sample, column tile) pairs of block size s on a card of ``sm_count``
    SMs: the largest c with blocks c <= 3/4 sm_count and at least
    STREAM_MIN_ROWS rows of a factor block per rank, at most
    STREAM_MAX_CLUSTER, at least 1."""
    return max(1, min(STREAM_MAX_CLUSTER, 3 * sm_count // (4 * max(blocks, 1)),
                      s // STREAM_MIN_ROWS))


def stream_carry_elems(s: int, kt: int, c: int, rsplit: int, trans: bool) -> int:
    """Elements of a streamed block's carry region (the mirror of
    ``hf_stream_carry_elems``)."""
    full, slab = s * kt, -(-s // c) * kt
    if trans:
        return full * (1 + rsplit) + 2 * c * slab + 3 * slab
    return 2 * full + 3 * slab


def stream_smem_bytes(s: int, kt: int, c: int, rows: int, nstage: int,
                      rsplit: int, trans: bool, itemsize: int) -> int:
    """Shared memory of one streamed block (the mirror of
    ``hf_stream_smem_bytes``): the ring's barriers, the carry region and
    ``nstage`` stages of ``rows`` factor rows."""
    return (STREAM_BAR_BYTES
            + _round16(stream_carry_elems(s, kt, c, rsplit, trans) * itemsize)
            + nstage * (_round16(rows * s * itemsize) + 16))


def stream_lanes(s: int, rows: int, wmax: int, share: int) -> int:
    """Lanes that take one row of a forward product of K2's streamed
    design, for chunks of ``rows`` rows on ``wmax`` warps where ``share``
    blocks share an SM: a power of two, at most a warp; about s / 16, so
    that a lane meets its part of a row in two batches of loads and the
    shuffle tree stays short; halved while a chunk's rows need more lanes
    than the block's share of an SM's 32 wmax (a second pass over the
    warps for a few rows costs more than longer parts, and where blocks
    share an SM what they all execute, not one block's latency, sets the
    time).  Fitted to ``ops/stream_solve_sweep.py --lanes``."""
    lanes = 1 << max(0, min(5, (-(-s // 16) - 1).bit_length()))
    while lanes > 1 and rows * lanes > 32 * wmax // share:
        lanes //= 2
    return lanes


def stream_splits(groups: int, wmax: int, rows: int) -> int:
    """Row splits of a transposed product of K2's streamed design whose
    outputs fill ``groups`` warps, on ``wmax`` warps and chunks of ``rows``
    rows: the warps left over split a chunk's rows, 4 ways at most where
    the outputs fill one or two warps and 2 ways above, and no thinner
    than 6 rows a split (more warps cost more at the block's barriers than
    their shorter parts save).  Fitted to ``ops/stream_solve_sweep.py
    --splits``."""
    return max(1, min(wmax // groups, 4 if groups <= 2 else 2, rows // 6))


@functools.lru_cache(maxsize=None)
def stream_geometry(blocks: int, s: int, kt: int, itemsize: int, c: int,
                    trans: bool, sm_count: int, limit: int, sm_smem: int):
    """(rows per stage, stages, threads, row splits, lanes per row, bytes)
    of K2's streamed design for ``blocks`` (sample, column tile) pairs in
    clusters of c, or None where not even two one-row stages fit ``limit``
    bytes.

    Where the grid has more blocks than the card SMs, as many blocks as it
    takes for one wave (at most 8) share an SM's shared memory and threads.
    A stage holds at most STREAM_STAGE_BYTES, in equal chunks of a rank's
    slab; the ring takes what shared memory is left, up to
    STREAM_MAX_STAGES.  One warp feeds the ring; of the others, transposed,
    each owns 32 columns (17 warps at s=516 in a cluster; a block on its own
    has at most 15 and takes them in two passes) and those left split the
    rows; forward, a group of ``stream_lanes`` lanes takes a row."""
    slab, groups = -(-s // c), -(-s // 32)
    for share in range(max(1, min(8, -(-blocks * c // sm_count))), 0, -1):
        budget = min(limit, sm_smem // share - BLOCK_SMEM_RESERVE)
        # warps that compute, beside the one that feeds the ring
        wmax = min(16 if c > 1 else 15, 32 // share - 1)
        rows = max(1, min(slab, (STREAM_STAGE_BYTES - 16) // (s * itemsize)))
        rows = -(-slab // -(-slab // rows))
        while True:
            rsplit = stream_splits(groups, wmax, rows) if trans else 1
            fgroup = stream_lanes(s, rows, wmax, share)
            if trans:
                warps = min(groups * rsplit,
                            STREAM_MAX_WARPS - 1 if share == 1 and c > 1 else wmax)
            else:
                warps = min(wmax, -(-rows * fgroup // 32))
            nstage = min(
                STREAM_MAX_STAGES,
                (budget - stream_smem_bytes(s, kt, c, rows, 0, rsplit, trans,
                                            itemsize))
                // (_round16(rows * s * itemsize) + 16))
            if nstage >= (2 if share == 1 else 3):
                return (rows, nstage, 32 * (warps + 1), rsplit, fgroup,
                        stream_smem_bytes(s, kt, c, rows, nstage, rsplit, trans,
                                          itemsize))
            if rows == 1:
                break
            rows = -(-rows // 2)
    return None


def column_split(k: int, tiles: int):
    """The column ranges [lo, hi) of K2's panel design at k columns in
    ``tiles`` tiles: widths that differ by at most one."""
    return [(y * k // tiles, (y + 1) * k // tiles) for y in range(tiles)]


def solve_tile_cols(k: int, tiles: int) -> int:
    """Columns of the widest tile of ``column_split``, padded to whole
    register tiles (the mirror of ``hf_solve_tile_cols``)."""
    return -(-(-(-k // tiles)) // SOLVE_COL_TILE) * SOLVE_COL_TILE


def panel_row_options(s: int):
    """The panel widths of K2's panel design at block size s, widest
    first: for each number of panels the fewest rows (a multiple of
    PANEL_ROW_STEP) that cover s, where the rows past s are at most s / 8;
    where no width keeps to that (s < 64), those of the fewest rows past
    s."""
    step = PANEL_ROW_STEP
    widths = sorted({step * -(-(-(-s // n)) // step) for n in range(1, s + 1)},
                    reverse=True)
    past = {w: -(-s // w) * w - s for w in widths}
    least = min(past.values())
    keep = [w for w in widths if 8 * past[w] <= s]
    return keep or [w for w in widths if past[w] == least]


def solve_threads(k: int, tiles: int, rows: int, row_tile: int, lsplit: int) -> int:
    """Threads of one block of K2's panel design (the mirror of
    ``hf_solve_threads``): one per output tile of a panel and slice of the
    inner index, in whole warps."""
    work = rows // row_tile * (solve_tile_cols(k, tiles) // SOLVE_COL_TILE) * lsplit
    return 32 * -(-work // 32)


def solve_smem_bytes(s: int, k: int, tiles: int, rows: int, lsplit: int,
                     itemsize: int) -> int:
    """Shared memory of one block of K2's panel design (the mirror of
    ``hf_solve_smem_bytes``): the panel, the carry twice, the slices'
    partial sums."""
    kp = solve_tile_cols(k, tiles)
    return (s * rows + 2 * s * kp + lsplit * rows * kp) * itemsize


def panel_lsplit(s: int, k: int, tiles: int, rows: int, row_tile: int) -> int:
    """Slices of the inner index of K2's panel design: as many as the
    block's threads take (at most SOLVE_MAX_THREADS, one per output tile
    and slice), no slice shorter than 16 indices; 0 where the output tiles
    of one panel alone need more threads."""
    tiles_out = rows // row_tile * (solve_tile_cols(k, tiles) // SOLVE_COL_TILE)
    return min(SOLVE_MAX_THREADS // tiles_out, max(1, s // 16))


PanelGeometry = collections.namedtuple(
    "PanelGeometry", "tiles rows row_tile lsplit threads smem_bytes share")


@functools.lru_cache(maxsize=None)
def panel_geometry(n: int, s: int, k: int, itemsize: int, sm_count: int,
                   limit: int, sm_smem: int, tiles: int | None = None,
                   rows: int | None = None, row_tile: int | None = None,
                   lsplit: int | None = None):
    """The geometry of K2's panel design for n samples of block size s and
    k rhs columns on a card of ``sm_count`` SMs with ``limit`` bytes of
    shared memory a block and ``sm_smem`` an SM: (column tiles, panel rows,
    register-tile rows, slices of the inner index, threads, bytes, blocks
    that share an SM), or None where nothing fits.  ``tiles``, ``rows``,
    ``row_tile`` and ``lsplit`` force their part (rows must be a multiple
    of PANEL_ROW_STEP, row_tile one of SOLVE_ROW_TILES, lsplit at most what
    ``panel_lsplit`` allows).

    Each block reads its sample's whole factor whatever its columns, so
    more tiles cost L2 reads, and nothing overlaps a panel's fill but
    another block's products.  The rule, fitted to
    ``ops/panel_solve_sweep.py`` at the lanes' shapes (``PERF.md``):
    the fewest column tiles from sm_count // n (at least 1: one block for
    each SM, two waves cost twice) at which a panel of at least
    PANEL_MIN_ROWS rows fits (float64 at s=516: 13, not 10 with 8-row
    panels); there, of the geometries of ``panel_fits`` (every slice count
    that fits), those with SOLVE_GOOD_THREADS threads where any has, then
    the most blocks an SM up to what the grid puts on one, the widest
    panel, the register tile that does not spill (8 rows in float32, 4 in
    float64: 312 bytes of spills at 8), and the most slices."""
    if not (1 <= k and 1 <= s):
        return None
    base = min(k, max(1, sm_count // max(n, 1)))
    first = None
    for t in [tiles] if tiles is not None else range(base, k + 1):
        if not 1 <= t <= k:
            continue
        pick = _panel_fit(s, k, t, itemsize, limit, sm_smem, rows, row_tile,
                          lsplit, -(-n * t // sm_count))
        if pick is not None and (pick.rows >= PANEL_MIN_ROWS or tiles is not None):
            return pick
        first = first or pick
    return first


def panel_fits(s, k, t, itemsize, limit, sm_smem, r_opts=None, rt_opts=None,
               lsplit=None):
    """Every geometry of K2's panel design at t column tiles that fits one
    block under ``limit`` (panel rows of ``r_opts``, register tiles of
    ``rt_opts``, the slices of ``panel_lsplit`` halved until the block
    fits, or ``lsplit``), each with the blocks that share an SM
    (PANEL_MAX_SHARE where ``sm_smem`` holds them)."""
    fits = []
    for r in panel_row_options(s) if r_opts is None else r_opts:
        for rt in SOLVE_ROW_TILES if rt_opts is None else rt_opts:
            if r < PANEL_ROW_STEP or r % PANEL_ROW_STEP or rt not in SOLVE_ROW_TILES:
                continue
            most = panel_lsplit(s, k, t, r, rt)
            ls = most if lsplit is None else lsplit
            if not 1 <= ls <= min(max(most, 1), s):
                continue
            while ls >= 1:
                need = solve_smem_bytes(s, k, t, r, ls, itemsize)
                if need <= limit:
                    share = max(1, min(PANEL_MAX_SHARE,
                                       sm_smem // (need + BLOCK_SMEM_RESERVE)))
                    fits.append(PanelGeometry(t, r, rt, ls,
                                              solve_threads(k, t, r, rt, ls),
                                              need, share))
                    break
                ls = ls // 2 if lsplit is None else 0
    return fits


def _panel_fit(s, k, t, itemsize, limit, sm_smem, rows, row_tile, lsplit,
               waves):
    """The geometry ``panel_geometry`` takes at t column tiles (``rows``,
    ``row_tile``, ``lsplit`` forced where given) for a grid of ``waves``
    blocks an SM, or None."""
    fits = []
    for ls in [lsplit] if lsplit is not None else range(1, max(1, s // 16) + 1):
        fits += panel_fits(s, k, t, itemsize, limit, sm_smem,
                           None if rows is None else [rows],
                           None if row_tile is None else [row_tile], ls)
    if not fits:
        return None
    good = min(SOLVE_GOOD_THREADS, max(g.threads for g in fits))
    tall = SOLVE_ROW_TILES[-1] if itemsize == 4 else SOLVE_ROW_TILES[0]
    return max(fits, key=lambda g: (g.threads >= good, min(g.share, waves),
                                    g.rows, g.row_tile == tall, g.lsplit))


def solve_tiles(n: int, s: int, k: int, itemsize: int, sm_count: int,
                limit: int, sm_smem: int, panels: bool | None = None):
    """(panel rows, column tiles) of K2 for n samples, s and k: the panel
    design (panels=None: from k >= PANELS_MIN_K) as ``panel_geometry``
    picks it; the streamed design (panel rows 0) the widest column tile,
    up to STREAM_MAX_COLS, whose transposed solve fits in one block per
    sample, as (0, column tile).  None when nothing fits."""
    if panels is None:
        panels = k >= PANELS_MIN_K
    if not panels:
        for kt in range(max(1, min(STREAM_MAX_COLS, k)), 0, -1):
            rsplit = stream_splits(-(-s // 32), 15, s)
            if stream_smem_bytes(s, kt, 1, 1, 2, rsplit, True, itemsize) <= limit:
                return 0, kt
        return None
    geo = panel_geometry(n, s, k, itemsize, sm_count, limit, sm_smem)
    return None if geo is None else (geo.rows, geo.tiles)


def banded_solve(M, Dinv, B, bb, trans: bool, tiles=None,
                 cluster: int | None = None):
    """K2.  M, Dinv, B (N, nb, s, s); bb (N, nb, s, k) -> x (N, nb, s, k)
    with A x = b (trans=False) or A^T x = b (trans=True).  On the card,
    ``tiles`` forces a design: (0, column tile) the streamed one (a column
    tile of at most STREAM_MAX_COLS); (panel rows, column tiles) or (panel
    rows, column tiles, register-tile rows[, slices]) the panel one, the k
    columns split into that many tiles whose widths differ by at most one
    (``column_split``), with panels of that many rows (a multiple of
    PANEL_ROW_STEP), register tiles of SOLVE_ROW_TILES rows (unset: as the
    rule takes them) and that many slices of the inner index (unset: as
    the rule takes them); a geometry that does not fit raises ValueError.
    None takes the streamed design below PANELS_MIN_K columns and
    ``panel_geometry``'s choice from it.  ``cluster`` forces
    the thread blocks per sample of the streamed design (1 to
    STREAM_MAX_CLUSTER; the kernel refuses others, and the panel design
    takes none); None takes ``stream_cluster``'s choice.  On the CPU the
    plain version runs the products in ``cluster`` slabs (None: 1)."""
    if bb.device.type == "cpu":
        return banded_solve_plain(M, Dinv, B, bb, trans,
                                  1 if cluster is None else cluster)
    if M.ndim != 4 or bb.ndim != 4:
        raise ValueError("banded_solve takes 4-d factor blocks and rhs")
    N, nb, s, _ = M.shape
    k = bb.shape[-1]
    fac = (N, nb, s, s)
    _check_cuda("banded_solve", [bb, M, Dinv, B], [(N, nb, s, k), fac, fac, fac])
    lib = _library()
    dev = bb.device
    item, limit = bb.element_size(), _smem_limit(dev)
    if tiles is None:
        tiles = solve_tiles(N, s, k, item, _sm_count(dev), limit, _sm_smem(dev))
        if tiles is None:
            raise ValueError(
                f"banded_solve: no panel and column tile of s={s}, k={k} fits "
                f"the card's {limit} bytes of shared memory per block"
            )
    tiles = tuple(tiles)
    if not (len(tiles) in (2, 3, 4) and tiles[0] >= 0 and tiles[1] >= 1
            and (tiles[0] > 0 or len(tiles) == 2)):
        raise ValueError(f"banded_solve: tiles={tiles!r}")
    rows = tiles[0]
    if rows == 0 and tiles[1] > STREAM_MAX_COLS:
        raise ValueError(f"banded_solve: tiles={tiles!r}: the streamed design "
                         f"takes column tiles of at most {STREAM_MAX_COLS}")
    if rows > 0 and cluster is not None:
        raise ValueError("banded_solve: cluster= belongs to the streamed "
                         f"design, not to tiles={tiles!r}")
    out = torch.empty_like(bb)
    args = (M.data_ptr(), Dinv.data_ptr(), B.data_ptr(), bb.data_ptr(),
            out.data_ptr(), N, nb, s, k)
    if rows > 0:
        geo = panel_geometry(N, s, k, item, _sm_count(dev), limit,
                             _sm_smem(dev), tiles=tiles[1], rows=rows,
                             row_tile=tiles[2] if len(tiles) > 2 else None,
                             lsplit=tiles[3] if len(tiles) > 3 else None)
        if geo is None:
            raise ValueError(
                f"banded_solve: tiles={tiles!r} at s={s}, k={k}: not a panel "
                f"geometry the kernel takes within the card's {limit} bytes "
                "of shared memory per block")
        _smem_check("banded_solve",
                    lib.hf_solve_smem_bytes(s, k, geo.tiles, geo.rows, geo.lsplit,
                                            item),
                    dev, f"the solve at s={s} with tiles {tiles}")
        stem = "hf_banded_solve"
        args += (geo.tiles, int(bool(trans)), geo.rows, geo.row_tile, geo.lsplit)
        design = "panels"
    else:
        kt = tiles[1]
        blocks = N * -(-k // kt)
        if cluster is None:
            cluster = stream_cluster(blocks, s, _sm_count(dev))
        geometry = None
        if cluster >= 1:
            geometry = stream_geometry(blocks, s, kt, item, cluster, bool(trans),
                                       _sm_count(dev), limit, _sm_smem(dev))
        if cluster >= 1 and geometry is None:
            raise ValueError(
                f"banded_solve: the streamed solve at s={s} with column tile "
                f"{kt} in clusters of {cluster} needs more than the card's "
                f"{limit} bytes of shared memory per block")
        # a cluster size the kernel does not take goes to it all the same,
        # with one block's geometry, and is refused there
        stem = "hf_banded_solve_stream"
        args += (kt, int(bool(trans)), cluster) + (geometry or (1, 2, 64, 1, 32))[:5]
        design = "streamed"
    if N == 0 or nb == 0 or k == 0:
        return out
    _launch(lib, getattr(lib, f"{stem}_{_suffix(bb.dtype)}"), "banded_solve",
            dev, *args)
    banded_solve.launches += 1
    banded_solve.launches_by_design[design] += 1
    banded_solve.launches_by_shape.add(_shape_key(design, N, s, nb, k, bb.dtype))
    return out


banded_solve.launches = 0
banded_solve.launches_by_design = {"panels": 0, "streamed": 0}
banded_solve.launches_by_shape = Tally()
