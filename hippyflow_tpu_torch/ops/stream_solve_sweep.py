"""Times K2's streamed design at each cluster size beside ``stream_cluster``'s pick.

    python3 -m hippyflow_tpu_torch.ops.stream_solve_sweep [--check]
        [--parent DIR] [--stage-bytes B ...] [--lanes L ...] [--splits R ...]

Needs one CUDA card and ``nvcc``.  For each (N, s, nb) at which the lanes
launch the k=1 solve (random contracting factor blocks: the work does not
depend on the values), in float32 and at s=516 also float64, forward and
transposed, one line: every cluster size of CLUSTERS held against the
plain version, then timed in turns (the list forwards, then backwards;
mean of REPS launches after a warm-up, 10 REPS below s=100), with the picked size, the plain
loop's time and the bound (each factor block read once at 3.35 TB/s).
``--check`` stops after the comparison; ``--parent DIR`` adds the K2 of
another checkout of this repository (its own build) to the turns;
``--stage-bytes`` repeats the sweep at other ring-stage sizes, and
``--lanes L ...`` at forced numbers of lanes per row of a forward product
(forward only), and ``--splits R ...`` at forced numbers of row splits of
a transposed product (transposed only).  The rules ``stream_cluster``,
``stream_lanes``, ``stream_splits`` and ``stream_geometry`` of
``hopper_kernels`` were fitted to these lines.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

from ..utils.profiling import k2_bound
from . import hopper_kernels as hk

CLUSTERS = (1, 2, 3, 4, 6, 8)
# (N, s, nb, dtypes): the helmholtz chunk, the nx=192 Jacobian chunk and
# chunk, its coarse levels, the nx=64 chunk and its coarse levels
SHAPES = (
    (16, 516, 52, (torch.float32, torch.float64)),
    (16, 193, 193, (torch.float32,)),
    (32, 193, 193, (torch.float32,)),
    (32, 97, 97, (torch.float32,)),
    (32, 49, 49, (torch.float32,)),
    (32, 25, 25, (torch.float32,)),
    (256, 65, 65, (torch.float32,)),
    (1024, 33, 33, (torch.float32,)),
    (1024, 17, 17, (torch.float32,)),
)
REPS = 3
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def random_factor(N: int, nb: int, s: int, dtype, device, seed: int = 0):
    """M, Dinv, B (N, nb, s, s) with spectral norms near 0.2, 1 and 0.2, so
    that the sweeps neither grow nor die out, and a rhs (N, nb, s, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 0.1 / s**0.5
    eye = torch.eye(s, dtype=dtype, device=device)
    blocks = [scale * torch.randn(N, nb, s, s, generator=gen, dtype=dtype,
                                  device=device) for _ in range(3)]
    blocks[1] += eye
    bb = torch.randn(N, nb, s, 1, generator=gen, dtype=dtype, device=device)
    return (*blocks, bb)


def mean_ms(fn, reps: int = REPS) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def load_parent(path: str):
    """``hopper_kernels`` of another checkout (it builds its own sources),
    imported with that checkout's package under another name, so that its
    relative imports find its own modules."""
    root = Path(path).resolve() / "hippyflow_tpu_torch"
    name = "parent_hippyflow_tpu_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, root / "__init__.py", submodule_search_locations=[str(root)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    mod = importlib.import_module(f"{name}.ops.hopper_kernels")
    mod.build_kernels()
    return mod


def sweep(N, s, nb, dtype, trans, device, check_only=False, parent=None):
    M, Dinv, B, bb = random_factor(N, nb, s, dtype, device)
    x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
    clusters = [c for c in CLUSTERS if c <= s]
    worst = 0.0
    for c in clusters:
        x = hk.banded_solve(M, Dinv, B, bb, trans, cluster=c)
        torch.cuda.synchronize()
        err = ((x - x_p).abs().max() / x_p.abs().max()).item()
        if not err <= TOL[dtype]:
            raise AssertionError(f"N={N} s={s} {dtype} trans={trans} c={c}: "
                                 f"against plain {err:.3e}")
        worst = max(worst, err)
    picked = hk.stream_cluster(N, s, hk._sm_count(device))
    head = (f"K2 streamed {str(dtype)[6:]} N={N} s={s} nb={nb} "
            f"{'transposed' if trans else 'forward'}: rel err {worst:.2e}")
    if check_only:
        print(head, flush=True)
        return
    runs = {f"c={c}": (lambda c=c: hk.banded_solve(M, Dinv, B, bb, trans, cluster=c))
            for c in clusters}
    runs["plain"] = lambda: hk.banded_solve_plain(M, Dinv, B, bb, trans)
    if parent is not None:
        runs["parent"] = lambda: parent.banded_solve(M, Dinv, B, bb, trans)
    ms = {key: [] for key in runs}
    for keys in (list(runs), list(runs)[::-1]):
        for key in keys:
            ms[key].append(mean_ms(runs[key], REPS if s >= 100 else 10 * REPS))
    ms = {key: sum(v) / len(v) for key, v in ms.items()}
    geo = hk.stream_geometry(N, s, 1, bb.element_size(), picked, trans,
                             hk._sm_count(device), hk._smem_limit(device),
                             hk._sm_smem(device))
    bound = k2_bound(N, nb, s, 1, dtype)[0]  # bytes at k=1
    best = min(runs.keys() - {"plain", "parent"}, key=ms.get)
    print(head + "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; picked c={picked} (rows, stages, threads, splits, lanes a row, bytes {geo}), "
          f"fastest {best}; bound {bound:.4f} ms", flush=True)


def main(argv) -> None:
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = None
    if "--parent" in argv:
        parent = load_parent(argv[argv.index("--parent") + 1])
    sizes = [hk.STREAM_STAGE_BYTES]
    if "--stage-bytes" in argv:
        i = argv.index("--stage-bytes") + 1
        while i < len(argv) and argv[i].isdigit():
            sizes.append(int(argv[i]))
            i += 1
    forced = [(None, None)]
    for flag, what in (("--lanes", False), ("--splits", True)):
        if flag in argv:
            i = argv.index(flag) + 1
            while i < len(argv) and argv[i].isdigit():
                forced.append((what, int(argv[i])))
                i += 1
    rules = hk.stream_lanes, hk.stream_splits
    for size in sizes:
        hk.STREAM_STAGE_BYTES = size
        for trans_only, value in forced:
            hk.stream_lanes, hk.stream_splits = rules
            label = "lanes per row and row splits by the rules"
            if trans_only is False:
                hk.stream_lanes = lambda s, rows, wmax, share: value
                label = f"{value} lanes per row"
            elif trans_only:
                hk.stream_splits = lambda groups, wmax, rows: min(
                    value, max(1, wmax // groups))
                label = f"at most {value} row splits"
            hk.stream_geometry.cache_clear()
            print(f"ring stages of at most {size} bytes, {label}", flush=True)
            for N, s, nb, dtypes in SHAPES:
                for dtype in dtypes:
                    for trans in (False, True):
                        if trans_only in (None, trans):
                            sweep(N, s, nb, dtype, trans, device,
                                  "--check" in argv, parent)
                    torch.cuda.empty_cache()
    hk.stream_lanes, hk.stream_splits = rules
    hk.stream_geometry.cache_clear()


if __name__ == "__main__":
    main(sys.argv[1:])
