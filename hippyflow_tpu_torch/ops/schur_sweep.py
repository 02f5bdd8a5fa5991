"""Times K1's Schur step at the lanes' shapes beside the plain step, the library pair and the bound.

    python3 -m hippyflow_tpu_torch.ops.schur_sweep [--check] [--parent DIR]

Needs one CUDA card and ``nvcc``.  For each (N, s) at which the lanes run
K1's row design (a diagonally dominant random band and a random
Dinv_{j-1}: the work does not depend on the values), in float32 and also
float64, one line: the step at block row 1, held against the plain
version, then timed in turns (the list forwards, then backwards) with the
plain version and the library pair (``library_pair``: one batched
product and one fused multiply-subtract, TF32 off; a yardstick the port
never calls), beside the bound.  ``--check`` stops after the comparison;
``--parent DIR`` adds the Schur step of another checkout of this
repository (its own build; its time per launch comes from the profiler
over its row design on the same band, the first row's copy left out, so
that any generation of the kernel is read the same way), and beside it
this checkout's, read the same way in turns, and this checkout's step
alone, read by the profiler.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from ..utils.profiling import schur_bound
from . import hopper_kernels as hk
from .stream_solve_sweep import load_parent

# (N, s, dtypes): the nx=192 lane's Jacobian chunk and chunk, the
# helmholtz chunk
SHAPES = (
    (16, 193, (torch.float32, torch.float64)),
    (32, 193, (torch.float32,)),
    (16, 516, (torch.float32, torch.float64)),
)
REPS = 20
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# cycles a second the spin kernel is counted at (about the H100's clock)
SPIN_HZ = 2e9


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds of fn() over reps calls.  The calls are
    queued behind a spin kernel that outlasts their enqueueing (twice the
    host time of one call, reps times, at most a second), so that the
    events time the device's work and not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(min(1.0, 2 * reps * host) * SPIN_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name: str, skip: int = 0):
    """(mean device ms per launch, launches) of the kernels whose names hold
    ``name`` in one call of fn() under the profiler, the first ``skip``
    launches (in time order) left out."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a profile now and then comes back without them
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        mine = sorted((e for e in prof.events()
                       if e.device_type.name == "CUDA" and name in e.name),
                      key=lambda e: e.time_range.start)[skip:]
        if mine:
            return (sum(e.device_time_total for e in mine) / 1e3 / len(mine),
                    len(mine))
    raise RuntimeError(f"three profiles hold no launch of {name}")


def library_pair(band, dinv_prev, j: int):
    """(M_j, T_j) by ``torch.bmm`` and ``torch.baddbmm`` (cuBLAS) on views
    of the band: the library's time for the Schur step's function."""
    s = band.shape[-2]
    M = torch.bmm(band[:, j, :, :s], dinv_prev)
    return M, torch.baddbmm(band[:, j, :, s : 2 * s], M,
                            band[:, j - 1, :, 2 * s :], alpha=-1)


def random_case(N: int, s: int, nb: int, dtype, device, seed: int = 0):
    """A diagonally dominant band (N, nb, s, 3s) and Dinv buffers whose
    rows are random, scaled like inverses of the diagonal blocks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    band = 0.1 * torch.randn(N, nb, s, 3 * s, generator=gen, dtype=dtype,
                             device=device)
    band[..., s : 2 * s] += 4.0 * torch.eye(s, dtype=dtype, device=device)
    dinv = torch.randn(N, nb, s, s, generator=gen, dtype=dtype,
                       device=device) / s**0.5
    return band, torch.zeros_like(dinv), dinv


def sweep(N, s, dtype, device, check_only=False, parent=None):
    band, M, Dinv = random_case(N, s, 3, dtype, device)
    M_p, T_p = hk.schur_step_plain(band, Dinv[:, 0], 1)
    hk.schur_step_(band, M, Dinv, 1)
    torch.cuda.synchronize()
    err = max((M[:, 1] - M_p).abs().max() / M_p.abs().max(),
              (Dinv[:, 1] - T_p).abs().max() / T_p.abs().max()).item()
    if not err <= TOL[dtype]:
        raise AssertionError(f"N={N} s={s} {dtype}: against plain {err:.3e}")
    head = f"K1 Schur step {str(dtype)[6:]} N={N} s={s}: rel err {err:.2e}"
    if check_only:
        print(head, flush=True)
        return
    runs = {"step": lambda: hk.schur_step_(band, M, Dinv, 1),
            "plain": lambda: hk.schur_step_plain(band, Dinv[:, 0], 1),
            "library": lambda: library_pair(band, Dinv[:, 0], 1)}
    ms = {key: [] for key in runs}
    for keys in (list(runs), list(runs)[::-1]):
        for key in keys:
            ms[key].append(device_ms(runs[key], REPS if s < 400 else REPS // 2))
    ms = {key: sum(v) / len(v) for key, v in ms.items()}
    line = head + "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
    if parent is not None:
        sub = band[:, :4].contiguous()
        prof = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            mod = parent if who == "parent" else hk
            name = "schur_" if who == "parent" else "schur_tile_kernel"
            prof[who].append(kernel_ms(
                lambda: mod.banded_factorize(sub, design="rows"), name, skip=1)[0])
        alone = kernel_ms(lambda: [hk.schur_step_(band, M, Dinv, 1)
                                   for _ in range(REPS)], "schur_tile_kernel")[0]
        line += (f"; profiled in the row design: parent {sum(prof['parent']) / 2:.4f}, "
                 f"this {sum(prof['this']) / 2:.4f}; profiled alone: this {alone:.4f}")
    b_ms, b_by = schur_bound(N, s, dtype)
    print(line + f"; bound {b_ms:.4f} ms ({b_by})", flush=True)


def main(argv) -> None:
    device = torch.device("cuda", 0)
    if torch.backends.cuda.matmul.fp32_precision != "ieee":
        raise SystemExit("TF32 matmuls are on: the library pair would not be IEEE float32")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = None
    if "--parent" in argv:
        parent = load_parent(argv[argv.index("--parent") + 1])
    for N, s, dtypes in SHAPES:
        for dtype in dtypes:
            sweep(N, s, dtype, device, "--check" in argv, parent)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
