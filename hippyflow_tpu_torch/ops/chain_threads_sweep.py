"""Times K1's chain at each thread count beside ``chain_threads``'s pick.

    python3 -m hippyflow_tpu_torch.ops.chain_threads_sweep

Needs one CUDA card and ``nvcc``.  For each (N, s) at which the lanes
launch the chain (nb = s, float32, random diagonally dominant bands: the
work does not depend on the values) one line: the picked count and its
time, then the time at each count of THREADS, each the mean of REPS
launches after a warm-up.  The rule in ``hopper_kernels.chain_threads``
was fitted to these lines.
"""

from __future__ import annotations

import subprocess

import torch

from . import hopper_kernels as hk

THREADS = (64, 128, 192, 256, 320, 384, 640)
SHAPES = ((1024, 65), (256, 65), (1024, 33), (1024, 17), (32, 97), (32, 49),
          (32, 25))
REPS = 3


def random_band(N: int, nb: int, s: int, device, seed: int = 0):
    """(N, nb, s, 3s) float32 diagonally dominant band, A_0 = B_{nb-1} = 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    band = 0.1 * torch.randn(N, nb, s, 3 * s, generator=gen, device=device)
    band[..., s : 2 * s] += 4.0 * torch.eye(s, device=device)
    band[:, 0, :, :s] = 0.0
    band[:, -1, :, 2 * s :] = 0.0
    return band


def chain_ms(band, threads: int) -> float:
    """Mean milliseconds of the chain on ``band`` at ``threads`` a block."""
    N, nb, s, _ = band.shape
    lib = hk._library()
    ld, _ = hk.chain_geometry(s, band.element_size(), hk._smem_limit(band.device))
    M = torch.empty((N, nb, s, s), dtype=band.dtype, device=band.device)
    Dinv = torch.empty_like(M)
    fn = getattr(lib, f"hf_banded_factorize_{hk._suffix(band.dtype)}")
    run = lambda: hk._launch(lib, fn, "banded_factorize", band.device,
                             band.data_ptr(), M.data_ptr(), Dinv.data_ptr(),
                             N, nb, s, ld, threads)
    run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> None:
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for N, s in SHAPES:
        band = random_band(N, s, s, device)
        _, need = hk.chain_geometry(s, 4, hk._smem_limit(device))
        picked = hk.chain_threads(N, s, hk._sm_count(device), need,
                                  hk._sm_smem(device))
        ms = {th: chain_ms(band, th) for th in (picked, *THREADS)}
        print(f"K1 chain threads float32 N={N} s={s}: picked {picked} "
              f"{ms[picked]:.4f} ms; "
              + ", ".join(f"{th}: {ms[th]:.4f}" for th in THREADS), flush=True)
        del band
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
