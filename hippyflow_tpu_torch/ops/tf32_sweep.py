"""Times block_cyclic and block_tridiag with IEEE float32 products, TF32, and TF32 refined once.

    python3 -m hippyflow_tpu_torch.ops.tf32_sweep

Needs one CUDA card and ``nvcc``.  The JAX package's solver-precision
policy (``config.set_solver_precision``) lowers the float32 products of
its banded factorize and solve ops and refines the PDE problem's solves
(``RefinedBandFactor``); the port leaves it out, and this script is the
measurement behind that.  On the card TF32 can reach only the library
products (``torch.matmul``, ``torch.linalg.lu_*``) of ``block_cyclic``
and ``block_tridiag``: the kernels K1-K3 do their own IEEE arithmetic.

For the nonlinear Poisson control problem at nx=64 (N=512 samples,
s=nb=65) and on its long thin band (nx=8, ny=300: N=256, s=9, nb=301),
the bc-symmetrized band of A at prior samples and u = 0 is factorized
(both orientations, as a Newton linearization does) and a seeded
right-hand side solved, in three modes: ``ieee``; ``tf32`` (factorize
and solve with ``torch.backends.cuda.matmul.fp32_precision = "tf32"``);
``tf32+1`` (``tf32`` and one sweep as ``RefinedBandFactor`` makes it:
the residual with the banded product in IEEE, one more TF32 solve).  One
line per solver and band: each mode's worst relative residual ||b - A x||
/ ||b|| (float64, against the float32 band), K3's launches per
factorization, and the wall ms of the factorization and of the solve,
each the median of ROUNDS rounds taken in turns over the modes after one
untimed round (synchronized).
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import torch

from . import hopper_kernels as hk
from .structured import (
    block_tridiag_matmat,
    factorize_block_cyclic_banded,
    factorize_block_tridiag_banded,
)

# (nx, ny, samples): the control phase's nx=64 problem and its thin band
BANDS = ((64, 64, 512), (8, 300, 256))
SOLVERS = ("block_cyclic", "block_tridiag")
MODES = ("ieee", "tf32", "tf32+1")
ROUNDS = 3
SEED = 0


def control_band(nx, ny, n, device):
    """(float32 bc-symmetrized band (n, nb, s, 3s) of the nonlinear Poisson
    control problem's A at n prior samples and u = 0, a seeded right-hand
    side (n, nb * s) with its Dirichlet rows zeroed)."""
    from ..fem import bc_symmetrize_banded_masked
    from ..testing import poisson_control_settings, setup_poisson_control_problem
    from ..utils import KeyChain

    st = poisson_control_settings()
    st["nx"], st["ny"], st["LINEAR"] = nx, ny, False
    pde, prior, dist, _ = setup_poisson_control_problem(
        st, solver="block_cyclic", dtype=torch.float32, device=device)
    kc = KeyChain(SEED, device)
    m = prior.sample(kc.normal((n, prior.noise_dim), torch.float32))
    z = dist.sample_n(kc, n, torch.float32)
    u = torch.zeros((n, pde.state_dim), dtype=m.dtype, device=m.device)
    band = bc_symmetrize_banded_masked(pde.bound.assemble_A_banded(u, m, z),
                                       pde._mask).contiguous()
    gen = torch.Generator().manual_seed(SEED)
    b = pde._zero_bc_rows(torch.randn((n, pde.state_dim), generator=gen).to(m))
    return band, b


def _factorize(solver, band):
    if solver == "block_cyclic":
        return factorize_block_cyclic_banded(band, with_transpose=True,
                                             with_forward=True)
    return factorize_block_tridiag_banded(band)


def _fp32(mode):
    torch.backends.cuda.matmul.fp32_precision = mode


def run_mode(solver, band, b, mode):
    """(x, factorize s, solve s, K3 launches) of one mode; the CUDA
    matmul setting is put back to what it was, also on an exception."""

    def clock():
        if band.is_cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    prev = torch.backends.cuda.matmul.fp32_precision
    try:
        _fp32("ieee" if mode == "ieee" else "tf32")
        t0 = clock()
        k3 = hk.batched_inverse.launches
        fac = _factorize(solver, band)
        t1 = clock()
        k3 = hk.batched_inverse.launches - k3
        x = fac.solve(b)
        if mode == "tf32+1":
            _fp32("ieee")
            r = b - block_tridiag_matmat(band, x)
            _fp32("tf32")
            x = x + fac.solve(r)
        t2 = clock()
    finally:
        _fp32(prev)
    return x, t1 - t0, t2 - t1, k3


def measure(solver, band, b, rounds=ROUNDS):
    """{mode: {"residual", "factorize_ms", "solve_ms", "k3"}}: the residual
    and K3's launches from the untimed round, the ms the medians of the
    timed rounds."""
    band64, b64 = band.double(), b.double()
    out = {mode: {"factorize_ms": [], "solve_ms": []} for mode in MODES}
    for rnd in range(rounds + 1):
        for mode in MODES:
            x, t_fac, t_sol, k3 = run_mode(solver, band, b, mode)
            if rnd:
                out[mode]["factorize_ms"].append(1e3 * t_fac)
                out[mode]["solve_ms"].append(1e3 * t_sol)
                continue
            r = b64 - block_tridiag_matmat(band64, x.double())
            out[mode]["residual"] = (torch.linalg.vector_norm(r, dim=1)
                                     / torch.linalg.vector_norm(b64, dim=1)).max().item()
            out[mode]["k3"] = k3
    for rec in out.values():
        for key in ("factorize_ms", "solve_ms"):
            rec[key] = statistics.median(rec[key]) if rec[key] else float("nan")
    return out


def line(solver, nx, ny, band, res) -> str:
    n, nb, s = band.shape[:3]
    total = {mode: r["factorize_ms"] + r["solve_ms"] for mode, r in res.items()}
    per = lambda key, fmt: ", ".join(f"{m} {res[m][key]:{fmt}}" for m in MODES)
    return (f"tf32 sweep {solver} nx={nx} ny={ny} (N={n}, s={s}, nb={nb}): "
            f"residual {per('residual', '.3e')}; K3 per factorization "
            f"{per('k3', 'd')}; factorize ms {per('factorize_ms', '.3f')}; "
            f"solve ms {per('solve_ms', '.3f')}; factorize + solve ms "
            + ", ".join(f"{m} {total[m]:.3f} ({total[m] / total['ieee']:.3f}x)"
                        for m in MODES))


def main(argv) -> None:
    device = torch.device("cuda", 0)
    if torch.backends.cuda.matmul.fp32_precision != "ieee":
        raise SystemExit("TF32 matmuls are on: the ieee mode would not be IEEE float32")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    hk.build_kernels()
    for nx, ny, n in BANDS:
        band, b = control_band(nx, ny, n, device)
        for solver in SOLVERS:
            res = measure(solver, band, b)
            print(line(solver, nx, ny, band, res), flush=True)
            if solver == "block_cyclic" and res["ieee"]["k3"] == 0:
                raise AssertionError("block_cyclic launched no K3")
            torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.fp32_precision != "ieee":
        raise AssertionError("the CUDA matmul setting was not put back")


if __name__ == "__main__":
    main(sys.argv[1:])
