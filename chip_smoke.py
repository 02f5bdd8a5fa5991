#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hippyflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile   # also: device-time table of the main path

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or
``/usr/local/cuda/bin``); imports nothing of JAX.  Phases, one summary line
each:

1. device: the card, and its name and power limit from ``nvidia-smi``;
2. build: the hand-written kernels K1-K4 compiled from ``csrc/`` (one nvcc
   process per source, in parallel);
3. kernels: K1 (``banded_factorize``) and K2 (``banded_solve``) against their
   plain PyTorch versions on confusion bands at nx=64 (N=256, nb=s=65,
   k=1 and k=100) in float32 and float64, with residuals and timings; K1's
   row-panel design at s=65 against the one-block chain and the plain
   version;
4. inverses: K3 and K4 (``batched_inverse``) against their plain version on
   the prior's cyclic-reduction blocks at nx=64 (N=32, s=65) and nx=192
   (N=96, s=193), both dtypes, with the identity residual and timings;
5. s=193: K1 (row panels) and K2 (k=1 streamed, and k=100 transposed
   through panels) against their plain versions on Newton bands of nx=192 (N=16,
   nb=s=193), both dtypes, with residuals and timings;
6. parity: the float64 pipeline on ``.bench/parity_ref.npz`` against the
   stored reference spectrum (relative error <= 1e-8 over eigenvalues above
   1e-4 lambda_0), with the dense prior and again with the structured one;
7. main path: the float32 input active subspace of confusion at nx=64 with
   the steady Navier-Stokes velocity, 1024 prior samples, rank 100,
   oversampling 10, through ``ActiveSubspaceProjector``;
8. nx=192 lane: the same at nx=192 (37249 dofs, the structured prior),
   256 samples, rank 128, oversampling 10, chunk 32, Jacobian chunk 16.

Then a JSON line describing the kernels (``launches`` is the sum over the
two paths, which are each driven with the counts set to 0 just before and
read just after; ``launches_by_path`` splits it), and last the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without printing the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

NX = 64
N_BAND = 256  # samples of the kernel phase
N_SAMPLES = 1024  # main path (bench.py's default)
RANK, OVERSAMPLING = 100, 10
SEED = 0
# the nx=192 lane of bench.py (NX192_*, chunk_default, jac_chunk_default)
NX192, N192_SAMPLES, RANK192 = 192, 256, 128
CHUNK192, JAC_CHUNK192 = 32, 16
N_BAND192 = 16  # samples of the s=193 kernel phase

# Kernel against plain version, relative to the largest plain entry, and
# relative residuals ||A x - b|| / ||b|| of the kernels' solves (taken in
# float64 against the float64 band).  float64: Gauss-Jordan without
# pivoting (kernel) and pivoted LU (plain) round differently, by a few ulps
# times the growth of the 65-row chain.  float32: accumulation is plain
# IEEE float32 (no TF32); the plain float32 factorization of these bands
# differs from the float64 one by 7e-7 (K1) and 4e-6 (K2), and leaves a
# residual of 1.3e-6 (measured on the CPU), so 1e-4 leaves a margin of 25x.
TOL = {
    torch.float64: {"diff": 1e-11, "residual": 1e-12},
    torch.float32: {"diff": 1e-4, "residual": 1e-4},
}
# max |V^T R V - I| of the float32 decoder: R = K M^-1 K is ill conditioned,
# and CholQR2 in float32 kept R-orthonormality to 2.4e-5 at 32 samples on
# the CPU; 1e-3 flags a broken orthogonalization
ORTHO_TOL_F32 = 1e-3
# K3/K4 against their plain version (the same Gauss-Jordan in PyTorch
# operations, summed in another order), relative to the largest plain
# entry, and the identity residual max|X X^-1 - I| on the prior's
# cyclic-reduction blocks (SPD and diagonally dominant); the first chip
# runs measured 5e-9 and 1.3e-7 in float32, 1.5e-16 and 6.7e-16 in float64
TOL_INV = {
    torch.float64: {"diff": 1e-12, "residual": 1e-12},
    torch.float32: {"diff": 1e-5, "residual": 1e-4},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (one warm-up)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def paired_ms(kernel, plain, reps: int = 5):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p0 = cuda_ms(plain, reps)
    k0 = cuda_ms(kernel, reps)
    k1 = cuda_ms(kernel, reps)
    p1 = cuda_ms(plain, reps)
    return 0.5 * (k0 + k1), 0.5 * (p0 + p1)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def setup(dtype, device, nx=NX, with_prior=True):
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
        load_ns_velocity,
    )

    vel = load_ns_velocity(nx)
    obs, Vh = confusion_linear_observable(
        nx=nx, velocity=vel, dtype=dtype, device=device
    )
    prior = confusion_prior(Vh, dtype=dtype, device=device) if with_prior else None
    return obs, prior


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def newton_bands(obs64, prior64, n, device):
    """bc-symmetrized Newton bands (n, nb, s, 3s) in float64 at prior
    samples of m and at states u drawn from the same prior (the cubic term
    is live)."""
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_from_mask

    pde = obs64.problem
    gen = torch.Generator(device=device).manual_seed(SEED)
    xi = torch.randn(2 * n, prior64.noise_dim, generator=gen,
                     dtype=torch.float64, device=device)
    ms = prior64.sample(xi)
    band = bc_symmetrize_banded_from_mask(
        pde.bound.assemble_A_banded(ms[n:], ms[:n]), pde.bc
    ).contiguous()
    return band, gen


def phase_kernels(obs64, prior64, device):
    """K1/K2 against their plain versions at the main path's shapes."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    band64, gen = newton_bands(obs64, prior64, N_BAND, device)
    N, nb, s, _ = band64.shape
    rhs64 = {
        k: torch.randn(N, nb, s, k, generator=gen, dtype=torch.float64,
                       device=device)
        for k in (1, 100)
    }
    report = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        band = band64.to(dtype)
        B = band[..., 2 * s :].contiguous()
        M, Dinv = hk.banded_factorize(band)
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        k1_err = max((M - M_p).abs().max().item(), (Dinv - D_p).abs().max().item())
        k1_rel = k1_err / D_p.abs().max().item()
        check(k1_rel <= tol["diff"],
              f"K1 {dtype}: kernel vs plain {k1_rel:.3e} > {tol['diff']}")
        line = f"kernels {str(dtype)[6:]}: K1 rel diff {k1_rel:.3e}"
        k2_err = 0.0
        for k, trans in ((1, False), (100, True)):
            bb = rhs64[k].to(dtype)
            x = hk.banded_solve(M, Dinv, B, bb, trans)
            x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
            torch.cuda.synchronize()
            err = (x - x_p).abs().max().item()
            rel = err / x_p.abs().max().item()
            apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
            b_flat = rhs64[k].reshape(N, nb * s, k)
            res = (
                torch.linalg.vector_norm(
                    apply(band64, x.to(torch.float64).reshape(N, nb * s, k))
                    - b_flat
                )
                / torch.linalg.vector_norm(b_flat)
            ).item()
            check(rel <= tol["diff"],
                  f"K2 {dtype} k={k}: kernel vs plain {rel:.3e}")
            check(res <= tol["residual"],
                  f"K2 {dtype} k={k}: residual {res:.3e} > {tol['residual']}")
            line += f"; K2 k={k} trans={trans} rel diff {rel:.3e} residual {res:.3e}"
            k2_err = max(k2_err, err)
        log(line)
        if dtype != torch.float32:
            continue
        bb1, bb100 = rhs64[1].to(dtype), rhs64[100].to(dtype)
        k1_ms, k1_plain = paired_ms(
            lambda: hk.banded_factorize(band), lambda: hk.banded_factorize_plain(band)
        )
        k2_ms, k2_plain = paired_ms(
            lambda: hk.banded_solve(M, Dinv, B, bb100, True),
            lambda: hk.banded_solve_plain(M, Dinv, B, bb100, True),
        )
        k2_ms1, k2_plain1 = paired_ms(
            lambda: hk.banded_solve(M, Dinv, B, bb1, False),
            lambda: hk.banded_solve_plain(M, Dinv, B, bb1, False),
        )
        log(
            f"timing float32 N={N} nb={nb} s={s}: K1 {k1_ms:.3f} ms "
            f"(plain {k1_plain:.3f}); K2 k=100 trans {k2_ms:.3f} ms "
            f"(plain {k2_plain:.3f}); K2 k=1 {k2_ms1:.3f} ms "
            f"(plain {k2_plain1:.3f})"
        )
        report = {
            "banded_factorize": {"max_abs_err": k1_err, "ms": k1_ms,
                                 "plain_ms": k1_plain},
            "banded_solve": {"max_abs_err": k2_err, "ms": k2_ms,
                             "plain_ms": k2_plain, "ms_k1": k2_ms1,
                             "plain_ms_k1": k2_plain1},
        }
    return report, band64


def phase_rows_s65(band64):
    """K1's row-panel design (the s=193 one) at s=65, against the one-block
    chain and the plain version, on the nx=64 Newton bands."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    band64 = band64[:32].contiguous()
    line = "K1 rows design s=65 N=32"
    for dtype in (torch.float32, torch.float64):
        band = band64.to(dtype)
        M, Dinv = hk.banded_factorize(band, design="rows")
        M_c, D_c = hk.banded_factorize(band, design="chain")
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        vs_chain = max(rel_err(M, M_c), rel_err(Dinv, D_c))
        vs_plain = max(rel_err(M, M_p), rel_err(Dinv, D_p))
        tol = TOL[dtype]["diff"]
        check(vs_chain <= tol and vs_plain <= tol,
              f"K1 rows s=65 {dtype}: {vs_chain:.3e} vs chain, "
              f"{vs_plain:.3e} vs plain")
        line += f"; {str(dtype)[6:]}: vs chain {vs_chain:.3e}, vs plain {vs_plain:.3e}"
    log(line)


def phase_inverses(priors):
    """K3 and K4 against their plain version on the blocks that cyclic
    reduction inverts first (the odd diagonal blocks of the structured
    prior's K band), at each nx of ``priors`` {nx: float64 structured
    prior}, in both dtypes; float32 timings, with torch.linalg.inv's time
    beside them for reference."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    report = {}
    for nx, prior in priors.items():
        s = nx + 1
        X64 = prior.K_band[1::2, :, s : 2 * s].contiguous()
        eye = torch.eye(s, dtype=torch.float64, device=X64.device)
        line = f"inverses nx={nx} N={X64.shape[0]} s={s}"
        for dtype in (torch.float32, torch.float64):
            tol = TOL_INV[dtype]
            X = X64.to(dtype)
            for name, rank1, w in (("K3", False, hk.GJ_WIDTH), ("K4", True, 1)):
                Y = hk.batched_inverse(X, rank1=rank1)
                Y_p = hk.batched_inverse_plain(X, w)
                torch.cuda.synchronize()
                diff = rel_err(Y, Y_p)
                res = (X64 @ Y.double() - eye).abs().max().item()
                check(diff <= tol["diff"],
                      f"{name} nx={nx} {dtype}: kernel vs plain {diff:.3e}")
                check(res <= tol["residual"],
                      f"{name} nx={nx} {dtype}: max|X X^-1 - I| {res:.3e}")
                line += (f"; {name} {str(dtype)[6:]} rel diff {diff:.3e} "
                         f"residual {res:.3e}")
                if dtype == torch.float32:
                    report[(name, nx)] = {
                        "max_abs_err": (Y - Y_p).abs().max().item()}
        log(line)
        X = X64.to(torch.float32)
        t = {}
        for name, rank1, w in (("K3", False, hk.GJ_WIDTH), ("K4", True, 1)):
            t[name] = paired_ms(lambda: hk.batched_inverse(X, rank1=rank1),
                                lambda: hk.batched_inverse_plain(X, w))
            report[(name, nx)].update(ms=t[name][0], plain_ms=t[name][1])
        inv_ms = cuda_ms(lambda: torch.linalg.inv(X), 5)
        log(f"timing float32 inverses nx={nx} N={X.shape[0]} s={s}: K3 "
            f"{t['K3'][0]:.3f} ms (plain {t['K3'][1]:.3f}); K4 {t['K4'][0]:.3f} "
            f"ms (plain {t['K4'][1]:.3f}); torch.linalg.inv {inv_ms:.3f} ms")
    return report


def phase_s193(obs64, prior64, device):
    """K1 (row panels) and K2 (streamed at k=1, panels at k=100), each
    picked by shape, against their plain versions on Newton bands of the
    nx=192 problem."""
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    band64, gen = newton_bands(obs64, prior64, N_BAND192, device)
    N, nb, s, _ = band64.shape
    rhs64 = {k: torch.randn(N, nb, s, k, generator=gen, dtype=torch.float64,
                            device=device) for k in (1, 100)}
    report = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        band = band64.to(dtype)
        B = band[..., 2 * s :].contiguous()
        M, Dinv = hk.banded_factorize(band)
        M_p, D_p = hk.banded_factorize_plain(band)
        torch.cuda.synchronize()
        k1_rel = max(rel_err(M, M_p), rel_err(Dinv, D_p))
        check(k1_rel <= tol["diff"], f"K1 s={s} {dtype}: kernel vs plain {k1_rel:.3e}")
        line = f"s={s} kernels {str(dtype)[6:]} N={N}: K1 rel diff {k1_rel:.3e}"
        k2_err = 0.0
        for k, trans in ((1, False), (100, True)):
            bb = rhs64[k].to(dtype)
            x = hk.banded_solve(M, Dinv, B, bb, trans)
            x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
            torch.cuda.synchronize()
            rel = rel_err(x, x_p)
            apply = block_tridiag_matmat_trans if trans else block_tridiag_matmat
            b_flat = rhs64[k].reshape(N, nb * s, k)
            res = (torch.linalg.vector_norm(
                apply(band64, x.double().reshape(N, nb * s, k)) - b_flat)
                / torch.linalg.vector_norm(b_flat)).item()
            check(rel <= tol["diff"], f"K2 s={s} {dtype} k={k}: kernel vs plain {rel:.3e}")
            check(res <= tol["residual"],
                  f"K2 s={s} {dtype} k={k}: residual {res:.3e} > {tol['residual']}")
            line += f"; K2 k={k} trans={trans} rel diff {rel:.3e} residual {res:.3e}"
            k2_err = max(k2_err, (x - x_p).abs().max().item())
        log(line)
        if dtype != torch.float32:
            continue
        bb1, bb100 = rhs64[1].to(dtype), rhs64[100].to(dtype)
        k1 = paired_ms(lambda: hk.banded_factorize(band),
                       lambda: hk.banded_factorize_plain(band), reps=2)
        k2 = paired_ms(lambda: hk.banded_solve(M, Dinv, B, bb100, True),
                       lambda: hk.banded_solve_plain(M, Dinv, B, bb100, True),
                       reps=2)
        k2_1 = paired_ms(lambda: hk.banded_solve(M, Dinv, B, bb1, False),
                         lambda: hk.banded_solve_plain(M, Dinv, B, bb1, False),
                         reps=2)
        log(f"timing float32 N={N} nb={nb} s={s}: K1 rows {k1[0]:.3f} ms "
            f"(plain {k1[1]:.3f}); K2 panels k=100 trans {k2[0]:.3f} ms "
            f"(plain {k2[1]:.3f}); K2 streamed k=1 {k2_1[0]:.3f} ms "
            f"(plain {k2_1[1]:.3f})")
        report = {
            "banded_factorize": {
                "max_abs_err_s193": max((M - M_p).abs().max().item(),
                                        (Dinv - D_p).abs().max().item()),
                "ms_s193": k1[0], "plain_ms_s193": k1[1]},
            "banded_solve": {"max_abs_err_s193": k2_err, "ms_s193": k2[0],
                             "plain_ms_s193": k2[1], "ms_k1_s193": k2_1[0],
                             "plain_ms_k1_s193": k2_1[1]},
        }
    return report


def phase_parity(obs64, prior64):
    """The float64 pipeline against the stored reference spectrum."""
    label = type(prior64).__name__
    import numpy as np

    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    data = np.load(os.path.join(REPO, ".bench", "parity_ref.npz"))
    check(int(data["nx"]) == NX, "parity reference is not at nx=64")
    rank = int(data["rank"])
    device, dtype = prior64.mean.device, prior64.mean.dtype
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = rank, OVERSAMPLING
    params["samples_per_process"] = data["xi"].shape[0]
    params["ms_given"], params["verbose"] = True, False
    proj = ActiveSubspaceProjector(obs64, prior64, parameters=params)
    proj.ms = prior64.sample(torch.as_tensor(data["xi"], dtype=dtype, device=device))
    proj.Omega_GN = torch.as_tensor(data["Omega"], dtype=dtype, device=device)
    t0 = time.perf_counter()
    d, _, _ = proj.construct_input_subspace()
    secs = time.perf_counter() - t0
    d = d.cpu().numpy()[:rank]
    d_ref = data["d_ref"][:rank]
    head = np.abs(d_ref) > 1e-4 * abs(d_ref[0])
    rel = np.abs(d - d_ref) / np.abs(d_ref)
    err = float(rel[head].max())
    log(f"parity float64 {label}: rel eig err {err:.3e} over {int(head.sum())} "
        f"head eigenvalues (limit 1e-8), {secs:.2f} s")
    check(err <= 1e-8,
          f"parity {label}: relative eigenvalue error {err:.3e} > 1e-8")
    return err


def run_subspace(obs32, prior_fn, label, n_samples, rank, **params_kw):
    """The float32 input active subspace once, through the user entry
    points, with every launch count set to 0 just before (``prior_fn``
    builds the prior, which is part of the path) and read just after;
    then the health checks."""
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    prior32 = prior_fn()
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = rank, OVERSAMPLING
    params["samples_per_process"] = n_samples
    params["verbose"], params["seed"] = False, SEED
    for key, value in params_kw.items():
        params[key] = value
    proj = ActiveSubspaceProjector(obs32, prior32, parameters=params)
    d, V, E = proj.construct_input_subspace()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {
        "banded_factorize": hk.banded_factorize.launches,
        "banded_solve": hk.banded_solve.launches,
        "batched_inverse": hk.batched_inverse.launches,
        "batched_inverse_rank1": hk.batched_inverse.rank1_launches,
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = proj.stage_seconds
    it = proj.samples.iterations.to(torch.float64)
    ortho = (V.T @ E - torch.eye(V.shape[1], dtype=V.dtype, device=V.device))
    ortho = ortho.abs().max().item()
    log(
        f"{label} samples={n_samples} rank={rank}: total {total:.3f} s "
        f"(prior {total - sum(st.values()):.3f}, forward {st['forward']:.3f}, "
        f"jacobian {st['jacobian']:.3f}, ghep {st['ghep']:.3f}); Newton "
        f"iterations max {int(it.max().item())} mean {it.mean().item():.3f}; "
        f"resampled failures {proj.samples.n_failures}; launches K1 "
        f"{launches['banded_factorize']} K2 {launches['banded_solve']} K3 "
        f"{launches['batched_inverse']} K4 {launches['batched_inverse_rank1']}; "
        f"peak {peak_gb:.2f} GB"
    )
    log(f"{label} eigenvalues[:5] {[round(x, 6) for x in d[:5].tolist()]}; "
        f"max|V^T R V - I| {ortho:.3e}")
    for t_name, t in (("d", d), ("decoder", V), ("encoder", E)):
        check(bool(torch.isfinite(t).all()), f"{label}: non-finite {t_name}")
    check(d.shape == (rank,) and V.shape == (obs32.dM, rank),
          f"{label}: shapes {tuple(d.shape)}, {tuple(V.shape)}")
    check(bool((d[1:] <= d[:-1]).all()), f"{label}: eigenvalues are not descending")
    check(ortho <= ORTHO_TOL_F32, f"{label}: max|V^T R V - I| {ortho:.3e}")
    return launches


def phase_main(obs32, prior32):
    """The float32 main path, once, through the user entry point."""
    launches = run_subspace(obs32, lambda: prior32, f"main float32 nx={NX}",
                            N_SAMPLES, RANK)
    for name in ("banded_factorize", "banded_solve"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    return launches


def phase_lane192(device):
    """The float32 nx=192 lane, once: confusion_prior builds the structured
    prior (cyclic reduction through K3) inside the counted run."""
    from hippyflow_tpu_torch.applications.confusion import confusion_prior
    from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior

    obs32, _ = setup(torch.float32, device, nx=NX192, with_prior=False)
    Vh = obs32.problem.Vu

    def prior_fn():
        prior = confusion_prior(Vh, dtype=torch.float32, device=device)
        check(isinstance(prior, StructuredBiLaplacianPrior),
              f"nx={NX192}: confusion_prior gave {type(prior).__name__}")
        return prior

    launches = run_subspace(
        obs32, prior_fn, f"lane float32 nx={NX192}", N192_SAMPLES, RANK192,
        chunk_size=CHUNK192, jac_chunk_size=JAC_CHUNK192,
    )
    for name in ("banded_factorize", "banded_solve", "batched_inverse"):
        check(launches[name] > 0, f"{name} was not launched on the nx=192 lane")
    return launches


def phase_profile(obs32, prior32):
    """Device time by kernel over one more main-path run (--profile)."""
    from torch.profiler import ProfilerActivity, profile

    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = RANK, OVERSAMPLING
    params["samples_per_process"] = N_SAMPLES
    params["verbose"], params["seed"] = False, SEED + 1
    proj = ActiveSubspaceProjector(obs32, prior32, parameters=params)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proj.construct_input_subspace()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events (kernels, copies) carry their own durations; one
    # stream, so their sum is the busy time
    device_us = sum(
        e.device_time_total for e in prof.events()
        if e.device_type.name == "CUDA"
    )
    log(f"profile: wall {wall:.3f} s, device busy {device_us / 1e6:.3f} s "
        f"({100 * device_us / 1e6 / wall:.1f}%), stages {proj.stage_seconds}")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=25))


def run_phases(device, argv):
    """Phases 3-8; returns the kernels' JSON records."""
    from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior

    f64 = torch.float64
    obs64, prior64 = setup(f64, device)
    report, band64 = phase_kernels(obs64, prior64, device)
    phase_rows_s65(band64)
    del band64
    sprior64 = StructuredBiLaplacianPrior(obs64.problem.Vu, gamma=0.1,
                                          delta=1.0, dtype=f64, device=device)
    obs192, sprior192 = setup(f64, device, nx=NX192)
    inv_report = phase_inverses({NX: sprior64, NX192: sprior192})
    s193_report = phase_s193(obs192, sprior192, device)
    del obs192, sprior192
    torch.cuda.empty_cache()
    phase_parity(obs64, prior64)
    phase_parity(obs64, sprior64)
    del obs64, prior64, sprior64
    torch.cuda.empty_cache()

    obs32, prior32 = setup(torch.float32, device)
    paths = {"nx64": phase_main(obs32, prior32)}
    if "--profile" in argv:
        phase_profile(obs32, prior32)
    del obs32, prior32
    torch.cuda.empty_cache()
    paths["nx192"] = phase_lane192(device)

    for name in ("banded_factorize", "banded_solve"):
        report[name].update(s193_report[name])
    for name, key in (("K3", "batched_inverse"), ("K4", "batched_inverse_rank1")):
        report[key] = {**inv_report[(name, NX192)],
                       **{f"{k}_s65": v for k, v in inv_report[(name, NX)].items()}}
    pallas = "hippyflow_tpu/ops/pallas_kernels.py"
    sources = {
        "banded_factorize": ("banded_factorize.cu", f"{pallas}:468"),
        "banded_solve": ("banded_solve.cu", f"{pallas}:307"),
        "batched_inverse": ("batched_inverse.cu", f"{pallas}:659"),
        "batched_inverse_rank1": ("batched_inverse.cu", f"{pallas}:66"),
    }
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"hippyflow_tpu_torch/csrc/{src}", "replaces": rep,
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {path: p[name] for path, p in paths.items()},
         **report[name]}
        for name, (src, rep) in sources.items()
    ]
    return kernels


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s)")
    log(smi)

    t0 = time.perf_counter()
    lib = hk.build_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, "
        f"{len(hk.SOURCES)} sources in parallel) -> {os.path.relpath(lib, REPO)}")

    kernels = run_phases(device, argv)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
