#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hippyflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile   # also: device-time table of the main path

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or
``/usr/local/cuda/bin``); imports nothing of JAX.  Phases, one summary line
each:

1. device: the card, and its name and power limit from ``nvidia-smi``;
2. build: the hand-written kernels K1/K2 compiled from ``csrc/``;
3. kernels: K1 (``banded_factorize``) and K2 (``banded_solve``) against their
   plain PyTorch versions on confusion bands at nx=64 (N=256, nb=s=65,
   k=1 and k=100) in float32 and float64, with residuals and timings;
4. parity: the float64 pipeline on ``.bench/parity_ref.npz`` against the
   stored reference spectrum (relative error <= 1e-8 over eigenvalues above
   1e-4 lambda_0);
5. main path: the float32 input active subspace of confusion at nx=64 with
   the steady Navier-Stokes velocity, 1024 prior samples, rank 100,
   oversampling 10, through ``ActiveSubspaceProjector``.

Then a JSON line describing the kernels, and last the result line
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


def setup(dtype, device):
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
        load_ns_velocity,
    )

    vel = load_ns_velocity(NX)
    obs, Vh = confusion_linear_observable(
        nx=NX, velocity=vel, dtype=dtype, device=device
    )
    prior = confusion_prior(Vh, dtype=dtype, device=device)
    return obs, prior


def phase_kernels(obs64, prior64, device):
    """K1/K2 against their plain versions at the main path's shapes."""
    from hippyflow_tpu_torch.fem import bc_symmetrize_banded_from_mask
    from hippyflow_tpu_torch.ops import hopper_kernels as hk
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        block_tridiag_matmat_trans,
    )

    pde = obs64.problem
    gen = torch.Generator(device=device).manual_seed(SEED)
    xi = torch.randn(2 * N_BAND, prior64.noise_dim, generator=gen,
                     dtype=torch.float64, device=device)
    ms = prior64.sample(xi)
    # bands of the bc-symmetrized Newton operator, at prior samples of m
    # and at states u drawn from the same prior (the cubic term is live)
    band64 = bc_symmetrize_banded_from_mask(
        pde.bound.assemble_A_banded(ms[N_BAND:], ms[:N_BAND]), pde.bc
    ).contiguous()
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
    return report


def phase_parity(obs64, prior64):
    """The float64 pipeline against the stored reference spectrum."""
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
    log(f"parity float64: rel eig err {err:.3e} over {int(head.sum())} head "
        f"eigenvalues (limit 1e-8), {secs:.2f} s")
    check(err <= 1e-8, f"parity: relative eigenvalue error {err:.3e} > 1e-8")
    return err


def phase_main(obs32, prior32):
    """The float32 main path, once, through the user entry point."""
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )
    from hippyflow_tpu_torch.ops import hopper_kernels as hk

    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = RANK, OVERSAMPLING
    params["samples_per_process"] = N_SAMPLES
    params["verbose"], params["seed"] = False, SEED
    proj = ActiveSubspaceProjector(obs32, prior32, parameters=params)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    d, V, E = proj.construct_input_subspace()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {
        "banded_factorize": hk.banded_factorize.launches,
        "banded_solve": hk.banded_solve.launches,
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = proj.stage_seconds
    it = proj.samples.iterations.to(torch.float64)
    ortho = (V.T @ E - torch.eye(V.shape[1], dtype=V.dtype, device=V.device))
    ortho = ortho.abs().max().item()
    log(
        f"main float32 nx={NX} samples={N_SAMPLES} rank={RANK}: total "
        f"{total:.3f} s (forward {st['forward']:.3f}, jacobian "
        f"{st['jacobian']:.3f}, ghep {st['ghep']:.3f}); Newton iterations "
        f"max {int(it.max().item())} mean {it.mean().item():.3f}; resampled "
        f"failures {proj.samples.n_failures}; launches K1 "
        f"{launches['banded_factorize']} K2 {launches['banded_solve']}; "
        f"peak {peak_gb:.2f} GB"
    )
    log(f"main eigenvalues[:5] {[round(x, 6) for x in d[:5].tolist()]}; "
        f"max|V^T R V - I| {ortho:.3e}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for name, t in (("d", d), ("decoder", V), ("encoder", E)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(d.shape == (RANK,) and V.shape == (obs32.dM, RANK),
          f"shapes {tuple(d.shape)}, {tuple(V.shape)}")
    check(bool((d[1:] <= d[:-1]).all()), "eigenvalues are not descending")
    check(ortho <= ORTHO_TOL_F32, f"max|V^T R V - I| {ortho:.3e}")
    return launches, proj


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
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a) -> "
        f"{os.path.relpath(lib, REPO)}")

    obs64, prior64 = setup(torch.float64, device)
    report = phase_kernels(obs64, prior64, device)
    phase_parity(obs64, prior64)
    del obs64, prior64
    torch.cuda.empty_cache()

    obs32, prior32 = setup(torch.float32, device)
    launches, _ = phase_main(obs32, prior32)
    if "--profile" in argv:
        phase_profile(obs32, prior32)

    sources = {
        "banded_factorize": ("hippyflow_tpu_torch/csrc/banded_factorize.cu",
                             "hippyflow_tpu/ops/pallas_kernels.py:468"),
        "banded_solve": ("hippyflow_tpu_torch/csrc/banded_solve.cu",
                         "hippyflow_tpu/ops/pallas_kernels.py:307"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **report[name]}
        for name, (src, rep) in sources.items()
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
