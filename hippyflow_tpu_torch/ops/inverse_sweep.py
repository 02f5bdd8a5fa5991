"""Times K3 at the lanes' shapes in the design ``gj_resident`` picks beside the L2 design.

    python3 -m hippyflow_tpu_torch.ops.inverse_sweep [--check] [--parent DIR]
        [--out FILE]

Needs one CUDA card and ``nvcc``.  For each K3 shape of the lanes (K1's
block rows, inverted in place in an (N, 8, s, s) buffer as the row design
calls them; the cyclic-reduction levels of the structured prior, of the
control paths and of SPIKE; the helmholtz, P2 and Navier-Stokes Schur
complements), on a diagonally dominant random batch (the work does not
depend on the values), one line: the picked design's result held bit for
bit against the L2 design's and, on a few matrices, against the plain
version; then the two timed in turns (the list forwards, then backwards),
at the cluster size ``gj_cluster`` picks, beside the bound.  ``--check``
stops after the comparisons; ``--parent DIR`` adds the K3 of another
checkout of this repository (its own build, its own picks) to the
comparison and to the turns; ``--out FILE`` writes the lines' numbers as
one JSON object.  A last line holds K1's row design at the nx=192 chunk
(N=32, s=nb=193) bit for bit against its Schur steps with K3 in the L2
design (and the parent's K1), and times it in turns with the parent's.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..utils.profiling import k3_bound
from . import hopper_kernels as hk
from .schur_sweep import device_ms
from .stream_solve_sweep import load_parent

F32, F64 = torch.float32, torch.float64
# (label, N, s, rows, dtypes): rows True inverts block row ROW of an
# (N, NB, s, s) buffer (K1's row design), else an (N, s, s) batch
SHAPES = (
    ("k1rows", 32, 193, True, (F32,)),  # nx=192 Newton chunk
    ("k1rows", 16, 193, True, (F32, F64)),  # nx=192 Jacobian chunk
    ("prior_cr", 96, 193, False, (F32, F64)),  # nx=192 prior, level 0
    *(("prior_cr", n, 193, False, (F32,)) for n in (48, 24, 12, 6, 3, 1)),
    ("prior_cr", 32, 65, False, (F32,)),  # nx=64 structured prior
    ("spike_root", 4, 193, False, (F32, F64)),  # prior at P=4, the root
    ("p2rows", 32, 258, True, (F32, F64)),
    ("helmholtz_rows", 16, 516, True, (F32, F64)),
    ("ns_rows", 1, 195, True, (F64,)),
    ("ns_rows", 1, 99, True, (F64,)),
    *(("control_cr", 512 * m, 65, False, (F32, F64)) for m in (32, 16, 8, 4, 2, 1)),
    *(("control_thin", 256 * m, 9, False, (F32, F64)) for m in (150, 75, 19, 1)),
    ("spike_level0", 32768, 65, False, (F32,)),
    ("spike_level0", 8192, 65, False, (F64,)),
    ("spike_root", 4096, 65, False, (F32,)),
    ("spike_root", 1024, 65, False, (F64,)),
)
NB, ROW = 8, 5
TOL = {F32: 1e-4, F64: 1e-12}
PLAIN_N = 4


def dd_batch(n: int, s: int, dtype, device, seed: int = 0):
    """(n, s, s) diagonally dominant batch: the contract of K3."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn(n, s, s, generator=gen, dtype=dtype, device=device)
    return X + 2.0 * s**0.5 * torch.eye(s, dtype=dtype, device=device)


def sweep(label, N, s, rows, dtype, device, check_only=False, parent=None):
    limit = hk._smem_limit(device)
    c = hk.gj_cluster(N, s, hk._sm_count(device))
    design = "resident" if hk.gj_resident(s, c, torch.finfo(dtype).bits // 8,
                                         limit) else "L2"
    if rows:
        buf = torch.stack([dd_batch(N, s, dtype, device, seed=q) for q in range(NB)],
                          dim=1).contiguous()
        before = buf.clone()

        def make(mod, resident):
            kw = {} if mod is not hk else {"resident": resident}
            return lambda: mod.batched_inverse_row_(buf, ROW, **kw)

        def result(fn):
            buf.copy_(before)
            fn()
            out = buf[:, ROW].clone()
            others = [q for q in range(NB) if q != ROW]
            if not torch.equal(buf[:, others], before[:, others]):
                raise AssertionError(f"{label} N={N} s={s}: other block rows changed")
            return out

        X = before[:, ROW]
    else:
        X = dd_batch(N, s, dtype, device)

        def make(mod, resident):
            kw = {} if mod is not hk else {"resident": resident}
            return lambda: mod.batched_inverse(X, **kw)

        def result(fn):
            return fn()

    runs = {"this": make(hk, None), "L2": make(hk, False)}
    if parent is not None:
        runs["parent"] = make(parent, None)
    out = {key: result(fn) for key, fn in runs.items()}
    torch.cuda.synchronize()
    n = min(N, PLAIN_N)
    want = hk.batched_inverse_plain(X[:n].contiguous())
    err = ((out["this"][:n] - want).abs().max() / want.abs().max()).item()
    if not err <= TOL[dtype]:
        raise AssertionError(f"{label} N={N} s={s} {dtype}: against plain {err:.3e}")
    rec = {"label": label, "N": N, "s": s, "dtype": str(dtype)[6:], "cluster": c,
           "design": design, "rel_err_plain": err,
           **{f"bitwise_{k}": bool(torch.equal(out["this"], v))
              for k, v in out.items() if k != "this"}}
    head = (f"K3 {label} {rec['dtype']} N={N} s={s} c={c} {design}: rel err "
            f"{err:.2e}; bit for bit: "
            + ", ".join(f"{k[8:]} {v}" for k, v in rec.items()
                        if k.startswith("bitwise_")))
    del out
    if check_only:
        print(head, flush=True)
        return rec
    reps = 20 if N * s * s < 4e6 else 5
    ms = {key: [] for key in runs}
    for keys in (list(runs), list(runs)[::-1]):
        for key in keys:
            ms[key].append(device_ms(runs[key], reps))
    ms = {key: sum(v) / len(v) for key, v in ms.items()}
    b_ms, b_by = k3_bound(N, s, dtype)
    rec.update({f"ms_{k}": v for k, v in ms.items()}, bound_ms=b_ms, bound_by=b_by)
    line = head + "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
    if "parent" in ms:
        line += f" (this / parent {ms['this'] / ms['parent']:.3f})"
    print(line + f"; bound {b_ms:.4f} ms ({b_by})", flush=True)
    return rec


def k1_rows(N, s, nb, device, check_only=False, parent=None):
    """K1's row design on a diagonally dominant random band (N, nb, s, 3s)
    float32, held bit for bit against the same Schur steps with K3 forced
    to the L2 design (and the parent's K1), then timed in turns with the
    parent's."""
    gen = torch.Generator(device=device).manual_seed(1)
    band = 0.1 / s**0.5 * torch.randn(N, nb, s, 3 * s, generator=gen, device=device)
    band[..., s : 2 * s] += 4.0 * torch.eye(s, device=device)
    M, Dinv = hk.banded_factorize(band, design="rows")
    M2, D2 = torch.zeros_like(M), torch.zeros_like(Dinv)
    for j in range(nb):
        hk.schur_step_(band, M2, D2, j)
        hk.batched_inverse_row_(D2, j, resident=False)
    same = {"L2": torch.equal(M, M2) and torch.equal(Dinv, D2)}
    runs = {"this": lambda: hk.banded_factorize(band, design="rows")}
    if parent is not None:
        Mp, Dp = parent.banded_factorize(band, design="rows")
        same["parent"] = torch.equal(M, Mp) and torch.equal(Dinv, Dp)
        runs["parent"] = lambda: parent.banded_factorize(band, design="rows")
    torch.cuda.synchronize()
    line = (f"K1 rows float32 N={N} s={s} nb={nb}: bit for bit: "
            + ", ".join(f"{k} {v}" for k, v in same.items()))
    rec = {"label": "k1_rows", "N": N, "s": s, "nb": nb,
           **{f"bitwise_{k}": v for k, v in same.items()}}
    if not check_only:
        ms = {key: [] for key in runs}
        for keys in (list(runs), list(runs)[::-1]):
            for key in keys:
                ms[key].append(device_ms(runs[key], 3))
        ms = {key: sum(v) / len(v) for key, v in ms.items()}
        rec.update({f"ms_{k}": v for k, v in ms.items()})
        line += "; ms " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
    print(line, flush=True)
    return rec


def main(argv) -> None:
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    parent = None
    if "--parent" in argv:
        parent = load_parent(argv[argv.index("--parent") + 1])
    records = []
    for label, N, s, rows, dtypes in SHAPES:
        for dtype in dtypes:
            records.append(sweep(label, N, s, rows, dtype, device,
                                 "--check" in argv, parent))
            torch.cuda.empty_cache()
    records.append(k1_rows(32, 193, 193, device, "--check" in argv, parent))
    if "--out" in argv:
        with open(argv[argv.index("--out") + 1], "w") as f:
            json.dump({"card": card, "records": records}, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
