"""Times K2's panel design at each column split, panel width and register tile beside ``panel_geometry``'s pick.

    python3 -m hippyflow_tpu_torch.ops.panel_solve_sweep [--check]
        [--parent DIR] [--out FILE]

Needs one CUDA card and ``nvcc``.  For each (N, s, nb, k) at which the
lanes launch the panel design (random contracting factor blocks: the work
does not depend on the values), in float32 and float64, transposed (the
lanes' orientation) and at s=65 also forward: every geometry that fits
(column tiles around the card's SM count over N, every width of
``panel_row_options``, both register tiles, the most slices of the inner
index that fit, half as many and one, and the rule's pick at each tile
count) held against the plain
version, then timed in turns (the list forwards, then backwards; mean of
the launches of a timing after a warm-up) with the plain version and, with
``--parent DIR``, the K2 of another checkout of this repository (its own
build), beside the bound (operations at 67 TFLOP/s, bytes at 3.35 TB/s).
One line per shape: the picked geometry and its time, the fastest few,
plain, parent and bound; ``--out FILE`` (JSON lines) keeps every
geometry's time.  ``--check`` stops after the comparison.  The rule of
``panel_geometry`` (``hopper_kernels``) was fitted to these lines.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..utils.profiling import k2_bound
from . import hopper_kernels as hk
from .stream_solve_sweep import load_parent, mean_ms

# (N, s, nb, k, orientations): the nx=64 Jacobian chunk, the nx=192
# Jacobian chunk, the helmholtz chunk
SHAPES = (
    (256, 65, 65, 100, (True, False)),
    (16, 193, 193, 100, (True,)),
    (16, 516, 52, 200, (True,)),
)
DTYPES = (torch.float32, torch.float64)
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def random_case(N, s, nb, k, dtype, device, seed=0):
    """M, Dinv, B (N, nb, s, s) with spectral norms near 0.2, 1 and 0.2 and
    a rhs (N, nb, s, k)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 0.1 / s**0.5
    blocks = [scale * torch.randn(N, nb, s, s, generator=gen, dtype=dtype,
                                  device=device) for _ in range(3)]
    blocks[1] += torch.eye(s, dtype=dtype, device=device)
    bb = torch.randn(N, nb, s, k, generator=gen, dtype=dtype, device=device)
    return (*blocks, bb)


def candidates(N, s, k, itemsize, device):
    """Every geometry the sweep times: column tiles from sm_count / N - 4
    to sm_count / N + 2, or on to the fourth count at which anything fits
    (within k and 2 sm_count / N + 2), each panel width of
    ``panel_row_options`` and register tile that fits one block, each at
    the most slices of the inner index that fit, half as many and one,
    and the rule's pick at each tile count."""
    sm = hk._sm_count(device)
    limit, sm_smem = hk._smem_limit(device), hk._sm_smem(device)
    out, counts = [], 0
    t = max(1, sm // N - 4)
    while t <= min(k, 2 * sm // N + 2) and (t <= sm // N + 2 or counts < 4):
        fits = hk.panel_fits(s, k, t, itemsize, limit, sm_smem)
        counts += bool(fits)
        for g in fits:
            out.append(g)
            for ls in sorted({g.lsplit // 2, 1} - {0, g.lsplit}):
                out += hk.panel_fits(s, k, t, itemsize, limit, sm_smem,
                                     [g.rows], [g.row_tile], ls)
        rule = hk.panel_geometry(N, s, k, itemsize, sm, limit, sm_smem, tiles=t)
        if rule is not None and rule not in out:
            out.append(rule)
        t += 1
    return out


def sweep(N, s, nb, k, dtype, trans, device, check_only=False, parent=None,
          out_file=None):
    M, Dinv, B, bb = random_case(N, s, nb, k, dtype, device)
    x_p = hk.banded_solve_plain(M, Dinv, B, bb, trans)
    scale = x_p.abs().max().item()
    item = bb.element_size()
    picked = hk.panel_geometry(N, s, k, item, hk._sm_count(device),
                               hk._smem_limit(device), hk._sm_smem(device))
    geos = candidates(N, s, k, item, device)
    if picked not in geos:
        geos.append(picked)
    worst = 0.0
    for g in geos:
        x = hk.banded_solve(M, Dinv, B, bb, trans,
                            tiles=(g.rows, g.tiles, g.row_tile, g.lsplit))
        torch.cuda.synchronize()
        err = (x - x_p).abs().max().item() / scale
        if not err <= TOL[dtype]:
            raise AssertionError(f"N={N} s={s} k={k} {dtype} trans={trans} {g}: "
                                 f"against plain {err:.3e}")
        worst = max(worst, err)
    del x
    name = str(dtype)[6:]
    head = (f"K2 panels {name} N={N} s={s} nb={nb} k={k} "
            f"{'transposed' if trans else 'forward'}: {len(geos)} geometries, "
            f"rel err {worst:.2e}")
    if check_only:
        print(head, flush=True)
        return

    def key(g):
        return f"t={g.tiles} R={g.rows} rt={g.row_tile} ls={g.lsplit}"

    runs = {key(g): (lambda g=g: hk.banded_solve(
        M, Dinv, B, bb, trans, tiles=(g.rows, g.tiles, g.row_tile, g.lsplit)))
        for g in geos}
    runs["plain"] = lambda: hk.banded_solve_plain(M, Dinv, B, bb, trans)
    if parent is not None:
        runs["parent"] = lambda: parent.banded_solve(M, Dinv, B, bb, trans)
    reps = 2 if s >= 400 else 3
    ms = {name_: [] for name_ in runs}
    for keys in (list(runs), list(runs)[::-1]):
        for name_ in keys:
            ms[name_].append(mean_ms(runs[name_], reps))
    ms = {name_: sum(v) / len(v) for name_, v in ms.items()}
    b_ms, b_by = k2_bound(N, nb, s, k, dtype)
    mine = sorted((g for g in geos), key=lambda g: ms[key(g)])
    line = (head + f"; picked {key(picked)} {ms[key(picked)]:.3f} ms "
            f"({ms[key(picked)] / ms[key(mine[0])]:.3f}x the fastest); fastest "
            + ", ".join(f"{key(g)} {ms[key(g)]:.3f}" for g in mine[:4])
            + f"; plain {ms['plain']:.3f}"
            + (f"; parent {ms['parent']:.3f}" if parent is not None else "")
            + f"; bound {b_ms:.3f} ms ({b_by})")
    print(line, flush=True)
    if out_file is not None:
        with open(out_file, "a") as f:
            for g in geos:
                f.write(json.dumps({
                    "dtype": name, "N": N, "s": s, "nb": nb, "k": k,
                    "trans": trans, **g._asdict(), "ms": ms[key(g)],
                    "picked": g == picked}) + "\n")
            f.write(json.dumps({
                "dtype": name, "N": N, "s": s, "nb": nb, "k": k, "trans": trans,
                "plain_ms": ms["plain"], "parent_ms": ms.get("parent"),
                "bound_ms": b_ms, "bound_by": b_by}) + "\n")


def main(argv) -> None:
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = None
    if "--parent" in argv:
        parent = load_parent(argv[argv.index("--parent") + 1])
    out_file = argv[argv.index("--out") + 1] if "--out" in argv else None
    for N, s, nb, k, orientations in SHAPES:
        for dtype in DTYPES:
            for trans in orientations:
                sweep(N, s, nb, k, dtype, trans, device, "--check" in argv,
                      parent, out_file)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
