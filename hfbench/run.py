"""The benchmark of the PyTorch and CUDA port (``hippyflow_tpu_torch``).

    python3 hfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for.  One process is one run: set-up (``setup_s``), then whole passes of
the cell until ``--seconds`` have passed, then the check against the
plain reference (``check.py``).  The last line of standard output is one
JSON object: ``correct``, ``attempted`` (passes), ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics, read by ``metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the checks are also the last lines of standard error.

A run without a CUDA card, or with fewer cards than the cell asks for,
exits with code 2 and prints no result; one that finds JAX or the JAX
package loaded exits with code 3.  The run writes no trace file: the
profiler's events are reduced in memory.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_note() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def execute(bench: dict, cell, seed: int, seconds: float, traced: bool,
            device, t_process: float = T_PROCESS) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    import torch

    from hfbench import harness, spec

    result, bank, prog = harness.run_cell(cell, seed, seconds, traced, device,
                                          t_process, log=_log)
    bad = harness.forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    harness.finish_passes(result)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench, cell.name, kind):
        value = spec.metric_reader(m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = torch.device(device)
    on_card = device.type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
            if on_card else 0}
    line = {}
    if traced and result.trace is not None:
        info["busy_s"] = result.trace.busy_s
        info["window_s"] = result.trace.window_s
        line["breakdown"] = {
            "device_ops": harness.trace.top(result.trace.kernel_s),
            "idle_gaps": harness.trace.top(result.trace.idle_by_host)}
    harness.free_program(prog, device)
    outcome = harness.reference_check(result, bank, device, log=_log)
    failed = harness.failed_passes(result)
    for note in outcome.notes:
        _log(f"check: {note}")
    checks = {k: {"value": outcome.values.get(k), "limit": v}
              for k, v in outcome.limits.items()}
    bad = harness.forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    return {"correct": outcome.ok,
            "attempted": len(result.passes), "failed": len(failed),
            "metrics": metrics, "device": info, **line, "checks": checks}


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the run inside the checkout, at fixed paths: the
    # kernel caches, and the bytecode of every module imported from here
    # on, so that only a checkout's first run compiles them
    cache = ROOT / "hfbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.pycache_prefix = str(cache / "pycache")
    sys.path.insert(0, str(ROOT))
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    import torch

    from hfbench import spec

    bench = spec.load_benchmark()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    _log(f"card: {_card_note()}; torch {torch.__version__}")
    try:
        line = execute(bench, cell, args.seed, args.seconds, bool(args.trace),
                       "cuda:0")
    except ForbiddenModules as exc:
        _log(f"JAX or the JAX package is loaded: {exc.args[0]}")
        return 3
    for name, c in line["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
