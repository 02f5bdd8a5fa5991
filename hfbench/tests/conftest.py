"""Shared helpers of the benchmark's tests: the checkout's root on the
path, and tiny CPU versions of the benchmark's cells."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("confusion-nx64.gs2", "confusion-nx192.cold", "confusion-nx192.gs3")
TINY_NX = 16


def tiny_velocity(config: dict, root: Path = ROOT):
    """The configuration's velocity at the grid of its ``nx``: the file's
    nodes taken at every stride-th one (a coarser grid nested in the
    file's, by injection)."""
    import numpy as np

    vel = np.load(root / config["velocity_file"])
    side = int(round(vel.shape[0] ** 0.5))
    stride = (side - 1) // config["nx"]
    return np.ascontiguousarray(vel.reshape(side, side, 2)[::stride, ::stride]
                                .reshape(-1, 2))


def use_tiny_velocity(setattr=setattr) -> None:
    """Make ``spec.load_velocity`` give ``tiny_velocity``, through
    ``setattr`` (a monkeypatch's, or the builtin for the whole process)."""
    from hfbench import spec

    setattr(spec, "load_velocity", tiny_velocity)


@pytest.fixture(autouse=True)
def _tiny_velocity(monkeypatch):
    use_tiny_velocity(monkeypatch.setattr)


def tiny_cell(name: str):
    """The cell cut to a size a CPU test run holds: nx=16, 16 samples,
    rank 8, chunks a quarter; everything else as run."""
    from hfbench import spec

    cell = spec.load_cell(name)
    cell.config = dict(cell.config, samples_per_process=16, rank=8, nx=TINY_NX)
    traffic = dict(cell.traffic)
    for key in ("chunk_size", "jac_chunk_size"):
        if traffic[key] is not None:
            traffic[key] = traffic[key] // 4
    cell.traffic = traffic
    return cell


@pytest.fixture(params=CELLS)
def tiny(request):
    return tiny_cell(request.param)
