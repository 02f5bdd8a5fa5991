"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files of one cell under ``hfbench/``, each found by its name:

* ``workloads/<cell>.json``: the cell's configuration, traffic, chips,
  ``why`` and the limits of its correctness check;
* ``configs/<config>.json``: the configuration's source, sizes, ``reduced``,
  ``assumed`` and ``application``;
* ``applications/<application>.py``: the program that configurations of
  the application run, its plain reference and the band work its pass
  needs (``applications/__init__.py`` lists what the module defines);
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``metrics/band_kernels.d/*``: the names of the band kernels.

A later change adds a cell, a configuration, an application, a traffic mix
or a metric by adding files and entries; none of these files is edited.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    application: object   # the module applications/<application>.py

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def load_cell(name: str, here: Path = HERE) -> Cell:
    workload = _json(here / "workloads" / f"{check_name(name)}.json")
    config_path = here / "configs" / f"{check_name(workload['config'])}.json"
    config = _json(config_path)
    traffic = _json(here / "traffic" / f"{check_name(workload['traffic'])}.json")
    if "application" not in config:
        raise ValueError(f"{config_path} names no application: it needs an "
                       f"\"application\" key, the name of a file "
                       f"{here / 'applications'}/<application>.py")
    return Cell(name, workload, config, traffic,
                application(config["application"], here))


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ('end_to_end' or 'per_layer') metrics that ``cell``
    reports: those that list it under ``workloads``, or list none."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "hfbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def application(name: str, here: Path = HERE):
    """The module ``applications/<name>.py``."""
    path = here / "applications" / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no application module {path}")
    spec = importlib.util.spec_from_file_location(
        "hfbench_application_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_velocity(config: dict, root: Path = ROOT):
    """The configuration's (n, 2) velocity dof values, from its file."""
    import numpy as np

    return np.load(root / config["velocity_file"])


def band_kernel_names(here: Path = HERE) -> set[str]:
    """Every kernel name listed in ``metrics/band_kernels.d``: one per
    line, '#' starts a comment."""
    names = set()
    for path in sorted((here / "metrics" / "band_kernels.d").iterdir()):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                names.add(line)
    return names
