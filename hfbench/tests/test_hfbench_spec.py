"""The benchmark's data files: every cell, configuration, traffic mix and
metric that BENCHMARK.json names loads, and every name and unit keeps to
the allowed characters."""

import json
import re

import pytest

from hfbench import spec

BENCH = spec.load_benchmark()


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert spec.NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_agree(entry):
    cell = spec.load_cell(entry["name"])
    assert cell.workload["config"] == entry["config"]
    assert cell.workload["traffic"] == entry["traffic"]
    assert cell.chips == entry["chips"] == 1
    assert cell.workload["why"] == entry["why"]
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cell.config["name"] == conf["name"]
    assert cell.config["source"] == conf["source"]
    assert cell.config["reduced"] == conf["reduced"]
    assert conf["file"] == f"hfbench/configs/{conf['name']}.json"
    assert set(cell.limits) == {"m_gap", "u_gap", "q_gap", "J_gap", "d_gap",
                                "V_gap"}


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_band_kernel_names():
    names = spec.band_kernel_names()
    assert {"banded_chain_kernel", "schur_tile_kernel", "gj_inverse_kernel",
            "banded_solve_kernel", "banded_stream_kernel"} <= names


def test_reduced_keys_differ_from_source():
    for conf in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / conf["file"]).read_text())
        for key in conf["reduced"]:
            assert cfg[key] != cfg["source_values"][key]
        assert not any(re.search(r"(_dim|_rank)$", k) or k == "rank"
                       for k in conf["reduced"])
