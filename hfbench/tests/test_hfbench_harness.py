"""The harness end to end at a tiny size on the CPU: a sound run is
correct; the control and each fault a cell can have are not; the run
refuses a machine without a card and a process with JAX loaded."""

import os
import subprocess
import sys
import time

import pytest
import torch

from hfbench import calibrate, check, harness, spec
from hfbench.applications.confusion import Reference as Confusion

from conftest import ROOT

SEED = 2 ** 31 + 12345


def _correct(cell, seconds=1.0, seed=SEED):
    """Set-up, window and check of one tiny run: (correct, outcome)."""
    result, bank, prog = harness.run_cell(cell, seed, seconds, False, "cpu",
                                          time.perf_counter(), log=lambda m: None)
    harness.finish_passes(result)
    harness.free_program(prog, "cpu")
    outcome = harness.reference_check(result, bank, "cpu", log=lambda m: None)
    return outcome.ok, outcome


def test_sound_run_is_correct(tiny):
    ok, outcome = _correct(tiny)
    assert ok, outcome.values


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_fault_is_not_correct(fault, tiny, monkeypatch):
    calibrate.FAULTS[fault](monkeypatch.setattr)
    ok, outcome = _correct(tiny, seconds=1.5)
    assert not ok, outcome.values


def test_control_fails_the_limits(tiny):
    """The reference one precision below float32 (TF32 products), put in
    the program's place, fails at least one limit; the reference in
    float32 itself passes them."""
    cfg = tiny.config
    n, rank = cfg["samples_per_process"], cfg["rank"]
    truth = Confusion(cfg["nx"], spec.load_velocity(cfg), cfg["sqrt_n_obs"],
                      cfg["c"], cfg["k"], cfg["gamma"], cfg["delta"],
                      dtype=torch.float64, device="cpu")
    bank = harness.DrawBank(SEED, n, truth.n, rank + cfg["oversampling"],
                            torch.float32, "cpu")
    draws = bank._make(0)
    lanes = harness.check_lanes(SEED, 0, n, 4)
    ref = check.solve_reference(truth, {0: draws}, {0: lanes}, 0, rank)
    limits = tiny.limits
    for side, should_pass in (("tf32", False), ("float32", True)):
        answers = calibrate.stand_in_answers(tiny, draws, lanes, side, "cpu")
        values, _ = check.judge(truth, ref, {0: answers}, 0)
        passes = all(values[k] <= v for k, v in limits.items())
        assert passes == should_pass, (side, values)


def test_forbidden_modules_compare_whole_top_level_names():
    found = harness.forbidden_modules({
        "jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
        "hippyflow_tpu": 1, "hippyflow_tpu.ops": 1, "hippyflow_tpu_torch": 1,
        "hippyflow_tpu_torch.ops": 1, "jaxtyping": 1, "hfbench": 1})
    assert found == ["flax", "hippyflow_tpu", "hippyflow_tpu.ops", "jax",
                     "jax.numpy", "jaxlib.xla"]


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys; sys.path.insert(0, '.');"
        "import hfbench.check, hfbench.reference.confusion, hfbench.calibrate;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'hippyflow_tpu', 'hippyflow_tpu_torch')];"
        "print(bad); assert not bad")
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_loads_no_jax():
    """A whole tiny run in a process of its own, through ``execute``, which
    refuses a process holding JAX or the JAX package."""
    out = _python(
        "import sys, time; sys.path.insert(0, '.'); sys.path.insert(0, 'hfbench/tests');"
        "from conftest import tiny_cell, use_tiny_velocity; from hfbench import run, spec;"
        "use_tiny_velocity();"
        "line = run.execute(spec.load_benchmark(), tiny_cell('confusion-nx64.gs2'),"
        " 7, 0.5, False, 'cpu', time.perf_counter());"
        "assert line['correct'], line; assert list(line)[-1] == 'checks';"
        "assert set(line['metrics']) == {'subspace_s', 'setup_s'}")
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]


def test_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "hfbench/run.py", "--workload", "confusion-nx64.gs2",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "hfbench/run.py", "--workload", "confusion-nx64.gs2",
         "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    for name in ("band_roofline", "device_idle"):
        assert 0 < line["metrics"][name]["value"] <= 100
