"""The port's ``utils/profiling.py`` against the JAX package's on the CPU:
``PhaseTimer``'s timings, counts and report, ``trace`` (a Chrome trace
file), ``annotate`` (a range in the profiler's events), the peak rates,
``flops_of`` / ``bytes_of`` of a matmul against XLA's counts for the same
matmul, ``mfu_report``'s keys, the analytic inverse-Thomas models against
JAX's, and the kernels' bounds against the numbers ``PERF.md`` records."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu.ops import structured as jstructured
from hippyflow_tpu.utils import profiling as jprof
from hippyflow_tpu_torch import ops as tops
from hippyflow_tpu_torch import utils as tutils
from hippyflow_tpu_torch.utils import profiling as tprof

F32, F64 = torch.float32, torch.float64


def _timed(timer, names):
    for name in names:
        with timer.phase(name) as holder:
            holder["result"] = [torch.ones(2)]
    return timer


def test_phase_timer_matches_jax():
    names = ["assembly", "solve", "assembly"]
    mine = _timed(tutils.PhaseTimer(), names)
    theirs = jprof.PhaseTimer()
    for name in names:
        with theirs.phase(name, block_on=jnp.ones(2)):
            pass
    assert mine.counts == theirs.counts == {"assembly": 2, "solve": 1}
    assert set(mine.timings) == set(theirs.timings)
    assert all(t >= 0.0 for t in mine.timings.values())
    # the report's layout: one line per phase, longest first
    mine.timings = dict(theirs.timings)
    assert mine.report() == theirs.report()
    line = re.compile(r"^\S+ +\d+\.\d{3}s  \(x\d+\)$")
    assert all(line.match(row) for row in mine.report().splitlines())


def test_phase_timer_verbose_prints(capsys):
    _timed(tutils.PhaseTimer(verbose=True), ["stage"])
    assert re.match(r"stage took \d+\.\d{3}s", capsys.readouterr().out)


def test_trace_writes_a_chrome_trace_and_annotate_is_in_it(tmp_path):
    log_dir = str(tmp_path / "trace")
    a, b = torch.randn(16, 8), torch.randn(8, 4)
    with tutils.trace(log_dir) as prof:
        with tutils.annotate("p2_stage"):
            a @ b
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0])) as f:
        assert '"p2_stage"' in f.read()
    assert any(e.name == "p2_stage" for e in prof.events())


def test_trace_raises_where_the_profiler_fails(tmp_path):
    """The JAX module swallows a failed trace; the port's raises."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(Exception):
        with tutils.trace(str(blocker / "below_a_file")):
            torch.ones(2) + 1


def test_peaks():
    assert tprof.device_peak_tflops("cpu") == 1.0
    assert tprof.device_peak_hbm_gbs(torch.device("cpu")) == 50.0
    cpu = jprof.device_peak_tflops(), jprof.device_peak_hbm_gbs()
    assert cpu == (tprof.device_peak_tflops("cpu"), tprof.device_peak_hbm_gbs("cpu"))


@pytest.mark.parametrize("name, peaks", [
    ("NVIDIA H100 80GB HBM3", (67.0, 3350.0)),
    ("NVIDIA H100 SXM5 80GB", (67.0, 3350.0)),
    ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA GeForce RTX 4090", None),
])
def test_card_peaks_by_name(monkeypatch, name, peaks):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    dev = torch.device("cuda", 0)
    if peaks is None:
        with pytest.raises(ValueError, match="no peak rates"):
            tprof.device_peak_tflops(dev)
        with pytest.raises(ValueError, match="no peak rates"):
            tprof.device_peak_hbm_gbs(dev)
    else:
        assert (tprof.device_peak_tflops(dev), tprof.device_peak_hbm_gbs(dev)) == peaks


@pytest.mark.parametrize("shape", [(16, 24, 8), (64, 64, 32)])
def test_flops_and_bytes_of_a_matmul_match_xla(shape):
    n, k, m = shape
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((n, k)), rng.standard_normal((k, m))
    f = lambda x, y: x @ y
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert tprof.flops_of(f, ta, tb) == jprof.flops_of(f, jnp.asarray(a),
                                                       jnp.asarray(b)) == 2 * n * k * m
    assert tprof.bytes_of(f, ta, tb) == jprof.bytes_of(f, jnp.asarray(a),
                                                       jnp.asarray(b))


def test_mfu_report_keys():
    a, b = torch.randn(32, 32, dtype=F64), torch.randn(32, 32, dtype=F64)
    rep = tprof.mfu_report(lambda x, y: x @ y, a, b, iters=2, name="mm")
    assert set(rep) == {"name", "flops", "bytes", "seconds", "tflops", "mfu",
                        "gbs", "xla_bytes_ratio", "device"}
    assert rep["name"] == "mm" and rep["device"] == "cpu"
    assert rep["flops"] == 2 * 32**3 and rep["seconds"] > 0
    assert rep["mfu"] == pytest.approx(rep["tflops"] / 1.0)
    assert rep["xla_bytes_ratio"] == pytest.approx(rep["gbs"] / 50.0)


@pytest.mark.parametrize("nb, s, k, itemsize", [(65, 65, 1, 4), (65, 258, 1, 4),
                                                (193, 193, 100, 8), (52, 516, 200, 4)])
def test_thomas_inv_models_match_jax(nb, s, k, itemsize):
    assert tops.thomas_inv_flops(nb, s, k) == jstructured.thomas_inv_flops(nb, s, k)
    assert tops.thomas_inv_bytes(nb, s, k, itemsize) == \
        jstructured.thomas_inv_bytes(nb, s, k, itemsize)


@pytest.mark.parametrize("fn, args, ms, by", [
    # PERF.md's kernel table: K1 N=256 s=nb=65 float32 / float64
    (tprof.k1_bound, (256, 65, 65, F32), 0.420, "bytes"),
    (tprof.k1_bound, (256, 65, 65, F64), 0.840, "bytes"),
    # K2 N=256 s=65 k=100 / k=1 float32, k=100 float64
    (tprof.k2_bound, (256, 65, 65, 100, F32), 0.623, "operations"),
    (tprof.k2_bound, (256, 65, 65, 100, F64), 1.015, "bytes"),
    (tprof.k2_bound, (256, 65, 65, 1, F32), 0.252, "bytes"),
    # K3 on the prior's CR blocks N=96 s=193
    (tprof.k3_bound, (96, 193, F32), 0.0206, "operations"),
    # the Schur step N=16 s=193, N=16 s=516
    (tprof.schur_bound, (16, 193, F32), 0.0069, "operations"),
    (tprof.schur_bound, (16, 516, F64), 0.1312, "operations"),
])
def test_bounds_give_perf_md_numbers(fn, args, ms, by):
    got_ms, got_by = fn(*args)
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=5e-3)


def test_bound_keys_and_peaks_of_the_bounds():
    assert tprof.bound_keys("s258", 1.5, "bytes") == {
        "bound_ms_s258": 1.5, "bound_by_s258": "bytes"}
    assert tprof.PEAK_FLOPS[F32] == tprof.PEAK_FLOPS[F64] == 67e12
    assert tprof.HBM_BYTES_PER_S == 3.35e12
    # 67e12 operations or 3.35e12 bytes take one second
    assert tprof.bound(67e12, 0.0, F32) == (1e3, "operations")
    assert tprof.bound(0.0, 3.35e12, F64) == (pytest.approx(1e3), "bytes")
