"""The application a configuration names: one added as files alone runs
and is correct; a configuration that names none, or one that does not
exist, fails at load; a state wider than the parameter is carried
through the harness and the check; the band work of bands with nb != s,
and of the confusion cells as before."""

import hashlib
import json
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from hfbench import check, harness, roofline, spec
from hfbench.reference import blocktri

SEED = 2 ** 31 + 4242

WRAPPED = '''"""confusion under another name."""
from hfbench import spec

_confusion = spec.application("confusion")
Program = _confusion.Program
reference = _confusion.reference
band_need_seconds = _confusion.band_need_seconds
'''


def _snapshot(top):
    """(path, size, sha1) of every file under ``top`` but caches."""
    out = {}
    for path in sorted(top.rglob("*")):
        if path.is_file() and not {"__pycache__", ".cache"} & set(path.parts):
            out[str(path)] = (path.stat().st_size,
                              hashlib.sha1(path.read_bytes()).hexdigest())
    return out


def _data_copy(tmp_path):
    """A copy of the benchmark's data directories under ``tmp_path``."""
    here = tmp_path / "hfbench"
    for sub in ("configs", "traffic", "workloads", "applications"):
        shutil.copytree(spec.HERE / sub, here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return here


def _write(path, obj):
    path.write_text(json.dumps(obj, indent=2) if isinstance(obj, dict) else obj)


def test_application_added_as_files_runs(tmp_path):
    before = _snapshot(spec.HERE)
    here = _data_copy(tmp_path)
    _write(here / "applications" / "wrapped.py", WRAPPED)
    config = json.loads((here / "configs" / "confusion-nx64.json").read_text())
    _write(here / "configs" / "wrapped-nx16.json",
           dict(config, name="wrapped-nx16", application="wrapped", nx=16,
                samples_per_process=16, rank=8))
    _write(here / "traffic" / "wrapped-gs2.json",
           dict(json.loads((here / "traffic" / "gridseq2.json").read_text()),
                name="wrapped-gs2"))
    workload = json.loads((here / "workloads" / "confusion-nx64.gs2.json").read_text())
    _write(here / "workloads" / "wrapped-nx16.gs2.json",
           dict(workload, name="wrapped-nx16.gs2", config="wrapped-nx16",
                traffic="wrapped-gs2"))

    cell = spec.load_cell("wrapped-nx16.gs2", here)
    result, bank, prog = harness.run_cell(cell, SEED, 1.0, False, "cpu",
                                          time.perf_counter(), log=lambda m: None)
    assert result.bands == [(17, 17), (9, 9), (5, 5)]
    harness.finish_passes(result)
    harness.free_program(prog, "cpu")
    outcome = harness.reference_check(result, bank, "cpu", log=lambda m: None)
    assert outcome.ok, outcome.values
    assert _snapshot(spec.HERE) == before


@pytest.mark.parametrize("application, missing", [
    (None, "confusion-nx64.json"), ("nope", "applications/nope.py")])
def test_config_without_its_application_fails_at_load(tmp_path, application,
                                                      missing):
    here = _data_copy(tmp_path)
    path = here / "configs" / "confusion-nx64.json"
    config = json.loads(path.read_text())
    del config["application"]
    if application is not None:
        config["application"] = application
    _write(path, config)
    with pytest.raises((ValueError, FileNotFoundError), match=missing):
        spec.load_cell("confusion-nx64.gs2", here)


# a stub application whose state (STATE wide) is wider than its parameter
# (DIM): u = (m, 2 m[:STATE - DIM]), q = u[:DQ], J a matrix of small
# integers, prior samples the noise, R the identity; every number exact in
# float32, so the program's answers equal the reference's
DIM, STATE, DQ = 6, 10, 3
JAC = (torch.arange(DQ * DIM, dtype=torch.float64).reshape(DQ, DIM) % 5) - 2


def _state(m):
    return torch.cat([m, 2 * m[:, :STATE - DIM]], 1)


class StubReference:
    n, ar = DIM, blocktri.EXACT

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, torch.device(device)

    def sample(self, noise):
        return noise

    def solve(self, m):
        N = m.shape[0]
        return _state(m), torch.ones(N, dtype=torch.bool), torch.ones(N)

    def observe(self, u):
        return u[:, :DQ]

    def jacobians(self, u, m):
        return JAC.to(m.dtype).expand(m.shape[0], -1, -1)

    def R(self, X):
        return X

    Rinv = R

    def batch_size(self):
        return 4


class StubProgram:
    def __init__(self, cell, device):
        self.dtype, self.rank = torch.float32, cell.config["rank"]
        self.dim, self.state_dim, self.dq = DIM, STATE, DQ
        self.bands = [(2, 5)]

    def run_pass(self, draws, noise):
        m = noise.normal((draws.noise.shape[0], DIM))
        ref = StubReference(torch.float64, "cpu")
        J = ref.jacobians(None, m)
        d, V = check.input_subspace(ref, J.double(), draws.omega.double(),
                                    self.rank)
        samples = SimpleNamespace(ms=m, us=_state(m), qs=_state(m)[:, :DQ],
                                  n_failures=0,
                                  iterations=torch.ones(m.shape[0]))
        proj = SimpleNamespace(samples=samples, Js=J, stage_seconds={})
        return proj, d.float(), V.float(), V

    def coarse_iterations(self):
        return []

    def free(self):
        pass


STUB = SimpleNamespace(
    Program=StubProgram,
    reference=lambda cell, dtype, device, arith=blocktri.EXACT:
        StubReference(dtype, device),
    band_need_seconds=roofline.newton_need_seconds)


def test_state_wider_than_the_parameter_is_carried_through():
    limits = {k: 1e-6 for k in check.NAMES}
    cell = spec.Cell("stub.cell", {"chips": 1, "limits": limits},
                     {"samples_per_process": 8, "rank": 2, "oversampling": 2,
                      "dtype": "float32"},
                     {"check_lanes_per_pass": 3}, STUB)
    result, bank, prog = harness.run_cell(cell, SEED, 0.05, False, "cpu",
                                          time.perf_counter(), log=lambda m: None)
    harness.finish_passes(result)
    for rec in result.passes:
        assert rec.kept["u"].shape == (3, STATE)
        assert rec.kept["m"].shape == (3, DIM)
        assert rec.kept["J"].shape == (3, DQ, DIM)
    harness.free_program(prog, "cpu")
    outcome = harness.reference_check(result, bank, "cpu", log=lambda m: None)
    assert outcome.n_lanes == 3 * len(result.passes)
    for name in ("m_gap", "u_gap", "q_gap", "J_gap"):
        assert outcome.values[name] == 0.0, (name, outcome.values)
    assert outcome.ok, outcome.values


def test_band_need_of_bands_with_nb_unlike_s():
    """Two levels, (nb, s) = (52, 516) and (27, 260), float32, dq = 100:
    10 fine and 30 coarse iterations, 4 samples."""
    cell = spec.load_cell("confusion-nx64.gs2")
    rec = SimpleNamespace(error=None, iterations=10, coarse_iterations=[30],
                          n_samples=4)
    result = harness.RunResult(cell=cell, seed=SEED, passes=[rec], window_s=1.0,
                               setup_s=1.0, bands=[(52, 516), (27, 260)], dq=100)
    flops, hbm = 67e12, 3.35e12
    # K1 at (52, 516): (6*51 + 2) s^3 operations (ops bound); at (27, 260):
    # (6*26 + 2) s^3 (ops bound)
    k1_fine = 308 * 516 ** 3 / flops
    k1_coarse = 158 * 260 ** 3 / flops
    # K2, one column: 3 nb - 2 blocks of s^2 floats, rhs and solution
    # (bytes bound); dq = 100 columns at the fine level: 2 (3 nb - 2) s^2 dq
    # operations (ops bound)
    k2_fine = (154 * 516 ** 2 + 2 * 52 * 516) * 4 / hbm
    k2_coarse = (79 * 260 ** 2 + 2 * 27 * 260) * 4 / hbm
    k2_adjoint = 2 * 154 * 516 ** 2 * 100 / flops
    want = (10 * (k1_fine + k2_fine) + 30 * (k1_coarse + k2_coarse)
            + 4 * (k1_fine + k2_adjoint))
    assert harness.band_need_seconds(result) == pytest.approx(want, rel=1e-12)


# the parent's roofline.pass_need_seconds (s alone, nb = s), frozen, at
# each cell's levels, iterations of a pass's size, dq = 100, float32
FROZEN = {
    "confusion-nx64.gs2": ([65, 33, 17], [2045, 3307, 3307], 1024,
                           0.010826460417910449),
    "confusion-nx192.cold": ([193], [934], 256, 0.1878263923961194),
    "confusion-nx192.gs3": ([193, 97, 49, 25], [256, 640, 640, 655], 256,
                            0.09436271745337313),
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_confusion_need_is_the_parents(name):
    sides, its, n, parent = FROZEN[name]
    cell = spec.load_cell(name)
    rec = SimpleNamespace(error=None, iterations=its[0],
                          coarse_iterations=its[1:], n_samples=n)
    result = harness.RunResult(cell=cell, seed=SEED, passes=[rec], window_s=1.0,
                               setup_s=1.0, bands=[(s, s) for s in sides], dq=100)
    assert harness.band_need_seconds(result) == parent
