"""The port's plots (``utils/plotting.py``) and the projectors' spectrum
plots under ``save_and_plot``, on the CPU:

* every public function writes its file (matplotlib is installed here);
* the AS, KLE and POD projectors write the JAX package's file names, the
  PDFs beside the arrays, and the arrays byte for byte as without
  matplotlib;
* with ``sys.modules["matplotlib"] = None`` (as on a machine without it)
  the arrays are written, no PDF, a log line says so, nothing raises;
* any other error raises;
* importing the port does not import matplotlib.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from applications.confusion import (
    confusion_linear_observable as j_observable,
    confusion_prior as j_prior,
)
from hippyflow_tpu import models as jm
from hippyflow_tpu_torch import models as tm
from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable as t_observable,
    confusion_prior as t_prior,
)
from hippyflow_tpu_torch.fem import FunctionSpace, unit_square_mesh
from hippyflow_tpu_torch.utils import GivenNoise, plotting

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(dtype=torch.float64, device="cpu")
NX, N, RANK = 8, 6, 4


def _save_all(mod, obs, prior, out, keychain=None):
    """AS (input and output), KLE and POD of one package with
    save_and_plot into ``out``."""
    p = mod.ActiveSubspaceParameterList()
    p["rank"], p["oversampling"], p["samples_per_process"] = RANK, 3, N
    p["save_and_plot"], p["output_directory"], p["verbose"] = True, out, False
    AS = mod.ActiveSubspaceProjector(obs, prior, parameters=p)
    if keychain is not None:
        AS.keychain = keychain()
    AS.construct_input_subspace()
    AS.construct_output_subspace()
    p = mod.KLEParameterList()
    p["rank"], p["oversampling"] = RANK, 3
    p["save_and_plot"], p["output_directory"], p["verbose"] = True, out, False
    KLE = mod.KLEProjector(prior, parameters=p)
    if keychain is not None:
        KLE.keychain = keychain()
    KLE.construct_input_subspace("mass")
    p = mod.PODParameterList()
    p["rank"], p["sample_per_process"] = RANK, N
    p["save_and_plot"], p["output_directory"], p["verbose"] = True, out, False
    POD = mod.PODProjector(obs, prior, parameters=p)
    if keychain is not None:
        POD.keychain = keychain()
    POD.construct_subspace()


def _port_problem():
    obs, Vh = t_observable(nx=NX, sqrt_n_obs=3, velocity="analytic", **F64)
    return obs, t_prior(Vh, **F64)


def _given():
    return GivenNoise(np.random.default_rng(0), "cpu")


def test_every_public_function_writes_its_file(tmp_path):
    d = np.array([4.0, 1.0, 0.3, 0.01])
    out = lambda name: str(tmp_path / name)
    assert plotting.spectrum_plot(d, out_name=out("s.pdf")) is not None
    plotting.generic_semilogy_plot(np.arange(4), [d, 2 * d], labels=["a", "b"],
                                   out_name=out("g.pdf"))
    plotting.plot_accs_vs_data([32, 64], [[0.5, 0.7], [0.6, 0.8]],
                               labels=["x", "y"], out_name=out("a.pdf"))
    plotting.plot_singular_values_with_std(d, 0.1 * d, out_name=out("sv.pdf"))
    V = FunctionSpace(unit_square_mesh(4))
    plotting.plot(V, np.arange(V.dim, dtype=float), out_name=out("f.pdf"))
    plotting.plot_eigenvector(V, np.ones(V.dim), out_name=out("e.pdf"))
    plotting.plot_pts(V.dof_coords, np.arange(V.dim), out_name=out("p.pdf"))
    for name in ("s", "g", "a", "sv", "f", "e", "p"):
        assert os.path.getsize(out(name + ".pdf")) > 0, name
    rng = np.random.default_rng(0)
    bases = [np.linalg.qr(rng.standard_normal((10, 3)))[0] for _ in range(3)]
    got = plotting.subspace_angle_video(bases, out_name=out("v.mp4"))
    if got.endswith(".mp4"):
        assert os.path.getsize(got) > 0
    else:  # no ffmpeg: one png per frame
        assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".png")) == [
            "v_0000.png", "v_0001.png"]
    assert plotting.subspace_angle_video(bases[:1], out_name=out("w.mp4")) is None


def test_projectors_write_the_jax_plot_names_beside_unchanged_arrays(
        tmp_path, monkeypatch):
    jobs, jV = j_observable(nx=NX, sqrt_n_obs=3, velocity="analytic")
    _save_all(jm, jobs, j_prior(jV), str(tmp_path / "jax"))
    obs, prior = _port_problem()
    _save_all(tm, obs, prior, str(tmp_path / "port"), _given)
    jax_files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == jax_files
    assert len([f for f in jax_files if f.endswith(".pdf")]) == 4
    # the same run without matplotlib writes the same arrays, byte for byte
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _save_all(tm, obs, prior, str(tmp_path / "bare"), _given)
    arrays = [f for f in jax_files if f.endswith(".npy")]
    assert sorted(os.listdir(tmp_path / "bare")) == arrays
    for f in arrays:
        assert (tmp_path / "bare" / f).read_bytes() == (
            tmp_path / "port" / f).read_bytes(), f


def test_without_matplotlib_arrays_are_written_and_a_line_logged(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    obs, prior = _port_problem()
    with caplog.at_level(logging.WARNING, logger=plotting.__name__):
        _save_all(tm, obs, prior, str(tmp_path), _given)
        assert plotting.spectrum_plot([1.0, 0.5]) is None
    files = os.listdir(tmp_path)
    assert not [f for f in files if f.endswith(".pdf")]
    assert {"AS_6_d_GN.npy", "AS_6_d_NG.npy", "KLE_d.npy", "POD_d.npy"} <= set(files)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 5
    assert all("matplotlib is not installed" in line for line in lines)
    assert any("KLE_eigenvalues_4.pdf" in line for line in lines)


def test_other_errors_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        plotting.spectrum_plot([1.0, 0.1], out_name=str(tmp_path / "no" / "s.pdf"))
    with pytest.raises(ValueError):
        plotting.plot_singular_values_with_std([1.0, 0.1], [0.1, 0.2, 0.3])


def test_importing_the_port_imports_no_matplotlib():
    code = ("import sys, hippyflow_tpu_torch, hippyflow_tpu_torch.utils, "
            "hippyflow_tpu_torch.models, hippyflow_tpu_torch.utils.plotting; "
            "sys.exit('matplotlib' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
