"""The float32 precision settings of the PyTorch port, and the TF32 sweep
that measures the JAX package's solver-precision policy on the card, on
the CPU:

* after import the CUDA and cuDNN float32 settings read "ieee", set
  through PyTorch's per-backend API; no module of the port (nor
  ``chip_smoke.py``) uses the legacy ``allow_tf32`` /
  ``set_float32_matmul_precision`` API; ``default_dtype`` and
  ``default_int_dtype``;
* ``ops.tf32_sweep``'s modes on a random band, float64: each sets only
  ``torch.backends.cuda.matmul.fp32_precision`` and puts it back, also on
  an exception; on the CPU the TF32 mode changes no bit; its refined mode
  is the JAX package's ``RefinedBandFactor`` with one sweep, around the
  same factor (1e-12);
* the sweep's measurement on the Poisson control problem's band at nx=8.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from hippyflow_tpu.ops import structured as jstructured
from hippyflow_tpu_torch import config as tconfig
from hippyflow_tpu_torch.ops import tf32_sweep

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(dtype=torch.float64, device="cpu")
FACTOR_TOL = 1e-12  # the refined mode against JAX's wrapper
SOLVERS = ("block_cyclic", "block_tridiag")
JAX_FACTORIZE = {"block_cyclic": "factorize_block_cyclic_banded",
                 "block_tridiag": "factorize_block_tridiag_banded"}


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the settings -----------------------------------------------------------------

def test_default_dtypes():
    assert tconfig.default_dtype() is tconfig.DEFAULT_DTYPE is torch.float32
    assert tconfig.default_int_dtype() is torch.int64


def _port_sources():
    root = os.path.join(REPO, "hippyflow_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_import_pins_ieee_through_the_new_api_only():
    """After import the float32 settings read "ieee"; no module of the port
    reads or sets the legacy API, whose state PyTorch refuses to mix with
    the per-backend settings."""
    import hippyflow_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.fp32_precision == "ieee"
    assert torch.backends.cudnn.fp32_precision == "ieee"
    legacy = {"allow_tf32", "set_float32_matmul_precision",
              "get_float32_matmul_precision"}
    found = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        found += [f"{os.path.relpath(path, REPO)}:{node.lineno}"
                  for node in ast.walk(tree)
                  if isinstance(node, ast.Attribute) and node.attr in legacy]
    assert not found, found


# -- the sweep's modes ------------------------------------------------------------

def _others():
    return (torch.backends.mkldnn.matmul.fp32_precision,
            torch.backends.cudnn.fp32_precision)


@pytest.mark.parametrize("solver", SOLVERS)
def test_tf32_sweep_modes_match_jax_on_the_cpu(solver):
    """On a random band (a batch of one), float64: ``ieee`` and ``tf32``
    give the same bits on the CPU, ``tf32+1`` is JAX's RefinedBandFactor
    with one sweep around the same factor; every mode leaves the CUDA,
    mkldnn and cuDNN settings as it found them."""
    band = W.random_band(6, 4, 0)
    b = np.random.default_rng(1).standard_normal(band.shape[0] * band.shape[1])
    tband, tb = torch.as_tensor(band, **F64)[None], torch.as_tensor(b, **F64)[None]
    before = _others()
    x = {}
    for mode in tf32_sweep.MODES:
        x[mode], _, _, k3 = tf32_sweep.run_mode(solver, tband, tb, mode)
        assert torch.backends.cuda.matmul.fp32_precision == "ieee"
        assert _others() == before
        assert k3 == 0  # no kernel on the CPU
    assert torch.equal(x["ieee"], x["tf32"])
    jinner = getattr(jstructured, JAX_FACTORIZE[solver])(jnp.asarray(band))
    want = jstructured.RefinedBandFactor(jinner, jnp.asarray(band), 1).solve(
        jnp.asarray(b))
    assert _rel(x["tf32+1"][0], want) < FACTOR_TOL
    assert _rel(x["ieee"][0], jinner.solve(jnp.asarray(b))) < FACTOR_TOL


def test_tf32_sweep_puts_the_setting_back_on_an_exception(monkeypatch):
    def fail(solver, band):
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
        raise RuntimeError("inside")

    monkeypatch.setattr(tf32_sweep, "_factorize", fail)
    band = torch.as_tensor(W.random_band(3, 2, 0), **F64)[None]
    with pytest.raises(RuntimeError, match="inside"):
        tf32_sweep.run_mode("block_cyclic", band, band.new_zeros(1, 6), "tf32")
    assert torch.backends.cuda.matmul.fp32_precision == "ieee"


@pytest.mark.parametrize("solver", SOLVERS)
def test_tf32_sweep_measures_the_control_band(solver):
    """The sweep's measurement at nx=8 on the CPU: every mode's residual is
    float32's, the ``ieee`` and ``tf32`` residuals are equal (TF32 does not
    reach the CPU), and the line names each figure."""
    band, b = tf32_sweep.control_band(8, 8, 2, "cpu")
    assert band.shape == (2, 9, 9, 27) and band.dtype == torch.float32
    res = tf32_sweep.measure(solver, band, b, rounds=1)
    assert set(res) == set(tf32_sweep.MODES)
    for rec in res.values():
        assert 0 < rec["residual"] < 1e-5
        assert rec["factorize_ms"] > 0 and rec["solve_ms"] > 0
    assert res["ieee"]["residual"] == res["tf32"]["residual"]
    text = tf32_sweep.line(solver, 8, 8, band, res)
    assert f"tf32 sweep {solver} nx=8 ny=8 (N=2, s=9, nb=9)" in text
    assert "(1.000x)" in text
