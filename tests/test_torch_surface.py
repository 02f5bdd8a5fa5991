"""The rest of the fem/ops public surface of the PyTorch port against the
JAX package, float64 on the CPU, on the same numpy inputs: ``cg_solve``,
``solve_refined``, ``extract_block_tridiag`` and the four Dirichlet
helpers (``band_bc_masks``, ``bc_symmetrize_banded``, ``bc_zero_rows``,
``bc_apply_rhs``), each to 1e-10; every public name of the JAX
package's ``fem``, ``ops``, ``utils`` and ``parallel`` and of its top level
has a counterpart in the port; and so has every top-level public function,
class and assignment of the JAX package's ``config``, ``ops.structured``,
``fem.multigrid`` and ``models.sampling`` (parsed from their sources), but
for the names left out by decision (``LEFT_OUT``).
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hippyflow_tpu.fem as jfem
import hippyflow_tpu.ops as jops
import hippyflow_tpu_torch.fem as tfem
import hippyflow_tpu_torch.ops as tops

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-10


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n))
    return X @ X.T / n + np.eye(n)


# -- ops ------------------------------------------------------------------------

@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("shape", [(40,), (8, 5)])
def test_cg_solve_matches_jax(shape, precondition):
    """At convergence (the iterates after maxiter differ from the exact
    arithmetic ones in each package's own way); b of any shape is one
    vector, as in jax.scipy.sparse.linalg.cg."""
    n = int(np.prod(shape))
    A = _spd(n)
    b = np.random.default_rng(1).standard_normal(shape)
    d = np.diag(A)
    jmv = lambda x: (jnp.asarray(A) @ x.reshape(-1)).reshape(shape)
    tmv = lambda x: (_t(A) @ x.reshape(-1)).reshape(shape)
    jM = (lambda r: r / jnp.asarray(d).reshape(shape)) if precondition else None
    tM = (lambda r: r / _t(d).reshape(shape)) if precondition else None
    want = jops.cg_solve(jmv, jnp.asarray(b), M=jM, tol=1e-13)
    got = tops.cg_solve(tmv, _t(b), M=tM, tol=1e-13)
    assert got.shape == shape
    assert _rel(got, want) < TOL
    assert _rel(got, np.linalg.solve(A, b.reshape(-1)).reshape(shape)) < TOL


def test_cg_solve_stops_at_its_tolerance_and_maxiter():
    A = _spd(60, seed=2)
    b = _t(np.random.default_rng(3).standard_normal(60))
    calls = []

    def mv(x):
        calls.append(1)
        return _t(A) @ x

    x = tops.cg_solve(mv, b, tol=1e-4)
    assert torch.linalg.vector_norm(_t(A) @ x - b) <= 1e-4 * torch.linalg.vector_norm(b)
    calls.clear()
    tops.cg_solve(mv, b, tol=0.0, maxiter=3)
    assert len(calls) == 4  # the initial residual and three steps
    x0 = _t(np.linalg.solve(A, b.numpy()))
    calls.clear()
    assert _rel(tops.cg_solve(mv, b, x0=x0), x0) < 1e-12 and len(calls) == 1


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("iters", [0, 2])
def test_solve_refined_matches_jax(iters, trans):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((30, 30)) + 6 * np.eye(30)
    b = rng.standard_normal((30, 3))
    jfac = jops.factorize(jnp.asarray(A), False)
    tfac = tops.factorize(_t(A), False)
    assert isinstance(tfac, tops.LUFactor)
    want = jops.solve_refined(jfac, jnp.asarray(A), jnp.asarray(b), iters, trans)
    got = tops.solve_refined(tfac, _t(A), _t(b), iters, trans)
    assert _rel(got, want) < TOL
    # a batch of matrices with a vector each
    Ab, bb = _t(np.stack([A, A.T])), _t(b[:, :2].T)
    got = tops.solve_refined(tops.factorize(Ab, False), Ab, bb, iters, trans)
    for i in range(2):
        assert _rel(got[i], np.linalg.solve((Ab[i].T if trans else Ab[i]).numpy(),
                                            bb[i].numpy())) < TOL


def test_solve_refined_recovers_a_perturbed_factor():
    """Two refinement sweeps against the exact A recover the accuracy a
    factor of a perturbed matrix lost."""
    A = _spd(40, seed=5)
    b = _t(np.random.default_rng(6).standard_normal(40))
    fac = tops.factorize(_t(A + 1e-4 * np.eye(40)), True)
    exact = np.linalg.solve(A, b.numpy())
    assert _rel(tops.solve_refined(fac, _t(A), b), exact) > 1e-6
    assert _rel(tops.solve_refined(fac, _t(A), b, iters=3), exact) < TOL


def test_extract_block_tridiag_matches_jax():
    nb, s = 5, 4
    rng = np.random.default_rng(7)
    A = np.zeros((nb * s, nb * s))
    for j in range(nb):
        for o in (-1, 0, 1):
            if 0 <= j + o < nb:
                A[j * s:(j + 1) * s, (j + o) * s:(j + o + 1) * s] = \
                    rng.standard_normal((s, s))
    want = jops.extract_block_tridiag(jnp.asarray(A), s)
    got = tops.extract_block_tridiag(_t(A), s)
    for g, w in zip(got, want):
        assert g.shape == (nb, s, s)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        tops.extract_block_tridiag(_t(A), 3)


# -- the Dirichlet helpers --------------------------------------------------------

def _bc_case():
    """A structured P1 band with an inhomogeneous Dirichlet condition on
    the left and bottom edges, at nx=(6, 5)."""
    jV = jfem.FunctionSpace(jfem.unit_square_mesh(6, 5))
    tV = tfem.FunctionSpace(tfem.unit_square_mesh(6, 5))
    pred = lambda x: (x[:, 0] < 1e-12) | (x[:, 1] < 1e-12)
    val = lambda x: 1.0 + x[:, 0] - 2 * x[:, 1]
    return (jfem.DirichletBC.from_predicate(jV, pred, val),
            tfem.DirichletBC.from_predicate(tV, pred, val), tV)


def test_band_bc_masks_and_bc_symmetrize_banded_match_jax():
    jbc, tbc, tV = _bc_case()
    s = 7
    masks = tfem.band_bc_masks(tbc, s, **F64)
    for g, w in zip(masks, jfem.band_bc_masks(jbc, s, jnp.float64)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    band = np.random.default_rng(8).standard_normal((3, tV.dim // s, s, 3 * s))
    want = jax.vmap(lambda b: jfem.bc_symmetrize_banded(
        b, *jfem.band_bc_masks(jbc, s, jnp.float64)))(jnp.asarray(band))
    got = tfem.bc_symmetrize_banded(_t(band), *masks)
    assert _rel(got, want) < TOL
    # the same as the band symmetrization from the raw mask
    assert _rel(got, tfem.bc_symmetrize_banded_from_mask(_t(band), tbc)) < TOL


@pytest.mark.parametrize("batch", [False, True])
def test_bc_zero_rows_matches_jax(batch):
    jbc, tbc, tV = _bc_case()
    rng = np.random.default_rng(9)
    M = rng.standard_normal((2, tV.dim, 4) if batch else (tV.dim, 4))
    fn = lambda x: jfem.bc_zero_rows(x, jbc)
    want = jax.vmap(fn)(jnp.asarray(M)) if batch else fn(jnp.asarray(M))
    got = tfem.bc_zero_rows(_t(M), tbc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_A", [False, True])
@pytest.mark.parametrize("batch", [False, True])
def test_bc_apply_rhs_matches_jax(batch, with_A):
    jbc, tbc, tV = _bc_case()
    rng = np.random.default_rng(10)
    n = tV.dim
    b = rng.standard_normal((3, n) if batch else (n,))
    A = rng.standard_normal((3, n, n) if batch else (n, n)) if with_A else None
    fn = lambda bb, AA: jfem.bc_apply_rhs(bb, jbc, AA)
    if batch:
        want = jax.vmap(fn)(jnp.asarray(b), None if A is None else jnp.asarray(A)) \
            if with_A else jax.vmap(lambda bb: fn(bb, None))(jnp.asarray(b))
    else:
        want = fn(jnp.asarray(b), None if A is None else jnp.asarray(A))
    got = tfem.bc_apply_rhs(_t(b), tbc, None if A is None else _t(A))
    assert _rel(got, want) < TOL


# -- the public names ---------------------------------------------------------------

# every public name is ported
NOT_PORTED = set()


def _public_names(modname):
    """The names an ``__init__`` binds: each relative import's module and
    names (a star import's expanded from its module's ``__init__``) and
    each assignment, without the private ones."""
    mod = importlib.import_module(modname)
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            if node.module:
                out.add(node.module.split(".")[0])
            for alias in node.names:
                if alias.name == "*":
                    out |= _public_names(f"{modname}.{node.module}")
                else:
                    out.add(alias.asname or alias.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("sub", ["", ".fem", ".ops", ".utils", ".parallel"])
def test_every_public_name_has_a_counterpart(sub):
    jax_names = _public_names("hippyflow_tpu" + sub)
    port = importlib.import_module("hippyflow_tpu_torch" + sub)
    assert len(jax_names) > 10
    missing = sorted(n for n in jax_names - NOT_PORTED if not hasattr(port, n))
    assert not missing, missing
    if sub == "":
        assert NOT_PORTED <= jax_names
        import hippyflow_tpu

        assert port.__version__ == hippyflow_tpu.__version__


# top-level names of JAX modules left out of the port by decision
LEFT_OUT = {
    "config": {
        # the XLA compile management: PyTorch runs eagerly, nothing to
        # precompile
        "set_parallel_precompile", "parallel_precompile",
        # the Pallas routing knobs choose between a Pallas kernel and an XLA
        # scan; the port has no route that hides its kernels
        "set_pallas_band_solve", "pallas_band_solve",
        "set_pallas_band_max_block", "pallas_band_max_block",
        # jax_enable_x64: PyTorch takes float64 wherever a caller asks for it
        "enable_x64",
        # the solver-precision policy: on the card it reaches only the
        # library products of block_cyclic / block_tridiag, and TF32 there
        # with its refinement sweep made neither faster (ops/tf32_sweep.py)
        "set_solver_precision", "solver_precision", "solver_refine_steps",
    },
    # the policy's refinement wrapper (the same measurement)
    "ops.structured": {"RefinedBandFactor"},
    # the grid-sequencing chain split into XLA programs: compile management
    "fem.multigrid": {"SplitWarmStartChain"},
    # jit of lifted programs and their threaded precompilation
    "models.sampling": {"jit_lifted", "precompile_parallel"},
}


def _module_names(path):
    """The public names a module's source defines at its top level: each
    function, class and assigned name (parsed, not imported)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("mod", ["config", "ops.structured", "fem.multigrid",
                                 "models.sampling"])
def test_every_module_name_has_a_counterpart(mod):
    import hippyflow_tpu

    root = os.path.dirname(hippyflow_tpu.__file__)
    jax_names = _module_names(os.path.join(root, *mod.split(".")) + ".py")
    port = importlib.import_module("hippyflow_tpu_torch." + mod)
    left_out = LEFT_OUT.get(mod, set())
    assert left_out <= jax_names
    missing = sorted(n for n in jax_names - left_out if not hasattr(port, n))
    assert not missing, missing
    ported = sorted(n for n in left_out if hasattr(port, n))
    assert not ported, ported  # a name that came back leaves LEFT_OUT
