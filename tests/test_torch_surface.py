"""The rest of the fem/ops public surface of the PyTorch port against the
JAX package, float64 on the CPU, on the same numpy inputs: ``cg_solve``,
``solve_refined``, ``extract_block_tridiag`` and the four Dirichlet
helpers (``band_bc_masks``, ``bc_symmetrize_banded``, ``bc_zero_rows``,
``bc_apply_rhs``), each to 1e-10; every public name of the JAX
package's ``fem``, ``ops``, ``utils`` and ``parallel`` and of its top level
has a counterpart in the port (``nn`` too); and so has every top-level
public function, class and assignment of the JAX package's ``config``,
``ops.structured``, ``fem.multigrid`` and ``models.sampling`` (parsed from
their sources).  Every module of the JAX package but its Pallas kernels,
and every application module, is parsed for its public functions and
classes: each public method has a counterpart on the port's class, each
keyword of each function and method one of the same name, and each key of
the JAX parameter lists one in the port's; but for what is left out by
decision (``LEFT_OUT``, each entry with its reason).  The members this
check found missing are held against the JAX package: the component
observation's ``applyt`` (1e-12) and J^T through it (1e-10), the priors'
``sample_n`` under given noise, ``CholeskyFactor.solve_L``,
``BlockTridiagFactor.nb`` / ``.s``, ``DirichletBC.homogenized``,
``BiLaplacian2D(robin_bc=)``, ``assemble_A_banded(s=)`` and
``auto_chunk_size``'s forms (1e-12 or exactly).  The same walk holds the
call forms: JAX's positional parameters come first on the port and in
JAX's order, with none of the port's taken by position from a parameter
the port leaves out on; the fields of JAX's dataclasses and named tuples
are the port's, in JAX's order; and every literal default of a JAX
parameter or field is the port's.
"""

import ast
import dataclasses
import functools
import importlib
import inspect
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


@pytest.mark.parametrize("sub", ["", ".fem", ".ops", ".utils", ".parallel", ".nn"])
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


# names of JAX modules left out of the port by decision: top-level names,
# ``Class.method``, ``Class.field`` (of a dataclass or named tuple),
# ``function(keyword)``, ``Class.method(keyword)``, ``name[key]`` (of a
# parameter list) and ``function(keyword=)`` (its literal default)
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
    "ops.structured": {
        # the policy's refinement wrapper (the same measurement)
        "RefinedBandFactor",
        # JAX pytree registration: a torch factor is a plain object
        "PermutedFactor.tree_flatten", "PermutedFactor.tree_unflatten",
    },
    "fem.multigrid": {
        # the grid-sequencing chain split into XLA programs, and the switch
        # that asks for it: compile management
        "SplitWarmStartChain", "coarse_newton_warm_start(split)",
    },
    "models.sampling": {
        # jit of lifted programs and their threaded precompilation, and the
        # entries' mode that only builds those programs: compile management
        "jit_lifted", "precompile_parallel",
        "sample_until_solved(precompile_only)",
        "sample_and_materialize_symmetric(precompile_only)",
        "materialize_jacobians(precompile_only)",
        # a JAX PRNG key; the port draws from a KeyChain or GivenNoise
        # stream, passed as ``keychain``
        "UniformDistribution.sample_n(key)",
        # the host prefetch of each chunk's (m, q, z) (and with it
        # ``SampleBatch.host_chunks``): it only hides the copy of the
        # samples to the host, which on the H100 is under 1% of the stages
        # it would overlap (chip_smoke.py's ``save stage`` lines at nx=64
        # and nx=192); timed in turns with and without it at nx=192, 1024
        # samples in 32 chunks, the stages and the writer's wait moved
        # within one spread
        "sample_until_solved(prefetch_host)", "SampleBatch.host_chunks",
    },
    "models.prior": {
        # a JAX PRNG key, as above
        "BiLaplacianPrior.sample_n(key)", "LaplacianPrior.sample_n(key)",
        "StructuredBiLaplacianPrior.sample_n(key)",
        # keeps K's band out of the XLA program's constants: compile
        # management (the port always holds its factors as tensors)
        "StructuredBiLaplacianPrior.__init__(materialize)",
    },
    # ahead-of-time compilation of the projector's XLA programs; the key
    # of the host prefetch (as ``sample_until_solved(prefetch_host)``)
    "models.active_subspace": {"ActiveSubspaceProjector.precompile_programs",
                               "ActiveSubspaceParameterList[prefetch_host]"},
    # JAX pytree registration
    "models.pde_problem": {"IterativeFactor.tree_flatten",
                           "IterativeFactor.tree_unflatten"},
    "parallel.dist_banded": {"DistributedBandedFactor.tree_flatten",
                             "DistributedBandedFactor.tree_unflatten"},
    # a JAX key has no torch counterpart: the port's KeyChain takes the
    # int seed (``seed``)
    "utils.prandom": {"KeyChain.__init__(seed_or_key)"},
    # the trace's folder has no default: the port writes nothing outside
    # the folder its caller names (JAX's default is a folder under /tmp)
    "utils.profiling": {"trace(log_dir=)"},
}

# JAX parameters the port takes in the same slot under another name
# (each also a ``LEFT_OUT`` keyword): a JAX key becomes a key chain
RENAMED = {
    "models.prior": {"BiLaplacianPrior.sample_n(key)": "keychain",
                     "LaplacianPrior.sample_n(key)": "keychain",
                     "StructuredBiLaplacianPrior.sample_n(key)": "keychain"},
    "models.sampling": {"UniformDistribution.sample_n(key)": "keychain"},
    "utils.prandom": {"KeyChain.__init__(seed_or_key)": "seed"},
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
    left_out = {n for n in LEFT_OUT.get(mod, set()) if n.isidentifier()}
    assert left_out <= jax_names
    missing = sorted(n for n in jax_names - left_out if not hasattr(port, n))
    assert not missing, missing
    ported = sorted(n for n in left_out if hasattr(port, n))
    assert not ported, ported  # a name that came back leaves LEFT_OUT


# -- methods and keywords -------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_modules():
    """Every module of the JAX package but its Pallas kernels, and the
    application modules, as keys of ``LEFT_OUT`` ("models.prior",
    "applications.helmholtz", "" for the package's ``__init__``)."""
    out = []
    pkg = os.path.join(_ROOT, "hippyflow_tpu")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), pkg)[:-3]
                out.append(rel.replace(os.sep, ".").replace("__init__", "")
                           .rstrip("."))
    out.remove("ops.pallas_kernels")
    out += ["applications." + f[:-3]
            for f in os.listdir(os.path.join(_ROOT, "applications"))
            if f.endswith(".py") and f != "__init__.py"]
    return sorted(out)


def _jax_source(mod):
    if mod.startswith("applications."):
        return os.path.join(_ROOT, *mod.split(".")) + ".py"
    path = os.path.join(_ROOT, "hippyflow_tpu", *mod.split("."))
    return path + ".py" if os.path.isfile(path + ".py") else \
        os.path.join(path, "__init__.py")


def _params(fn):
    """The names a parsed function takes by keyword (not self or cls)."""
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _public_surface(path):
    """{name: keywords} of the public functions and {class: {method:
    keywords}} of the public classes (public methods, ``__init__`` and
    ``__call__``), parsed from a module's source."""
    with open(path) as f:
        tree = ast.parse(f.read())
    funcs, classes = {}, {}
    for node in tree.body:
        if node.name.startswith("_") if hasattr(node, "name") else True:
            continue
        if isinstance(node, ast.FunctionDef):
            funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = {
                b.name: _params(b) for b in node.body
                if isinstance(b, ast.FunctionDef)
                and (not b.name.startswith("_")
                     or b.name in ("__init__", "__call__"))}
    return funcs, classes


def _port_params(cls_or_fn, method=None):
    """The parameters (``inspect.Parameter``, in order, without self) of a
    port function, or of a port class's method (``__init__``: the class's
    own signature, dataclasses and named tuples included; ``__call__`` of a
    torch module: its ``forward``); None where the member is a property."""
    if method is None:
        obj = cls_or_fn
    elif method == "__init__":
        obj = cls_or_fn
    elif method == "__call__" and issubclass(cls_or_fn, torch.nn.Module):
        obj = cls_or_fn.forward
    else:
        if isinstance(inspect.getattr_static(cls_or_fn, method),
                      (property, functools.cached_property)):
            return None
        obj = getattr(cls_or_fn, method)
    return [p for p in inspect.signature(obj).parameters.values()
            if p.name not in ("self", "cls")]


def _port_keywords(cls_or_fn, method=None):
    """The parameter names of a port function or method (as
    ``_port_params``), None where the member is a property."""
    params = _port_params(cls_or_fn, method)
    return None if params is None else {
        p.name for p in params
        if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def _port_module(mod):
    return importlib.import_module(
        "hippyflow_tpu_torch" + ("." + mod if mod else ""))


def _literal(node):
    """(True, value) of a literal expression, else (False, None)."""
    try:
        return True, ast.literal_eval(node)
    except ValueError:
        return False, None


def _signature(fn):
    """(positional names, {name: literal default}) of a parsed function,
    without self or cls."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = dict(zip([x.arg for x in pos[len(pos) - len(a.defaults):]],
                        a.defaults))
    defaults.update((x.arg, d) for x, d in zip(a.kwonlyargs, a.kw_defaults)
                    if d is not None)
    literal = {}
    for name, node in defaults.items():
        ok, value = _literal(node)
        if ok:
            literal[name] = value
    return [x.arg for x in pos if x.arg not in ("self", "cls")], literal


def _jax_signatures(mod):
    """{"function" or "Class.method": (positional names, literal
    defaults)} of a JAX module's public surface (as ``_public_surface``)."""
    with open(_jax_source(mod)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, ast.FunctionDef):
            out[node.name] = _signature(node)
        elif isinstance(node, ast.ClassDef):
            out.update((f"{node.name}.{b.name}", _signature(b))
                       for b in node.body if isinstance(b, ast.FunctionDef)
                       and (not b.name.startswith("_")
                            or b.name in ("__init__", "__call__")))
    return out


def _jax_fields(mod):
    """{class: (kind, [fields], {field: literal default})} of the public
    dataclasses ("dataclass") and named tuples ("NamedTuple") of a JAX
    module, the fields in their order."""
    with open(_jax_source(mod)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        if any("NamedTuple" in ast.unparse(b) for b in node.bases):
            kind = "NamedTuple"
        elif any("dataclass" in ast.unparse(d) for d in node.decorator_list):
            kind = "dataclass"
        else:
            continue
        fields, defaults = [], {}
        for b in node.body:
            if (isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)
                    and "ClassVar" not in ast.unparse(b.annotation)):
                fields.append(b.target.id)
                ok, value = _literal(b.value) if b.value is not None else (
                    False, None)
                if ok:
                    defaults[b.target.id] = value
        out[node.name] = (kind, fields, defaults)
    return out


def _left_out(mod, kind):
    """The ``LEFT_OUT`` entries of a module of one kind: "field"
    (``Class.field`` of a JAX dataclass or named tuple), "default"
    (``function(keyword=)``), "key" (``name[key]``) or "surface" (the
    rest: names, methods and keywords)."""
    fields = {f"{c}.{f}" for c, (_, fs, _) in _jax_fields(mod).items()
              for f in fs}
    out = {"field": set(), "default": set(), "key": set(), "surface": set()}
    for n in LEFT_OUT.get(mod, set()):
        out["field" if n in fields else "default" if n.endswith("=)")
            else "key" if "[" in n else "surface"].add(n)
    return out[kind]


def _port_member(port, name):
    """The port's parameters of a JAX ``function`` or ``Class.method``
    (``_port_params``); None where the port lacks it or it is a property
    (the keyword walk reports those)."""
    cls, _, meth = name.partition(".")
    obj = getattr(port, cls, None)
    if obj is None or (meth and not hasattr(obj, meth)):
        return None
    return _port_params(obj, meth or None)


@pytest.mark.parametrize("mod", _jax_modules())
def test_every_method_and_keyword_has_a_counterpart(mod):
    """Every public function and class of the JAX module has a counterpart
    in the port's module of the same path, every public method of each
    class one on the port's class (inherited, or a property), and every
    keyword of each function and method one of the same name; but for the
    entries of ``LEFT_OUT``, each of which must still be missing."""
    funcs, classes = _public_surface(_jax_source(mod))
    port = _port_module(mod)
    gaps = set()
    for name, kws in funcs.items():
        fn = getattr(port, name, None)
        if fn is None:
            gaps.add(name)
            continue
        gaps |= {f"{name}({k})" for k in kws if k not in _port_keywords(fn)}
    for name, methods in classes.items():
        cls = getattr(port, name, None)
        if cls is None:
            gaps.add(name)
            continue
        for meth, kws in methods.items():
            if not hasattr(cls, meth):
                gaps.add(f"{name}.{meth}")
                continue
            have = _port_keywords(cls, meth)
            if have is not None:
                gaps |= {f"{name}.{meth}({k})" for k in kws if k not in have}
    left_out = _left_out(mod, "surface")
    assert gaps - left_out == set(), sorted(gaps - left_out)
    # a left-out entry that came back (or was never a gap) leaves LEFT_OUT
    assert left_out - gaps == set(), sorted(left_out - gaps)


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


@pytest.mark.parametrize("mod", _jax_modules())
def test_positional_order_matches_jax(mod):
    """JAX's positional parameters of every public function and method come
    first on the port, in JAX's order (a parameter of ``RENAMED`` under its
    port name), so that each positional JAX call binds every argument to
    the same parameter; from a parameter ``LEFT_OUT`` on, the port takes
    none by position, so that such a call raises ``TypeError``.  Members
    the port lacks are the keyword walk's."""
    port = _port_module(mod)
    left_out = _left_out(mod, "surface")
    renamed = RENAMED.get(mod, {})
    assert set(renamed) <= left_out
    gaps = []
    for name, (jax_pos, _) in _jax_signatures(mod).items():
        params = _port_member(port, name)
        if params is None:
            continue
        port_pos = [p.name for p in params if p.kind in _POSITIONAL]
        for i, p in enumerate(jax_pos):
            entry = f"{name}({p})"
            if entry in left_out and entry not in renamed:
                if len(port_pos) > i:
                    gaps.append(f"{name}: {port_pos[i:]} positional from "
                                f"the left-out {p!r} on")
                break
            want = renamed.get(entry, p)
            if i >= len(port_pos) or port_pos[i] != want:
                gaps.append(f"{name}: position {i} is "
                            f"{port_pos[i] if i < len(port_pos) else None!r}"
                            f", JAX's {want!r}")
                break
    assert not gaps, gaps


def _fields_modules():
    return [m for m in _jax_modules() if _jax_fields(m)]


@pytest.mark.parametrize("mod", _fields_modules())
def test_fields_match_jax_in_order(mod):
    """Every JAX dataclass is a dataclass on the port and every named tuple
    a named tuple, with each of JAX's fields (but for ``LEFT_OUT``'s
    ``Class.field``, which must still be missing), and positionally in
    JAX's order: a JAX positional construction, or a named tuple's
    unpacking, gives each value the same field.  From a left-out field on,
    the port's fields are keyword-only."""
    port = _port_module(mod)
    left_out = _left_out(mod, "field")
    gaps = []
    for name, (kind, fields, _) in _jax_fields(mod).items():
        cls = getattr(port, name)
        if kind == "NamedTuple":
            assert issubclass(cls, tuple) and hasattr(cls, "_fields"), name
            have = positional = list(cls._fields)
        else:
            assert dataclasses.is_dataclass(cls), name
            have = [f.name for f in dataclasses.fields(cls)]
            positional = [f.name for f in dataclasses.fields(cls)
                          if f.init and not f.kw_only]
        cut = None
        for i, f in enumerate(fields):
            if f"{name}.{f}" in left_out:
                assert f not in have, f"{name}.{f} came back"
                cut = i if cut is None else cut
            elif f not in have:
                gaps.append(f"{name}.{f} is missing")
            elif cut is None and positional[i:i + 1] != [f]:
                gaps.append(f"{name}: field {i} is {positional[i:i + 1]}, "
                            f"JAX's {f!r}")
        if cut is not None and len(positional) > cut:
            gaps.append(f"{name}: {positional[cut:]} positional from the "
                        "left-out field on")
    assert not gaps, gaps
    assert left_out <= {f"{c}.{f}" for c, (_, fs, _) in
                        _jax_fields(mod).items() for f in fs}


def _same_default(port, jax):
    """A port default equals a JAX literal: equal, and a bool only where
    JAX's is one (1 == True)."""
    return (port is not inspect.Parameter.empty and port == jax
            and isinstance(port, bool) == isinstance(jax, bool))


@pytest.mark.parametrize("mod", _jax_modules())
def test_literal_defaults_match_jax(mod):
    """Every literal default of a JAX parameter (positional or keyword-only)
    and of a JAX dataclass or named-tuple field is the port's default of
    the same parameter; but for ``LEFT_OUT``'s ``function(keyword=)``
    entries, each of which must still differ."""
    port = _port_module(mod)
    renamed = RENAMED.get(mod, {})
    gaps = set()
    for name, (_, defaults) in _jax_signatures(mod).items():
        params = _port_member(port, name)
        if params is None:
            continue
        by_name = {p.name: p.default for p in params}
        for p, value in defaults.items():
            mine = renamed.get(f"{name}({p})", p)
            if mine in by_name and not _same_default(by_name[mine], value):
                gaps.add(f"{name}({p}=)")
    for name, (kind, _, defaults) in _jax_fields(mod).items():
        cls = getattr(port, name)
        have = (dict(cls._field_defaults) if kind == "NamedTuple" else
                {f.name: f.default for f in dataclasses.fields(cls)
                 if f.default is not dataclasses.MISSING})
        gaps |= {f"{name}.{f}=" for f, value in defaults.items()
                 if f in have and not _same_default(have[f], value)}
    left_out = _left_out(mod, "default")
    assert gaps - left_out == set(), sorted(gaps - left_out)
    assert left_out - gaps == set(), sorted(left_out - gaps)


def test_the_walk_sees_the_call_forms():
    """The parse finds the members whose order it holds: JAX's positional
    (u, m, z, border), the Linearization, GalerkinForm and SampleBatch
    fields, and the defaults of parameters and fields."""
    sigs = _jax_signatures("fem.assembly")
    assert sigs["BoundGalerkinForm.assemble_A_banded_ordered"][0] == [
        "u", "m", "z", "border"]
    assert _jax_fields("models.pde_problem")["Linearization"][:2] == (
        "NamedTuple", ["u", "m", "z", "factor"])
    kind, fields, defaults = _jax_fields("fem.assembly")["GalerkinForm"]
    assert kind == "dataclass" and fields[3] == "symmetric"
    assert defaults == {"flux": None, "source": None, "quad_degree": 2,
                        "symmetric": False}
    assert _jax_fields("models.sampling")["SampleBatch"][1][3:5] == [
        "zs", "n_failures"]
    assert _jax_signatures("utils.profiling")["trace"][1] == {
        "log_dir": "/tmp/hippyflow_tpu_trace"}
    assert _left_out("models.sampling", "field") == {"SampleBatch.host_chunks"}


def _parameter_lists():
    """(module, name) of every JAX function that returns a ParameterList."""
    out = []
    for mod in _jax_modules():
        with open(_jax_source(mod)) as f:
            tree = ast.parse(f.read())
        out += [(mod, n.name) for n in tree.body
                if isinstance(n, ast.FunctionDef)
                and isinstance(n.returns, ast.Name)
                and n.returns.id == "ParameterList"]
    return out


@pytest.mark.parametrize("mod,name", _parameter_lists())
def test_every_parameter_key_has_a_counterpart(mod, name):
    """The port's parameter list has every key of the JAX one, with the
    same default where the default is a plain value; but for the keys
    ``LEFT_OUT`` lists as ``name[key]``, each of which must still be
    missing."""
    jlist = getattr(importlib.import_module("hippyflow_tpu." + mod), name)()
    tlist = getattr(_port_module(mod), name)()
    left_out = {n[len(name) + 1:-1] for n in LEFT_OUT.get(mod, set())
                if n.startswith(name + "[")}
    assert left_out <= set(jlist.keys()) and not left_out & set(tlist.keys())
    missing = sorted(k for k in jlist.keys() if k not in tlist
                     and k not in left_out)
    assert not missing, missing
    for k in jlist.keys() - left_out:
        if isinstance(jlist[k], (bool, int, float, str, type(None))):
            assert tlist[k] == jlist[k], k


def test_the_parameter_lists_are_found():
    assert {n for _, n in _parameter_lists()} >= {
        "ActiveSubspaceParameterList", "KLEParameterList", "PODParameterList",
        "modelWrapperSettings", "newtonSolver_ParameterList"}


# -- the methods and keywords that were missing, against the JAX package -----------

def _component_case(component):
    """One component of a 2-component P2 state observed at points, on
    both sides."""
    from hippyflow_tpu.fem.vector_assembly import (
        ComponentObservation as JComponentObservation,
    )
    from hippyflow_tpu.models.observable import (
        PointwiseObservation as JPointwiseObservation,
    )
    from hippyflow_tpu_torch.models import PointwiseObservation

    targets = np.array([[0.3, 0.4], [0.55, 0.8], [0.9, 0.1], [0.2, 0.7]])
    t_obs = tfem.ComponentObservation(
        PointwiseObservation(tfem.FunctionSpace(tfem.unit_square_mesh(4), 2),
                             targets, **F64), 2, component)
    j_obs = JComponentObservation(
        JPointwiseObservation(jfem.FunctionSpace(jfem.unit_square_mesh(4), 2),
                              targets), 2, component)
    return t_obs, j_obs


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("component", [0, 1])
def test_component_observation_applyt_matches_jax(component, k):
    """applyt on a batch (N, dQ) or (N, dQ, k) is the transpose of the
    port's dense and apply, zero outside the component's slot, and equals
    the JAX package's sample by sample."""
    t_obs, j_obs = _component_case(component)
    rng = np.random.default_rng(11 + component)
    shape = (3, t_obs.dim) if k is None else (3, t_obs.dim, k)
    q = rng.standard_normal(shape)
    got = t_obs.applyt(_t(q))
    assert got.shape == (3, t_obs.state_dim) + (() if k is None else (k,))
    want = np.stack([np.asarray(j_obs.applyt(jnp.asarray(x))) for x in q])
    assert _rel(got, want) < 1e-12
    D = t_obs.dense()
    assert _rel(got, torch.einsum("nq...,qs->ns...", _t(q), D)) < 1e-12
    n = t_obs.state_dim // 2
    other = slice(0, n) if component == 1 else slice(n, 2 * n)
    assert not got[:, other].any()
    # <B u, q> = <u, B^T q>
    u = _t(rng.standard_normal((3, t_obs.state_dim) + shape[2:]))
    lhs = (t_obs.apply(u) * _t(q)).sum()
    assert abs(lhs - (u * got).sum()) < 1e-12 * abs(lhs)


def test_vector_pointwise_observation_applyt_matches_jax():
    """The helmholtz lane's observation of both components: state_dim and
    applyt on vectors and blocks, against the JAX package's."""
    from applications.helmholtz import VectorPointwiseObservation as JVPO
    from hippyflow_tpu_torch.applications.helmholtz import (
        VectorPointwiseObservation as TVPO,
    )

    targets = np.array([[0.3, 0.4], [0.55, 0.8], [0.9, 0.1]])
    t_obs = TVPO(tfem.FunctionSpace(tfem.unit_square_mesh(4), 2), targets, 2,
                 **F64)
    j_obs = JVPO(jfem.FunctionSpace(jfem.unit_square_mesh(4), 2), targets, 2)
    assert (t_obs.dim, t_obs.state_dim) == (j_obs.dim, j_obs.state_dim)
    rng = np.random.default_rng(12)
    for shape in ((3, t_obs.dim), (3, t_obs.dim, 2)):
        q = rng.standard_normal(shape)
        want = np.stack([np.asarray(j_obs.applyt(jnp.asarray(x))) for x in q])
        assert _rel(t_obs.applyt(_t(q)), want) < 1e-12
        u = rng.standard_normal((3, t_obs.state_dim) + shape[2:])
        want = np.stack([np.asarray(j_obs.apply(jnp.asarray(x))) for x in u])
        assert _rel(t_obs.apply(_t(u)), want) < 1e-12


@functools.lru_cache(maxsize=None)
def _helmholtz_component(component=0, nx=8):
    """The helmholtz problem at nx=8 observed on one component of its
    state, on both sides; m of 2 prior samples and JAX's states."""
    from applications.helmholtz import helmholtz_linear_observable as jh
    from applications.helmholtz import helmholtz_prior as jh_prior
    from hippyflow_tpu.fem.vector_assembly import (
        ComponentObservation as JComponentObservation,
    )
    from hippyflow_tpu.models import LinearStateObservable as JLSO
    from hippyflow_tpu.models.observable import (
        PointwiseObservation as JPointwiseObservation,
    )
    from hippyflow_tpu_torch.applications.helmholtz import (
        helmholtz_linear_observable as th,
    )
    from hippyflow_tpu_torch.models import (
        LinearStateObservable,
        PointwiseObservation,
    )

    jobs, jV = jh(nx=nx, frequency=600.0)
    tobs, tV = th(nx=nx, frequency=600.0, **F64)
    targets = jobs.B.targets
    jB = JComponentObservation(
        JPointwiseObservation(jobs.problem.Vu, targets), 2, component)
    tB = tfem.ComponentObservation(
        PointwiseObservation(tobs.problem.Vu, targets, **F64), 2, component)
    jc, tc = JLSO(jobs.problem, jB), LinearStateObservable(tobs.problem, tB)
    xi = np.random.default_rng(13).standard_normal((2, jV.dim))
    m = np.asarray(jh_prior(jV).sample(jnp.asarray(xi)))
    u = np.asarray(jax.jit(jax.vmap(
        lambda mm: jobs.problem.solve_fwd(mm)[0]))(jnp.asarray(m)))
    return jc, tc, m, u


@pytest.mark.parametrize("k", [None, 2])
def test_transpmult_through_a_component_observable_matches_jax(k):
    """J^T dq through ComponentObservation (applyBt, then the adjoint
    solve and C^T) against the JAX package, and against the port's
    materialized J."""
    from hippyflow_tpu.models import ObservableJacobian as JOJ
    from hippyflow_tpu_torch.models import ObservableJacobian

    jc, tc, m, u = _helmholtz_component()
    shape = (2, tc.dQ) if k is None else (2, tc.dQ, k)
    dq = np.random.default_rng(14).standard_normal(shape)
    JJ, jp = JOJ(jc), jc.problem
    want = jax.vmap(lambda mm, uu, d: JJ.transpmult(jp.linearize(uu, mm), d))(
        jnp.asarray(m), jnp.asarray(u), jnp.asarray(dq))
    J = ObservableJacobian(tc)
    lin = tc.problem.linearize(_t(u), _t(m))
    got = J.transpmult(lin, _t(dq))
    assert _rel(got, want) < TOL
    Jm = J.materialize(lin)
    assert _rel(got, torch.einsum("nqm,nq...->nm...", Jm, _t(dq))) < TOL


def test_serialized_subspace_through_a_component_observable():
    """The matrix-free (serialized) input subspace through a component
    observable: the same spectrum as the materialized one from the same
    samples and probe block."""
    from hippyflow_tpu_torch.applications.helmholtz import helmholtz_prior
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    _, tc, m, _ = _helmholtz_component()
    prior = helmholtz_prior(tc.problem.Vm, **F64)
    Omega = _t(np.random.default_rng(15).standard_normal((tc.dM, 6)))
    spectra = []
    for serialized in (False, True):
        p = ActiveSubspaceParameterList()
        p["rank"], p["oversampling"], p["verbose"] = 4, 2, False
        p["ms_given"], p["serialized_sampling"] = True, serialized
        proj = ActiveSubspaceProjector(tc, prior, parameters=p)
        proj.ms, proj.Omega_GN = _t(m), Omega
        d, _, _ = proj.construct_input_subspace()
        spectra.append(d)
    assert (proj.Js is None) and spectra[0][0] > 0
    assert _rel(spectra[1], spectra[0]) < TOL


@functools.lru_cache(maxsize=None)
def _priors(nx=8):
    """(JAX prior, port prior) pairs: the dense BiLaplacian, the Laplacian
    and the structured BiLaplacian."""
    import hippyflow_tpu as hf
    import hippyflow_tpu_torch as hft

    jV = jfem.FunctionSpace(jfem.unit_square_mesh(nx))
    tV = tfem.FunctionSpace(tfem.unit_square_mesh(nx))
    return {
        "bilaplacian": (hf.BiLaplacianPrior(jV, 0.1, 1.0),
                        hft.BiLaplacianPrior(tV, 0.1, 1.0, **F64)),
        "laplacian": (hf.LaplacianPrior(jV, 0.1, 1.0),
                      hft.LaplacianPrior(tV, 0.1, 1.0, **F64)),
        "structured": (hf.StructuredBiLaplacianPrior(jV, 0.1, 1.0),
                       hft.StructuredBiLaplacianPrior(tV, 0.1, 1.0, **F64)),
    }


@pytest.mark.parametrize("kind", ["bilaplacian", "laplacian", "structured"])
def test_sample_n_matches_jax_under_given_noise(kind):
    """sample_n draws its white noise from the stream, then samples: under
    a given stream it equals the JAX prior's samples of the same noise,
    and under a KeyChain it equals sample() of the chain's own draw; a
    ``dtype`` is the dtype of the samples it returns."""
    from hippyflow_tpu_torch.utils import GivenNoise, KeyChain

    jpr, tpr = _priors()[kind]
    got = tpr.sample_n(GivenNoise(np.random.default_rng(16), "cpu"), 5)
    xi = np.random.default_rng(16).standard_normal((5, jpr.noise_dim))
    want = jpr.sample(jnp.asarray(xi))
    assert got.shape == (5, tpr.dim) and got.dtype == torch.float64
    assert _rel(got, want) < 1e-12
    draw = KeyChain(3, "cpu").normal((4, tpr.noise_dim), dtype=torch.float64)
    assert torch.equal(tpr.sample_n(KeyChain(3, "cpu"), 4), tpr.sample(draw))
    got32 = tpr.sample_n(KeyChain(3, "cpu"), 4, dtype=torch.float32)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, tpr.sample(draw).to(torch.float32))


@pytest.mark.parametrize("robin_bc", [False, True])
def test_bilaplacian2d_robin_bc_matches_jax(robin_bc):
    import hippyflow_tpu as hf
    import hippyflow_tpu_torch as hft

    jpr = hf.BiLaplacian2D(jfem.FunctionSpace(jfem.unit_square_mesh(6)),
                           gamma=0.1, delta=1.0, robin_bc=robin_bc)
    tpr = hft.BiLaplacian2D(tfem.FunctionSpace(tfem.unit_square_mesh(6)),
                            gamma=0.1, delta=1.0, robin_bc=robin_bc, **F64)
    assert _rel(tpr.K, jpr.K) < 1e-12
    xi = np.random.default_rng(17).standard_normal((3, tpr.noise_dim))
    assert _rel(tpr.sample(_t(xi)), jpr.sample(jnp.asarray(xi))) < 1e-12
    plain = hft.BiLaplacian2D(tfem.FunctionSpace(tfem.unit_square_mesh(6)),
                              gamma=0.1, delta=1.0, **F64)
    assert torch.equal(tpr.K, plain.K) != robin_bc


@pytest.mark.parametrize("shape", [(20,), (20, 3), (4, 20), (4, 20, 3)])
def test_cholesky_solve_L_matches_jax(shape):
    """L^{-1} b for one factor (b a vector or a block) and for a batch of
    four factors, against the JAX package's (vmapped for the batch)."""
    rng = np.random.default_rng(18)
    batch = len(shape) == 3 or shape == (4, 20)
    A = np.stack([_spd(20, seed=i) for i in range(4)]) if batch else _spd(20)
    b = rng.standard_normal(shape)
    tfac = tops.factorize(_t(A), True)
    got = tfac.solve_L(_t(b))
    if batch:
        want = jax.vmap(lambda a, bb: jops.factorize(a, True).solve_L(bb))(
            jnp.asarray(A), jnp.asarray(b))
    else:
        want = jops.factorize(jnp.asarray(A), True).solve_L(jnp.asarray(b))
    assert got.shape == shape
    assert _rel(got, want) < 1e-12
    vec = got.ndim < tfac.L.ndim
    Lx = tfac.L @ (got[..., None] if vec else got)
    assert _rel(Lx[..., 0] if vec else Lx, b) < 1e-12


def test_block_tridiag_factor_nb_and_s_match_jax():
    A = _spd(24, seed=19)
    j = jops.structured.factorize_block_tridiag_dense(jnp.asarray(A), 6)
    t = tops.structured.factorize_block_tridiag_dense(_t(A), 6)
    assert (t.nb, t.s) == (j.nb, j.s) == (4, 6)
    batch = tops.structured.factorize_block_tridiag(
        *(x.expand(3, -1, -1, -1) for x in tops.extract_block_tridiag(_t(A), 6)))
    assert (batch.nb, batch.s) == (4, 6)


def test_dirichlet_bc_homogenized_matches_jax():
    jbc, tbc, _ = _bc_case()
    t0, j0 = tbc.homogenized(), jbc.homogenized()
    np.testing.assert_array_equal(t0.mask, j0.mask)
    np.testing.assert_array_equal(t0.value, np.asarray(j0.value))
    assert t0.mask.any() and tbc.value.any() and not t0.value.any()


@pytest.mark.parametrize("s", [7, 14])
def test_assemble_A_banded_at_a_block_size_matches_jax(s):
    """The band of a P1 form at the structured plan's block size (7 at
    nx=6) and at twice it, which JAX sums by segment and the port by
    index: both equal the JAX package's, and prepare_banded builds the
    indices of the second once."""
    import hippyflow_tpu as hf
    import hippyflow_tpu_torch as hft

    nx, ny = 6, 5  # 42 dofs: 6 block rows of 7, 3 of 14
    jV = jfem.FunctionSpace(jfem.unit_square_mesh(nx, ny))
    tV = tfem.FunctionSpace(tfem.unit_square_mesh(nx, ny))
    jform = hf.GalerkinForm(
        flux=lambda x, u, gu, m, z, c: jnp.exp(m) * gu * (1.0 + u * u),
        source=lambda x, u, gu, m, z, c: -m * u)
    tform = hft.fem.GalerkinForm(
        flux=lambda x, u, gu, m, z, c: torch.exp(m)[..., None] * gu
        * (1.0 + u * u)[..., None],
        source=lambda x, u, gu, m, z, c: -m * u)
    jb = jfem.BoundGalerkinForm(jV, jV, jform)
    tb = tfem.BoundGalerkinForm(tV, tV, tform, **F64)
    rng = np.random.default_rng(20)
    u, m = rng.standard_normal((2, 42)), 0.3 * rng.standard_normal((2, 42))
    jb.prepare_banded(s)
    tb.prepare_banded(s)
    assert (s in tb._band_idx_cache) == (s != 7)
    want = jax.vmap(lambda uu, mm: jb.assemble_A_banded(uu, mm, None, s))(
        jnp.asarray(u), jnp.asarray(m))
    got = tb.assemble_A_banded(_t(u), _t(m), s=s)
    assert got.shape == (2, 42 // s, s, 3 * s)
    assert _rel(got, want) < 1e-12
    with pytest.raises(ValueError):
        tb.prepare_banded(5)  # 42 rows are not blocks of 5


def test_auto_chunk_size_forms_match_jax():
    """JAX's (state_dim, dtype, memory_gb, problem) order, positional and
    by keyword, gives the JAX chunks, bare (the dense rule) and with a
    problem (its band)."""
    from applications.confusion import confusion_linear_observable as jco
    from hippyflow_tpu.models.sampling import auto_chunk_size as j_chunk
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable as tco,
    )
    from hippyflow_tpu_torch.models import auto_chunk_size

    for n, dt, jdt, gb in ((4225, torch.float32, jnp.float32, 20.0),
                           (1000, torch.float64, jnp.float64, 0.5),
                           (100000, torch.float32, jnp.float32, 1.0)):
        want = j_chunk(n, jdt, gb)
        assert want == j_chunk(n, jdt, memory_gb=gb)
        assert auto_chunk_size(n, dt, gb) == want
        assert auto_chunk_size(state_dim=n, dtype=dt, memory_gb=gb) == want
    assert auto_chunk_size(10, torch.float64, device="cpu") == 4096
    jobs, jV = jco(nx=16, velocity="analytic")
    tobs, _ = tco(nx=16, velocity="analytic", **F64)
    for gb in (0.01, 0.3):
        want = j_chunk(jV.dim, jnp.float64, gb, jobs.problem)
        assert auto_chunk_size(jV.dim, torch.float64, gb, tobs.problem) == want
        assert auto_chunk_size(jV.dim, torch.float64, memory_gb=gb,
                               problem=tobs.problem, device="cpu") == want


def test_keychain_next_key_and_sigma():
    """next_key is a generator of its own, seeded from the chain (so the
    chain moves on); normal(sigma=) scales the standard draw, on KeyChain
    and GivenNoise alike."""
    from hippyflow_tpu_torch.utils import GivenNoise, KeyChain

    a, b = KeyChain(5, "cpu"), KeyChain(5, "cpu")
    ga, gb = a.next_key(), b.next_key()
    assert isinstance(ga, torch.Generator)
    x = torch.randn(8, generator=ga, dtype=torch.float64)
    assert torch.equal(x, torch.randn(8, generator=gb, dtype=torch.float64))
    assert torch.equal(a.normal((3,)), b.normal((3,)))
    assert a.next_key().initial_seed() != ga.initial_seed()
    want = KeyChain(6, "cpu").normal((4, 3), dtype=torch.float64)
    got = KeyChain(6, "cpu").normal((4, 3), dtype=torch.float64, sigma=2.5)
    assert torch.equal(got, 2.5 * want)
    g = GivenNoise(np.random.default_rng(7), "cpu").normal((5,), sigma=0.5,
                                                          dtype=torch.float64)
    np.testing.assert_array_equal(
        g.numpy(), 0.5 * np.random.default_rng(7).standard_normal(5))
