"""The port's surrogate networks, losses and CG against the JAX package.

Every case runs in float64 on the CPU, with inputs made from a numpy seed:
the JAX network's parameters (flax's init, cast to float64) load into the
port's module of the same architecture through ``interop.flax_params``,
and both packages get the same inputs.

* networks: all five architectures (DIPResNet with sigmoid and softplus),
  forward to 1e-12 relative, with softplus inputs above 20;
* losses: ``l2_loss`` and ``make_h1_loss`` (plain and normalized), values
  and parameter gradients to 1e-10 (the H1 gradient is reverse over
  forward mode in both packages); ``jstarphi_from_jsvd`` and ``accuracy``
  to 1e-12;
* CG against ``jax.scipy.sparse.linalg.cg``, with and without a
  preconditioner, stopping early or at ``maxiter``, to 1e-10;
* ``gauss_newton_cg_step`` to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippyflow_tpu import nn as jnn
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch import nn as tnn
from hippyflow_tpu_torch.nn.networks import flax_name
from hippyflow_tpu_torch.nn.training import cg

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
DM, DQ, RIN, ROUT, N = 24, 7, 5, 4, 12


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype=np.float64), tree)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    P = np.linalg.qr(rng.standard_normal((DM, RIN)))[0]
    Phi = np.linalg.qr(rng.standard_normal((DQ, ROUT)))[0]
    m = rng.standard_normal((N, DM))
    q = np.tanh(m @ rng.standard_normal((DM, DQ)) / 5.0) + 0.5
    J = rng.standard_normal((N, DM, ROUT))  # sketches J^T Phi
    shift = q.mean(axis=0)
    return dict(P=P, Phi=Phi, m=m, q=q, J=J, shift=shift)


ARCHS = ["dipnet", "dipresnet_softplus", "dipresnet_sigmoid",
         "generic_dense", "generic_linear", "low_rank_linear"]


def _models(arch, d):
    """(flax module, port module) of one architecture."""
    P, Phi, shift = d["P"], d["Phi"], d["shift"]
    if arch == "dipnet":
        return (jnn.projected_dense(P, Phi, intermediate_layers=2, output_shift=shift),
                tnn.projected_dense(P, Phi, intermediate_layers=2,
                                    output_shift=shift, **F64))
    if arch.startswith("dipresnet"):
        act = arch.split("_")[1]
        return (jnn.projected_low_rank_residual_network(
                    P, Phi, ranks=(3, 2), residual_activation=act, output_shift=shift),
                tnn.projected_low_rank_residual_network(
                    P, Phi, ranks=(3, 2), residual_activation=act,
                    output_shift=shift, **F64))
    if arch == "generic_dense":
        return jnn.GenericDense(output_dim=DQ), tnn.GenericDense(DM, DQ, **F64)
    if arch == "generic_linear":
        return jnn.GenericLinear(output_dim=DQ), tnn.GenericLinear(DM, DQ, **F64)
    return (jnn.LowRankLinear(output_dim=DQ, rank=3),
            tnn.LowRankLinear(DM, DQ, rank=3, **F64))


def _pair(arch, d):
    """Both modules with the same (flax-initialized) float64 weights."""
    jmodel, tmodel = _models(arch, d)
    jparams = _f64(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(d["m"][:1])))
    interop.flax_params(tmodel, jparams)
    return jmodel, jparams, tmodel


def _tree_get(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _compare_tree(tparams, jtree, tol):
    """Port parameter dict against a flax tree (kernels transposed),
    relative to the largest entry of the whole tree."""
    scale = max(np.abs(np.asarray(x)).max()
                for x in jax.tree_util.tree_leaves(jtree))
    for n, t in tparams.items():
        key = flax_name(n)
        want = _tree_get(jtree, key)
        got = t.detach().numpy()
        if key.endswith("/kernel"):
            got = got.T
        assert np.abs(got - want).max() <= tol * scale, key


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(data, arch):
    jmodel, jparams, tmodel = _pair(arch, data)
    # plain inputs, and scaled so that the activations see inputs above 20
    for scale in (1.0, 60.0):
        m = scale * data["m"]
        want = np.asarray(jmodel.apply(jparams, jnp.asarray(m)))
        got = tmodel(torch.as_tensor(m)).detach().numpy()
        assert got.shape == (N, DQ)
        assert _rel(got, want) <= 1e-12


def test_softplus_matches_jax_at_large_inputs():
    x = np.linspace(-60.0, 60.0, 241)
    got = tnn.networks.softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-15, atol=0)


def test_projections_frozen_and_initialized(data):
    """The input projection is a buffer (no parameter); the output layer
    starts at Phi^T (weight Phi) with the bias at output_shift; the other
    weights are LeCun-normal from the caller's generator."""
    model = tnn.projected_dense(data["P"], data["Phi"], output_shift=data["shift"],
                                generator=torch.Generator().manual_seed(5), **F64)
    names = dict(model.named_parameters())
    assert "input_projector" not in names
    assert "input_projector" in dict(model.named_buffers())
    np.testing.assert_array_equal(model.output_layer.weight.detach().numpy(), data["Phi"])
    np.testing.assert_array_equal(model.output_layer.bias.detach().numpy(), data["shift"])
    assert not model.input_bias.detach().any()
    again = tnn.projected_dense(data["P"], data["Phi"],
                                generator=torch.Generator().manual_seed(5), **F64)
    torch.testing.assert_close(again.dense_reduction_layer.weight,
                               model.dense_reduction_layer.weight, rtol=0, atol=0)
    # flax's lecun_normal: a normal truncated at 2 sigma, unit variance after
    # the 1/0.8796 correction, times sqrt(1/fan_in)
    w = tnn.networks.dense(400, 300, generator=torch.Generator().manual_seed(0),
                           **F64).weight.detach().numpy() * np.sqrt(400)
    assert abs(w.std() - 1.0) < 0.01 and np.abs(w).max() <= 2.0 / 0.87962566103423978


def _loss_pair(kind, data, jmodel, tmodel):
    """(JAX loss(params), port loss(params)) on the same batch."""
    m, q, J = data["m"], data["q"], data["J"]
    japply = lambda p, x: jmodel.apply(p, x)
    tapply = tnn.apply_fn_of(tmodel)
    mt, qt, Jt = (torch.as_tensor(a) for a in (m, q, J))
    if kind == "l2":
        return (lambda p: jnn.l2_loss(japply, p, jnp.asarray(m), jnp.asarray(q)),
                lambda p: tnn.l2_loss(tapply, p, mt, qt))
    normalized = kind == "h1_normalized"
    jh1 = jnn.make_h1_loss(japply, data["P"], data["Phi"], normalized=normalized)
    th1 = tnn.make_h1_loss(tapply, torch.as_tensor(data["P"]),
                           torch.as_tensor(data["Phi"]), normalized=normalized)
    return (lambda p: jh1(p, jnp.asarray(m), jnp.asarray(J)),
            lambda p: th1(p, mt, Jt))


@pytest.mark.parametrize("arch", ["dipnet", "dipresnet_sigmoid"])
@pytest.mark.parametrize("kind", ["l2", "h1", "h1_normalized"])
def test_loss_and_gradient_match_jax(data, arch, kind):
    jmodel, jparams, tmodel = _pair(arch, data)
    jloss, tloss = _loss_pair(kind, data, jmodel, tmodel)
    jval, jgrad = jax.value_and_grad(jloss)(jparams)
    tparams = tnn.parameters_of(tmodel)
    tgrad, tval = torch.func.grad_and_value(tloss)(tparams)
    assert abs(tval.item() - float(jval)) <= 1e-10 * abs(float(jval))
    _compare_tree(tgrad, jgrad, 1e-10)


def test_jstarphi_and_accuracy_match_jax(data):
    rng = np.random.default_rng(11)
    U = rng.standard_normal((N, DQ, 3))
    s = rng.random((N, 3))
    V = rng.standard_normal((N, DM, 3))
    want = np.asarray(jnn.jstarphi_from_jsvd(U, s, V, data["Phi"]))
    got = tnn.jstarphi_from_jsvd(U, s, V, data["Phi"]).numpy()
    assert got.shape == (N, DM, ROUT)
    assert _rel(got, want) <= 1e-12
    jmodel, jparams, tmodel = _pair("dipnet", data)
    want = float(jnn.accuracy(lambda p, x: jmodel.apply(p, x), jparams,
                              jnp.asarray(data["m"]), jnp.asarray(data["q"])))
    got = tnn.accuracy(tnn.apply_fn_of(tmodel), tnn.parameters_of(tmodel),
                       torch.as_tensor(data["m"]), torch.as_tensor(data["q"])).item()
    assert abs(got - want) <= 1e-12 * abs(want)


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.geomspace(1.0, cond, n)) @ Q.T
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("case", [
    # (n, condition number, maxiter, preconditioned, stops early): the
    # first two stop on the tolerance, the last two run into maxiter
    (12, 10.0, 60, False, True),
    (12, 10.0, 60, True, True),
    (40, 100.0, 15, False, False),
    (40, 100.0, 15, True, False),
])
def test_cg_matches_jax(case):
    n, cond, maxiter, preconditioned, early = case
    A, b = _spd(n, cond, seed=n)
    Minv = np.diag(1.0 / np.diag(A)) if preconditioned else None
    jM = (lambda v: jnp.asarray(Minv) @ v) if preconditioned else None
    want, _ = jax.scipy.sparse.linalg.cg(lambda v: jnp.asarray(A) @ v,
                                         jnp.asarray(b), M=jM, maxiter=maxiter)
    At = torch.as_tensor(A)
    tM = (lambda v: torch.as_tensor(Minv) @ v) if preconditioned else None
    got = cg(lambda v: At @ v, torch.as_tensor(b), M=tM, maxiter=maxiter).numpy()
    assert _rel(got, want) <= 1e-10
    resid = np.linalg.norm(A @ got - b) / np.linalg.norm(b)
    assert (resid <= 1e-5) == early


def test_cg_stops_before_maxiter():
    """Past convergence the frozen loop returns what a loop that stopped
    returns: more iterations change nothing."""
    A, b = _spd(12, 10.0, seed=12)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x30 = cg(lambda v: At @ v, bt, maxiter=30)
    x60 = cg(lambda v: At @ v, bt, maxiter=60)
    torch.testing.assert_close(x30, x60, rtol=0, atol=0)


def test_gauss_newton_cg_step_matches_jax(data):
    jmodel, jparams, tmodel = _pair("dipnet", data)
    m, q = data["m"], data["q"]
    want = jnn.gauss_newton_cg_step(lambda p, x: jmodel.apply(p, x), jparams,
                                    jnp.asarray(m), jnp.asarray(q), cg_iters=10)
    got = tnn.gauss_newton_cg_step(tnn.apply_fn_of(tmodel), tnn.parameters_of(tmodel),
                                   torch.as_tensor(m), torch.as_tensor(q), cg_iters=10)
    _compare_tree(got, want, 1e-9)
    l0 = tnn.l2_loss(tnn.apply_fn_of(tmodel), tnn.parameters_of(tmodel),
                     torch.as_tensor(m), torch.as_tensor(q))
    l1 = tnn.l2_loss(tnn.apply_fn_of(tmodel), got, torch.as_tensor(m), torch.as_tensor(q))
    assert l1 < l0


def test_flax_params_order_maps_raveled_vectors(data):
    """port_flat == jax_flat[order] for the raveled parameter vectors."""
    from jax.flatten_util import ravel_pytree

    jmodel, jparams, tmodel = _pair("dipresnet_softplus", data)
    order = interop.flax_params(tmodel, jparams)
    jflat = np.asarray(ravel_pytree(jparams)[0])
    tflat = torch.cat([p.detach().reshape(-1) for p in tmodel.parameters()]).numpy()
    np.testing.assert_array_equal(tflat, jflat[order])
    assert sorted(order) == list(range(jflat.size))
    with pytest.raises(ValueError):
        interop.flax_params(tnn.GenericLinear(DM, DQ, **F64), jparams)
