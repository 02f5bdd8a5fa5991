"""The port's surrogate training against the JAX package.

Float64 on the CPU, inputs from a numpy seed.  Both packages start from
the same weights: the JAX network's flax init, cast to float64, loads into
the port's module (``interop.flax_params``) and goes into the JAX ``train``
through a model whose ``init`` returns it.  The JAX Newton-CG pieces are
the closures of its ``_fit_incg``, taken as ``jax.jit`` wraps them; its
probe blocks Omega (and its validation split) reach the port through
``training.draw``, rows mapped onto the port's flat order.

* the preconditioner refresh: U diag(d) U^T and d to 1e-8;
* one Newton-CG step from the same w, U, d: the same Armijo step length,
  w to 1e-9;
* AdamW, 5 steps: parameters and logger to 1e-10 (with frozen prefixes
  against optax's AdamW restricted to the trainable parameters: the JAX
  ``train`` passes the frozen parameters' gradients through
  ``optax.masked`` and moves them, which its incg path does not);
* ``train(optimizer="incg")``, 3 sweeps, validation data given: logger to
  1e-8 (spectra too), final parameters to 1e-7, on l2, with a frozen
  output layer, and with a normalized H1 term;
* the slice: POD from data, ``modify_projectors``, ``projected_dense``
  and 2 Newton-CG sweeps, the JAX chain of ``bench.py``'s training lane
  against the port's ``training_lane``, parameters and validation
  accuracy to 1e-7; one sweep at the lane's CG settings and ranks 4 x 8
  against JAX's own last-bit spread;
* ``main()``'s architectures on a small data directory; the device
  default.

A note on CG.  Past the loss of orthogonality of its Krylov basis, CG
amplifies rounding.  ``test_incg_sweep_at_lane_damping_tracks_jax`` shows
it: on the slice's data at ranks 4 x 8, one sweep at the lane's damping
1e-3, a change of the inputs in their last bit moves JAX's own trained
parameters by about 1e-14 of their largest after 6 CG steps and by about
1e-4 after the lane's 20.  No two summation orders agree there, so the
cases held to fixed tolerances run where the iteration is stable: 6 CG
steps at damping 1e-2 for the multi-step sweeps (the preconditioner then
stale within a sweep), and ranks 2 x 2 for the slice at the lane's own
settings (20 steps, damping 1e-3); at ranks 4 x 8 and 20 steps the port
is held to JAX's own last-bit spread.

Run as a script (``PYTHONPATH=. python3 tests/test_torch_training.py
--h1-gap FILE.npz``), the module holds ACCURACY.md's n=32 H1 comparison
of the JAX train against the port's on the CPU, on the arrays that
``chip_smoke.py --save-h1 FILE.npz`` writes (``h1_gap_runs``).
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from applications.confusion_training import modify_projectors as j_modify_projectors
from hippyflow_tpu import nn as jnn
from hippyflow_tpu.models import PODProjectorFromData as JPOD
from hippyflow_tpu_torch import config, interop
from hippyflow_tpu_torch import nn as tnn
from hippyflow_tpu_torch.applications import confusion_training as tct
from hippyflow_tpu_torch.nn import training as ttraining
from hippyflow_tpu_torch.nn.networks import flax_name

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
DM, DQ, RIN, ROUT = 20, 6, 4, 3
N_TRAIN, N_VAL = 48, 24


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype=np.float64), tree)


class _FixedInit:
    """A flax model whose ``init`` returns the given (float64) parameters."""

    def __init__(self, model, params):
        self.model, self.params = model, params

    def init(self, key, x):
        return self.params

    def apply(self, params, x):
        return self.model.apply(params, x)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    P = np.linalg.qr(rng.standard_normal((DM, RIN)))[0]
    Phi = np.linalg.qr(rng.standard_normal((DQ, ROUT)))[0]
    # a reduced map the network can represent: q = Phi tanh(A P^T m) + c
    A = rng.standard_normal((RIN, ROUT))
    m = rng.standard_normal((N_TRAIN + N_VAL, DM))
    q = np.tanh(m @ P @ A) @ Phi.T + 0.5
    shift = q[:N_TRAIN].mean(axis=0)
    jmodel = jnn.projected_dense(P, Phi, output_shift=shift)
    jparams = _f64(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(m[:1])))
    tmodel = tnn.projected_dense(P, Phi, output_shift=shift, **F64)
    order = interop.flax_params(tmodel, jparams)
    return dict(P=P, Phi=Phi, m=m, q=q, jmodel=jmodel, jparams=jparams,
                tmodel=tmodel, order=order)


def _jax_flat(jparams):
    return np.asarray(jax.flatten_util.ravel_pytree(jparams)[0])


def _tree_errors(tparams, jtree):
    """max|port - JAX| of each parameter over the largest JAX entry."""
    scale = max(np.abs(np.asarray(x)).max()
                for x in jax.tree_util.tree_leaves(jtree))
    errors = {}
    for n, t in tparams.items():
        key = flax_name(n)
        want = jtree
        for k in key.split("/"):
            want = want[k]
        got = t.detach().numpy()
        if key.endswith("/kernel"):
            got = got.T
        errors[key] = np.abs(got - np.asarray(want)).max() / scale
    return errors


def _compare_tree(tparams, jtree, tol):
    for key, err in _tree_errors(tparams, jtree).items():
        assert err <= tol, key


def _jax_draw(order):
    """``training.draw`` with JAX's draws: its split permutation and its
    probe block of sweep ``epoch``, rows in the port's order."""

    def draw(kind, seed, size, dtype=None, device=None):
        if kind == "split":
            return torch.as_tensor(np.asarray(
                jax.random.permutation(jax.random.PRNGKey(seed), size)))
        base, sweep = seed
        om = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(base), sweep),
                               size, dtype=jnp.float64)
        return torch.as_tensor(np.asarray(om)[order], dtype=dtype, device=device)

    return draw


@pytest.fixture(scope="module")
def jax_incg(setup):
    """The JAX package's refresh_preconditioner and incg_step closures for
    the fixture's model and l2 loss (frozen nothing), with the hess batch
    of 8 and rank 6 used below."""
    captured = {}
    real_jit = jax.jit

    def spy(fun=None, **kw):
        out = real_jit(fun, **kw)
        captured[fun.__name__] = out
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", spy)
    mp.setenv("HF_PARALLEL_PRECOMPILE", "0")
    try:
        jnn.train(_FixedInit(setup["jmodel"], setup["jparams"]), setup["m"], setup["q"],
                  epochs=0, optimizer="incg", batch_size=N_TRAIN, hess_batch_size=8,
                  hessian_low_rank=6, cg_iters=6)
    finally:
        mp.undo()
    return captured["refresh_preconditioner"], captured["incg_step"]


def _newton_cg(setup):
    apply_fn = tnn.apply_fn_of(setup["tmodel"])
    params = tnn.parameters_of(setup["tmodel"])
    nc = ttraining.NewtonCG(
        apply_fn, lambda p, mb, qb, jb: tnn.l2_loss(apply_fn, p, mb, qb), params,
        hess_batch=8, cg_iters=6, hessian_low_rank=6)
    return nc, nc.ravel(params)


def _refresh_both(setup, jax_incg):
    refresh, _ = jax_incg
    order = setup["order"]
    w = _jax_flat(setup["jparams"])
    m, q = setup["m"][:8], setup["q"][:8]
    Omega = np.random.default_rng(5).standard_normal((w.size, 11))
    Uj, dj = map(np.asarray, refresh(jnp.asarray(w), jnp.asarray(m), jnp.asarray(q),
                                     jnp.asarray(Omega)))
    nc, wt = _newton_cg(setup)
    np.testing.assert_array_equal(wt.numpy(), w[order])
    Ut, dt = nc.refresh(wt, torch.as_tensor(m), torch.as_tensor(q),
                        torch.as_tensor(Omega[order]))
    return (Uj, dj), (Ut, dt), nc, wt


def test_preconditioner_refresh_matches_jax(setup, jax_incg):
    (Uj, dj), (Ut, dt), _, _ = _refresh_both(setup, jax_incg)
    order = setup["order"]
    assert dt.shape == (6,) and np.all(np.diff(dt.numpy()) <= 0)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-8)
    Hj = (Uj * dj) @ Uj.T
    Ht = ((Ut * dt) @ Ut.T).numpy()
    assert np.abs(Ht - Hj[np.ix_(order, order)]).max() <= 1e-8 * np.abs(Hj).max()


def test_incg_step_matches_jax(setup, jax_incg):
    _, step = jax_incg
    (Uj, dj), _, nc, wt = _refresh_both(setup, jax_incg)
    order = setup["order"]
    w = _jax_flat(setup["jparams"])
    m, q = setup["m"][:N_TRAIN], setup["q"][:N_TRAIN]
    wj, basej, gj = map(np.asarray, step(jnp.asarray(w), jnp.asarray(m), jnp.asarray(q),
                                         None, jnp.asarray(Uj), jnp.asarray(dj)))
    args = (torch.as_tensor(m), torch.as_tensor(q), None,
            torch.as_tensor(Uj[order]), torch.as_tensor(dj))
    w_new, base, gnorm = nc.step(wt, *args)
    _, _, dp = nc.direction(wt, *args)
    np.testing.assert_allclose(base.item(), basej, rtol=1e-12)
    np.testing.assert_allclose(gnorm.item(), gj, rtol=1e-10)
    assert np.abs(w_new.numpy() - wj[order]).max() <= 1e-9 * np.abs(wj).max()

    def armijo_index(w_after):
        steps = [np.abs(wt.numpy() + 0.5**k * dp.numpy() - w_after).max()
                 for k in range(10)]
        return int(np.argmin(steps))

    k = armijo_index(w_new.numpy())
    assert k == armijo_index(wj[order])
    assert np.abs(wt.numpy() + 0.5**k * dp.numpy() - w_new.numpy()).max() <= 1e-12


def _adamw_reference(setup, frozen):
    """optax's AdamW over 5 batches in the JAX train's batch order, the
    frozen parameters left out (their updates set to zero)."""
    jmodel, params = setup["jmodel"], setup["jparams"]
    m, q = setup["m"][:N_TRAIN], setup["q"][:N_TRAIN]
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if "/".join(k.key for k in path).startswith(frozen)
        else "train", params)
    tx = optax.multi_transform(
        {"train": optax.adamw(1e-2, weight_decay=0.01), "frozen": optax.set_to_zero()},
        labels)
    state = tx.init(params)
    grad = jax.grad(lambda p, mb, qb: jnn.l2_loss(jmodel.apply, p, mb, qb))
    order = np.random.RandomState(0).permutation(N_TRAIN)
    for s in range(5):
        idx = order[s * 9: (s + 1) * 9]
        updates, state = tx.update(grad(params, m[idx], q[idx]), state, params)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("frozen", [None, "params/output_layer"])
def test_adamw_matches_jax(setup, frozen):
    m, q = setup["m"], setup["q"]
    kw = dict(epochs=1, batch_size=9, learning_rate=1e-2, weight_decay=0.01, seed=0,
              validation_data=(m[N_TRAIN:], q[N_TRAIN:]))
    if frozen:
        kw["frozen_prefixes"] = (frozen,)
    tparams, tlog = tnn.train(setup["tmodel"], m[:N_TRAIN], q[:N_TRAIN], **kw)
    if frozen is None:
        jparams, jlog = jnn.train(_FixedInit(setup["jmodel"], setup["jparams"]),
                                  m[:N_TRAIN], q[:N_TRAIN], **kw)
        for key in ("loss", "train_acc", "val_acc"):
            np.testing.assert_allclose(tlog[key], jlog[key], rtol=1e-10)
    else:
        jparams = _adamw_reference(setup, frozen)
        for n, t in tparams.items():
            if flax_name(n).startswith(frozen):
                torch.testing.assert_close(t, dict(setup["tmodel"].named_parameters())[n],
                                           rtol=0, atol=0)
    _compare_tree(tparams, jparams, 1e-10)
    # the module keeps its weights; the trained ones differ from them
    assert not torch.equal(tparams["input_bias"], setup["tmodel"].input_bias)


@pytest.mark.parametrize("case", ["l2", "frozen", "h1"])
def test_incg_train_matches_jax(setup, monkeypatch, case):
    m, q = setup["m"], setup["q"]
    kw = dict(epochs=3, batch_size=16, optimizer="incg", hess_batch_size=8,
              hessian_low_rank=6, cg_iters=6, incg_damping=1e-2, seed=0,
              record_spectrum=True, validation_data=(m[N_TRAIN:], q[N_TRAIN:]))
    if case == "frozen":
        kw["frozen_prefixes"] = ("params/output_layer",)
    if case == "h1":
        # random sketches J^T Phi, normalized H1 at weight 1
        rng = np.random.default_rng(2)
        kw.update(JstarPhi_data=rng.standard_normal((N_TRAIN, DM, ROUT)),
                  input_decoder=setup["P"], output_encoder=setup["Phi"],
                  h1_weight=1.0, h1_normalized=True)
    monkeypatch.setenv("HF_PARALLEL_PRECOMPILE", "0")
    jparams, jlog = jnn.train(_FixedInit(setup["jmodel"], setup["jparams"]),
                              m[:N_TRAIN], q[:N_TRAIN], **kw)
    monkeypatch.setattr(ttraining, "draw", _jax_draw(setup["order"]))
    tparams, tlog = tnn.train(setup["tmodel"], m[:N_TRAIN], q[:N_TRAIN], **kw)
    for key in ("loss", "train_acc", "val_acc", "gnorm"):
        np.testing.assert_allclose(tlog[key], jlog[key], rtol=1e-8)
    np.testing.assert_allclose(tlog["hessian_spectrum"], jlog["hessian_spectrum"],
                               rtol=1e-8)
    assert tlog["max_val_acc"] == max(tlog["val_acc"])
    _compare_tree(tparams, jparams, 1e-7)


def _slice_chain(in_rank, out_rank):
    """The slice's data from one numpy seed (n=64, dM=81 as at nx=8, dQ=10,
    a decoder) and the JAX chain of ``bench.py``'s training lane up to
    the network: POD ``hep``, ``modify_projectors``, ``projected_dense``
    and its init in float64."""
    rng = np.random.default_rng(0)
    n, dM, dQ = 64, 81, 10
    m = rng.standard_normal((n, dM))
    B = rng.standard_normal((dM, dQ)) / 9.0
    q = np.tanh(m @ B) + 0.2 * (m @ B) ** 2 + 1.0
    dec = np.linalg.qr(rng.standard_normal((dM, 12)))[0]
    _, phi, _, q_shift = JPOD(None, M_output=np.eye(dQ)).construct_subspace(
        jnp.asarray(q), u_rank=out_rank, shifted=True, method="hep")
    proj_in, proj_out = j_modify_projectors(
        {"AS_input": dec[:, :in_rank], "POD": np.asarray(phi)[:, :out_rank]})
    jmodel = jnn.projected_dense(proj_in, proj_out, output_shift=np.asarray(q_shift))
    jinit = _f64(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(m[:1])))
    return dict(m=m, q=q, dec=dec, proj_in=proj_in, proj_out=proj_out,
                q_shift=np.asarray(q_shift), jmodel=jmodel, jinit=jinit)


# bench.py's run_training_lane: train's arguments besides the sweeps
LANE_FIT = dict(batch_size=128, optimizer="incg", hess_batch_size=16,
                hessian_low_rank=20, validation_split=0.5, seed=0)


def test_training_lane_matches_jax_chain(monkeypatch):
    """bench.py's training lane: the JAX chain against ``training_lane``
    at n=64 (nx=8: dM=81), dQ=10, 2 sweeps, at ranks 2 x 2 (see the
    module's note on CG)."""
    c = _slice_chain(2, 2)
    m, q, jinit = c["m"], c["q"], c["jinit"]
    monkeypatch.setenv("HF_PARALLEL_PRECOMPILE", "0")
    jparams, jlog = jnn.train(_FixedInit(c["jmodel"], jinit), m, q, epochs=2,
                              **LANE_FIT)

    orders = []
    real_projected_dense = tct.projected_dense

    def projected_dense(*args, **kwargs):
        model = real_projected_dense(*args, **kwargs)
        np.testing.assert_array_equal(model.input_projector.numpy(), c["proj_in"])
        orders.append(interop.flax_params(model, jinit))
        return model

    monkeypatch.setattr(tct, "projected_dense", projected_dense)
    # the flat order is known once training_lane has built its model
    monkeypatch.setattr(ttraining, "draw",
                        lambda *args: _jax_draw(orders[-1])(*args))
    out = tct.training_lane(m, q, c["dec"], sweeps=2, n=64, in_rank=2, out_rank=2,
                            device="cpu")
    assert len(out["logger"]["val_acc"]) == 2
    assert abs(out["val_acc"] - jlog["val_acc"][-1]) <= 1e-7 * abs(jlog["val_acc"][-1])
    _compare_tree(out["params"], jparams, 1e-7)
    assert out["s_per_sweep"] > 0 and out["first_run_s"] > 0


@pytest.mark.parametrize("cg_iters", [6, 12, 20])
def test_incg_sweep_at_lane_damping_tracks_jax(monkeypatch, cg_iters):
    """One Newton-CG sweep at the lane's damping (1e-3) and Hessian rank
    (20) on the slice's data at ranks 4 x 8 (154 parameters): the port
    against JAX, beside JAX against itself with m changed in its last bit,
    m (1 + 2^-52).  That spread grows with the CG steps: about 1e-14 at 6,
    1e-11 at 12 and 1e-4 at the lane's 20, where no two summation orders
    can agree to 1e-7.  The port stays within 10 times JAX's own spread."""
    c = _slice_chain(4, 8)
    m, q = c["m"], c["q"]
    fit = dict(LANE_FIT, epochs=1, cg_iters=cg_iters, incg_damping=1e-3)
    monkeypatch.setenv("HF_PARALLEL_PRECOMPILE", "0")
    jparams, _ = jnn.train(_FixedInit(c["jmodel"], c["jinit"]), m, q, **fit)
    jlast, _ = jnn.train(_FixedInit(c["jmodel"], c["jinit"]), m * (1 + 2.0**-52), q,
                         **fit)
    w, w_last = _jax_flat(jparams), _jax_flat(jlast)
    spread = np.abs(w - w_last).max() / np.abs(w).max()

    tmodel = tnn.projected_dense(c["proj_in"], c["proj_out"],
                                 output_shift=c["q_shift"], **F64)
    monkeypatch.setattr(ttraining, "draw",
                        _jax_draw(interop.flax_params(tmodel, c["jinit"])))
    tparams, _ = tnn.train(tmodel, m, q, **fit)
    assert sum(t.numel() for t in tparams.values()) == 154
    err = max(_tree_errors(tparams, jparams).values())
    if cg_iters == 6:
        assert spread <= 1e-12
    if cg_iters == 20:
        assert spread >= 1e-6
    assert err <= max(10 * spread, 1e-12)


@pytest.mark.parametrize("arch", ["as_dense", "kle_dense", "as_resnet", "generic_dense",
                                  "linear", "low_rank_linear"])
def test_main_architectures(tmp_path, arch):
    """``main()`` on a small data directory (AS, KLE, POD files and the H1
    sketches), on the CPU."""
    rng = np.random.default_rng(3)
    n = 40
    m = rng.standard_normal((n, DM))
    q = np.tanh(m @ rng.standard_normal((DM, DQ)) / 4.0)
    np.savez(tmp_path / "mq_data.npz", m_data=m, q_data=q)
    np.save(tmp_path / "AS_input_decoder.npy", rng.standard_normal((DM, 6)))
    np.save(tmp_path / "AS_d_GN.npy", np.geomspace(1.0, 1e-6, 6))
    np.save(tmp_path / "KLE_decoder.npy", rng.standard_normal((DM, 6)))
    np.save(tmp_path / "POD_projector.npy", np.linalg.qr(rng.standard_normal((DQ, 4)))[0])
    np.save(tmp_path / "POD_d.npy", np.geomspace(1.0, 1e-3, 4))
    Phi = np.linalg.qr(rng.standard_normal((DQ, 4)))[0]
    np.savez(tmp_path / "JstarPhi_data.npz",
             JstarPhi_data=rng.standard_normal((n, DM, 4)), MPhi=Phi)
    argv = ["--data_dir", str(tmp_path), "--architecture", arch, "--epochs", "2",
            "--fixed_input_rank", "4", "--fixed_output_rank", "4", "--device", "cpu",
            "--batch_size", "16", "--logger_out", str(tmp_path / "log.pkl")]
    if arch == "as_dense":
        argv += ["--h1_weight", "0.5", "--optimizer", "incg", "--record_spectrum", "1"]
    logger = tct.main(argv)
    assert len(logger["val_acc"]) == 2 and np.isfinite(logger["loss"]).all()
    assert (tmp_path / "log.pkl").exists()
    if arch == "as_dense":
        assert len(logger["hessian_spectrum"]) == 2


def test_default_device_needs_a_card(monkeypatch):
    """No quiet fallback: without a card the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.default_device()
    with pytest.raises(RuntimeError):
        tnn.projected_dense(np.eye(4)[:, :2], np.eye(3)[:, :2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.default_device() == torch.device("cuda", 0)
    assert config.resolve(None, "cpu") == (torch.float32, torch.device("cpu"))


def h1_gap_runs(path, sweeps=40, seeds=(0, 1, 2, 3, 4)):
    """ACCURACY.md's n=32 comparison through the JAX train and through the
    port's, on the CPU in float32, from the arrays that ``chip_smoke.py
    --save-h1 PATH`` writes: DIPNet and DIPResNet (ranks 8, 8), l2 and
    normalized H1 (weight 1), ``sweeps`` Newton-CG sweeps per weight seed,
    set up as ``benchmarks/accuracy_sweep.py`` sets them up.  Prints the
    max validation accuracy of each run and each package's mean gap."""
    import time

    a = {k: v.astype(np.float32) for k, v in np.load(path).items()}
    n = a["m"].shape[0]
    P, Phi = j_modify_projectors({"AS_input": a["decoder"], "POD": a["phi"]})
    fit = dict(epochs=sweeps, batch_size=n, optimizer="incg", hess_batch_size=16,
               hessian_low_rank=20, validation_data=(a["m_val"], a["q_val"]))
    h1 = dict(JstarPhi_data=a["JstarPhi"], input_decoder=P, output_encoder=a["phi"],
              h1_weight=1.0, h1_normalized=True)

    def jax_run(arch, loss, seed):
        model = (jnn.projected_dense(P, Phi, output_shift=a["q_shift"])
                 if arch == "as_dense" else jnn.projected_low_rank_residual_network(
                     P, Phi, ranks=(8, 8), output_shift=a["q_shift"]))
        return jnn.train(model, a["m"], a["q"], seed=seed, **fit,
                         **(h1 if loss == "h1" else {}))[1]["max_val_acc"]

    def port_run(arch, loss, seed):
        kw = dict(output_shift=a["q_shift"], dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
        model = (tnn.projected_dense(P, Phi, **kw) if arch == "as_dense" else
                 tnn.projected_low_rank_residual_network(P, Phi, ranks=(8, 8), **kw))
        return tnn.train(model, a["m"], a["q"], seed=seed, **fit,
                         **(h1 if loss == "h1" else {}))[1]["max_val_acc"]

    for package, run in (("JAX", jax_run), ("port", port_run)):
        for arch in ("as_dense", "as_resnet"):
            acc = {}
            for loss in ("l2", "h1"):
                t0 = time.perf_counter()
                acc[loss] = np.array([run(arch, loss, s) for s in seeds])
                print(f"{package} {arch} {loss} n={n} float32 CPU, {sweeps} sweeps, "
                      f"seeds {list(seeds)}: max val acc {np.round(acc[loss], 4)} "
                      f"(mean {acc[loss].mean():.4f}, std {acc[loss].std():.4f}); "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            gap = (acc["h1"] - acc["l2"]).mean()
            sd = max(acc["l2"].std(), acc["h1"].std())
            print(f"{package} {arch} H1 gap n={n}: {gap:+.4f} ({gap / sd:+.1f} times "
                  f"the larger seed std {sd:.4f})", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. python3 tests/test_torch_training.py --h1-gap FILE.npz
    import os
    import sys

    os.environ.setdefault("HF_PARALLEL_PRECOMPILE", "0")
    jax.config.update("jax_platforms", "cpu")
    h1_gap_runs(sys.argv[sys.argv.index("--h1-gap") + 1])
