"""Surrogate training: l2 and derivative-informed (H1-seminorm) losses,
AdamW and inexact Newton-CG (port of ``hippyflow_tpu/nn/training.py``).

Losses
------
* l2:   mean_i ||f(m_i) - q_i||^2
* h1:   mean_i ||d(Phi^T f)/d(m_r)(m_i) - (J_i^T Phi)^T P||_F^2
  where P is the (frozen) reduced input decoder and J_i^T Phi the stored
  Jacobian sketches.  The network Jacobian in reduced coordinates is rIn
  forward-mode tangents (``torch.func.jacfwd``) through the network, for
  the whole batch at once: each sample's output depends on its own input
  only.

Accuracy metric: 1 - ||f - q|| / ||q - q_bar|| per sample, averaged.

The losses are functions of ``(apply_fn, params, ...)`` with
``apply_fn(params, m)`` a functional call of the module (``apply_fn_of``)
and ``params`` a dict of tensors by parameter name, so that ``torch.func``
differentiates them.  ``train`` starts from the module's own weights and
leaves the module untouched: it returns the trained parameters.

The flat parameter vector of the Newton-CG path lays the parameters out
in ``named_parameters()`` order, each in its own row-major layout.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, jacfwd, jvp, vjp, vmap

from .networks import flax_name


def apply_fn_of(model):
    """``apply_fn(params, m)``: the module's forward with ``params`` (a dict
    by parameter name) in place of its parameters."""
    return lambda params, m: functional_call(model, params, (m,))


def parameters_of(model):
    """The module's parameters as a dict of detached tensors."""
    return {n: p.detach() for n, p in model.named_parameters()}


def l2_loss(apply_fn, params, m, q):
    pred = apply_fn(params, m)
    return torch.mean(torch.sum((pred - q) ** 2, dim=-1))


def make_h1_loss(apply_fn, input_decoder, output_encoder, normalized=False):
    """Returns h1(params, m, JstarPhi) for sketches laid out (n, dM, rQ).

    CONSISTENCY CONTRACT: ``output_encoder`` must be the SAME matrix Phi
    that formed the stored sketches ``JstarPhi = J^T Phi``.  A rescaled or
    re-orthogonalized variant (such as the output layer that
    ``modify_projectors`` gives the network) drives the network Jacobian
    toward a scaled or sign-flipped copy of the true one.

    ``normalized=True`` uses the per-sample relative Frobenius misfit
    ``||J_net - J||_F^2 / ||J||_F^2``, so that ``h1_weight`` is a unitless
    mix ratio against the l2 term."""
    P = torch.as_tensor(input_decoder)  # (dM, rIn)
    Phi = torch.as_tensor(output_encoder)  # (dQ, rQ)

    def loss(params, m_batch, JstarPhi_batch):
        P_, Phi_ = P.to(m_batch), Phi.to(m_batch)

        def g(dm_r):
            # Phi^T f(m + P dm_r) for every sample of the batch
            return apply_fn(params, m_batch + dm_r @ P_.T) @ Phi_

        jac = jacfwd(g)(m_batch.new_zeros(P_.shape[1]))  # (n, rQ, rIn)
        target = JstarPhi_batch.to(m_batch).transpose(1, 2) @ P_  # Phi^T J P
        mis = torch.sum((jac - target) ** 2, dim=(1, 2))
        if normalized:
            mis = mis / torch.clamp(torch.sum(target**2, dim=(1, 2)), min=1e-20)
        return torch.mean(mis)

    return loss


def jstarphi_from_jsvd(U_data, sigma_data, V_data, output_encoder):
    """Jacobian sketches ``J_i^T Phi`` (n, dM, rQ) from low-rank Jacobian
    SVD data ``J_i ~= U_i diag(s_i) V_i^T`` (the ``Jsvd_data.npz``
    schema), so that H1 training works from either derivative artifact."""
    U = torch.as_tensor(U_data)  # (n, dQ, r)
    s = torch.as_tensor(sigma_data)  # (n, r)
    V = torch.as_tensor(V_data)  # (n, dM, r)
    Phi = torch.as_tensor(output_encoder)  # (dQ, rQ)
    UtPhi = torch.einsum("nqr,qp->nrp", U, Phi)
    return torch.einsum("nmr,nrp->nmp", V, s[:, :, None] * UtPhi)


def accuracy(apply_fn, params, m, q):
    pred = apply_fn(params, m)
    q_bar = q.mean(dim=0)
    num = torch.linalg.norm(pred - q, dim=-1)
    den = torch.linalg.norm(q - q_bar, dim=-1)
    return torch.mean(1.0 - num / den)


CG_TOL = 1e-5


def cg(A, b, *, maxiter, M=None):
    """Conjugate gradients for A x = b from x0 = 0, as
    ``jax.scipy.sparse.linalg.cg`` runs them at its default tolerance: it
    stops once ||r||^2 <= CG_TOL^2 ||b||^2 (the unpreconditioned residual,
    also when ``M`` is given) or after ``maxiter`` steps.  The loop runs
    all ``maxiter`` steps and freezes x, r, p and gamma once the test
    holds, so that no step waits for the host."""
    precon = M if M is not None else (lambda v: v)
    atol2 = CG_TOL**2 * (b @ b)
    x = torch.zeros_like(b)
    r = b  # b - A(0)
    p = z = precon(r)
    gamma = r @ z
    for _ in range(maxiter):
        active = (gamma if M is None else r @ r) > atol2
        Ap = A(p)
        alpha = gamma / (p @ Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = precon(r_)
        gamma_ = r_ @ z_
        p_ = z_ + (gamma_ / gamma) * p
        x, r, gamma, p = (torch.where(active, new, old) for new, old in
                          ((x_, x), (r_, r), (gamma_, gamma), (p_, p)))
    return x


def draw(kind: str, seed, size, dtype=None, device=None):
    """The train's random draws, from a seeded CPU ``torch.Generator`` so
    that they do not depend on the device: ``"split"`` the permutation of
    ``size`` samples that splits off the validation set (``seed``), and
    ``"probe"`` the standard-normal block of shape ``size`` that probes the
    Gauss-Newton Hessian (``seed`` the pair (seed + 2, sweep))."""
    if kind == "split":
        return torch.randperm(size, generator=torch.Generator().manual_seed(seed))
    base, sweep = seed
    gen = torch.Generator().manual_seed(base * 1_000_003 + sweep)
    return torch.randn(size, generator=gen, dtype=dtype).to(device)


def _split(n, validation_split, seed, device):
    n_val = max(1, int(n * validation_split)) if validation_split else 0
    perm = draw("split", seed, n).to(device)
    return perm[: n - n_val], perm[n - n_val:], n_val


def train(
    model,
    m_data,
    q_data,
    JstarPhi_data=None,
    input_decoder=None,
    output_encoder=None,
    h1_weight: float = 1.0,
    h1_normalized: bool = False,
    l2_weight: float = 1.0,
    batch_size: int = 128,
    epochs: int = 100,
    learning_rate: float = 1e-3,
    weight_decay: float = 0.0,
    validation_split: float = 0.1,
    validation_data=None,
    seed: int = 0,
    frozen_prefixes: tuple = (),
    verbose: bool = False,
    optimizer: str = "adamw",
    cg_iters: int = 20,
    hess_batch_size: int = 16,
    hessian_low_rank: int = 20,
    incg_damping: float = 1e-3,
    record_spectrum: bool = False,
):
    """Train a surrogate module from its current weights; returns (params,
    logger) with ``params`` a dict of tensors by parameter name (load it
    with ``model.load_state_dict(params, strict=False)``).  The data go to
    the module's dtype and device.

    The logger mirrors hessianlearn's: per-epoch train/val accuracy and
    loss (and ||g|| on the second-order path); the weights of the best
    validation accuracy are returned, not the last iterate.
    ``frozen_prefixes`` name parameters by their JAX package paths
    (``params/output_layer``, see ``flax_name``); they stay as they are.

    optimizer='adamw' (default) is ``torch.optim.AdamW`` with this
    function's ``weight_decay``; optimizer='incg' is the inexact
    Newton-CG path: per batch, (H_GN + damping I) dp = -g by matrix-free
    CG (Gauss-Newton products on a ``hess_batch_size`` subsample),
    preconditioned by a rank-``hessian_low_rank`` randomized
    eigendecomposition of H_GN refreshed each sweep, globalized by an
    Armijo ladder of 10 step lengths evaluated in one batched call.  With
    an h1 term the gradient includes it; curvature is Gauss-Newton on the
    l2 residual only.  record_spectrum=True logs the top eigenvalues of
    H_GN each sweep (incg only).
    """
    ref = next(model.parameters())
    dtype, device = ref.dtype, ref.device

    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    m_data, q_data = as_t(m_data), as_t(q_data)
    if validation_data is not None:
        # an explicit held-out set: every data-size sweep point is scored
        # on the same samples
        m_val, q_val = validation_data
        n_train = m_data.shape[0]
        m_data = torch.cat([m_data, as_t(m_val)])
        q_data = torch.cat([q_data, as_t(q_val)])
        n_val = m_data.shape[0] - n_train
        tr = torch.arange(n_train, device=device)
        va = torch.arange(n_train, m_data.shape[0], device=device)
    else:
        tr, va, n_val = _split(m_data.shape[0], validation_split, seed, device)

    apply_fn = apply_fn_of(model)
    params = {n: p.clone() for n, p in parameters_of(model).items()}

    h1 = None
    if JstarPhi_data is not None:
        assert input_decoder is not None and output_encoder is not None
        h1 = make_h1_loss(apply_fn, as_t(input_decoder), as_t(output_encoder),
                          normalized=h1_normalized)
        JstarPhi_data = as_t(JstarPhi_data)

    def total_loss(p, mb, qb, jb):
        loss = l2_weight * l2_loss(apply_fn, p, mb, qb)
        if h1 is not None:
            loss = loss + h1_weight * h1(p, mb, jb)
        return loss

    def evaluate(p):
        tr_acc = accuracy(apply_fn, p, m_data[tr], q_data[tr]).item()
        va_acc = (accuracy(apply_fn, p, m_data[va], q_data[va]).item()
                  if n_val else float("nan"))
        return tr_acc, va_acc

    if optimizer == "incg":
        return _fit_incg(
            params, total_loss, evaluate, m_data, q_data, JstarPhi_data,
            tr, n_val,
            l2_weight=l2_weight, apply_fn=apply_fn, batch_size=batch_size,
            epochs=epochs, seed=seed, frozen_prefixes=frozen_prefixes,
            verbose=verbose, cg_iters=cg_iters,
            hess_batch_size=hess_batch_size,
            hessian_low_rank=hessian_low_rank, damping=incg_damping,
            record_spectrum=record_spectrum,
        )
    assert not record_spectrum, "record_spectrum requires optimizer='incg'"
    assert optimizer == "adamw", f"unknown optimizer {optimizer!r}"

    trainable = [n for n in params if not _frozen(n, frozen_prefixes)]
    opt = torch.optim.AdamW([params[n] for n in trainable], lr=learning_rate,
                            weight_decay=weight_decay)
    loss_and_grad = grad_and_value(total_loss)

    logger = {"train_acc": [], "val_acc": [], "loss": [], "epoch_time": []}
    steps_per_epoch = max(1, tr.shape[0] // batch_size)
    rng = np.random.RandomState(seed)
    best_params = None
    for epoch in range(epochs):
        t0 = time.time()
        order = torch.as_tensor(rng.permutation(tr.shape[0]), device=device)
        last_loss = None
        for s_idx in range(steps_per_epoch):
            idx = tr[order[s_idx * batch_size: (s_idx + 1) * batch_size]]
            jb = JstarPhi_data[idx] if h1 is not None else None
            grads, last_loss = loss_and_grad(params, m_data[idx],
                                             q_data[idx], jb)
            for n in trainable:
                params[n].grad = grads[n]
            opt.step()
        tr_acc, va_acc = evaluate(params)
        logger["train_acc"].append(tr_acc)
        logger["val_acc"].append(va_acc)
        logger["loss"].append(last_loss.item())
        logger["epoch_time"].append(time.time() - t0)
        if n_val and (best_params is None or va_acc > logger["max_val_acc"]):
            logger["max_val_acc"] = va_acc
            best_params = {n: p.clone() for n, p in params.items()}
        if verbose and (epoch % 10 == 0 or epoch == epochs - 1):
            print(
                f"epoch {epoch:4d} loss {last_loss.item():.4e} "
                f"train_acc {tr_acc:.4f} val_acc {va_acc:.4f}"
            )
    return (best_params if best_params is not None else params), logger


def _frozen(name, frozen_prefixes):
    return any(flax_name(name).startswith(fp) for fp in frozen_prefixes)


def _flat_layout(params):
    """(ravel, unravel) between a parameter dict and one flat vector in the
    dict's order."""
    names = list(params)
    shapes = [params[n].shape for n in names]
    sizes = [math.prod(s) for s in shapes]

    def ravel(p):
        return torch.cat([p[n].reshape(-1) for n in names])

    def unravel(w):
        return {n: c.view(s) for n, c, s in
                zip(names, torch.split(w, sizes), shapes)}

    return ravel, unravel


def _frozen_flat_mask(params, frozen_prefixes, flat):
    """(nflat,) 0/1 mask over the flat parameter vector: 0 on frozen
    parameters."""
    return torch.cat([
        torch.full((p.numel(),), 0.0 if _frozen(n, frozen_prefixes) else 1.0,
                   dtype=flat.dtype, device=flat.device)
        for n, p in params.items()
    ])


class NewtonCG:
    """The pieces of the inexact Newton-CG path on one flat parameter
    vector (the parameters of ``params`` in its order, see
    ``_flat_layout``): the masked, damped Gauss-Newton product on a batch,
    the rank-k preconditioner refresh, and one step (gradient, CG
    direction, Armijo ladder).  Gauss-Newton curvature is that of the l2
    residual only; ``total_loss(params, m, q, J)`` gives the gradient and
    the ladder's losses."""

    def __init__(self, apply_fn, total_loss, params, *, l2_weight=1.0,
                 frozen_prefixes=(), hess_batch=16, cg_iters=20,
                 hessian_low_rank=20, damping=1e-3):
        self.apply_fn, self.total_loss = apply_fn, total_loss
        self.ravel, self.unravel = _flat_layout(params)
        flat = self.ravel(params)
        self.mask = _frozen_flat_mask(params, frozen_prefixes, flat)
        self.l2_weight, self.hess_batch = l2_weight, hess_batch
        self.cg_iters, self.rank, self.damping = cg_iters, hessian_low_rank, damping
        self.alphas = torch.pow(0.5, torch.arange(10, dtype=flat.dtype,
                                                  device=flat.device))
        self._loss_and_grad = grad_and_value(self.loss)

    def loss(self, w, mb, qb, jb):
        return self.total_loss(self.unravel(w), mb, qb, jb)

    def matvec(self, w, hm, hq):
        """v -> mask (J^T J) (mask v) + damping v, with J the Jacobian of
        the residual scaled so that 0.5||r_s||^2 == l2_weight * mean_i
        ||f - q||^2 on (hm, hq)."""
        scale = math.sqrt(2.0 * self.l2_weight / hm.shape[0])
        mask, damping = self.mask, self.damping

        def scaled_resid(wv):
            return (self.apply_fn(self.unravel(wv), hm) - hq).reshape(-1) * scale

        _, vjp_fn = vjp(scaled_resid, w)

        def mv(v):
            _, Jv = jvp(scaled_resid, (w,), (mask * v,))
            return mask * vjp_fn(Jv)[0] + damping * v

        return mv

    def refresh(self, w, hm, hq, Omega):
        """Rank-k randomized eigendecomposition of the (masked) GN Hessian:
        Y = H Omega, Q = qr(Y), T = Q^T H Q.  Returns (U, d), (nflat, k)
        and (k,), d descending."""
        mv = vmap(self.matvec(w, hm, hq), in_dims=1, out_dims=1)
        Q, _ = torch.linalg.qr(mv(Omega))
        T = Q.T @ mv(Q)
        d, S = torch.linalg.eigh(0.5 * (T + T.T))
        k = min(self.rank, d.shape[0])
        d, S = d.flip(0)[:k], S.flip(1)[:, :k]
        return Q @ S, d

    def direction(self, w, mb, qb, jb, U, dprec):
        """(g, loss, dp): the masked gradient, the loss at w, and the
        preconditioned-CG solution of (H_GN + damping I) dp = -g with H_GN
        on the first ``hess_batch`` samples of the batch."""
        g, base = self._loss_and_grad(w, mb, qb, jb)
        g = self.mask * g
        mv = self.matvec(w, mb[: self.hess_batch], qb[: self.hess_batch])
        damping = self.damping

        def precon(v):
            # (U diag(d) U^T + damping-complement)^{-1} v
            c = U.T @ v
            return v / damping + U @ (c / torch.clamp(dprec, min=damping)
                                      - c / damping)

        dp = self.mask * cg(mv, -g, M=precon, maxiter=self.cg_iters)
        return g, base, dp

    def step(self, w, mb, qb, jb, U, dprec):
        """One step: the first of 10 halving step lengths that meets the
        Armijo condition (else the one of least loss), taken only if it
        lowers the loss.  The 10 losses are one batched call.  Returns
        (w_new, loss at w, ||g||)."""
        g, base, dp = self.direction(w, mb, qb, jb, U, dprec)
        alphas = self.alphas
        ls = vmap(lambda a: self.loss(w + a * dp, mb, qb, jb))(alphas)
        ok = ls <= base + 1e-4 * alphas * (g @ dp)
        idx = torch.where(ok.any(), ok.to(torch.int32).argmax(), ls.argmin())
        w_new = torch.where(ls[idx] < base, w + alphas[idx] * dp, w)
        return w_new, base, torch.linalg.norm(g)


def _fit_incg(
    params, total_loss, evaluate, m_data, q_data, J_data, tr, n_val, *,
    l2_weight, apply_fn, batch_size, epochs, seed, frozen_prefixes, verbose,
    cg_iters, hess_batch_size, hessian_low_rank, damping,
    record_spectrum=False,
):
    """Inexact Newton-CG fit loop (hessianlearn's ``fit()`` with optimizer
    'incg'): the preconditioner refreshed once per sweep on the first
    Hessian batch of the sweep's order, then ``NewtonCG.step`` per batch;
    the best-validation weights are returned."""
    nc = NewtonCG(apply_fn, total_loss, params, l2_weight=l2_weight,
                  frozen_prefixes=frozen_prefixes,
                  hess_batch=min(hess_batch_size, batch_size),
                  cg_iters=cg_iters, hessian_low_rank=hessian_low_rank,
                  damping=damping)
    flat = nc.ravel(params)
    logger = {
        "train_acc": [], "val_acc": [], "loss": [], "epoch_time": [],
        "gnorm": [], "optimizer": "incg",
    }
    if record_spectrum:
        logger["hessian_spectrum"] = []
    n_train = tr.shape[0]
    steps_per_epoch = max(1, n_train // batch_size)
    rng = np.random.RandomState(seed)
    best_flat = None
    k_probe = min(hessian_low_rank + 5, flat.shape[0])
    for epoch in range(epochs):
        t0 = time.time()
        order = torch.as_tensor(rng.permutation(n_train), device=flat.device)
        hb_idx = tr[order[: nc.hess_batch]]
        Omega = draw("probe", (seed + 2, epoch), (flat.shape[0], k_probe),
                     flat.dtype, flat.device)
        U, dprec = nc.refresh(flat, m_data[hb_idx], q_data[hb_idx], Omega)
        if record_spectrum:
            logger["hessian_spectrum"].append(dprec.tolist())
        last_loss, gnorm = None, None
        for s_idx in range(steps_per_epoch):
            idx = tr[order[s_idx * batch_size: (s_idx + 1) * batch_size]]
            jb = J_data[idx] if J_data is not None else None
            flat, last_loss, gnorm = nc.step(flat, m_data[idx], q_data[idx],
                                             jb, U, dprec)
        tr_acc, va_acc = evaluate(nc.unravel(flat))
        logger["train_acc"].append(tr_acc)
        logger["val_acc"].append(va_acc)
        logger["loss"].append(last_loss.item())
        logger["gnorm"].append(gnorm.item())
        logger["epoch_time"].append(time.time() - t0)
        if n_val and (best_flat is None or va_acc > logger["max_val_acc"]):
            logger["max_val_acc"] = va_acc
            best_flat = flat
        if verbose and (epoch % 10 == 0 or epoch == epochs - 1):
            print(
                f"incg sweep {epoch:4d} loss {last_loss.item():.4e} "
                f"||g|| {gnorm.item():.3e} train_acc {tr_acc:.4f} "
                f"val_acc {va_acc:.4f}"
            )
    best = best_flat if best_flat is not None else flat
    return {n: t.clone() for n, t in nc.unravel(best).items()}, logger


def gauss_newton_cg_step(apply_fn, params, m, q, cg_iters: int = 20,
                         damping: float = 1e-4):
    """One inexact Gauss-Newton/CG step on the l2 loss: solve (J^T J +
    damping I) dp = -grad with matrix-free Gauss-Newton products (jvp/vjp
    through the network), then halve the step until the loss falls (at
    most 10 times).  ``params`` is a dict of tensors; returns a new one."""
    ravel, unravel = _flat_layout(params)
    flat = ravel(params)

    def resid(w):
        return (apply_fn(unravel(w), m) - q).reshape(-1)

    r0, vjp_fn = vjp(resid, flat)

    def gn_mv(v):
        return vjp_fn(jvp(resid, (flat,), (v,))[1])[0] + damping * v

    g = vjp_fn(r0)[0]
    dp = cg(gn_mv, -g, maxiter=cg_iters)

    # backtracking on the true loss
    def loss_of(w):
        return 0.5 * torch.sum(resid(w) ** 2)

    base = loss_of(flat)
    alpha = 1.0
    for _ in range(10):
        if loss_of(flat + alpha * dp).item() < base.item():
            break
        alpha *= 0.5
    return unravel(flat + alpha * dp)
