"""DIPNet surrogate training for the confusion problem (port of
``applications/confusion_training.py``): load the generated (m, q) data
and the AS/KLE/POD projectors, re-orthonormalize and rescale them, build
the projected network, train with l2 (and optionally the H1
Jacobian-sketch) loss, and report train/val accuracy.

    python -m hippyflow_tpu_torch.applications.confusion_training \\
        --data_dir confusion_output/ [--device cpu]

``training_lane`` is the training lane of the JAX package's ``bench.py``
on arrays in memory: the output POD from data, the projectors, and
inexact Newton-CG at the reference experiment's scale.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from .. import config
from ..models.pod import PODProjectorFromData
from ..nn import (
    GenericDense,
    GenericLinear,
    LowRankLinear,
    projected_dense,
    projected_low_rank_residual_network,
    train,
)


def load_confusion_data(data_dir: str):
    """Load the consolidated (m, q) data bundle (``mq_data.npz``)."""
    data = np.load(os.path.join(data_dir, "mq_data.npz"))
    return data["m_data"], data["q_data"]


def get_projectors(data_dir: str, as_input_tolerance=1e-4, pod_tolerance=1e-4,
                   fixed_input_rank=0, fixed_output_rank=0):
    """Load AS/KLE input and POD output bases with tolerance- or fixed-rank
    truncation (reference `confusion_utilities.py:115-172`)."""
    projectors = {}
    as_files = [f for f in os.listdir(data_dir) if f.endswith("_input_decoder.npy")]
    if as_files:
        AS_input = np.load(os.path.join(data_dir, sorted(as_files)[-1]))
        d_files = [f for f in os.listdir(data_dir) if f.endswith("_d_GN.npy")]
        if fixed_input_rank > 0:
            rank = fixed_input_rank
        else:
            d_GN = np.load(os.path.join(data_dir, sorted(d_files)[-1]))
            rank = max(1, int(np.sum(d_GN / max(d_GN[0], 1e-30) > as_input_tolerance)))
        projectors["AS_input"] = AS_input[:, :rank]
    if os.path.exists(os.path.join(data_dir, "KLE_decoder.npy")):
        KLE = np.load(os.path.join(data_dir, "KLE_decoder.npy"))
        rank = fixed_input_rank or KLE.shape[1]
        projectors["KLE"] = KLE[:, :rank]
    if os.path.exists(os.path.join(data_dir, "POD_projector.npy")):
        POD = np.load(os.path.join(data_dir, "POD_projector.npy"))
        d_files = os.path.join(data_dir, "POD_d.npy")
        if fixed_output_rank > 0:
            rank = fixed_output_rank
        else:
            d_POD = np.load(d_files)
            rank = max(1, int(np.sum(d_POD / max(d_POD[0], 1e-30) > pod_tolerance)))
        projectors["POD"] = POD[:, :rank]
    return projectors


def modify_projectors(projectors: dict, input_basis="AS_input"):
    """QR re-orthonormalization + rescaling (reference
    `confusion_utilities.py:174-227`), in numpy on the host. Returns
    (input_proj, output_proj).

    Input scale: Q / (dM/(32 r) * ||Q||_F); output: Phi_orth / ||Phi_orth||_F.
    """
    P = projectors[input_basis]
    Q, _ = np.linalg.qr(P)
    scale_in = float(Q.shape[0]) / (32.0 * float(Q.shape[1]))
    Q = Q / (scale_in * np.linalg.norm(Q))
    Phi, _ = np.linalg.qr(projectors["POD"])
    Phi = Phi / np.linalg.norm(Phi)
    return Q, Phi


def build_model(architecture, projectors, q_data, dM, dQ, input_rank, *,
                dtype, device, generator=None, residual_activation="softplus"):
    """The network of ``main()``'s ``--architecture`` (as_dense, kle_dense,
    as_resnet, generic_dense, linear, low_rank_linear); returns (model,
    input projector or None).  ``residual_activation``: the DIPResNet's
    (the helmholtz drivers take 'sigmoid')."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    if architecture in ("as_dense", "kle_dense", "as_resnet"):
        basis = "AS_input" if architecture.startswith("as") else "KLE"
        P, Phi = modify_projectors(projectors, basis)
        # center the regression on the training-data mean (hessianlearn's
        # RegressionProblem(y_mean=q_mean), confusion_training.py:177)
        q_mean = q_data.mean(axis=0)
        if architecture == "as_resnet":
            model = projected_low_rank_residual_network(
                P, Phi, ranks=[8, 8], residual_activation=residual_activation,
                output_shift=q_mean, **kw)
        else:
            model = projected_dense(P, Phi, output_shift=q_mean, **kw)
        return model, P
    if architecture == "generic_dense":
        return GenericDense(dM, dQ, **kw), None
    if architecture == "linear":
        return GenericLinear(dM, dQ, **kw), None
    if architecture == "low_rank_linear":
        return LowRankLinear(dM, dQ, rank=input_rank, **kw), None
    raise ValueError(f"unknown architecture {architecture!r}")


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def training_lane(m_data, q_data, input_decoder, *, sweeps=20, n=1024,
                  in_rank=8, out_rank=16, device=None):
    """DIPNet training at the reference experiment's scale (reference
    `dipnet_paper/confusion_training.py:46-56,191-217`; the JAX package's
    ``bench.py::run_training_lane``): the output POD from data (``hep``,
    M = I, shifted) at rank ``out_rank``, ``modify_projectors`` on the
    first ``in_rank`` decoder columns, ``projected_dense`` with the output
    bias at the data mean, then inexact Newton-CG with batch 128, Hessian
    batch 16, Hessian rank 20, a half/half split of the first ``n``
    samples and seed 0: one warm sweep, then ``sweeps`` sweeps.

    The arrays keep their dtype (tensors or numpy) and go to ``device``.
    Returns a dict: ``s_per_sweep``, ``first_run_s`` (the warm sweep),
    ``pod_s``, ``val_acc`` (the last sweep's), ``logger`` and ``params``
    (the trained ones)."""
    _, device = config.resolve(None, device)
    m_data = torch.as_tensor(m_data, device=device)[:n]
    q_data = torch.as_tensor(q_data, device=device)[:n]
    dtype = m_data.dtype
    q_data = q_data.to(dtype)
    dec = torch.as_tensor(input_decoder)[:, :in_rank]

    t0 = time.perf_counter()
    eye = torch.eye(q_data.shape[1], dtype=dtype, device=device)
    _, phi, _, q_shift = PODProjectorFromData(None, M_output=eye).construct_subspace(
        q_data, u_rank=out_rank, shifted=True, method="hep")
    _synchronize(device)
    pod_s = time.perf_counter() - t0

    # the reference training flow: QR re-orthonormalization and rescaling of
    # both projectors before they seed the network
    proj_in, proj_out = modify_projectors({
        "AS_input": dec.detach().cpu().numpy(),
        "POD": phi[:, :out_rank].cpu().numpy(),
    })
    model = projected_dense(proj_in, proj_out, output_shift=q_shift,
                            generator=torch.Generator().manual_seed(1),
                            dtype=dtype, device=device)
    fit_kwargs = dict(
        batch_size=128, optimizer="incg", hess_batch_size=16,
        hessian_low_rank=20, validation_split=0.5, seed=0,
    )
    t0 = time.perf_counter()
    train(model, m_data, q_data, epochs=1, **fit_kwargs)
    _synchronize(device)
    first_run = time.perf_counter() - t0

    t0 = time.perf_counter()
    params, logger = train(model, m_data, q_data, epochs=sweeps, **fit_kwargs)
    _synchronize(device)
    elapsed = time.perf_counter() - t0
    return {
        "s_per_sweep": elapsed / sweeps,
        "first_run_s": first_run,
        "pod_s": pod_s,
        "val_acc": logger["val_acc"][-1],
        "logger": logger,
        "params": params,
    }


def training_parser(data_dir: str, architecture: str):
    """The training drivers' flags, with their data directory and
    architecture defaults."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default=data_dir)
    parser.add_argument("--architecture", type=str, default=architecture,
                        choices=["as_dense", "kle_dense", "as_resnet",
                                 "generic_dense", "linear", "low_rank_linear"])
    parser.add_argument("--fixed_input_rank", type=int, default=8)
    parser.add_argument("--fixed_output_rank", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--n_data", type=int, default=0, help="0 = all")
    parser.add_argument("--h1_weight", type=float, default=0.0)
    parser.add_argument("--optimizer", type=str, default="adamw",
                        choices=["adamw", "incg"],
                        help="incg = inexact Newton-CG with line search and "
                             "rank-20 Hessian preconditioning")
    parser.add_argument("--hessian_low_rank", type=int, default=20)
    parser.add_argument("--hess_batch_size", type=int, default=16)
    parser.add_argument("--record_spectrum", type=int, default=0,
                        help="log top-k GN Hessian eigenvalues per sweep "
                             "(incg only)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--logger_out", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the first CUDA card)")
    return parser


def train_driver(args, m_data, q_data, residual_activation="softplus",
                 h1_needs_projector=False):
    """The training drivers' body on loaded data: the projectors, the
    network of ``--architecture``, the optional H1 loss on
    ``JstarPhi_data.npz`` (with ``h1_needs_projector`` only for the
    projected networks, as the helmholtz driver has it), training and the
    report.  Returns the logger."""
    if args.n_data:
        m_data, q_data = m_data[: args.n_data], q_data[: args.n_data]
    print(f"data: m {m_data.shape}, q {q_data.shape}")

    projectors = get_projectors(
        args.data_dir,
        fixed_input_rank=args.fixed_input_rank,
        fixed_output_rank=args.fixed_output_rank,
    )
    dtype, device = config.resolve(torch.float32, args.device)
    model, P = build_model(
        args.architecture, projectors, q_data, m_data.shape[1],
        q_data.shape[1], args.fixed_input_rank, dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(args.seed + 1),
        residual_activation=residual_activation)

    h1_kwargs = {}
    jsp_path = os.path.join(args.data_dir, "JstarPhi_data.npz")
    if (args.h1_weight > 0 and os.path.exists(jsp_path)
            and (P is not None or not h1_needs_projector)):
        jsp = np.load(jsp_path)
        n = m_data.shape[0]
        h1_kwargs = dict(
            JstarPhi_data=jsp["JstarPhi_data"][:n],
            input_decoder=P,
            output_encoder=jsp["MPhi"],
            h1_weight=args.h1_weight,
        )
        print("training with derivative-informed H1 loss")

    _, logger = train(
        model,
        m_data,
        q_data,
        epochs=args.epochs,
        batch_size=min(args.batch_size, m_data.shape[0]),
        learning_rate=args.learning_rate,
        seed=args.seed,
        verbose=True,
        optimizer=args.optimizer,
        hessian_low_rank=args.hessian_low_rank,
        hess_batch_size=args.hess_batch_size,
        record_spectrum=bool(args.record_spectrum) and args.optimizer == "incg",
        **h1_kwargs,
    )
    print(
        f"final: train_acc {logger['train_acc'][-1]:.4f} "
        f"val_acc {logger['val_acc'][-1]:.4f}"
    )
    if args.logger_out:
        with open(args.logger_out, "wb") as f:
            pickle.dump(logger, f)
    return logger


def main(argv=None):
    args = training_parser("confusion_output/", "as_dense").parse_args(argv)
    return train_driver(args, *load_confusion_data(args.data_dir))


if __name__ == "__main__":
    main()
