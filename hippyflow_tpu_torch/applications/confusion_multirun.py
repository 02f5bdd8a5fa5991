"""Data-size sweep for DIPNet accuracy curves (port of
``applications/confusion_multirun.py``, the reference's
``dipnet_paper/confusion_multirun.py:90-161``): for each architecture and
each training-data size n, train over several weight seeds and keep the
accuracy histories in a pickled master logger keyed
``repr((architecture, n, seed))``.  The sweep resumes: a key already in the
pickle is not trained again, sizes above the data are skipped, and the
pickle is rewritten after every run.

    python -m hippyflow_tpu_torch.applications.confusion_multirun \\
        --data_dir confusion_output/ [--device cpu]

``helmholtz_multirun`` is the same sweep with the helmholtz defaults.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from .. import config
from ..nn import GenericDense, projected_dense, projected_low_rank_residual_network, train
from .confusion_training import get_projectors, load_confusion_data, modify_projectors


def sweep(data_dir, architectures, data_sizes, n_seeds, epochs,
          fixed_input_rank=8, fixed_output_rank=16, out=None,
          residual_activation="softplus", device=None):
    """Train every (architecture, n, seed) not yet in the master logger at
    ``out`` (default ``<data_dir>/master_logger.pkl``) on the first n
    samples of ``<data_dir>/mq_data.npz``, in float32 on ``device``.
    Architectures: as_dense and kle_dense (DIPNet on the AS input or KLE
    basis), as_resnet (DIPResNet with ``residual_activation``) and
    generic_dense.  Returns (the master logger, the keys trained in this
    call)."""
    dtype, device = config.resolve(torch.float32, device)
    out = out or os.path.join(data_dir, "master_logger.pkl")
    master = {}
    if os.path.exists(out):
        with open(out, "rb") as f:
            master = pickle.load(f)
    m_all, q_all = load_confusion_data(data_dir)
    projectors = get_projectors(data_dir, fixed_input_rank=fixed_input_rank,
                                fixed_output_rank=fixed_output_rank)
    trained = []
    for arch in architectures:
        for n in data_sizes:
            if n > m_all.shape[0]:
                continue
            for seed in range(n_seeds):
                key = repr((arch, n, seed))
                if key in master:
                    continue
                kw = dict(generator=torch.Generator().manual_seed(seed + 1),
                          dtype=dtype, device=device)
                if arch in ("as_dense", "kle_dense", "as_resnet"):
                    basis = "AS_input" if arch.startswith("as") else "KLE"
                    P, Phi = modify_projectors(projectors, basis)
                    if arch == "as_resnet":
                        model = projected_low_rank_residual_network(
                            P, Phi, residual_activation=residual_activation, **kw)
                    else:
                        model = projected_dense(P, Phi, **kw)
                elif arch == "generic_dense":
                    model = GenericDense(m_all.shape[1], q_all.shape[1], **kw)
                else:
                    raise ValueError(f"unknown architecture {arch!r}")
                _, logger = train(model, m_all[:n], q_all[:n], epochs=epochs,
                                  batch_size=min(128, n), seed=seed)
                master[key] = {"train_acc": logger["train_acc"],
                               "val_acc": logger["val_acc"]}
                trained.append(key)
                print(f"{arch} n={n} seed={seed}: val_acc "
                      f"{logger['val_acc'][-1]:.4f}")
                with open(out, "wb") as f:
                    pickle.dump(master, f)
    print(f"master logger at {out} with {len(master)} runs")
    return master, trained


def sweep_main(argv, data_dir, architectures, residual_activation):
    """The multirun drivers' flags and the sweep."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default=data_dir)
    parser.add_argument("--architectures", type=str, default=architectures)
    parser.add_argument("--data_sizes", type=str, default="32,64,128,256,512")
    parser.add_argument("--n_seeds", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--fixed_input_rank", type=int, default=8)
    parser.add_argument("--fixed_output_rank", type=int, default=16)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the first CUDA card)")
    args = parser.parse_args(argv)
    return sweep(args.data_dir, args.architectures.split(","),
                 [int(s) for s in args.data_sizes.split(",")], args.n_seeds,
                 args.epochs, args.fixed_input_rank, args.fixed_output_rank,
                 args.out, residual_activation, args.device)


def main(argv=None):
    return sweep_main(argv, "confusion_output/", "as_dense,kle_dense,generic_dense",
                      "softplus")


if __name__ == "__main__":
    main()
