"""The helmholtz setup driver (port of ``applications/helmholtz_setup.py``,
the reference's ``helmholtz_problem_setup.py:39-234``): build the PML
Helmholtz observable (600 Hz by default) and its prior (BiLaplacian,
gamma=1, delta=5, or the Laplacian prior), construct the input and output
active subspaces, the mass-orthogonal KLE and the POD, run the projection
error tests, generate the training data and the low-rank Jacobian data,
and save it all in the JAX driver's layout:

    AS_<n>_input_decoder.npy  AS_<n>_d_GN.npy
    AS_<n>_output_decoder.npy AS_<n>_d_NG.npy
    KLE_decoder.npy  KLE_d.npy  POD_projector.npy  POD_d.npy
    the spectra's plots (*.pdf, where matplotlib is installed)
    error_data.pkl (with --error_test: keys as, kle, pod)  metadata.pkl
    mq_data.npz  jacobian_data/Jsvd_data.npz

    python -m hippyflow_tpu_torch.applications.helmholtz_setup \\
        [--nx 64] [--output helmholtz_output/] [--error_test] \\
        [--laplacian_prior] [--device cpu]

The workflow is ``confusion_setup.setup_lane``'s; ``helmholtz_training``
and ``helmholtz_multirun`` read the directory this writes.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from .. import config
from .confusion_setup import setup_lane
from .helmholtz import helmholtz_linear_observable, helmholtz_prior


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nx", type=int, default=64)
    parser.add_argument("--frequency", type=float, default=600.0)
    parser.add_argument("--sqrt_n_obs", type=int, default=10)
    parser.add_argument("--rank", type=int, default=128, help="AS/KLE/POD rank")
    parser.add_argument("--oversampling", type=int, default=10)
    parser.add_argument("--n_samples", type=int, default=32)
    parser.add_argument("--n_data", type=int, default=512)
    parser.add_argument("--gamma", type=float, default=1.0)
    parser.add_argument("--delta", type=float, default=5.0)
    parser.add_argument("--laplacian_prior", action="store_true",
                        help="Laplacian instead of BiLaplacian prior")
    parser.add_argument("--output", type=str, default="helmholtz_output/")
    parser.add_argument("--dtype", choices=["float32", "float64"],
                        default="float64")
    parser.add_argument("--error_test", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the first CUDA card)")
    args = parser.parse_args(argv)

    dtype, device = config.resolve(getattr(torch, args.dtype), args.device)
    observable, Vh = helmholtz_linear_observable(
        nx=args.nx, frequency=args.frequency, sqrt_n_obs=args.sqrt_n_obs,
        dtype=dtype, device=device)
    prior = helmholtz_prior(Vh, gamma=args.gamma, delta=args.delta,
                            use_bilaplacian=not args.laplacian_prior,
                            dtype=dtype, device=device)
    print(f"dofs: {Vh.dim}, observations: {observable.dQ}, device {device}")
    out = setup_lane(
        observable, prior, args.output, rank=args.rank,
        oversampling=args.oversampling, n_samples=args.n_samples,
        n_data=args.n_data, error_test=args.error_test, verbose=True,
        input_output_test=False)
    metadata = {f"{k}_time": v for k, v in out["seconds"].items()}
    with open(os.path.join(args.output, "metadata.pkl"), "wb") as f:
        pickle.dump(metadata, f)
    print("metadata:", metadata)
    return out


if __name__ == "__main__":
    main()
