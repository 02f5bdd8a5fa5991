"""The confusion setup driver (port of ``applications/confusion_setup.py``,
the reference's ``confusion_problem_setup.py:39-215``): build the
observable and the prior, construct the input and output active
subspaces, the mass-orthogonal KLE and the POD, run the projection error
tests, generate the training data and the low-rank Jacobian data, and
save it all in the reference's layout:

    AS_<n>_input_decoder.npy  AS_<n>_d_GN.npy
    AS_<n>_output_decoder.npy AS_<n>_d_NG.npy
    KLE_decoder.npy  KLE_d.npy  POD_projector.npy  POD_d.npy
    error_data.pkl (with --error_test)  metadata.pkl  mq_data.npz
    jacobian_data/Jsvd_data.npz  jacobian_data/mq_{m,q}_data.npy

    python -m hippyflow_tpu_torch.applications.confusion_setup \\
        [--nx 64] [--output confusion_output/] [--error_test] [--device cpu]

The velocity is the steady Navier-Stokes field: the JAX package's cached
field at nx=64 and 192 (``load_ns_velocity``), else solved here
(``navier_stokes.steady_navier_stokes``); with ``--velocity analytic`` it
is the analytic vortex.  ``confusion_training`` reads the directory this
writes.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import torch

from .. import config
from ..models import (
    ActiveSubspaceParameterList,
    ActiveSubspaceProjector,
    KLEParameterList,
    KLEProjector,
    PODParameterList,
    PODProjector,
)
from ..utils import GivenNoise
from .confusion import (
    _BENCH_DIR,
    confusion_linear_observable,
    confusion_prior,
    load_ns_velocity,
)

STAGES = ("as_input", "as_output", "kle", "pod", "error_test", "data",
          "jacobian_data")


def error_test_ranks(rank: int):
    """The driver's rank ladder: 8, 16, 32, 64, 128 up to ``rank``."""
    return [r for r in (8, 16, 32, 64, 128) if r <= rank] or [rank]


def setup_lane(observable, prior, output, *, rank=128, oversampling=10,
               n_samples=512, n_data=512, jacobian_rank=128, error_test=True,
               error_test_samples=50, seed=0, verbose=False, noise_rng=None,
               input_output_test=True):
    """The setup workflow on (observable, prior), writing into ``output``
    (the helmholtz setup driver's too: it runs the error tests without the
    POD input-output test, ``input_output_test=False``).

    ``noise_rng`` (a numpy Generator), when given, supplies every draw of
    the lane as given noise (``utils.GivenNoise`` and the training data's
    ``noise``), so that two devices see the same numbers; else each class
    draws from its own seeded generator.  Returns a dict: ``seconds`` (wall
    seconds of each stage of ``STAGES``, each ended by a device
    synchronize), the projectors ``as``, ``kle`` and ``pod``, their outputs
    ``d_GN``, ``as_decoder``, ``d_NG``, ``as_output_decoder``, ``d_KLE``,
    ``kle_decoder``, ``d_POD``, ``pod_decoder``, ``errors`` (the
    error_data.pkl dict, or None) and ``jacobian_svd`` (U, sigma, V)."""
    device = prior.mean.device
    os.makedirs(output, exist_ok=True)
    seconds, out = {}, {}
    t = [time.perf_counter()]

    def lap(stage):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[stage] = now - t[0]
        t[0] = now

    def given(obj):
        if noise_rng is not None:
            obj.keychain = GivenNoise(noise_rng, device)
        return obj

    p = ActiveSubspaceParameterList()
    p["rank"], p["oversampling"] = rank, oversampling
    p["samples_per_process"], p["jacobian_rank"] = n_samples, jacobian_rank
    p["error_test_samples"], p["seed"], p["verbose"] = (error_test_samples,
                                                        seed, verbose)
    p["save_and_plot"], p["output_directory"] = True, output
    AS = given(ActiveSubspaceProjector(observable, prior, parameters=p))
    out["d_GN"], out["as_decoder"], _ = AS.construct_input_subspace()
    lap("as_input")
    out["d_NG"], out["as_output_decoder"], _ = AS.construct_output_subspace()
    lap("as_output")

    p = KLEParameterList()
    p["rank"], p["oversampling"] = rank, oversampling
    p["error_test_samples"], p["seed"], p["verbose"] = (error_test_samples,
                                                        seed, verbose)
    p["save_and_plot"], p["output_directory"] = True, output
    KLE = given(KLEProjector(prior, parameters=p))
    out["d_KLE"], out["kle_decoder"], _ = KLE.construct_input_subspace("mass")
    lap("kle")

    p = PODParameterList()
    p["rank"] = min(rank, observable.dQ)
    p["sample_per_process"], p["data_per_process"] = n_samples, n_data
    p["seed"], p["verbose"] = seed, verbose
    p["save_and_plot"], p["output_directory"] = True, output
    POD = given(PODProjector(observable, prior, parameters=p))
    out["d_POD"], out["pod_decoder"], _ = POD.construct_subspace()
    lap("pod")

    out["errors"] = None
    if error_test:
        ranks = error_test_ranks(rank)
        # the reference driver's rank pairs (`confusion_problem_setup.py:
        # 157-189`): the rank ladder with itself, capped by dQ
        rank_pairs = [(r, min(r, observable.dQ)) for r in ranks]
        if input_output_test:  # first: given noise is drawn in this order
            io_avg, io_std = POD.input_output_error_test(
                out["as_decoder"], Cinv_matmat=prior.R_matmat,
                rank_pairs=rank_pairs)
        out["errors"] = {
            "as": AS.test_errors(ranks=ranks, test_input=True, test_output=True),
            "kle": KLE.test_errors(ranks=ranks),
            "pod": POD.test_output_errors(
                ranks=[r for r in ranks if r <= observable.dQ]),
        }
        if input_output_test:
            out["errors"]["input_output"] = {"rank_pairs": rank_pairs,
                                             "avg": io_avg, "std": io_std}
        with open(os.path.join(output, "error_data.pkl"), "wb") as f:
            pickle.dump(out["errors"], f)
        lap("error_test")

    noise = None
    if noise_rng is not None:
        noise = torch.as_tensor(noise_rng.standard_normal((n_data, prior.noise_dim)),
                                dtype=prior.mean.dtype, device=device)
    POD.generate_training_data(output, n_data=n_data, noise=noise)
    lap("data")
    out["jacobian_svd"] = AS.construct_low_rank_Jacobians(
        os.path.join(output, "jacobian_data"))
    lap("jacobian_data")
    out.update({"seconds": seconds, "as": AS, "kle": KLE, "pod": POD})
    return out


def lane_difference(a, b, head: float = 1e-4, gap: float = 1e-6):
    """The largest relative difference between two ``setup_lane`` results
    (e.g. one run on the card and one on the CPU from the same given
    noise), by quantity: each spectrum (d_GN, d_NG, d_KLE, d_POD) over its
    eigenvalues above ``head`` * lambda_0, and the projector V V^T of each
    basis (AS input and output, KLE, POD) at the largest such rank that
    splits no pair closer than ``gap`` * lambda_0, relative to its largest
    entry.  Returns a dict name -> error."""
    out = {}
    for d_key, v_key in (("d_GN", "as_decoder"), ("d_NG", "as_output_decoder"),
                         ("d_KLE", "kle_decoder"), ("d_POD", "pod_decoder")):
        da, db = (x[d_key].double().cpu() for x in (a, b))
        keep = (db.abs() > head * db[0].abs()).nonzero()[:, 0]
        out[d_key] = ((da[keep] - db[keep]).abs() / db[keep].abs()).max().item()
        cuts = [r for r in keep.tolist()
                if r + 1 == len(db) or (db[r] - db[r + 1]).abs() > gap * db[0].abs()]
        r = cuts[-1] + 1
        Pa, Pb = ((x[v_key][:, :r].double().cpu() @ x[v_key][:, :r].double().cpu().T)
                  for x in (a, b))
        out[v_key] = ((Pa - Pb).abs().max() / Pb.abs().max()).item()
    return out


def _velocity(kind: str, nx: int):
    """The ``velocity`` argument of ``confusion_linear_observable`` for
    ``--velocity``: the JAX package's cached Navier-Stokes field where
    ``.bench/`` holds one at nx (64, 192), else 'navier_stokes' (solved on
    the problem's device), or 'analytic'."""
    if kind == "analytic":
        return "analytic"
    if (_BENCH_DIR / f"ns_velocity_nx{nx}.npy").exists():
        return load_ns_velocity(nx)
    return "navier_stokes"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nx", type=int, default=64)
    parser.add_argument("--sqrt_n_obs", type=int, default=10)
    parser.add_argument("--rank", type=int, default=128, help="AS/KLE/POD rank")
    parser.add_argument("--oversampling", type=int, default=10)
    parser.add_argument("--n_samples", type=int, default=512)
    parser.add_argument("--n_data", type=int, default=512)
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--delta", type=float, default=1.0)
    parser.add_argument("--output", type=str, default="confusion_output/")
    parser.add_argument("--error_test", action="store_true")
    parser.add_argument("--jacobian_rank", type=int, default=128)
    parser.add_argument("--velocity", choices=["ns", "analytic"], default="ns",
                        help="ns: steady Navier-Stokes (cached at nx=64, 192, else "
                        "solved)")
    parser.add_argument("--dtype", choices=["float32", "float64"],
                        default="float32")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the first CUDA card)")
    args = parser.parse_args(argv)

    dtype, device = config.resolve(getattr(torch, args.dtype), args.device)
    observable, Vh = confusion_linear_observable(
        nx=args.nx, sqrt_n_obs=args.sqrt_n_obs,
        velocity=_velocity(args.velocity, args.nx), dtype=dtype, device=device)
    prior = confusion_prior(Vh, gamma=args.gamma, delta=args.delta, dtype=dtype,
                            device=device)
    print(f"dofs: {Vh.dim}, observations: {observable.dQ}, device {device}")
    out = setup_lane(
        observable, prior, args.output, rank=args.rank,
        oversampling=args.oversampling, n_samples=args.n_samples,
        n_data=args.n_data, jacobian_rank=args.jacobian_rank,
        error_test=args.error_test, verbose=True)
    metadata = {f"{k}_time": v for k, v in out["seconds"].items()}
    with open(os.path.join(args.output, "metadata.pkl"), "wb") as f:
        pickle.dump(metadata, f)
    print("metadata:", metadata)


if __name__ == "__main__":
    main()
