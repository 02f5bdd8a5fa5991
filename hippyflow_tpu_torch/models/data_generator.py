"""Training data: (m_i, q_i[, z_i]) and their derivative information (port
of ``hippyflow_tpu/models/data_generator.py``), in the JAX package's
artifact schemas (``mq_data.npz`` or, with controls, ``mzq_data.npz``;
``Jsvd_data.npz``, ``JstarPhi_data.npz``, ``JPsi_data.npz``, and for the
control Jacobian ``Jzsvd_data.npz`` and ``JzstarPhi_data.npz``).

Samples are solved in chunks; each chunk's dense Jacobians come from one
batched linearization and one adjoint solve of dQ right-hand sides (K1 and
K2 on the card), and the derivative payloads are batched products or the
exact batched SVD.  Finished chunks persist under ``<data_dir>/chunks/``,
each drawn from a generator of its own (``chunk_keychain``), so a killed
run resumes at the first missing chunk and writes the same bits as an
uninterrupted one.

``two_step_generate`` (the reference's "Texas two-step", for a full-state
observable): forward samples of the state, the POD of that data, then the
Jacobians' sketches J^T MPhi in the POD subspace.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import time

import numpy as np
import torch

from ..utils import KeyChain
from ..utils.profiling import PhaseTimer, stage
from .observable import StateSpaceIdentityOperator
from .pod import PODProjectorFromData
from .sampling import auto_chunk_size, materialize_jacobians, sample_until_solved


def data_generator_settings(settings: dict | None = None) -> dict:
    """The JAX package's settings with their defaults (reference
    `dataGenerator.py:25-35`)."""
    settings = dict(settings or {})
    settings.setdefault("rM", None)
    settings.setdefault("rZ", None)
    settings.setdefault("oversample", 10)
    settings.setdefault("reset_initial_guess", False)
    # grid sequencing: a noise -> u0 map, a pure function of each lane's
    # noise, so chunk resume stays bit-exact
    settings.setdefault("coarse_warm_start", None)
    settings.setdefault("save_failed_solves", True)
    settings.setdefault("verbose", True)
    settings.setdefault("chunk_size", None)
    settings.setdefault("seed", 0)
    return settings


def _scan_chunks(chunk_dir):
    """Sorted (start, end, path) of the chunk_<start>_<end>.npz files."""
    out = []
    for f in glob.glob(os.path.join(chunk_dir, "chunk_*_*.npz")):
        m = re.match(r".*chunk_(\d+)_(\d+)\.npz", f)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), f))
    return sorted(out)


def contiguous_prefix_end(done) -> int:
    """Largest e with chunks [0, e) contiguously covered by the sorted
    (start, end, path) records: a resume restarts at the first gap, so a
    deleted early chunk is made again."""
    end = 0
    for a, b, _ in done:
        if a <= end < b:
            end = b
        elif a > end:
            break
    return end


def prune_stale_chunks(chunk_dir) -> int:
    """Delete the chunk files beyond the contiguous [0, e) prefix and return
    e.  The resume makes everything from the first gap on the current chunk
    grid (``auto_chunk_size`` depends on the card's memory), so chunks past
    the gap may overlap it and would duplicate samples when concatenated."""
    chunks = _scan_chunks(chunk_dir)
    end = contiguous_prefix_end(chunks)
    for _, b, f in chunks:
        if b > end:
            os.remove(f)
    return end


def load_chunks_validated(chunk_dir, n: int | None = None) -> dict:
    """Load and concatenate the chunk files, which must tile [0, end)
    exactly (each starts where the previous one ends) and, with ``n``,
    reach n; raise on an overlap, a gap or too few samples."""
    chunks = _scan_chunks(chunk_dir)
    if not chunks:
        raise FileNotFoundError(f"no chunk files in {chunk_dir}")
    end = 0
    for a, b, f in chunks:
        if a != end or b <= a:
            kind = "overlap" if a < end else "gap"
            raise ValueError(
                f"chunk files do not tile contiguously ({kind} at sample {end}: "
                f"{os.path.basename(f)} covers [{a}, {b})); a resume under a "
                f"different chunk size left stale chunks: delete {chunk_dir} "
                "and generate again")
        end = b
    if n is not None and end < n:
        raise ValueError(
            f"chunk files cover only [0, {end}) of the requested {n} samples")
    arrays: dict[str, list] = {}
    for _, _, f in chunks:
        with np.load(f) as z:
            for k in z.files:
                arrays.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v) for k, v in arrays.items()}


def chunk_keychain(seed: int, tag: int, chunk_start: int, device=None) -> KeyChain:
    """The generator of the chunk that starts at sample ``chunk_start``:
    seeded from (seed, tag, chunk_start) alone, so the chunk draws the same
    noise whatever ran before it (process restarts, resampling in other
    chunks, the resume position).  The JAX package folds the same triple
    into a jax.random key."""
    state = np.random.SeedSequence((seed, tag, chunk_start)).generate_state(
        1, np.uint64)[0]
    return KeyChain(int(state), device)


def _svd_payload(J, rank):
    """The exact SVD of each J (N, dq, dm), truncated at ``rank``:
    (U (N, dq, r), sigma (N, r), V (N, dm, r)) on J's device."""
    U, sig, Vt = torch.linalg.svd(J, full_matrices=False)
    return U[:, :, :rank], sig[:, :rank], Vt.mT[:, :, :rank]


class DataGenerator:
    """Generates (m, q[, z]) data and the Jacobians' information.

    After ``generate``, ``stage_seconds`` holds the wall seconds of its
    stages (``forward``, ``jacobian``, ``jacobian_z``, ``write``, each a
    ``PhaseTimer`` phase with an ``annotate`` range of its name, ended by
    a device synchronize) and ``samples`` the Newton iterations
    of the kept samples and the resampled (unconverged) lanes."""

    def __init__(self, observable, prior, control_distribution=None,
                 settings: dict | None = None):
        self.observable = observable
        self.prior = prior
        self.control_distribution = control_distribution
        self.settings = data_generator_settings(settings)
        self.stage_seconds = None
        self.samples = None

    def generate(self, n_samples: int, derivatives=(0, 0), output_decoder=None,
                 output_encoder=None, input_decoder=None, input_encoder=None,
                 data_dir: str = "data/test/", compress: bool = True,
                 clean_up: bool = True, noise=None, controls=None):
        """Generate n_samples of (m, q[, z]) and the Jacobians' data
        (reference `dataGenerator.py:164-195`).  ``derivatives[0]``: of
        dq/dm, J^T MPhi when an output decoder is given (``JstarPhi_data``),
        J Psi for an input decoder (``JPsi_data``), else the SVD truncated at
        ``settings['rM']`` (``U_data``, ``sigma_data``, ``V_data``).
        ``derivatives[1]``: of dq/dz (a control distribution is needed),
        Jz^T MPhi (``JzstarPhi_data``) or the SVD at ``settings['rZ']``
        (``Uz_data``, ...).  ``noise`` (n_samples, noise_dim) and
        ``controls`` (n_samples, dZ) give the chunks' first draws."""
        has_z = self.control_distribution is not None
        if derivatives[1] and not has_z:
            raise ValueError("the control Jacobian needs a control distribution")
        os.makedirs(data_dir, exist_ok=True)
        chunk_dir = os.path.join(data_dir, "chunks")
        os.makedirs(chunk_dir, exist_ok=True)
        dtype, device = self.prior.mean.dtype, self.prior.mean.device
        chunk_size = self.settings["chunk_size"] or auto_chunk_size(
            self.observable.problem.state_dim, dtype,
            problem=self.observable.problem, device=device)
        if output_decoder is not None and output_encoder is None:
            output_encoder = output_decoder
        if input_decoder is not None and input_encoder is None:
            input_encoder = input_decoder
        as_tensor = lambda X: (None if X is None else torch.as_tensor(
            X, dtype=dtype, device=device))
        MPhi = as_tensor(output_encoder) if output_decoder is not None else None
        Psi = as_tensor(input_decoder)

        start = prune_stale_chunks(chunk_dir)
        timer = PhaseTimer()

        def stage_of(key):
            """Stage ``key``: a profiler range, timed up to the end of the
            device's work."""
            return stage(timer, key, block_on=self.prior.mean)

        its, n_failures = [], 0
        t0 = time.time()
        i = start
        while i < n_samples:
            b = min(chunk_size, n_samples - i)
            with stage_of("forward"):
                batch = sample_until_solved(
                    self.observable, self.prior,
                    chunk_keychain(self.settings["seed"], 0, i, device), b,
                    chunk_size=b, verbose=self.settings["verbose"],
                    reset_initial_guess=self.settings["reset_initial_guess"],
                    noise=None if noise is None else noise[i:i + b],
                    coarse_warm_start=self.settings["coarse_warm_start"],
                    control_distribution=self.control_distribution,
                    controls=None if controls is None else controls[i:i + b],
                )
            its.append(batch.iterations)
            n_failures += batch.n_failures
            payload = {"m_data": batch.ms, "q_data": batch.qs}
            if has_z:
                payload["z_data"] = batch.zs
            for control, key in ((False, "jacobian"), (True, "jacobian_z")):
                if not derivatives[int(control)]:
                    continue
                with stage_of(key):
                    J = materialize_jacobians(self.observable, batch.ms,
                                              batch.us, batch.zs, chunk_size=b,
                                              control=control)
                    payload.update(self._derivative_payload(
                        J, MPhi, Psi, self.settings["rZ" if control else "rM"],
                        prefix="z" if control else ""))
            with stage_of("write"):
                np.savez(os.path.join(chunk_dir, f"chunk_{i}_{i + b}.npz"),
                         **{k: v.cpu().numpy() for k, v in payload.items()})
                if (self.settings["save_failed_solves"]
                        and batch.failed_ms is not None):
                    skipped_dir = os.path.join(data_dir, "skipped")
                    os.makedirs(skipped_dir, exist_ok=True)
                    np.save(os.path.join(skipped_dir,
                                         f"m_failed_{i}_{i + b}.npy"),
                            batch.failed_ms)
            if self.settings["verbose"]:
                rate = (i + b - start) / (time.time() - t0)
                print(f"samples [{i}, {i + b}) done ({rate:.2f} samples/s)")
            i += b
        if compress:
            with stage_of("write"):
                self.compress_dataset(
                    data_dir, derivatives=derivatives, clean_up=clean_up,
                    has_z_data=has_z, input_decoder=input_decoder,
                    input_encoder=input_encoder, output_decoder=output_decoder,
                    output_encoder=output_encoder)
        self.stage_seconds = {
            **dict.fromkeys(("forward", "jacobian", "jacobian_z", "write"), 0.0),
            **timer.timings}
        self.samples = {"iterations": torch.cat(its) if its else None,
                        "n_failures": n_failures}

    def two_step_generate(self, n_samples: int, n_samples_pod: int | None = None,
                          derivatives=(0, 0), pod_rank: int | None = None,
                          data_dir: str = "data/test/", compress: bool = True,
                          clean_up: bool = True, pod_method: str = "hep",
                          pod_shifted: bool = True, noise=None, controls=None):
        """The "Texas two-step" (reference `dataGenerator.py:251-297`) of a
        full-state observable: (1) ``generate`` n_samples forward samples of
        the state (``noise`` and ``controls`` give its draws), (2) the POD
        of the first ``n_samples_pod`` states (``PODProjectorFromData``,
        ``pod_method``, shifted by their mean with ``pod_shifted``), checked
        to ||Psi^* Psi - I|| < 1e-5 and saved under ``POD/``, (3)
        ``compute_jacobians_in_subspace`` with that basis, which
        materializes each full-state J (B.dense() = I, dQ = n right-hand
        sides a sample) as the JAX package does."""
        if not isinstance(self.observable.B, StateSpaceIdentityOperator):
            raise TypeError("two_step_generate needs a full-state observable "
                            "(StateSpaceIdentityOperator)")
        n_samples_pod = n_samples_pod or n_samples
        if pod_rank is None or pod_rank > n_samples_pod:
            raise ValueError(f"pod_rank {pod_rank} must be set and at most "
                             f"{n_samples_pod}")
        self.generate(n_samples, derivatives=(0, 0), data_dir=data_dir,
                      compress=True, clean_up=False, noise=noise,
                      controls=controls)
        fname = ("mzq_data.npz" if self.control_distribution is not None
                 else "mq_data.npz")
        with np.load(os.path.join(data_dir, fname)) as data:
            u_data = data["q_data"][:n_samples_pod]
        mean = self.prior.mean
        pod = PODProjectorFromData(self.observable.problem.Vu, dtype=mean.dtype,
                                   device=mean.device)
        d_POD, phi, Mphi, u_shift = pod.construct_subspace(
            u_data, pod_rank, shifted=pod_shifted, method=pod_method,
            verify=True)
        r = pod_rank - 1 if pod_shifted else pod_rank
        PsistarPsi = Mphi[:, :r].T @ phi[:, :r]
        orth_error = torch.linalg.norm(
            PsistarPsi - torch.eye(r, dtype=phi.dtype, device=phi.device)).item()
        if self.settings["verbose"]:
            print("||Psi^*Psi - I|| =", orth_error)
        if not orth_error < 1e-5:
            raise AssertionError(f"||Psi^*Psi - I|| = {orth_error:.3e} >= 1e-5")
        pod_dir = os.path.join(data_dir, "POD")
        os.makedirs(pod_dir, exist_ok=True)
        for name, X in (("POD_decoder", phi), ("POD_encoder", Mphi),
                        ("d_POD", d_POD), ("POD_shift", u_shift)):
            np.save(os.path.join(pod_dir, name + ".npy"), X.cpu().numpy())
        self.compute_jacobians_in_subspace(
            derivatives=derivatives, output_decoder=phi.cpu().numpy(),
            output_encoder=Mphi.cpu().numpy(), data_file_name=fname,
            data_dir=data_dir, compress=compress, clean_up=clean_up)

    def compute_jacobians_in_subspace(self, derivatives, output_decoder,
                                      data_file_name: str, data_dir: str,
                                      output_encoder=None, compress: bool = True,
                                      clean_up: bool = True):
        """The sketches J^T MPhi (``derivatives[0]``) and Jz^T MPhi
        (``derivatives[1]``) at stored (m, q[, z]) points of a full-state
        observable, q = u (reference `dataGenerator.py:300-355`), into
        ``JstarPhi_data.npz`` and ``JzstarPhi_data.npz``."""
        if output_encoder is None:
            output_encoder = output_decoder
        dtype, device = self.prior.mean.dtype, self.prior.mean.device
        MPhi = torch.as_tensor(output_encoder, dtype=dtype, device=device)
        with np.load(os.path.join(data_dir, data_file_name)) as data:
            m_data = torch.as_tensor(data["m_data"], dtype=dtype, device=device)
            u_data = torch.as_tensor(data["q_data"], dtype=dtype, device=device)
            z_data = (torch.as_tensor(data["z_data"], dtype=dtype, device=device)
                      if "z_data" in data.files else None)
        if u_data.shape[1] != self.observable.problem.state_dim:
            raise ValueError(
                f"q_data of width {u_data.shape[1]} is not the state "
                f"({self.observable.problem.state_dim}): the sketches need "
                "full-state data, q = u")
        # a from-scratch loop: clear chunks an interrupted run may have left
        chunk_dir = os.path.join(data_dir, "chunks_J")
        shutil.rmtree(chunk_dir, ignore_errors=True)
        os.makedirs(chunk_dir)
        chunk_size = self.settings["chunk_size"] or auto_chunk_size(
            self.observable.problem.state_dim, dtype,
            problem=self.observable.problem, device=device)
        N = m_data.shape[0]
        for s in range(0, N, chunk_size):
            e = min(s + chunk_size, N)
            zc = None if z_data is None else z_data[s:e]
            payload = {}
            for control, key in ((False, "JstarPhi_data"),
                                 (True, "JzstarPhi_data")):
                if derivatives[int(control)]:
                    J = materialize_jacobians(self.observable, m_data[s:e],
                                              u_data[s:e], zc, chunk_size=e - s,
                                              control=control)
                    payload[key] = (J.mT @ MPhi).cpu().numpy()
            np.savez(os.path.join(chunk_dir, f"chunk_{s}_{e}.npz"), **payload)
        if compress:
            self._compress_jacobian_chunks(data_dir, chunk_dir, derivatives,
                                           output_decoder, output_encoder,
                                           clean_up)

    @staticmethod
    def _derivative_payload(J, MPhi, Psi, r, prefix: str = ""):
        """The Jacobian's part of a chunk's payload, tensors on J's device;
        ``prefix`` 'z' names the control Jacobian's (no J Psi for it)."""
        if MPhi is not None:
            return {f"J{prefix}starPhi_data": J.mT @ MPhi}  # (N, dM, r_out)
        if Psi is not None and not prefix:
            return {"JPsi_data": J @ Psi}  # (N, dQ, r_in)
        full = min(J.shape[1], J.shape[2])
        U, sig, V = _svd_payload(J, min(r or full, full))
        return {f"U{prefix}_data": U, f"sigma{prefix}_data": sig,
                f"V{prefix}_data": V}

    def compress_dataset(self, data_dir, derivatives=(0, 0), clean_up: bool = True,
                         has_z_data: bool = False, input_decoder=None,
                         input_encoder=None, output_decoder=None,
                         output_encoder=None):
        """Concatenate the chunk files into the consolidated bundles
        (reference `dataGenerator.py:495-667`): ``mq_data.npz`` or, with
        controls, ``mzq_data.npz``.  The data bundle is compressed; the
        Jacobian bundles are not, as in ``_save_bundle``."""
        chunk_dir = os.path.join(data_dir, "chunks")
        cat = load_chunks_validated(chunk_dir)
        name = "mzq_data.npz" if has_z_data else "mq_data.npz"
        np.savez_compressed(os.path.join(data_dir, name), **{
            k: cat[k] for k in ("m_data", "q_data", "z_data") if k in cat})
        for prefix, wanted in (("", derivatives[0]), ("z", derivatives[1])):
            if not wanted:
                continue
            if f"J{prefix}starPhi_data" in cat:
                _save_bundle(
                    os.path.join(data_dir, f"J{prefix}starPhi_data.npz"),
                    **{f"J{prefix}starPhi_data": cat[f"J{prefix}starPhi_data"]},
                    Phi=_numpy(output_decoder), MPhi=_numpy(output_encoder))
            if not prefix and "JPsi_data" in cat:
                _save_bundle(
                    os.path.join(data_dir, "JPsi_data.npz"),
                    JPsi_data=cat["JPsi_data"], Psi=_numpy(input_decoder),
                    input_encoder=_numpy(input_encoder))
            if f"U{prefix}_data" in cat:
                _save_bundle(
                    os.path.join(data_dir, f"J{prefix}svd_data.npz"),
                    **{f"{k}{prefix}_data": cat[f"{k}{prefix}_data"]
                       for k in ("U", "sigma", "V")})
        if clean_up:
            shutil.rmtree(chunk_dir, ignore_errors=True)

    def _compress_jacobian_chunks(self, data_dir, chunk_dir, derivatives,
                                  output_decoder, output_encoder, clean_up):
        cat = load_chunks_validated(chunk_dir)
        for prefix, wanted in (("", derivatives[0]), ("z", derivatives[1])):
            if wanted:
                _save_bundle(
                    os.path.join(data_dir, f"J{prefix}starPhi_data.npz"),
                    **{f"J{prefix}starPhi_data": cat[f"J{prefix}starPhi_data"]},
                    Phi=_numpy(output_decoder), MPhi=_numpy(output_encoder))
        if clean_up:
            shutil.rmtree(chunk_dir, ignore_errors=True)


def _save_bundle(path, **arrays):
    """An npz bundle of Jacobian data, uncompressed: float Jacobian data
    barely compresses, and zlib would be the slowest step of writing the
    (N, dM, r) arrays of a full-size run (the JAX package compresses;
    ``np.load`` reads either)."""
    np.savez(path, **arrays)


def _numpy(X):
    """A tensor or array as a numpy array."""
    return X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
