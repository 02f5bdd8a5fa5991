"""Batched sampling of (m, u, q, J) with resampling of failed lanes.

Port of ``hippyflow_tpu/models/sampling.py`` (``auto_chunk_size``,
``sample_until_solved`` with grid-sequenced warm starts and control
distributions, ``sample_and_materialize_symmetric``,
``materialize_jacobians`` of dq/dm or dq/dz, ``linearize_batch``,
``UniformDistribution``), and ``fresh_solves``, the error tests' cold
re-solves.  PyTorch
runs eagerly, so the JAX package's program cache and ahead-of-time compile
machinery have no counterpart here.

The host waits on the device once a chunk for its converged flags
(``utils.profiling.host_syncs``, site ``sample.converged``) and twice a
resampling sweep (site ``sample.resample``; the sweep is a
``sample.resample`` span).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import config
from ..utils.profiling import annotate, host_syncs
from .jacobian import ObservableControlJacobian, ObservableJacobian
from .observable import LinearStateObservable


def _device_memory_budget_gb(device) -> float:
    """A quarter of the card's memory (factors are one of several live
    buffers: samples, Jacobians, probe blocks); 2 GB on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return 0.25 * total / 1e9
    return 2.0


def auto_chunk_size(state_dim, dtype=None, memory_gb=None, problem=None,
                    device=None) -> int:
    """Largest power-of-two sample batch (at most 4096) whose factorizations
    fit the memory budget (``memory_gb``, else a quarter of ``device``'s
    memory), in the JAX package's order.

    With a ``problem``, ``problem.bytes_per_sample(dtype)`` a sample;
    without one, the dense rule, 3 state_dim^2 itemsize bytes a sample."""
    dtype = dtype or config.DEFAULT_DTYPE
    if problem is not None:
        per_sample = problem.bytes_per_sample(dtype)
    else:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        per_sample = 3.0 * state_dim * state_dim * itemsize
    if memory_gb is None:
        memory_gb = _device_memory_budget_gb(config.resolve(dtype, device)[1])
    count = max(1, min(4096, int(memory_gb * 1e9 / per_sample)))
    return 1 << (count.bit_length() - 1)


class UniformDistribution:
    """Controls uniform on [a, b)^dim (the reference fixture's control
    distribution, ``setupPoissonControlProblem.py:352-383``)."""

    def __init__(self, dim: int, a: float, b: float):
        self.dim = dim
        self.a, self.b = float(a), float(b)

    def sample_n(self, keychain, n: int, dtype=None):
        """n draws (n, dim) from a ``KeyChain`` or ``GivenNoise`` stream."""
        return keychain.uniform((n, self.dim), self.a, self.b, dtype=dtype)

    def mean(self, dtype=None, device=None):
        """The distribution's mean (dim,)."""
        return torch.full((self.dim,), 0.5 * (self.a + self.b), dtype=dtype,
                          device=device)


@dataclass
class SampleBatch:
    """Solved forward samples, leading sample axis; the JAX package's
    fields in its order, then the port's ``iterations`` (keyword-only,
    since the JAX package's next field, ``host_chunks``, is not ported)."""

    ms: torch.Tensor  # (n, dM)
    us: torch.Tensor  # (n, n_state)
    qs: torch.Tensor  # (n, dQ)
    zs: torch.Tensor | None  # (n, dZ) with a control distribution, or None
    n_failures: int
    # parameters whose forward solve did not converge (resampled lanes)
    failed_ms: np.ndarray | None = None
    # Newton iterations of every kept sample, (n,)
    iterations: torch.Tensor | None = field(default=None, kw_only=True)


def sample_until_solved(
    observable: LinearStateObservable,
    prior,
    keychain,
    n_samples: int,
    control_distribution=None,
    chunk_size: int | None = None,
    max_tries: int = 10,
    verbose: bool = False,
    collective=None,
    reset_initial_guess: bool = False,
    *,
    coarse_warm_start=None,
    noise=None,
    controls=None,
) -> SampleBatch:
    """Draw n_samples prior samples with converged forward solves.  The
    JAX package's parameters in its order up to ``reset_initial_guess``;
    the rest are keyword-only, since its next one (``prefetch_host``) is
    not ported.

    ``noise`` (n_samples, noise_dim), when given, replaces the first draws;
    resampling always draws from ``keychain``.  With a
    ``control_distribution`` each chunk draws its controls after its noise
    (``controls`` (n_samples, dZ) replaces the first draws), as the JAX
    package does, and resampled lanes draw new controls too.  As in the JAX
    package, every chunk is solved first; then failed lanes are resampled
    with fresh noise at the chunk's own batch size, keeping the first nbad
    lanes, up to ``max_tries`` sweeps; a hard failure raises.

    Initial guesses of a nonlinear problem: with ``coarse_warm_start`` (a
    map noise -> u0 from ``fem.multigrid.coarse_newton_warm_start``) each
    lane starts from the interpolant of its own coarse-grid solution, a pure
    function of its noise, so the m stream is what a cold start draws;
    this replaces the chunk-to-chunk carry.  Otherwise, unless
    ``reset_initial_guess``, each chunk starts from the previous chunk's
    converged states, lane by lane (a failed or non-finite lane carries
    zero), and resampled lanes cold-start.

    With a ``collective`` (``parallel.DeviceCollective``) the samples are
    split over its ranks: every rank draws each chunk's noise (and
    controls) whole from the same stream, solves its share of the lanes
    (``collective.local_slice``) and gathers the chunk's results, so every
    rank holds the whole batch and agrees on the failed lanes before it
    draws their replacements (whose solves are split the same way).  The
    default chunk is the one-process chunk times the collective's size."""
    problem = observable.problem
    dtype, device = prior.mean.dtype, prior.mean.device
    if chunk_size is None:
        chunk_size = auto_chunk_size(problem.state_dim, dtype, problem=problem,
                                     device=device)
        if collective is not None:
            # each rank's share at the one-process chunk
            chunk_size = min(4096, chunk_size * collective.size())
    if collective is None:
        share, gather = (lambda b: slice(0, b)), (lambda x, b: x)
    else:
        share, gather = collective.local_slice, collective.gather_samples
    nonlinear = not problem.is_fwd_linear
    use_cws = coarse_warm_start is not None and nonlinear
    carry = not reset_initial_guess and nonlinear and not use_cws
    draw = lambda b: keychain.normal((b, prior.noise_dim), dtype=dtype)
    with_control = control_distribution is not None

    def draw_z(b):
        if not with_control:
            return None
        return control_distribution.sample_n(keychain, b, dtype=dtype)

    def solve(noise_c, z, u0):
        """The chunk's lanes (this rank's share of them, gathered): (m, u,
        q, converged, Newton iterations), each with the chunk's rows."""
        b = noise_c.shape[0]
        sl = share(b)
        noise_c = noise_c[sl]
        z = None if z is None else z[sl]
        u0 = None if u0 is None else u0[sl]
        if use_cws:
            u0 = coarse_warm_start(noise_c)
        m = prior.sample(noise_c)
        u, info = problem.solve_fwd(m, z=z, u0=u0)
        ok = gather(info.converged.to(torch.uint8), b).bool()
        return (gather(m, b), gather(u, b), gather(observable.evalu(u), b), ok,
                gather(info.iterations, b))

    chunks = []
    u_prev = None
    for a in range(0, n_samples, chunk_size):
        b = min(chunk_size, n_samples - a)
        noise_c = noise[a : a + b] if noise is not None else draw(b)
        z = controls[a : a + b] if controls is not None else draw_z(b)
        u0 = None
        if carry and u_prev is not None and u_prev.shape[0] >= b:
            u0 = u_prev[:b]
        m, u, q, ok, it = solve(noise_c, z, u0)
        if carry:
            good = ok[:, None] & torch.isfinite(u).all(dim=1, keepdim=True)
            u_prev = torch.where(good, u, 0.0)
        chunks.append((m, u, q, z, ok, it))
        if verbose:
            print(f"  solved {a + b}/{n_samples}", flush=True)

    out = {k: [] for k in ("m", "u", "q", "z", "it")}
    failed_ms = []
    n_failures = 0
    for m, u, q, z, ok_t, it in chunks:
        b = m.shape[0]
        ok = ok_t.cpu().numpy()
        host_syncs.add("sample.converged")
        for _ in range(max_tries):
            if ok.all():
                break
            with annotate("sample.resample", fine=True, N=b):
                bad = np.flatnonzero(~ok)
                nbad = len(bad)
                n_failures += nbad
                failed_ms.append(m[bad].cpu().numpy())
                if verbose:
                    print(f"resampling {nbad} failed forward solves")
                noise2 = draw(b)
                z2 = draw_z(b)
                m2, u2, q2, ok2, it2 = solve(noise2, z2, None)
                bad_t = torch.as_tensor(bad, device=device)
                m[bad_t], u[bad_t], q[bad_t] = m2[:nbad], u2[:nbad], q2[:nbad]
                if with_control:  # out of place: z may be the caller's controls
                    z = z.index_copy(0, bad_t, z2[:nbad])
                it[bad_t] = it2[:nbad]
                ok[bad] = ok2[:nbad].cpu().numpy()
            host_syncs.add("sample.resample", 2)
        if not ok.all():
            raise RuntimeError(
                f"{(~ok).sum()} forward solves failed after {max_tries} "
                "resampling sweeps"
            )
        for k, v in zip(("m", "u", "q", "z", "it"), (m, u, q, z, it)):
            out[k].append(v)
    return SampleBatch(
        ms=torch.cat(out["m"]),
        us=torch.cat(out["u"]),
        qs=torch.cat(out["q"]),
        zs=torch.cat(out["z"]) if with_control else None,
        n_failures=n_failures,
        failed_ms=np.concatenate(failed_ms) if failed_ms else None,
        iterations=torch.cat(out["it"]),
    )


def sample_and_materialize_symmetric(
    observable: LinearStateObservable,
    prior,
    keychain,
    n_samples: int,
    chunk_size: int | None = None,
    max_tries: int = 10,
    refine_steps: int = 1,
    verbose: bool = False,
    *,
    noise=None,
):
    """Fused forward + Jacobian sampling for a linear problem whose
    assembled operator is symmetric, A^T = A, possibly indefinite (the
    split-complex Helmholtz/PML form [[P, Q], [Q, -P]]).

    Per chunk, one adjoint-only factorization (K1 on the card) serves three
    solves through the same factor (K2): the forward solve u = A^{-T} b, its
    ``refine_steps`` sweeps of iterative refinement against the residual,
    and the dQ-rhs adjoint solve that materializes J.  Failure and
    resampling semantics as in ``sample_until_solved`` (the flag is
    ``linear_convergence_check``); the noise stream is the same, so fused
    and staged runs see identical parameters.  ``noise`` (n_samples,
    noise_dim), when given, replaces the first draws; it is keyword-only,
    in the slot of the JAX package's unported ``precompile_only``.
    Returns (SampleBatch, Js (n, dQ, dM))."""
    problem = observable.problem
    if not (problem.is_fwd_linear and problem.operator_symmetric):
        raise ValueError("the fused pass needs a linear, symmetric operator")
    if problem._has_bc:
        raise ValueError(
            "the fused pass takes problems without Dirichlet rows: bc "
            "masking breaks A^T = A"
        )
    dtype, device = prior.mean.dtype, prior.mean.device
    if chunk_size is None:
        chunk_size = auto_chunk_size(problem.state_dim, dtype, problem=problem,
                                     device=device)
    J = ObservableJacobian(observable)
    draw = lambda b: keychain.normal((b, prior.noise_dim), dtype=dtype)

    def solve(noise_c):
        m = prior.sample(noise_c)
        zero = torch.zeros((m.shape[0], problem.state_dim), dtype=dtype,
                           device=device)
        lin = problem.linearize(zero, m, needs="adj")
        b = problem.linear_rhs(m)
        u = problem.solve_incremental(lin, b, is_adj=True)  # A^T = A
        for _ in range(refine_steps):
            r = problem.residual_masked(u, m)  # = A u - b (r is affine)
            u = u - problem.solve_incremental(lin, r, is_adj=True)
        ok, _ = problem.linear_convergence_check(u, m, b)
        # A does not depend on u, but C = dr/dm does: rebind the
        # linearization point to the solved state, keeping the factor
        Jm = J.materialize(lin._replace(u=u))
        return m, u, observable.evalu(u), Jm, ok

    chunks = []
    for a in range(0, n_samples, chunk_size):
        b = min(chunk_size, n_samples - a)
        noise_c = noise[a : a + b] if noise is not None else draw(b)
        chunks.append(solve(noise_c))
        if verbose:
            print(f"  solved {a + b}/{n_samples}", flush=True)

    out = {k: [] for k in ("m", "u", "q", "J")}
    failed_ms = []
    n_failures = 0
    for m, u, q, Jm, ok_t in chunks:
        b = m.shape[0]
        ok = ok_t.cpu().numpy()
        host_syncs.add("sample.converged")
        for _ in range(max_tries):
            if ok.all():
                break
            with annotate("sample.resample", fine=True, N=b):
                bad = np.flatnonzero(~ok)
                nbad = len(bad)
                n_failures += nbad
                failed_ms.append(m[bad].cpu().numpy())
                if verbose:
                    print(f"resampling {nbad} failed linear solves")
                m2, u2, q2, J2, ok2 = solve(draw(b))
                bad_t = torch.as_tensor(bad, device=device)
                m[bad_t], u[bad_t], q[bad_t] = m2[:nbad], u2[:nbad], q2[:nbad]
                Jm[bad_t] = J2[:nbad]
                ok[bad] = ok2[:nbad].cpu().numpy()
            host_syncs.add("sample.resample", 2)
        if not ok.all():
            raise RuntimeError(
                f"{(~ok).sum()} linear solves failed after {max_tries} sweeps"
            )
        for k, v in zip(("m", "u", "q", "J"), (m, u, q, Jm)):
            out[k].append(v)
    batch = SampleBatch(
        ms=torch.cat(out["m"]),
        us=torch.cat(out["u"]),
        qs=torch.cat(out["q"]),
        zs=None,
        n_failures=n_failures,
        failed_ms=np.concatenate(failed_ms) if failed_ms else None,
        iterations=torch.ones(n_samples, dtype=torch.long, device=device),
    )
    return batch, torch.cat(out["J"])


def fresh_solves(observable: LinearStateObservable, ms, chunk_size: int | None = None,
                 zs=None):
    """Cold-started forward solves of ms (N, dM) (and controls zs (N, dZ))
    in chunks, no resampling (the error tests' re-solves): (qs (N, dQ),
    converged (N,) bool, Newton iterations (N,))."""
    problem = observable.problem
    if chunk_size is None:
        chunk_size = auto_chunk_size(problem.state_dim, ms.dtype,
                                     problem=problem, device=ms.device)
    qs, ok, its = [], [], []
    for a in range(0, ms.shape[0], chunk_size):
        z = None if zs is None else zs[a:a + chunk_size]
        u, info = problem.solve_fwd(ms[a:a + chunk_size], z=z)
        qs.append(observable.evalu(u))
        ok.append(info.converged)
        its.append(info.iterations)
    return torch.cat(qs), torch.cat(ok), torch.cat(its)


def materialize_jacobians(observable: LinearStateObservable, ms, us, zs=None,
                          chunk_size: int | None = None, control: bool = False):
    """Dense Jacobians J_i = dq/dm (N, dQ, dM) at each sample, or with
    ``control`` Jz_i = dq/dz (N, dQ, dZ) (controls zs (N, dZ)).

    Per chunk: one batched adjoint-only linearization (K1 on the card, or
    the solver's own factor) and one adjoint solve of dQ right-hand sides
    (K2), written into a preallocated result, so the factors of only one
    chunk are alive at a time."""
    problem = observable.problem
    J = (ObservableControlJacobian if control else ObservableJacobian)(observable)
    n = ms.shape[0]
    if chunk_size is None:
        chunk_size = auto_chunk_size(problem.state_dim, ms.dtype,
                                     problem=problem, device=ms.device)
    J_all = torch.empty((n,) + J.shape, dtype=ms.dtype, device=ms.device)
    for a in range(0, n, chunk_size):
        e = min(a + chunk_size, n)
        lin = problem.linearize(us[a:e], ms[a:e],
                                None if zs is None else zs[a:e], needs="adj")
        J_all[a:e] = J.materialize(lin)
    return J_all


def linearize_batch(observable: LinearStateObservable, ms, us, zs=None):
    """The batched Linearization of every sample (factors kept)."""
    return observable.problem.linearize(us, ms, zs)
