"""Batched Newton, linearization and Jacobians of the PyTorch port against
the JAX package.

Confusion at nx=12 (analytic velocity), float64, on the same numpy prior
noise: the port's batched Newton must take exactly the iterations of the
JAX package's vmapped ``solve_fwd`` lane by lane and agree on u to 1e-10;
incremental solves and the materialized Jacobians agree to 1e-10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applications.confusion import (
    confusion_linear_observable as j_observable,
    confusion_prior as j_prior,
)
from hippyflow_tpu.models import ObservableJacobian as JObservableJacobian
from hippyflow_tpu_torch import interop
from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable as t_observable,
    confusion_prior as t_prior,
)
from hippyflow_tpu_torch.models import (
    ObservableJacobian,
    materialize_jacobians,
    sample_until_solved,
)
from hippyflow_tpu_torch.utils import KeyChain

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX = 12
N_SAMPLES = 6
TOL = 1e-10


@functools.lru_cache(maxsize=None)
def _setup():
    jobs, jV = j_observable(nx=NX, velocity="analytic")
    jpr = j_prior(jV)
    tobs, tV = t_observable(nx=NX, velocity="analytic", **F64)
    tpr = t_prior(tV, **F64)
    xi = np.random.default_rng(0).standard_normal((N_SAMPLES, jV.dim))
    m = np.asarray(jpr.sample(jnp.asarray(xi)))
    u, info = jax.jit(jax.vmap(lambda mm: jobs.problem.solve_fwd(mm)))(
        jnp.asarray(m)
    )
    return jobs, tobs, jpr, tpr, xi, m, np.asarray(u), info


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=tol, atol=tol
    )


def test_newton_matches_vmapped_solve_fwd():
    jobs, tobs, _, _, _, m, u_ref, info_ref = _setup()
    u, info = tobs.problem.solve_fwd(interop.tensor(m, **F64))
    np.testing.assert_array_equal(
        info.iterations.numpy(), np.asarray(info_ref.iterations)
    )
    assert info.converged.all() and np.asarray(info_ref.converged).all()
    _close(u, u_ref)
    _close(info.residual_norm, info_ref.residual_norm)


def test_newton_warm_start_matches():
    """From a given initial guess (the chunk warm start) iterations and
    states still agree."""
    jobs, tobs, _, _, _, m, u_ref, _ = _setup()
    u0 = np.roll(u_ref, 1, axis=0)
    u_j, info_j = jax.vmap(lambda mm, uu: jobs.problem.solve_fwd(mm, u0=uu))(
        jnp.asarray(m), jnp.asarray(u0)
    )
    u, info = tobs.problem.solve_fwd(
        interop.tensor(m, **F64), u0=interop.tensor(u0, **F64)
    )
    np.testing.assert_array_equal(
        info.iterations.numpy(), np.asarray(info_j.iterations)
    )
    _close(u, u_j)


def test_converged_lanes_stop():
    """A lane that starts at its solution takes no step while the others
    iterate."""
    _, tobs, _, _, _, m, u_ref, _ = _setup()
    u0 = np.zeros_like(u_ref)
    u0[0] = u_ref[0]
    u, info = tobs.problem.solve_fwd(
        interop.tensor(m, **F64), u0=interop.tensor(u0, **F64)
    )
    assert info.iterations[0].item() == 0
    assert (info.iterations[1:] > 0).all()
    np.testing.assert_array_equal(u[0].numpy(), u_ref[0])


@pytest.mark.parametrize("k", [None, 3])
def test_apply_C_matches(k):
    """C dm with C = dr/dm of the masked residual at the solved states,
    for one direction and for a block of k, against the JAX package."""
    from hippyflow_tpu.models.pde_problem import Linearization as JLin
    from hippyflow_tpu_torch.models import Linearization

    jobs, tobs, _, _, _, m, u_ref, _ = _setup()
    shape = (N_SAMPLES, m.shape[1]) + (() if k is None else (k,))
    dm = np.random.default_rng(4).standard_normal(shape)
    got = tobs.problem.apply_C(
        Linearization(interop.tensor(u_ref, **F64), interop.tensor(m, **F64),
                      None, None), interop.tensor(dm, **F64))
    want = jax.vmap(lambda u, mm, d: jobs.problem.apply_C(
        JLin(u, mm, None, None), d))(jnp.asarray(u_ref), jnp.asarray(m),
                                     jnp.asarray(dm))
    assert got.shape == want.shape
    _close(got, want, tol=1e-12)


def test_prior_samples_match():
    _, _, jpr, tpr, xi, m, _, _ = _setup()
    _close(tpr.sample(interop.tensor(xi, **F64)), m, tol=1e-12)
    _close(tpr.sample(interop.tensor(xi[0], **F64)), m[0], tol=1e-12)


@pytest.mark.parametrize("is_adj", [False, True])
def test_incremental_solves(is_adj):
    jobs, tobs, _, _, _, m, u, _ = _setup()
    rhs = np.random.default_rng(1).standard_normal((N_SAMPLES, u.shape[1], 3))
    want = jax.vmap(
        lambda mm, uu, r: jobs.problem.solve_incremental(
            jobs.problem.linearize(uu, mm), r, is_adj=is_adj
        )
    )(jnp.asarray(m), jnp.asarray(u), jnp.asarray(rhs))
    lin = tobs.problem.linearize(
        interop.tensor(u, **F64), interop.tensor(m, **F64)
    )
    got = tobs.problem.solve_incremental(
        lin, interop.tensor(rhs, **F64), is_adj=is_adj
    )
    _close(got, want)


def test_jacobians_match():
    jobs, tobs, _, _, _, m, u, _ = _setup()
    JJ = JObservableJacobian(jobs)
    want = jax.vmap(
        lambda mm, uu: JJ.materialize(jobs.problem.linearize(uu, mm))
    )(jnp.asarray(m), jnp.asarray(u))
    mt, ut = interop.tensor(m, **F64), interop.tensor(u, **F64)
    got = ObservableJacobian(tobs).materialize(tobs.problem.linearize(ut, mt))
    assert got.shape == (N_SAMPLES, tobs.dQ, tobs.dM)
    _close(got, want)
    # chunked materialization writes the same slices, here from a sample
    # batch carried over from the JAX package
    qs = np.asarray(jax.vmap(jobs.evalu)(jnp.asarray(u)))
    batch = interop.sample_batch(m, u, qs, **F64)
    _close(batch.qs, u @ np.asarray(jobs.B.dense()).T, tol=1e-12)
    _close(materialize_jacobians(tobs, batch.ms, batch.us, chunk_size=4), want)


def test_sample_until_solved_warm_starts_chunks():
    """Given noise, chunk 2 starts from chunk 1's states lane by lane, as
    the JAX package's sampler does; iterations match JAX's solve_fwd from
    the same initial guesses."""
    jobs, tobs, _, tpr, xi, m, u_ref, info_ref = _setup()
    batch = sample_until_solved(
        tobs, tpr, KeyChain(0, "cpu"), N_SAMPLES, chunk_size=4,
        noise=interop.tensor(xi, **F64),
    )
    assert batch.n_failures == 0 and batch.failed_ms is None
    _close(batch.ms, m, tol=1e-12)
    _close(batch.us, u_ref)
    _close(batch.qs, u_ref @ np.asarray(jobs.B.dense()).T)
    it_ref = np.asarray(info_ref.iterations)
    np.testing.assert_array_equal(batch.iterations[:4].numpy(), it_ref[:4])
    _, info_w = jax.vmap(lambda mm, uu: jobs.problem.solve_fwd(mm, u0=uu))(
        jnp.asarray(m[4:]), jnp.asarray(u_ref[:2])
    )
    np.testing.assert_array_equal(
        batch.iterations[4:].numpy(), np.asarray(info_w.iterations)
    )


def test_failed_lane_is_resampled_at_the_chunk_size():
    """A lane that does not converge within newton_max_iter is replaced by
    the first lane of a fresh chunk-sized draw from the keychain, and its
    parameter is kept in failed_ms."""
    tobs, tV = t_observable(
        nx=NX, velocity="analytic", newton_max_iter=7, **F64
    )
    tpr = t_prior(tV, **F64)
    xi = np.random.default_rng(0).standard_normal((4, tV.dim))
    xi[1] *= 40.0  # a rough draw whose Newton solve needs more than 7 steps
    noise = interop.tensor(xi, **F64)
    batch = sample_until_solved(
        tobs, tpr, KeyChain(7, "cpu"), 4, chunk_size=4, noise=noise,
        reset_initial_guess=True,
    )
    assert batch.n_failures == 1
    m0 = tpr.sample(noise)
    _close(batch.failed_ms, m0[1:2].numpy(), tol=0.0)
    redraw = KeyChain(7, "cpu").normal((4, tV.dim), dtype=torch.float64)
    _close(batch.ms[1], tpr.sample(redraw[0]), tol=1e-12)
    _close(batch.ms[[0, 2, 3]], m0[[0, 2, 3]], tol=0.0)
    u, info = tobs.problem.solve_fwd(batch.ms)
    assert info.converged.all()
    _close(batch.us, u, tol=1e-12)
    np.testing.assert_array_equal(batch.iterations.numpy(), info.iterations.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_auto_chunk_size_matches(dtype):
    """On the CPU both packages budget 2 GB for the banded factors."""
    from hippyflow_tpu.models.sampling import auto_chunk_size as j_chunk
    from hippyflow_tpu_torch.models import auto_chunk_size

    jobs, jV = j_observable(nx=64, velocity="analytic")
    tobs, _ = t_observable(nx=64, velocity="analytic", dtype=dtype, device="cpu")
    want = j_chunk(
        jV.dim, jnp.float32 if dtype == torch.float32 else jnp.float64,
        problem=jobs.problem,
    )
    assert auto_chunk_size(tobs.problem.state_dim, dtype, problem=tobs.problem,
                           device="cpu") == want < 4096
