"""Grid-sequenced Newton warm starts of the PyTorch port against the JAX
package (``fem/multigrid.py``).

Confusion at nx=16 with the analytic velocity, float64, coarse levels at
nx=8 (depth 1) and nx=8, 4 (depth 2), on the same numpy prior noise:

* ``restrict_injection`` and ``prolong_linear`` match to 1e-14, one and two
  components;
* the warm-start map matches the JAX map to 1e-10 at depth 1 and 2;
* ``sample_until_solved`` with the map draws the same ``ms`` as a cold
  start, takes exactly the JAX package's Newton iterations lane by lane
  (fine solve from the JAX map's u0) and agrees on u to 1e-10.
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
from hippyflow_tpu.fem import (
    coarse_newton_warm_start as j_cws,
    prolong_linear as j_prolong,
    restrict_injection as j_restrict,
)
from hippyflow_tpu_torch.applications.confusion import (
    confusion_linear_observable as t_observable,
    confusion_prior as t_prior,
)
from hippyflow_tpu_torch.fem import (
    FunctionSpace,
    coarse_newton_warm_start,
    prolong_linear,
    restrict_injection,
    unit_square_mesh,
)
from hippyflow_tpu_torch.models import sample_until_solved
from hippyflow_tpu_torch.utils import KeyChain

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
NX, N_SAMPLES = 16, 6
TOL = 1e-10


@pytest.mark.parametrize("trail", [(), (2,)])
def test_transfers_match_jax(trail):
    """Injection and 2:1 linear interpolation, batch-first in the port,
    against the JAX transfers lane by lane."""
    Vf = FunctionSpace(unit_square_mesh(8))
    Vc = FunctionSpace(unit_square_mesh(4))
    rng = np.random.default_rng(0)
    xf = rng.standard_normal((3, Vf.dim) + trail)
    xc = rng.standard_normal((3, Vc.dim) + trail)
    r = restrict_injection(torch.tensor(xf), Vf, Vc).numpy()
    p = prolong_linear(torch.tensor(xc), Vc, Vf).numpy()
    assert r.shape == (3, Vc.dim) + trail and p.shape == (3, Vf.dim) + trail
    for i in range(3):
        np.testing.assert_allclose(
            r[i], np.asarray(j_restrict(jnp.asarray(xf[i]), Vf, Vc)), atol=1e-14)
        np.testing.assert_allclose(
            p[i], np.asarray(j_prolong(jnp.asarray(xc[i]), Vc, Vf)), atol=1e-14)
    # injection is a left inverse of the prolongation
    np.testing.assert_allclose(
        restrict_injection(torch.tensor(p), Vf, Vc).numpy(), xc, atol=1e-15)


def test_transfers_refuse_grids_not_2_to_1():
    Vf = FunctionSpace(unit_square_mesh(8))
    V3 = FunctionSpace(unit_square_mesh(3))
    with pytest.raises(ValueError, match="2x coarser"):
        restrict_injection(torch.zeros(1, Vf.dim), Vf, V3)


@functools.lru_cache(maxsize=None)
def _chains():
    """(port, JAX) observables, priors and warm-start maps at depth 1 and
    2, and the shared noise."""
    jobs = {nx: j_observable(nx=nx, velocity="analytic") for nx in (16, 8, 4)}
    tobs = {nx: t_observable(nx=nx, velocity="analytic", **F64)
            for nx in (16, 8, 4)}
    jpr, tpr = j_prior(jobs[NX][1]), t_prior(tobs[NX][1], **F64)
    maps = {}
    for depth in (1, 2):
        maps[depth] = (
            j_cws(jpr, jobs[8][0].problem, jobs[NX][1], jobs[8][1],
                  coarser_levels=[(jobs[4][0].problem, jobs[4][1])][: depth - 1]),
            coarse_newton_warm_start(
                tpr, tobs[8][0].problem, tobs[NX][1], tobs[8][1],
                coarser_levels=[(tobs[4][0].problem, tobs[4][1])][: depth - 1]),
        )
    xi = np.random.default_rng(7).standard_normal((N_SAMPLES, tobs[NX][1].dim))
    return jobs[NX][0], tobs[NX][0], jpr, tpr, maps, xi


@functools.lru_cache(maxsize=None)
def _jax_fine(depth):
    jobs, _, jpr, _, maps, xi = _chains()
    u0 = jax.jit(maps[depth][0])(jnp.asarray(xi))
    ms = jax.jit(jax.vmap(jpr.sample))(jnp.asarray(xi))
    u, info = jax.jit(jax.vmap(lambda m, w: jobs.problem.solve_fwd(m, u0=w)))(
        ms, u0)
    return np.asarray(u0), np.asarray(u), np.asarray(info.iterations)


@pytest.mark.parametrize("depth", [1, 2])
def test_warm_start_map_matches_jax(depth):
    _, _, _, _, maps, xi = _chains()
    t_map = maps[depth][1]
    t_map.clear()
    u0 = t_map(torch.tensor(xi)).numpy()
    u0_j = _jax_fine(depth)[0]
    assert np.isfinite(u0).all() and np.abs(u0).max() > 0
    np.testing.assert_allclose(u0, u0_j, rtol=0, atol=TOL * np.abs(u0_j).max())
    # one call, N_SAMPLES lanes at every level
    assert [len(it) for it in t_map.iterations] == [1] * depth
    assert all(it[0].shape == (N_SAMPLES,) for it in t_map.iterations)


@pytest.mark.parametrize("depth", [1, 2])
def test_sample_until_solved_with_warm_start_matches_jax(depth):
    """Same ms as a cold start (the map draws nothing), the JAX package's
    per-lane Newton iterations from its own warm start, u to 1e-10, and
    fewer iterations than the cold start in total."""
    _, tobs, _, tpr, maps, xi = _chains()
    warm = sample_until_solved(tobs, tpr, KeyChain(0, "cpu"), N_SAMPLES,
                               chunk_size=3, noise=torch.tensor(xi),
                               coarse_warm_start=maps[depth][1])
    cold = sample_until_solved(tobs, tpr, KeyChain(0, "cpu"), N_SAMPLES,
                               chunk_size=3, noise=torch.tensor(xi),
                               reset_initial_guess=True)
    assert torch.equal(warm.ms, cold.ms) and warm.n_failures == 0
    _, u_j, it_j = _jax_fine(depth)
    np.testing.assert_array_equal(warm.iterations.numpy(), it_j)
    np.testing.assert_allclose(warm.us.numpy(), u_j, rtol=0,
                               atol=TOL * np.abs(u_j).max())
    assert warm.iterations.sum() < cold.iterations.sum()


def test_warm_start_keeps_the_drawn_stream():
    """Drawing from the keychain: the warm-started run sees the same
    parameters as a cold run from the same seed and lands on the same
    states."""
    _, tobs, _, tpr, maps, _ = _chains()
    kw = dict(chunk_size=4)
    warm = sample_until_solved(tobs, tpr, KeyChain(11, "cpu"), 8,
                               coarse_warm_start=maps[1][1], **kw)
    cold = sample_until_solved(tobs, tpr, KeyChain(11, "cpu"), 8,
                               reset_initial_guess=True, **kw)
    assert torch.equal(warm.ms, cold.ms)
    np.testing.assert_allclose(warm.us.numpy(), cold.us.numpy(), atol=1e-7)


def test_failed_coarse_lane_hands_a_zero_guess():
    """Converged coarse lanes hand on their prolonged states; a coarse
    solve that does not converge hands a zero initial guess to the fine
    level."""
    _, tobs, _, tpr, maps, xi = _chains()
    noise = torch.tensor(xi[:2])
    assert (maps[1][1](noise).abs().sum(dim=1) > 0).all()
    coarse = t_observable(nx=8, velocity="analytic", newton_max_iter=0, **F64)[0]
    bad = coarse_newton_warm_start(tpr, coarse.problem, tobs.problem.Vu,
                                   coarse.problem.Vu)
    assert (bad(noise) == 0).all()
