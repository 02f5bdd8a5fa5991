"""The port's parallel layer across gloo CPU ranks, against the JAX package.

Two launches, each of separate OS processes that meet at a ``FileStore``
in ``tmp_path`` and run one thread each (``tests/_torch_parallel_worker.py``;
the ranks import the port only, never JAX):

* 4 ranks, on a (1, 4) and a (2, 2) ('sample', 'fem') mesh: the halo
  product (bitwise the serial product's, and the JAX package's at 1e-13),
  the partitioned SPIKE solve sharded and placed, forward and transposed
  (1e-12), a batch of factors over the 2D grid, the sharded assembly at
  nx=13 (1e-12), the dof-sharded structured prior at nx=12 and 24 (1e-10),
  the linear and Newton Poisson control solves with ``solver="dist_banded"``
  and their incremental solves at nx=12 (1e-9, equal Newton iterations),
  the helmholtz P2 ordered band at nx=12 (1e-8) and the active-subspace
  spectrum at nx=12 with a ``DeviceCollective`` against the JAX package's
  serial run on the same noise (1e-8);
* 2 ranks: the collectives of ``tests/test_multiprocess.py`` and the
  ``allReduce`` rules, failed lanes resampled across ranks, and the
  resumable files under the collective: ``construct_low_rank_Jacobians(
  output_directory=...)`` and ``PODProjector.generate_training_data``
  write from rank 0 alone, every rank returns the same arrays, the one-rank
  run's (last bits; sigma and U diag(sigma) V^T to 1e-12), a run resumed
  from partial chunks writes the uninterrupted run's bundles, and the
  Jacobians' bundle is the JAX package's serial one on the same noise
  (1e-9).

The JAX side runs in the test process on the same numpy inputs, in float64.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_parallel_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Job:
    """The ranks of one case set, started at once; ``result()`` waits for
    them and returns rank 0's results."""

    def __init__(self, tmp_path, cases, world):
        self.out = tmp_path / f"{cases}.npz"
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_parallel_worker.py"),
             cases, str(r), str(world), str(tmp_path / f"{cases}.store"),
             str(self.out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        self._result = None

    def result(self):
        if self._result is None:
            logs = [p.communicate(timeout=300)[0] for p in self.procs]
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            with np.load(self.out, allow_pickle=True) as z:
                self._result = {k: z[k] for k in z.files}
        return self._result

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both launches, started together; the tests compute the JAX side
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("ranks")
    started = {"world4": _Job(tmp, "world4", 4), "world2": _Job(tmp, "world2", 2)}
    yield started
    for job in started.values():
        job.kill()


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fem_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("fem",))


# -- the 4-rank job ------------------------------------------------------------

@pytest.mark.parametrize("nb,s,n_fem", W.HALO_CASES)
def test_halo_product_matches(jobs, nb, s, n_fem):
    """Bitwise the port's serial banded product (checked on the ranks: the
    same per-row arithmetic) and the JAX package's halo product."""
    from hippyflow_tpu.parallel import dist_block_tridiag_matmat

    band, X = jnp.asarray(W.random_band(nb, s)), jnp.asarray(W.rhs(nb * s, 3, 1))
    want = np.asarray(dist_block_tridiag_matmat(_fem_mesh(n_fem), band, X))
    world4 = jobs["world4"].result()
    assert bool(world4[f"halo_exact_{nb}_{s}"])
    assert _rel(world4[f"halo_{nb}_{s}"], want) < 1e-13
    assert _rel(world4[f"halo1_{nb}_{s}"], want[:, 0]) < 1e-13


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("nb,s,n_fem", W.SPIKE_CASES)
def test_spike_across_ranks_matches_jax(jobs, nb, s, n_fem, trans):
    """Built sharded (each rank its own partitions) and placed from the
    unplaced factor, forward and transposed, against the JAX package's
    placed SPIKE factor and the port's cyclic reduction."""
    X = jnp.asarray(W.rhs(nb * s, 3, 2))
    want = np.asarray(_jax_spike(nb, s, n_fem, trans)(X))
    world4 = jobs["world4"].result()
    tag = f"{nb}_{s}_{int(trans)}"
    for key in ("spike", "spike_placed", "spike_cr"):
        assert _rel(world4[f"{key}_{tag}"], want) < 1e-12, key


def _jax_spike(nb, s, n_fem, trans):
    """The JAX package's SPIKE solve of ``random_band(nb, s)``, jitted (the
    same program its mesh placement runs, on one device)."""
    from hippyflow_tpu.parallel import factorize_distributed_banded

    band = jnp.asarray(W.random_band(nb, s))
    return jax.jit(lambda X: factorize_distributed_banded(band, n_fem).solve(
        X, trans=trans))


@functools.lru_cache(maxsize=None)
def _jax_prior_ops(nx):
    """The JAX package's structured prior (robin_bc) at nx: its sample of
    ``rhs(3, n, 3)`` and its operators on ``rhs(n, 4, 4)``, in one jitted
    program."""
    from hippyflow_tpu.models.prior import StructuredBiLaplacianPrior
    import hippyflow_tpu as hf

    V = hf.FunctionSpace(hf.unit_square_mesh(nx))
    p = StructuredBiLaplacianPrior(V, 0.1, 1.0, robin_bc=True, materialize=False)
    ops = ("Rsolver_matmat", "R_matmat", "M_matmat", "Msolver_matmat",
           "sqrtM_matmat")
    run = jax.jit(lambda n, X: {"sample": p.sample(n),
                                **{op: getattr(p, op)(X) for op in ops}})
    return {k: np.asarray(v) for k, v in run(
        jnp.asarray(W.rhs(3, V.dim, 3)), jnp.asarray(W.rhs(V.dim, 4, 4))).items()}


def test_batch_over_sample_and_fem_matches_jax(jobs):
    """A batch of per-sample factors, samples over 'sample' and partitions
    over 'fem' (the JAX package's 2D composition test)."""
    from hippyflow_tpu.ops.structured import factorize_block_cyclic_banded

    X = jnp.asarray(np.random.default_rng(9).standard_normal((2, 60, 3)))
    bands = jnp.asarray(np.stack([W.random_band(12, 5, seed=i) for i in range(2)]))
    want = jax.jit(jax.vmap(
        lambda b, x: factorize_block_cyclic_banded(b).solve(x)))(bands, X)
    assert _rel(jobs["world4"].result()["grid2d"], want) < 1e-10


def test_sharded_assembly_matches_jax(jobs):
    """nx=13 (14 block rows on 4 ranks of 4 rows): each rank's own rows,
    the halo row added, identity pad rows, and a SPIKE solve from the
    sharded band."""
    from hippyflow_tpu.models.prior import StructuredBiLaplacianPrior
    from hippyflow_tpu.parallel.dist_banded import (
        dist_assemble_band,
        partition_cells_by_row,
    )
    import hippyflow_tpu as hf

    V = hf.FunctionSpace(hf.unit_square_mesh(13))
    pr = StructuredBiLaplacianPrior(V, 0.1, 1.0, materialize=False)
    s = nb = 14
    cells = np.asarray(V.mesh.cells)
    plan, L = partition_cells_by_row((cells // s).min(axis=1), nb, 4)
    nc = cells.shape[0]
    want = np.asarray(dist_assemble_band(
        _fem_mesh(4), np.asarray(pr._K_e).reshape(nc, -1),
        np.asarray(pr._cell_idx).reshape(nc, -1), plan, nb, s))
    world4 = jobs["world4"].result()
    got = world4["asm_K"]
    assert got.shape == want.shape == (4 * L, s, 3 * s)
    assert int(world4["asm_local_rows"]) == L
    assert _rel(got[:nb], want[:nb]) < 1e-12
    for r in range(nb, 4 * L):
        np.testing.assert_array_equal(got[r, :, s : 2 * s], np.eye(s))
    assert float(world4["asm_residual"]) < 1e-9


@pytest.mark.parametrize("op", ["sample", "Rsolver_matmat", "R_matmat",
                                "M_matmat", "Msolver_matmat", "sqrtM_matmat"])
@pytest.mark.parametrize("nx,n_fem", W.PRIOR_CASES)
def test_dof_sharded_prior_matches_jax(jobs, nx, n_fem, op):
    """The prior with mesh= (rows assembled per rank, SPIKE K and M solves,
    M's block Cholesky down the ranks, halo products) against the JAX
    package's structured prior (robin_bc)."""
    want = _jax_prior_ops(nx)[op]
    assert _rel(jobs["world4"].result()[f"prior{nx}_{op}"], want) < 1e-10


@pytest.mark.parametrize("linear", [True, False])
def test_dist_banded_poisson_solves_match_jax(jobs, linear):
    """Forward (linear, or Newton with equal iterations) and incremental
    solves of the Poisson control problem at nx=12, dof-sharded on 4
    ranks, against the JAX package's solves on the same m, z."""
    from hippyflow_tpu.testing import setup_poisson_control_problem

    st = W.poisson_settings(linear)
    st["nx"] = st["ny"] = 12
    pde = setup_poisson_control_problem(st)[0]
    world4 = jobs["world4"].result()
    tag = f"poisson{int(linear)}"
    m, z = jnp.asarray(world4[f"{tag}_m"]), jnp.asarray(world4[f"{tag}_z"])
    u, info = jax.jit(jax.vmap(pde.solve_fwd))(m, z)
    assert world4[f"{tag}_converged"].all()
    np.testing.assert_array_equal(world4[f"{tag}_it"], np.asarray(info.iterations))
    assert _rel(world4[f"{tag}_u"], u) < 1e-9
    rhs = jnp.asarray(world4[f"{tag}_rhs"])
    for adj in (False, True):
        want = jax.jit(jax.vmap(lambda uu, mm, zz, r: pde.solve_incremental(
            pde.linearize(uu, mm, zz), r, is_adj=adj)))(u, m, z, rhs)
        assert _rel(world4[f"{tag}_inc{int(adj)}"], want) < 1e-9


def test_dist_banded_helmholtz_ordered_band_matches_jax(jobs):
    """The helmholtz P2 split-complex state (the ordered band through
    ``PermutedFactor``) at nx=12 on 4 'fem' ranks."""
    from applications.helmholtz import helmholtz_linear_observable

    obs, _ = helmholtz_linear_observable(nx=12, frequency=150.0)
    pde = obs.problem
    world4 = jobs["world4"].result()
    assert bool(world4["helm_ordered"]) and world4["helm_converged"].all()

    @jax.jit
    def solves(m, rhs):
        u, info = pde.solve_fwd(m)
        lin = pde.linearize(u, m)
        return (u, info.converged, pde.solve_incremental(lin, rhs),
                pde.solve_incremental(lin, rhs, is_adj=True))

    u, ok, inc0, inc1 = solves(jnp.asarray(world4["helm_m"][0]),
                               jnp.asarray(world4["helm_rhs"][0]))
    assert bool(ok)
    assert _rel(world4["helm_u"][0], u) < 1e-8
    assert _rel(world4["helm_inc0"][0], inc0) < 1e-8
    assert _rel(world4["helm_inc1"][0], inc1) < 1e-8


class _JaxGivenNoise:
    """The JAX side's keychain: the same numpy stream as ``GivenNoise``."""

    def __init__(self, rng):
        self.rng = rng

    def normal(self, shape, dtype=None, sigma=1.0):
        return sigma * jnp.asarray(self.rng.standard_normal(shape),
                                   dtype=dtype or jnp.float64)

    def next_key(self):
        return None


def test_active_subspace_over_the_grid_matches_jax_serial(jobs):
    """Samples split over 'sample' (each rank's Jacobians, the Gauss-Newton
    sums meeting in an all-reduce), solves dof-sharded over 'fem': the
    spectrum of the JAX package's serial run on the same noise."""
    from applications.confusion import confusion_linear_observable, confusion_prior
    from hippyflow_tpu.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    obs, V = confusion_linear_observable(nx=W.AS_NX, velocity="analytic")
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = W.AS_RANK, W.AS_OVERSAMPLING
    params["samples_per_process"] = params["chunk_size"] = W.AS_N
    params["verbose"] = False
    proj = ActiveSubspaceProjector(obs, confusion_prior(V), parameters=params)
    proj.keychain = _JaxGivenNoise(np.random.default_rng(W.AS_SEED))
    d, _, _ = proj.construct_input_subspace()
    world4 = jobs["world4"].result()
    assert int(world4["as_js_rows"]) == W.AS_N // 2  # each rank its share
    assert bool(world4["as_sharded"])
    assert _rel(world4["as_d"], d) < 1e-8


# -- the 2-rank job --------------------------------------------------------------

@pytest.fixture
def world2(jobs):
    return jobs["world2"].result()

def test_two_rank_group(world2):
    assert bool(world2["no_group_raised"])  # DeviceCollective before a group
    assert bool(world2["multi"]) and bool(world2["repeat_init"])
    assert int(world2["size"]) == 2 and int(world2["rank"]) == 0


@pytest.mark.parametrize("key,want", [
    ("psum_mean", np.arange(12.0).reshape(4, 3).mean(0)),
    ("allreduce_avg", np.arange(12.0).reshape(4, 3).mean(0)),
    ("allreduce_sum", np.arange(12.0).reshape(4, 3).sum(0)),
    ("sample_mean", np.arange(12.0).reshape(4, 3).mean(0)),
    ("dtensor_mean", np.arange(12.0).reshape(4, 3).mean(0)),
    ("scalar_sum", 6.0), ("scalar_avg", 3.0),
    ("replicated_avg", np.arange(9.0).reshape(3, 3)),
    ("replicated_sum", 2 * np.arange(9.0).reshape(3, 3)),
    ("bcast", np.full(3, 8.0)),
    ("gathered", np.arange(10.0).reshape(5, 2)),
    ("multislice_shape", np.array([1, 2])),
])
def test_collectives_reduce_across_ranks(world2, key, want):
    """Cross-rank reductions of per-rank contributions (the JAX package's
    two-process pmean and its allReduce rules): real collectives, and
    'avg' / 'sum' of a replicated value are the identity / size times it."""
    np.testing.assert_allclose(world2[key], want, rtol=1e-15, atol=0)


def test_allreduce_refuses_nondivisible_and_sharding_checks(world2):
    assert int(world2["nondivisible_raised"]) == 2
    assert int(world2["shard_local_rows"]) == 2 and bool(world2["shard_consistent"])
    assert not bool(world2["wrong_axis"])
    assert bool(world2["plain_consistent"]) and bool(world2["plain_warned"])
    np.testing.assert_allclose(world2["collective_operator"],
                               world2["collective_operator_ref"], rtol=1e-12)


def test_failed_lanes_resampled_across_ranks(world2):
    """A failed lane on each rank: the ranks agree on them and draw the same
    replacements, so the split run keeps the serial run's samples."""
    assert int(world2["resample_split_failures"]) == 2
    assert int(world2["resample_serial_failures"]) == 2
    np.testing.assert_array_equal(world2["resample_split_it"],
                                  world2["resample_serial_it"])
    for key in ("ms", "us", "failed"):
        assert _rel(world2[f"resample_split_{key}"],
                    world2[f"resample_serial_{key}"]) < 1e-12


# -- the resumable files on 2 ranks ------------------------------------------------

def _svd_product(U, S, V):
    return np.einsum("nik,nk,njk->nij", U, S, V)


@pytest.mark.parametrize("kind", ["as", "pod"])
def test_resumable_files_written_by_rank_zero(world2, kind):
    """Rank 0 alone writes: rank 1's own directory is never made, rank 0's
    holds the bundle and no chunk directory; every rank returns the same
    arrays."""
    assert bool(world2[f"files_{kind}_ranks_equal"])
    assert world2[f"files_{kind}_dirs"].tolist() == [True, False]
    want = (["Jsvd_data.npz", "mq_m_data.npy", "mq_q_data.npy"] if kind == "as"
            else ["mq_data.npz"])
    assert world2[f"files_{kind}_listing"].tolist() == want


def test_two_rank_files_match_one_rank(world2):
    """m and q of the split run are the one-rank run's but for the last
    bits of the lanes a rank solved alone (another product shape); sigma
    and U diag(sigma) V^T to 1e-12 (U and V only up to signs)."""
    assert _rel(world2["files_pod2_m"], world2["files_pod1_m"]) < 1e-14
    assert _rel(world2["files_pod2_q"], world2["files_pod1_q"]) < 1e-14
    assert _rel(world2["files_as2_S"], world2["files_as1_S"]) < 1e-12
    two, one = ((world2[f"files_as{t}_{k}"] for k in "USV") for t in "21")
    assert _rel(_svd_product(*two), _svd_product(*one)) < 1e-12
    # the bundle holds what the call returned, and the samples it used
    np.testing.assert_array_equal(world2["files_jsvd_sigma_data"],
                                  world2["files_as2_S"])
    np.testing.assert_array_equal(world2["files_as_m_file"], world2["files_as_m"])


def test_resumed_files_equal_an_uninterrupted_run(world2):
    """From the first chunk of an uninterrupted run and a chunk of another
    grid (Jacobians), or a stale chunk past the first gap (POD): the
    finished chunk is not made again, and the bundles and returned arrays
    are the uninterrupted run's, bit for bit; a finished bundle is read,
    not made again."""
    made = world2["files_as_resumed_made"]
    assert made.size and (made[:, 0] >= W.FILES_CHUNK).all()
    assert world2["files_pod_resumed_chunks"].tolist() == [3, 2]
    for kind in ("as", "pod"):
        assert bool(world2[f"files_{kind}_resumed_equal"])
        assert bool(world2[f"files_{kind}_resumed_bundle_equal"])
    assert world2["files_as_resumed_listing"].tolist() == [
        "Jsvd_data.npz", "mq_m_data.npy", "mq_q_data.npy"]
    assert world2["files_pod_resumed_listing"].tolist() == ["mq_data.npz"]
    assert int(world2["files_pod_again_solved"]) == 0
    assert bool(world2["files_pod_again_equal"])


def test_two_rank_jacobian_bundle_matches_jax_serial(world2, tmp_path):
    """``Jsvd_data.npz`` of the 2-rank run against the JAX package's serial
    ``construct_low_rank_Jacobians`` on the same noise and chunks."""
    from applications.confusion import confusion_linear_observable, confusion_prior
    from hippyflow_tpu.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
    )

    obs, V = confusion_linear_observable(nx=W.AS_NX, velocity="analytic")
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = W.AS_RANK, W.AS_OVERSAMPLING
    params["samples_per_process"] = W.AS_N
    params["chunk_size"] = W.FILES_CHUNK
    params["jacobian_rank"] = W.FILES_JAC_RANK
    params["verbose"] = False
    proj = ActiveSubspaceProjector(obs, confusion_prior(V), parameters=params)
    proj.keychain = _JaxGivenNoise(np.random.default_rng(W.AS_SEED))
    proj.construct_low_rank_Jacobians(output_directory=str(tmp_path / "jax"))
    with np.load(tmp_path / "jax" / "Jsvd_data.npz") as z:
        want = {k: z[k] for k in z.files}
    got = {k: world2[f"files_jsvd_{k}"] for k in want}
    assert _rel(got["sigma_data"], want["sigma_data"]) < 1e-9
    assert _rel(_svd_product(got["U_data"], got["sigma_data"], got["V_data"]),
                _svd_product(want["U_data"], want["sigma_data"],
                             want["V_data"])) < 1e-9
