"""The port's parallel layer in one process, against the JAX package in
float64 on the CPU, on the same numpy inputs:

* the unplaced partitioned SPIKE factor (every partition on one device)
  at the JAX package's own shapes, forward and transposed, one band and a
  batch, 1e-12; its spikes and reduced system, both directions, at a
  block-row count the partition count does not divide ((13, 4, 4) and the
  structured prior's K band at nx=13), 1e-12; the identity padding and
  the assembly plan, exactly;
* ``NullCollective``, and on a one-rank gloo group: ``DeviceCollective``'s
  scalar, replicated and per-contribution rules, ``check_consistent_sharding``
  on DTensors sharded on the expected axis, on another, replicated and
  unsharded, the meshes, ``place_on_mesh`` with a sample axis, and the
  active subspace, POD and KLE with a one-rank collective against the
  serial runs (the exchanges between ranks:
  ``tests/test_torch_parallel_ranks.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from hippyflow_tpu_torch.parallel import (
    DeviceCollective,
    NullCollective,
    check_consistent_sharding,
    factorize_distributed_banded,
    initialize_distributed,
    make_multislice_mesh,
    make_sample_fem_mesh,
    place_on_mesh,
)
from hippyflow_tpu_torch.parallel import dist_banded as tdb

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the unplaced SPIKE factor ------------------------------------------------------

@pytest.mark.parametrize("nb,s,n_parts", W.HALO_CASES)
def test_unplaced_spike_matches_jax(nb, s, n_parts):
    from hippyflow_tpu.parallel import factorize_distributed_banded as jfac

    band, X = W.random_band(nb, s), W.rhs(nb * s, 3, 2)
    F = factorize_distributed_banded(_t(band), n_parts)
    for trans in (False, True):
        want = jax.jit(lambda b, x: jfac(b, n_parts).solve(x, trans=trans))(
            jnp.asarray(band), jnp.asarray(X))
        assert _rel(F.solve(_t(X), trans=trans), want) < 1e-12
        assert _rel(F.solve(_t(X[:, 0]), trans=trans), want[:, 0]) < 1e-12


def test_unplaced_spike_batch_matches_jax():
    """A batch of 3 bands (the leading sample axis where JAX vmaps)."""
    from hippyflow_tpu.parallel import factorize_distributed_banded as jfac

    bands = np.stack([W.random_band(13, 4, seed=i) for i in range(3)])
    X = np.random.default_rng(4).standard_normal((3, 52, 2))
    F = factorize_distributed_banded(_t(bands), 4)
    for trans in (False, True):
        want = jax.jit(jax.vmap(lambda b, x: jfac(b, 4).solve(x, trans=trans)))(
            jnp.asarray(bands), jnp.asarray(X))
        assert _rel(F.solve(_t(X), trans=trans), want) < 1e-12


def _structured_k_band():
    import hippyflow_tpu_torch as hft
    from hippyflow_tpu_torch.models import StructuredBiLaplacianPrior

    V = hft.FunctionSpace(hft.unit_square_mesh(13))
    return StructuredBiLaplacianPrior(V, 0.1, 1.0, robin_bc=True, **F64).K_band


@pytest.mark.parametrize("case", ["random_13_4", "prior_K_nx13"])
def test_spikes_and_reduced_system_match_jax(case):
    """Both directions' spikes W, V and reduced systems R (the JAX package
    keeps R's LU; R = P L U here), with nb not a multiple of P: the
    transposed band's couplings land in the right rows."""
    from hippyflow_tpu.parallel import factorize_distributed_banded as jfac

    band = (_t(W.random_band(13, 4)) if case == "random_13_4"
            else _structured_k_band())
    P = 4
    F = factorize_distributed_banded(band, P)
    J = jax.jit(lambda b: jfac(b, P))(jnp.asarray(band.numpy()))
    for side, jside in ((F.fwd, J.fwd), (F.adj, J.adj)):
        assert _rel(side.W, jside.W) < 1e-12 and _rel(side.V, jside.V) < 1e-12
        lu, piv = (np.asarray(x) for x in (jside.R_lu, jside.R_piv))
        n = lu.shape[0]
        R = np.tril(lu, -1) + np.eye(n)
        R = R @ np.triu(lu)
        perm = np.arange(n)
        for i, p in enumerate(piv):
            perm[[i, p]] = perm[[p, i]]
        want = np.empty_like(R)
        want[perm] = R
        got = torch.linalg.lu_solve(side.R.lu, side.R.piv,
                                    torch.eye(n, **F64)).numpy()
        assert _rel(np.linalg.inv(got), want) < 1e-12


def test_padding_and_assembly_plan_match_jax():
    import hippyflow_tpu_torch as hft
    from hippyflow_tpu.parallel import dist_banded as jdb

    band = W.random_band(13, 4)
    got, nb_pad = tdb._pad_band(_t(band), 4)
    want, jnb = jdb._pad_band(jnp.asarray(band), 4)
    assert nb_pad == jnb == 16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cells = hft.unit_square_mesh(13).cells
    rows = (cells // 14).min(axis=1)
    for P in (2, 3, 4):
        ids, L = tdb.partition_cells_by_row(rows, 14, P)
        jids, jL = jdb.partition_cells_by_row(rows, 14, P)
        assert L == jL
        np.testing.assert_array_equal(ids, jids)


def test_transpose_needs_its_factor():
    F = factorize_distributed_banded(_t(W.random_band(9, 3)), 3,
                                     with_transpose=False)
    with pytest.raises(ValueError, match="with_transpose"):
        F.solve(_t(W.rhs(27, 1, 0)), trans=True)


# -- collectives ------------------------------------------------------------------

def test_null_collective_is_the_identity():
    c = NullCollective()
    x = torch.arange(6.0).reshape(3, 2)
    assert c.size() == 1 and c.rank() == 0
    assert c.allReduce(x, "sum") is x and c.bcast(x) is x
    assert c.shard_samples(x) is x and c.sum_partials(x) is x
    assert c.local_slice(3) == slice(0, 3) and c.gather_samples(x, 3) is x
    assert torch.equal(c.sample_mean(x), x.mean(0))
    with pytest.raises(ValueError, match="avg"):
        c.allReduce(x, "max")


@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    with W.world_one(tmp_path_factory.mktemp("group") / "store") as mesh:
        yield mesh


def test_one_rank_collective_rules(mesh11):
    assert initialize_distributed() is False  # the group exists: a no-op
    c = DeviceCollective(mesh11, axis="sample")
    assert (c.size(), c.rank(), c.axis_rank()) == (1, 0, 0)
    v = torch.arange(12.0, dtype=torch.float64).reshape(4, 3)
    assert c.allReduce(3.0, "sum") == 3.0 and c.allReduce(3.0, "avg") == 3.0
    assert torch.equal(c.allReduce(v, "sum"), v.sum(0))
    assert torch.equal(c.allReduce(v, "avg"), v.mean(0))
    assert torch.equal(c.allReduce(v, "sum", replicated=True), v)
    assert torch.equal(c.psum_contributions(c.shard_samples(v), mean=True),
                       v.mean(0))
    assert torch.equal(c.bcast(v), v) and torch.equal(c.gather_samples(v, 4), v)
    with pytest.raises(ValueError, match="avg"):
        c.allReduce(v, "max")
    with pytest.raises(ValueError, match="axis"):
        DeviceCollective(mesh11, axis="rows")


def test_io_gate_spans_the_world(mesh11, monkeypatch):
    """The resumable files' I/O gate: rank 0's object and tensors on every
    rank (the identity without a group and on one rank), and a refusal
    where the mesh does not cover every process, which would deadlock."""
    from hippyflow_tpu_torch.parallel import collective as tcoll

    x = {"a": torch.arange(6.0).reshape(3, 2), "b": torch.arange(3)}
    null = NullCollective()
    assert null.bcast_io([(0, 3)]) == [(0, 3)] and null.bcast_io_tensors(x) is x
    null.barrier()
    c = DeviceCollective(mesh11, axis="sample")
    assert c.bcast_io({"start": 3}) == {"start": 3}
    got = c.bcast_io_tensors(x)
    assert set(got) == {"a", "b"} and all(torch.equal(got[k], x[k]) for k in x)
    c.barrier()
    monkeypatch.setattr(tcoll.dist, "get_world_size", lambda *a, **k: 2)
    for call in (lambda: c.bcast_io(1), lambda: c.bcast_io_tensors(x), c.barrier):
        with pytest.raises(RuntimeError, match="I/O gate"):
            call()


def test_check_consistent_sharding(mesh11):
    """False on a leading axis sharded over another mesh axis; True with a
    warning on replicated or unsharded tensors."""
    from torch.distributed.tensor import DTensor, Replicate

    x = torch.arange(32.0).reshape(8, 4)
    assert check_consistent_sharding(DeviceCollective(mesh11).shard_samples(x))
    wrong = DeviceCollective(mesh11, axis="fem").shard_samples(x)
    assert not check_consistent_sharding(wrong, expected_axis="sample")
    for t, msg in ((x, "not mesh-sharded"),
                   (DTensor.from_local(x, mesh11, [Replicate(), Replicate()]),
                    "replicated")):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert check_consistent_sharding(t)
            assert any(msg in str(m.message) for m in w)


def test_meshes(mesh11):
    assert mesh11.mesh_dim_names == ("sample", "fem")
    m = make_multislice_mesh(n_fem=1)
    assert (m.size(0), m.size(1)) == (1, 1)
    with pytest.raises(ValueError, match="ranks"):
        make_sample_fem_mesh(2, 1)


def test_place_on_one_rank_mesh(mesh11):
    """Placed with a sample axis on the (1, 1) mesh: the unplaced solves;
    a placed factor is not placed again."""
    bands = _t(np.stack([W.random_band(12, 5, seed=i) for i in range(2)]))
    X = _t(np.random.default_rng(9).standard_normal((2, 60, 3)))
    F = factorize_distributed_banded(bands, 2)
    placed = place_on_mesh(F, mesh11, sample_axis="sample")
    for trans in (False, True):
        assert torch.equal(placed.solve(X, trans=trans), F.solve(X, trans=trans))
    with pytest.raises(ValueError, match="placed"):
        place_on_mesh(placed, mesh11)


def _confusion(nx=8):
    from hippyflow_tpu_torch.applications import confusion

    obs, V = confusion.confusion_linear_observable(nx=nx, velocity="analytic",
                                                   **F64)
    return obs, confusion.confusion_prior(V, **F64)


def test_one_rank_collective_projectors_match_serial(mesh11):
    """The active subspace (materialized and serialized), POD and KLE with
    a one-rank DeviceCollective: the serial runs' spectra and errors (the
    sample split, the gathers and the all-reduce are the identity here)."""
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
        KLEProjector,
        PODParameterList,
        PODProjector,
    )

    obs, prior = _confusion()
    coll = DeviceCollective(mesh11)
    for serialized in (False, True):
        runs = []
        for c in (None, coll):
            p = ActiveSubspaceParameterList()
            p["rank"], p["oversampling"], p["verbose"] = 6, 4, False
            p["samples_per_process"], p["serialized_sampling"] = 8, serialized
            proj = ActiveSubspaceProjector(obs, prior, parameters=p, collective=c)
            d, _, _ = proj.construct_input_subspace()
            errs = proj.test_errors_double_loop(ranks=(2, 6), n_samples=3,
                                                double_loop_samples=2)
            runs.append((d, errs))
        assert _rel(runs[1][0], runs[0][0]) < 1e-12
        for key in runs[0][1]:
            np.testing.assert_allclose(runs[1][1][key], runs[0][1][key],
                                       rtol=1e-12)
    pods = []
    for c in (None, coll):
        p = PODParameterList()
        p["sample_per_process"], p["rank"], p["verbose"] = 8, 6, False
        pod = PODProjector(obs, prior, parameters=p, collective=c)
        d, _, _ = pod.construct_subspace()
        pods.append((d, pod.test_output_errors(ranks=(2, 4))))
    assert _rel(pods[1][0], pods[0][0]) < 1e-12
    np.testing.assert_allclose(pods[1][1], pods[0][1], rtol=1e-12)
    kle = KLEProjector(prior, collective=coll)
    assert kle.collective is coll
    assert KLEProjector(prior).collective.size() == 1
