"""One gloo CPU rank of the port's multi-rank parallel tests
(``tests/test_torch_parallel_ranks.py``).  It imports the port only,
never JAX:

    python tests/_torch_parallel_worker.py CASES RANK WORLD STORE OUT

CASES is ``world4`` (a 4-rank job: (1, 4) and (2, 2) meshes) or ``world2``
(the collectives on 2 ranks, and the resumable Jacobian and POD files
written under a collective, in the STORE file's directory); STORE is the
file of the ``FileStore`` that the ranks meet at, and rank 0 writes every
result into OUT (npz).  The input generators here are shared with the test
module, which feeds the same numpy inputs to the JAX package.
"""

import contextlib
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F64 = dict(dtype=torch.float64, device="cpu")
HALO_CASES = ((16, 5, 4), (13, 4, 4), (9, 3, 2))  # nb, s, ranks on 'fem'
SPIKE_CASES = ((16, 5, 4), (13, 4, 4))
PRIOR_CASES = ((12, 4), (24, 2))  # nx, ranks on 'fem'
AS_NX, AS_N, AS_RANK, AS_OVERSAMPLING, AS_SEED = 12, 8, 8, 4, 3
RESAMPLE_NX = 8
# the resumable files: chunks of 3 of the AS_N = 8 samples ([0, 3), [3, 6),
# [6, 8)), split 2 + 1 and 1 + 1 over 2 ranks; Jacobian rank 5
FILES_CHUNK, FILES_JAC_RANK = 3, 5


def random_band(nb, s, seed=0):
    """(nb, s, 3s) block-diagonally dominant band, a_0 = b_{nb-1} = 0."""
    rng = np.random.default_rng(seed)
    band = rng.standard_normal((nb, s, 3 * s))
    band[:, :, s : 2 * s] += 6.0 * np.eye(s)
    band[0, :, :s] = 0.0
    band[-1, :, 2 * s :] = 0.0
    return band


def rhs(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


def poisson_settings(linear):
    from hippyflow_tpu_torch.testing import poisson_control_settings

    st = poisson_control_settings()
    st["nx"] = st["ny"] = 12
    st["LINEAR"] = linear
    return st


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


@contextlib.contextmanager
def world_one(store):
    """A one-rank gloo group meeting at the file ``store`` (or the group this
    process has already) and its (1, 1) ('sample', 'fem') mesh; the group
    made here is destroyed on exit."""
    import torch.distributed as dist

    from hippyflow_tpu_torch.parallel import make_sample_fem_mesh

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                                world_size=1)
    try:
        yield make_sample_fem_mesh(1, 1, device="cpu")
    finally:
        if made:
            dist.destroy_process_group()


def world4(out):
    """The dof-sharded layer on 4 ranks."""
    import hippyflow_tpu_torch as hft
    from hippyflow_tpu_torch.applications import confusion, helmholtz
    from hippyflow_tpu_torch.fem.assembly import (
        band_indices,
        p1_mass_elements,
        p1_stiffness_elements,
    )
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceParameterList,
        ActiveSubspaceProjector,
        StructuredBiLaplacianPrior,
    )
    from hippyflow_tpu_torch.models.prior import aniso_tensor_2d
    from hippyflow_tpu_torch.ops.structured import (
        block_tridiag_matmat,
        factorize_block_cyclic_banded,
    )
    from hippyflow_tpu_torch.parallel import (
        DeviceCollective,
        check_consistent_sharding,
        dist_block_tridiag_matmat,
        factorize_distributed_banded,
        make_sample_fem_mesh,
        place_on_mesh,
    )
    from hippyflow_tpu_torch.parallel.dist_banded import (
        dist_assemble_band,
        partition_cells_by_row,
    )
    from hippyflow_tpu_torch.utils import GivenNoise

    meshes = {4: make_sample_fem_mesh(1, 4), 2: make_sample_fem_mesh(2, 2)}

    for nb, s, P in HALO_CASES:
        band, X = _t(random_band(nb, s)), _t(rhs(nb * s, 3, 1))
        y = dist_block_tridiag_matmat(meshes[P], band, X)
        y1 = dist_block_tridiag_matmat(meshes[P], band, X[:, 0])
        serial = block_tridiag_matmat(band[None], X[None])[0]
        out[f"halo_{nb}_{s}"] = y.numpy()
        out[f"halo1_{nb}_{s}"] = y1.numpy()
        out[f"halo_exact_{nb}_{s}"] = (torch.equal(y, serial)
                                       and torch.equal(y1, serial[:, 0]))

    for nb, s, P in SPIKE_CASES:
        band, X = _t(random_band(nb, s)), _t(rhs(nb * s, 3, 2))
        sharded = factorize_distributed_banded(band, P, mesh=meshes[P])
        placed = place_on_mesh(factorize_distributed_banded(band, P), meshes[P])
        ref = factorize_block_cyclic_banded(band)
        for trans in (False, True):
            tag = f"{nb}_{s}_{int(trans)}"
            out[f"spike_{tag}"] = sharded.solve(X, trans=trans).numpy()
            out[f"spike_placed_{tag}"] = placed.solve(X, trans=trans).numpy()
            out[f"spike_cr_{tag}"] = ref.solve(X, trans=trans).numpy()

    # a batch of per-sample factors over the (2, 2) grid: samples on
    # 'sample', partitions on 'fem'
    bands = _t(np.stack([random_band(12, 5, seed=i) for i in range(2)]))
    Xs = _t(np.random.default_rng(9).standard_normal((2, 60, 3)))
    grid = place_on_mesh(factorize_distributed_banded(bands, 2), meshes[2],
                         axis="fem", sample_axis="sample")
    out["grid2d"] = grid.solve(Xs).numpy()

    # sharded assembly at nx=13 (nb = 14 rows on 4 ranks: 2 pad rows)
    V = hft.FunctionSpace(hft.unit_square_mesh(13))
    s = nb = 14
    cells = V.mesh.cells
    plan, _ = partition_cells_by_row((cells // s).min(axis=1), nb, 4)
    K_e = 0.1 * p1_stiffness_elements(V, aniso_tensor_2d(2.0, 0.5, np.pi / 4)) \
        + 1.0 * p1_mass_elements(V)
    band = dist_assemble_band(meshes[4], _t(K_e.reshape(len(cells), -1)),
                              torch.as_tensor(band_indices(V)), plan, nb, s)
    out["asm_K"] = band.full_tensor().numpy()
    out["asm_local_rows"] = band.to_local().shape[0]
    b = _t(rhs(V.dim, 2, 0))
    x = factorize_distributed_banded(band, 4, n_true=V.dim).solve(b)
    full = band.full_tensor()[:nb]
    out["asm_residual"] = float((block_tridiag_matmat(full[None], x[None])[0]
                                 - b).abs().max())

    for nx, P in PRIOR_CASES:
        V = hft.FunctionSpace(hft.unit_square_mesh(nx))
        prior = StructuredBiLaplacianPrior(V, 0.1, 1.0, robin_bc=True,
                                           mesh=meshes[P], **F64)
        out[f"prior{nx}_sample"] = prior.sample(_t(rhs(3, V.dim, 3))).numpy()
        X = _t(rhs(V.dim, 4, 4))
        for op in ("Rsolver_matmat", "R_matmat", "M_matmat", "Msolver_matmat",
                   "sqrtM_matmat"):
            out[f"prior{nx}_{op}"] = getattr(prior, op)(X).numpy()

    # dof-sharded Newton and incremental solves: the Poisson control
    # problem at nx=12 on 4 'fem' ranks
    from hippyflow_tpu_torch.testing import setup_poisson_control_problem

    for linear in (True, False):
        st = poisson_settings(linear)
        pde, prior, _, V = setup_poisson_control_problem(
            st, solver="dist_banded", dist_mesh=meshes[4], dist_axis="fem", **F64)
        tag = f"poisson{int(linear)}"
        m = prior.sample(_t(rhs(2, V.dim, 5)))
        z = _t(np.random.default_rng(6).uniform(-1.0, 1.0, (2, 25)))
        u, info = pde.solve_fwd(m, z)
        lin = pde.linearize(u, m, z)
        r = _t(np.random.default_rng(7).standard_normal((2, V.dim, 3)))
        out.update({f"{tag}_m": m.numpy(), f"{tag}_z": z.numpy(),
                    f"{tag}_u": u.numpy(), f"{tag}_it": info.iterations.numpy(),
                    f"{tag}_converged": info.converged.numpy(),
                    f"{tag}_rhs": r.numpy()})
        for adj in (False, True):
            out[f"{tag}_inc{int(adj)}"] = pde.solve_incremental(
                lin, r, is_adj=adj).numpy()

    # the helmholtz P2 split-complex state (the ordered band) at nx=12
    obs, V = helmholtz.helmholtz_linear_observable(
        nx=12, frequency=150.0, solver="dist_banded", dist_mesh=meshes[4],
        dist_axis="fem", **F64)
    pde = obs.problem
    m = 0.1 * _t(rhs(1, V.dim, 10))
    u, info = pde.solve_fwd(m)
    lin = pde.linearize(u, m)
    r = _t(np.random.default_rng(11).standard_normal((1, pde.state_dim, 3)))
    out.update({"helm_m": m.numpy(), "helm_u": u.numpy(), "helm_rhs": r.numpy(),
                "helm_converged": info.converged.numpy(),
                "helm_ordered": pde._band_order is not None})
    for adj in (False, True):
        out[f"helm_inc{int(adj)}"] = pde.solve_incremental(lin, r,
                                                           is_adj=adj).numpy()

    # the active subspace over the full (2, 2) grid: samples split over
    # 'sample', each solve's band over 'fem'
    obs, V = confusion.confusion_linear_observable(
        nx=AS_NX, velocity="analytic", solver="dist_banded",
        dist_mesh=meshes[2], dist_axis="fem", **F64)
    coll = DeviceCollective(meshes[2], axis="sample")
    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = AS_RANK, AS_OVERSAMPLING
    params["samples_per_process"] = params["chunk_size"] = AS_N
    params["verbose"] = False
    proj = ActiveSubspaceProjector(obs, confusion.confusion_prior(V, **F64),
                                   parameters=params, collective=coll)
    proj.keychain = GivenNoise(np.random.default_rng(AS_SEED), "cpu")
    d, _, _ = proj.construct_input_subspace()
    out["as_d"] = d.numpy()
    out["as_js_rows"] = proj.Js.shape[0]
    out["as_sharded"] = check_consistent_sharding(
        coll.shard_samples(proj.samples.ms))


def files_as_params():
    from hippyflow_tpu_torch.models import ActiveSubspaceParameterList

    params = ActiveSubspaceParameterList()
    params["rank"], params["oversampling"] = AS_RANK, AS_OVERSAMPLING
    params["samples_per_process"] = AS_N
    params["chunk_size"], params["jacobian_rank"] = FILES_CHUNK, FILES_JAC_RANK
    params["verbose"] = False
    return params


def _same_on_every_rank(arrays):
    """True on rank 0 when every rank's arrays equal its own, bit for bit."""
    mine = [np.asarray(a) for a in arrays]
    return all(len(o) == len(mine) and all(np.array_equal(x, y)
                                           for x, y in zip(o, mine))
               for o in _every_rank(mine))


def _every_rank(value):
    """[each rank's value], in rank order."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, value)
    return every


def _bundle(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def resumable_files(out, coll, workdir):
    """``construct_low_rank_Jacobians(output_directory=...)`` and
    ``PODProjector.generate_training_data`` under the 2-rank collective:
    each rank is given a directory of its own, so only rank 0's may hold
    files; against one-rank runs; and resumed from partial chunks (a
    directory both ranks name, which rank 0 alone reads)."""
    import torch.distributed as dist

    from hippyflow_tpu_torch.applications import confusion
    from hippyflow_tpu_torch.models import (
        ActiveSubspaceProjector,
        PODParameterList,
        PODProjector,
    )
    from hippyflow_tpu_torch.models import pod as pod_module
    from hippyflow_tpu_torch.utils import GivenNoise

    rank = dist.get_rank()
    obs, V = confusion.confusion_linear_observable(
        nx=AS_NX, velocity="analytic", **F64)
    prior = confusion.confusion_prior(V, **F64)
    own = lambda tag: os.path.join(workdir, f"{tag}_rank{rank}")

    def as_run(c, outdir, subspace=False):
        proj = ActiveSubspaceProjector(obs, prior, parameters=files_as_params(),
                                       collective=c)
        proj.keychain = GivenNoise(np.random.default_rng(AS_SEED), "cpu")
        if subspace:  # the build's Jacobians: each rank holds its share
            proj.construct_input_subspace()
        made = []  # the sample ranges whose Jacobians this rank made
        inner = proj._chunk_jacobians

        def counted(lo, hi, control):
            made.append((lo, hi))
            return inner(lo, hi, control)

        proj._chunk_jacobians = counted
        U, sig, Vm = proj.construct_low_rank_Jacobians(output_directory=outdir)
        return proj, (U.numpy(), sig.numpy(), Vm.numpy()), made

    proj2, as2, _ = as_run(coll, own("as2"), subspace=True)
    _, as1, _ = as_run(None, own("as1"))
    out["files_as_ranks_equal"] = _same_on_every_rank(as2)
    out["files_as_dirs"] = _every_rank(os.path.isdir(own("as2")))
    out["files_as_m"] = proj2.samples.ms.numpy()
    for tag, arrays in (("2", as2), ("1", as1)):
        out.update({f"files_as{tag}_{k}": v for k, v in zip("USV", arrays)})
    if rank == 0:
        b2 = _bundle(os.path.join(own("as2"), "Jsvd_data.npz"))
        out.update({f"files_jsvd_{k}": v for k, v in b2.items()})
        out["files_as_listing"] = np.array(sorted(os.listdir(own("as2"))))
        out["files_as_m_file"] = np.load(os.path.join(own("as2"), "mq_m_data.npy"))
    # resume: rank 0 leaves the first chunk of the uninterrupted run and a
    # chunk of another grid, as a killed run would
    resume = os.path.join(workdir, "as_resume")
    if rank == 0:
        os.makedirs(os.path.join(resume, "chunks"))
        np.savez(os.path.join(resume, "chunks", "chunk_0_3.npz"),
                 **{k: v[:3] for k, v in b2.items()})
        np.savez(os.path.join(resume, "chunks", "chunk_3_5.npz"),
                 U_data=np.zeros(1), sigma_data=np.zeros(1), V_data=np.zeros(1))
    dist.barrier()
    _, asr, made = as_run(coll, resume)
    out["files_as_resumed_made"] = np.array(made)
    out["files_as_resumed_equal"] = _same_on_every_rank(asr) and all(
        np.array_equal(x, y) for x, y in zip(asr, as2))
    if rank == 0:
        br = _bundle(os.path.join(resume, "Jsvd_data.npz"))
        out["files_as_resumed_bundle_equal"] = all(
            np.array_equal(br[k], b2[k]) for k in b2)
        out["files_as_resumed_listing"] = np.array(sorted(os.listdir(resume)))

    # POD training data: the same, with a stale chunk past the first gap
    calls = []  # the sizes of the chunks this rank solved
    inner_sample = pod_module.sample_until_solved

    def counted_sample(*args, **kwargs):
        calls.append(args[3])
        return inner_sample(*args, **kwargs)

    pod_module.sample_until_solved = counted_sample
    try:
        params = PODParameterList()
        params["chunk_size"], params["verbose"] = FILES_CHUNK, False

        def pod_run(c, outdir):
            pod = PODProjector(obs, prior, parameters=params, collective=c)
            return pod.generate_training_data(outdir, n_data=AS_N)

        mq2 = pod_run(coll, own("pod2"))
        mq1 = pod_run(None, own("pod1"))
        out["files_pod_ranks_equal"] = _same_on_every_rank(mq2)
        out["files_pod_dirs"] = _every_rank(os.path.isdir(own("pod2")))
        out["files_pod2_m"], out["files_pod2_q"] = mq2
        out["files_pod1_m"], out["files_pod1_q"] = mq1
        resume = os.path.join(workdir, "pod_resume")
        if rank == 0:
            p2 = _bundle(os.path.join(own("pod2"), "mq_data.npz"))
            out["files_pod_listing"] = np.array(sorted(os.listdir(own("pod2"))))
            os.makedirs(os.path.join(resume, "chunks_pod"))
            np.savez(os.path.join(resume, "chunks_pod", "chunk_0_3.npz"),
                     m_data=p2["m_data"][:3], q_data=p2["q_data"][:3])
            np.savez(os.path.join(resume, "chunks_pod", "chunk_6_8.npz"),
                     m_data=np.zeros((2, 1)), q_data=np.zeros((2, 1)))
        dist.barrier()
        calls.clear()
        mqr = pod_run(coll, resume)
        out["files_pod_resumed_chunks"] = np.array(calls)
        out["files_pod_resumed_equal"] = _same_on_every_rank(mqr) and all(
            np.array_equal(x, y) for x, y in zip(mqr, mq2))
        if rank == 0:
            pr = _bundle(os.path.join(resume, "mq_data.npz"))
            out["files_pod_resumed_bundle_equal"] = all(
                np.array_equal(pr[k], p2[k]) for k in p2)
            out["files_pod_resumed_listing"] = np.array(sorted(os.listdir(resume)))
        # a finished bundle: every rank gets its arrays, nothing is solved
        calls.clear()
        again = pod_run(coll, resume)
        out["files_pod_again_solved"] = len(calls)
        out["files_pod_again_equal"] = _same_on_every_rank(again) and all(
            np.array_equal(x, y) for x, y in zip(again, mq2))
    finally:
        pod_module.sample_until_solved = inner_sample


def world2(out, workdir):
    """The collectives on 2 ranks (the JAX package's two-process test and
    the allReduce rules), and the resumable files under them."""
    import warnings

    import torch.distributed as dist

    from hippyflow_tpu_torch.applications import confusion
    from hippyflow_tpu_torch.models.sampling import sample_until_solved
    from hippyflow_tpu_torch.parallel import (
        CollectiveOperator,
        DeviceCollective,
        check_consistent_sharding,
        initialize_distributed,
        make_multislice_mesh,
    )
    from hippyflow_tpu_torch.utils import GivenNoise

    rank = dist.get_rank()
    out["repeat_init"] = initialize_distributed()  # a no-op: True (2 ranks)
    coll = DeviceCollective()
    out["size"], out["rank"] = coll.size(), coll.rank()
    n = 2 * coll.size()
    base = torch.arange(n * 3, dtype=torch.float64).reshape(n, 3)
    out["psum_mean"] = coll.psum_contributions(base, mean=True).numpy()
    out["allreduce_sum"] = coll.allReduce(base, "sum").numpy()
    out["allreduce_avg"] = coll.allReduce(base, "avg").numpy()
    out["sample_mean"] = coll.sample_mean(base).numpy()
    out["scalar_sum"], out["scalar_avg"] = (coll.allReduce(3.0, "sum"),
                                            coll.allReduce(3.0, "avg"))
    odd = torch.arange(9, dtype=torch.float64).reshape(3, 3)
    raised = 0
    for op in ("avg", "sum"):
        try:
            coll.allReduce(odd, op)
        except ValueError as e:
            raised += "not divisible" in str(e)
    out["nondivisible_raised"] = raised
    out["replicated_avg"] = coll.allReduce(odd, "avg", replicated=True).numpy()
    out["replicated_sum"] = coll.allReduce(odd, "sum", replicated=True).numpy()
    # a sharded DTensor reduces its local slices
    xs = coll.shard_samples(base)
    out["shard_local_rows"] = xs.to_local().shape[0]
    out["shard_consistent"] = check_consistent_sharding(xs)
    out["dtensor_mean"] = coll.sample_mean(xs).numpy()
    out["bcast"] = coll.bcast(torch.full((3,), float(rank + 7)), root=1).numpy()
    # per-contribution operator (reference collectiveOperator.py:14-55)
    A = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 6, 6)))
    X = torch.as_tensor(np.random.default_rng(1).standard_normal((6, 4)))
    op = CollectiveOperator(lambda Y: torch.einsum("sij,jk->sik", A, Y), coll)
    out["collective_operator"] = op.matmat(X).numpy()
    out["collective_operator_ref"] = (A.mean(0) @ X).numpy()
    # uneven shares of 5 rows: 3 and 2
    rows = torch.arange(10, dtype=torch.float64).reshape(5, 2)
    out["gathered"] = coll.gather_samples(rows[coll.local_slice(5)], 5).numpy()
    # a (1, 2) multislice mesh, and a tensor sharded on the wrong axis
    mesh = make_multislice_mesh(n_fem=2)
    out["multislice_shape"] = np.array([mesh.size(0), mesh.size(1)])
    fem = DeviceCollective(mesh, axis="fem")
    wrong = fem.shard_samples(base)
    out["wrong_axis"] = check_consistent_sharding(wrong, expected_axis="sample")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out["plain_consistent"] = check_consistent_sharding(base)
        out["plain_warned"] = any("not mesh-sharded" in str(x.message) for x in w)

    # failed lanes on both ranks: the ranks agree on them, and the split
    # run gives the serial run's samples
    obs, V = confusion.confusion_linear_observable(
        nx=RESAMPLE_NX, velocity="analytic", newton_max_iter=7, **F64)
    prior = confusion.confusion_prior(V, **F64)
    xi = np.random.default_rng(0).standard_normal((4, V.dim))
    xi[1] *= 40.0  # rough draws whose Newton solves need more than 7 steps
    xi[3] *= 40.0
    runs = {}
    for name, c in (("split", coll), ("serial", None)):
        runs[name] = sample_until_solved(
            obs, prior, GivenNoise(np.random.default_rng(5), "cpu"), 4,
            chunk_size=4, noise=_t(xi), reset_initial_guess=True, collective=c)
    for name, b in runs.items():
        out[f"resample_{name}_ms"] = b.ms.numpy()
        out[f"resample_{name}_us"] = b.us.numpy()
        out[f"resample_{name}_it"] = b.iterations.numpy()
        out[f"resample_{name}_failures"] = b.n_failures
        out[f"resample_{name}_failed"] = b.failed_ms

    resumable_files(out, coll, workdir)


def main(argv):
    cases, rank, world, store, dest = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from hippyflow_tpu_torch.parallel import DeviceCollective, initialize_distributed

    out = {}
    try:
        DeviceCollective()
    except RuntimeError as e:  # no process group yet
        out["no_group_raised"] = "initialize_distributed" in str(e)
    out["multi"] = initialize_distributed(f"file://{store}", world, rank,
                                          device="cpu")
    if cases == "world4":
        world4(out)
    else:
        world2(out, os.path.dirname(store))
    import torch.distributed as dist

    dist.barrier()
    if rank == 0:
        np.savez(dest, **{k: np.asarray(v) for k, v in out.items()
                          if v is not None})
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
