"""Sample-parallel collectives over a ``torch.distributed`` device mesh.

Port of ``hippyflow_tpu/parallel/collective.py``.  The JAX package runs
one program over a ``jax.sharding.Mesh`` with named axes ('sample',
'fem'); an array sharded over an axis is one global array whose slices
live on that axis's devices.  PyTorch runs one process per rank (SPMD), so
the mapping is:

* the mesh -> a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names=("sample", "fem")`` (``make_sample_fem_mesh``);
* an array sharded over an axis -> a ``DTensor`` with a ``Shard(0)``
  placement on that mesh dimension (``DeviceCollective.shard_samples``),
  whose local tensor is the rank's contiguous share of the leading axis
  (``torch.chunk``'s split);
* ``lax.psum`` over the axis -> ``dist.all_reduce`` on
  ``mesh.get_group(axis)`` (``DeviceCollective.sum_partials``).

Every rank runs the same program on the same seed, so a global input built
from a seeded stream (noise, the probe block Omega) is identical on every
rank, and a rank takes its share of it without communication.

``NullCollective`` is the serial test double of the reference
(`collectives/collective.py:19-38`); its ``local_slice``,
``sum_partials`` and ``gather_samples`` are the identity, so serial code
and rank-local code are one code path.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist


def _mesh_device_type() -> str:
    """The DeviceMesh device type of the process group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Create the process group every mesh and collective here spans.

    The JAX package's ``jax.distributed.initialize`` analog.  A group is
    made when ``coordinator_address`` is given ("host:port", or an
    ``init_method`` URL such as ``tcp://...`` or ``file://...``, with
    ``num_processes`` and ``process_id``), when torchrun's environment is
    set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), or when
    ``HIPPYFLOW_TPU_DISTRIBUTED=1`` (the same ``env://`` variables).  The
    backend is NCCL, one card per rank (``LOCAL_RANK``, else the rank
    modulo the card count); gloo only when ``device`` names the CPU.  A
    group that exists already is kept (a repeated call does nothing).

    Returns True when more than one process runs after the call."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    torchrun = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if (coordinator_address is None and not torchrun
            and env.get("HIPPYFLOW_TPU_DISTRIBUTED") != "1"):
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize_distributed: the NCCL backend needs a CUDA card; "
            'pass device="cpu" for gloo CPU ranks')
    if coordinator_address is None:
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    if not cpu:
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method,
                            rank=rank, world_size=world)
    return world > 1


def _shares(n: int, size: int):
    """Contiguous shares of n rows over size ranks, ``torch.chunk``'s
    split (each ceil(n / size) rows, the last ones shorter or empty):
    the (start, stop) of every rank."""
    c = -(-n // size) if n else 0
    return [(min(r * c, n), min((r + 1) * c, n)) for r in range(size)]


class NullCollective:
    """Serial no-op collective (reference parity)."""

    def size(self) -> int:
        return 1

    def rank(self) -> int:
        return 0

    def allReduce(self, v, op: str = "avg", replicated: bool | None = None):
        if op not in ("sum", "avg"):
            raise ValueError(f"op={op!r}: 'sum' or 'avg'")
        return v

    def bcast(self, v, root: int = 0):
        return v

    def shard_samples(self, x):
        return x

    def sample_mean(self, x, axis: int = 0):
        return x.mean(dim=axis)

    def local_slice(self, n: int) -> slice:
        """The rows of an n-row sample axis this process holds: all."""
        return slice(0, n)

    def sum_partials(self, x):
        """The sum over processes of each one's partial sum: x itself."""
        return x

    def gather_samples(self, x, n: int):
        """Every process's share of an n-row sample axis, in order: x."""
        return x

    def bcast_io(self, obj):
        """The I/O rank's object on every process: obj itself."""
        return obj

    def bcast_io_tensors(self, tensors):
        """The I/O rank's tensors on every process: ``tensors`` itself."""
        return tensors

    def barrier(self) -> None:
        """Wait for every process: nothing to wait for."""


class DeviceCollective:
    """Collective over one axis of a device mesh.

    A per-rank contribution is the rank's share of an array whose leading
    axis is sharded over the mesh axis; the reductions are real
    collectives on the axis's process group (``dist.all_reduce``), the
    analog of the reference's ``MPI.Allreduce``
    (`collectives/collective.py:61-71`).  Without a ``mesh`` it builds a
    one-axis 'sample' mesh over the whole group.  It needs a process group
    (``initialize_distributed``) and raises without one."""

    def __init__(self, mesh=None, axis: str = "sample"):
        if not dist.is_initialized():
            raise RuntimeError(
                "DeviceCollective needs a process group: call "
                "initialize_distributed() first")
        if mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh(_mesh_device_type(),
                                    (dist.get_world_size(),),
                                    mesh_dim_names=("sample",))
        if axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"axis {axis!r} is not a dimension of the mesh "
                             f"{mesh.mesh_dim_names}")
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)

    def size(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))

    def rank(self) -> int:
        """The process's global rank, as the reference uses ``comm.rank``:
        to gate I/O and logging to one writer, not to split data (the
        sample axis does that)."""
        return dist.get_rank()

    def axis_rank(self) -> int:
        """This rank's position along the collective's mesh axis."""
        return self.mesh.get_local_rank(self.axis)

    # --- the rank's share and the reductions --------------------------------
    def local_slice(self, n: int) -> slice:
        """The rows of an n-row sample axis this rank holds (contiguous,
        ``torch.chunk``'s split)."""
        return slice(*_shares(n, self.size())[self.axis_rank()])

    def sum_partials(self, x):
        """The sum over the axis's ranks of each rank's partial sum x (a
        tensor of the same shape on every rank), replicated: one
        ``all_reduce``."""
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def gather_samples(self, x, n: int):
        """The n-row array whose rows ``local_slice(n)`` this rank holds as
        x, gathered from every rank of the axis in order (one
        ``all_gather`` of shares padded to the longest)."""
        shares = _shares(n, self.size())
        width = shares[0][1] - shares[0][0]
        pad = x.new_zeros((width - x.shape[0],) + tuple(x.shape[1:]))
        part = torch.cat([x, pad]).contiguous()
        buf = [torch.empty_like(part) for _ in shares]
        dist.all_gather(buf, part, group=self.group)
        return torch.cat([b[: hi - lo] for b, (lo, hi) in zip(buf, shares)])

    # --- the I/O gate: the whole world -------------------------------------
    # The resumable files are read and written by global rank 0 alone
    # (``rank()``), and every process must take part in handing out what it
    # read, so these three span the default (world) group, not the axis's.
    def _check_world(self) -> None:
        if self.mesh.size() != dist.get_world_size():
            raise RuntimeError(
                f"the I/O gate spans every process, but the mesh covers "
                f"{self.mesh.size()} of {dist.get_world_size()}")

    def bcast_io(self, obj):
        """Global rank 0's small picklable object (a resume plan) on every
        process of the world: one ``broadcast_object_list``; what the other
        processes pass is ignored."""
        self._check_world()
        box = [obj if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def bcast_io_tensors(self, tensors):
        """Global rank 0's tensors (a dict name -> tensor; what the other
        processes pass is ignored) on every process of the world, on the
        process group's device: one ``broadcast_object_list`` of their
        names, shapes and dtypes, then one ``dist.broadcast`` each."""
        root = dist.get_rank() == 0
        meta = self.bcast_io({k: (tuple(v.shape), v.dtype)
                              for k, v in tensors.items()} if root else None)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if _mesh_device_type() == "cuda" else torch.device("cpu"))
        out = {}
        for k, (shape, dtype) in meta.items():
            t = (tensors[k].to(device).contiguous() if root
                 else torch.empty(shape, dtype=dtype, device=device))
            dist.broadcast(t, src=0)
            out[k] = t
        return out

    def barrier(self) -> None:
        """Wait for every process of the world (after a write of the I/O
        rank, before any process reads or returns)."""
        self._check_world()
        dist.barrier()

    def _divisible(self, x) -> bool:
        return np.ndim(x) >= 1 and x.shape[0] % self.size() == 0

    def psum_contributions(self, v, mean: bool = False):
        """Reduce per-rank contributions over the axis: v has one leading
        slice per contribution, either as a ``DTensor`` sharded on the axis
        (each rank sums its local slices) or as the global tensor that every
        rank holds (each rank sums its share); the partial sums meet in one
        ``all_reduce``.  Returns the sum (or the mean) over the leading
        axis, replicated."""
        if _is_dtensor(v):
            if not check_consistent_sharding(v, self.axis, warn_unsharded=False):
                raise ValueError(f"the leading axis is not sharded on "
                                 f"{self.axis!r}")
            n, local = v.shape[0], v.to_local()
        else:
            v = torch.as_tensor(v)
            n = v.shape[0]
            if n % self.size():
                raise ValueError(f"leading axis {n} not divisible by "
                                 f"collective size {self.size()}")
            local = v[self.local_slice(n)]
        out = self.sum_partials(local.sum(dim=0))
        return out / n if mean else out

    def allReduce(self, v, op: str = "avg", replicated: bool | None = None):
        """MPI-allReduce analog (reference `collective.py:61-71`), with the
        JAX package's rules:

        * an array whose leading contributions axis the collective size
          divides -> reduced over that axis (``psum_contributions``);
        * a scalar, or ``replicated=True`` -> every rank holds the same
          value, so 'avg' is the identity and 'sum' scales by the size;
        * any other array -> ValueError: a per-contribution array that does
          not tile the collective has no correct reduction, and guessing
          "replicated" would return it unreduced."""
        if op not in ("sum", "avg"):
            raise ValueError(f"op={op!r}: 'sum' or 'avg'")
        if replicated or np.ndim(v) == 0:
            return v * self.size() if op == "sum" else v
        if not self._divisible(v):
            raise ValueError(
                f"allReduce: leading axis {v.shape[0]} is not divisible by "
                f"the collective size {self.size()}; pass replicated=True if "
                "every rank holds the same (already reduced) value")
        return self.psum_contributions(v, mean=(op == "avg"))

    def bcast(self, v, root: int = 0):
        """Every rank of the axis gets the value of the rank at position
        ``root`` along it (``dist.broadcast``; the reference's
        ``MPI.Bcast``, `collective.py:119-152`)."""
        t = torch.as_tensor(v).clone()
        dist.broadcast(t, src=dist.get_global_rank(self.group, root),
                       group=self.group)
        return t

    def shard_samples(self, x):
        """x, which every rank holds whole, as a ``DTensor`` with its leading
        (sample) axis sharded over the collective's axis: each rank keeps
        its ``local_slice`` (no communication)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        x = torch.as_tensor(x)
        placements = [Shard(0) if name == self.axis else Replicate()
                      for name in self.mesh.mesh_dim_names]
        return DTensor.from_local(x[self.local_slice(x.shape[0])].contiguous(),
                                  self.mesh, placements, run_check=False,
                                  shape=x.shape, stride=x.contiguous().stride())

    def sample_mean(self, x, axis: int = 0):
        """Mean over the sample axis: on axis 0 of a sharded or divisible
        input the ``psum_contributions`` reduction, else ``x.mean``."""
        if axis == 0 and (_is_dtensor(x) or self._divisible(x)):
            return self.psum_contributions(x, mean=True)
        return x.mean(dim=axis)


class CollectiveOperator:
    """Operator whose every application is reduced across the collective:
    the sample-averaged operator fed to eigensolvers (reference
    `collectives/collectiveOperator.py:14-55`).  The wrapped op returns
    per-contribution results with a leading axis the collective size
    divides, reduced here, or an already reduced replicated array
    (declare it with ``replicated=True``)."""

    def __init__(self, op, collective, mpi_op: str = "avg",
                 replicated: bool | None = None):
        self.op = op if callable(op) else op.matmat
        self.collective = collective
        self.mpi_op = mpi_op
        self.replicated = replicated

    def matmat(self, X):
        return self.collective.allReduce(self.op(X), self.mpi_op,
                                         replicated=self.replicated)

    mult = matmat  # reference naming
    __call__ = matmat


class MatrixMultCollectiveOperator(CollectiveOperator):
    """Block-interface twin of CollectiveOperator (reference
    `collectives/collectiveOperator.py:58-97`); every operator here is a
    block matmat already."""

    matMvMult = CollectiveOperator.matmat


def make_sample_fem_mesh(n_sample: int, n_fem: int = 1, device=None):
    """The ('sample', 'fem') mesh over every rank of the process group,
    which must hold n_sample * n_fem of them: the analog of the
    reference's splitCommunicators process grid
    (`collectives/comm_utils.py:19-40`).  Its device type is ``device``'s,
    else the backend's (NCCL: cuda, gloo: cpu)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_sample_fem_mesh needs a process group: call "
                           "initialize_distributed() first")
    world = dist.get_world_size()
    if n_sample * n_fem != world:
        raise ValueError(f"a ({n_sample}, {n_fem}) mesh needs "
                         f"{n_sample * n_fem} ranks; the group has {world}")
    kind = torch.device(device).type if device is not None else _mesh_device_type()
    return init_device_mesh(kind, (n_sample, n_fem),
                            mesh_dim_names=("sample", "fem"))


def make_multislice_mesh(n_fem: int = 1):
    """The ('sample', 'fem') mesh over every rank, with each 'fem' group
    inside one node (nodes stand in for the JAX package's slices: the halo
    and spike-tip exchanges stay on the node's links, the sample
    reduction crosses nodes).  torchrun numbers a node's ranks
    contiguously, so ``n_fem`` must divide ``LOCAL_WORLD_SIZE`` (the ranks
    of a node; the whole group where it is unset)."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local % n_fem or world % n_fem:
        raise ValueError(f"n_fem={n_fem} must divide the ranks per node "
                         f"({local}): the 'fem' axis cannot straddle nodes")
    return make_sample_fem_mesh(world // n_fem, n_fem)


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def check_consistent_sharding(x, expected_axis: str = "sample",
                              warn_unsharded: bool = True) -> bool:
    """Partitioning assertion replacing the reference's
    checkMeshConsistentPartitioning (`comm_utils.py:62-75`).  Returns
    False when x's leading axis is sharded over another mesh axis than
    ``expected_axis``; an unsharded tensor or a replicated leading axis is
    consistent but defeats sample parallelism, so it passes with a
    warning."""
    if not _is_dtensor(x):
        if warn_unsharded:
            warnings.warn(f"array is not mesh-sharded (expected leading axis "
                          f"on '{expected_axis}'); sample parallelism is "
                          "inactive", stacklevel=2)
        return True
    names = x.device_mesh.mesh_dim_names
    leading = [names[i] for i, p in enumerate(x.placements)
               if p.is_shard() and p.dim == 0]
    if not leading:
        if warn_unsharded:
            warnings.warn(f"leading axis is replicated, not sharded on "
                          f"'{expected_axis}'; sample parallelism is inactive",
                          stacklevel=2)
        return True
    return expected_axis in leading
