"""Block-tridiagonal operators with the block rows sharded over a mesh axis.

Port of ``hippyflow_tpu/parallel/dist_banded.py``: the domain
decomposition of the reference's distributed PETSc solves over
``mesh_constructor_comm`` (`collectives/comm_utils.py:19-40`) for the
(..., nb, s, 3s) bands of ``ops/structured.py``.  Batch-first: every band
may carry leading sample axes, where the JAX package vmaps.

* ``dist_block_tridiag_matmat``: each rank multiplies its own block rows,
  after a one-block-row halo exchange each way with its neighbours along
  the axis (``dist.batch_isend_irecv``), and the rows are gathered.
* ``factorize_distributed_banded`` / ``DistributedBandedFactor``: the
  partitioned (SPIKE) direct solve.  The nb block rows split into P
  contiguous partitions of L rows; each partition's own block-tridiagonal
  chunk D_p is factorized by block cyclic reduction (``ops/structured.py``,
  K3 once per level for every sample and partition at once), its
  couplings to the neighbours are captured by two s-column spikes, and a
  reduced system of the 2P interface block rows, replicated on every
  rank, stitches the partitions together.  Only the spike tips (at the
  factorization) and the solution tips (at each solve) cross between
  ranks.
* ``dist_assemble_band``: each rank scatters its own cells into its rows
  plus one halo row, which one hop adds into the next rank's first row;
  no rank holds the global band.

A band sharded over the axis is a ``DTensor`` with a ``Shard`` placement
on its block-row dimension (``dist_assemble_band`` returns one,
``factorize_distributed_banded`` and ``dist_block_tridiag_matmat`` take
one); right-hand sides and results are the global tensors every rank
holds, so a placed factor is a drop-in for ``BlockCyclicFactor``.

Partitioned solve, math
-----------------------
With D_p partition p's chunk, A_p = a_{pL} its first row's coupling to the
left neighbour's last row and B_p = b_{(p+1)L-1} its last row's coupling to
the right neighbour's first row,

    D_p x_p + (e_first ⊗ A_p) x_{p-1}^{last} + (e_last ⊗ B_p) x_{p+1}^{first} = f_p.

With y_p = D_p^{-1} f_p and the spikes W_p = D_p^{-1}(e_first ⊗ A_p),
V_p = D_p^{-1}(e_last ⊗ B_p):

    x_p = y_p - W_p x_{p-1}^{last} - V_p x_{p+1}^{first}.

The first and last block rows of that identity close a reduced system in
the 2P interface unknowns (t_p = x_p^{first}, u_p = x_p^{last}) whose
matrix depends only on the spike tips; it is factorized once (pivoted LU
of size 2Ps, ``ops/linalg.py``; no TPU kernel) and solved on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.linalg import factorize
from ..ops.structured import _transpose_band, factorize_block_cyclic
from .collective import _is_dtensor


class _Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group (None when
    the work is not placed), its size and this rank's position."""

    group: object
    size: int
    pos: int


_LOCAL = _Axis(None, 1, 0)


def _axis(mesh, axis: str) -> _Axis:
    names = mesh.mesh_dim_names
    if axis not in (names or ()):
        raise ValueError(f"axis {axis!r} is not a dimension of the mesh {names}")
    return _Axis(mesh.get_group(axis), mesh.size(names.index(axis)),
                 mesh.get_local_rank(axis))


def _row_sharding(band):
    """(mesh, axis) of a band DTensor sharded on its block-row dimension."""
    names = band.device_mesh.mesh_dim_names
    rows = band.ndim - 3
    axes = [names[i] for i, p in enumerate(band.placements)
            if p.is_shard() and p.dim == rows]
    if len(axes) != 1 or any(p.is_shard() and p.dim != rows
                             for p in band.placements):
        raise ValueError("a distributed band is sharded on its block-row "
                         f"dimension over one mesh axis: {band.placements}")
    return band.device_mesh, axes[0]


def _rows_dtensor(local, mesh, axis: str, n_rows: int):
    """The band DTensor whose block rows this rank holds as ``local``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rows = local.ndim - 3
    shape = local.shape[:rows] + (n_rows,) + local.shape[rows + 1:]
    stride = torch.empty(shape, device="meta").stride()
    placements = [Shard(rows) if name == axis else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _gather(x, ax: _Axis, dim: int):
    """Every rank's x along ``dim`` in axis order (one ``all_gather``)."""
    if ax.group is None or ax.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _halo(first, last, ax: _Axis, to_left: bool = True):
    """One hop each way along the axis (``dist.batch_isend_irecv``):
    ``last`` goes to the next rank and, with ``to_left``, ``first`` to the
    previous one.  Returns (the previous rank's ``last``, the next rank's
    ``first``), zeros at the ends of the axis and for a hop not made."""
    from_left = last.new_zeros(last.shape)
    from_right = first.new_zeros(first.shape)
    if ax.group is None or ax.size == 1:
        return from_left, from_right
    peer = lambda p: dist.get_global_rank(ax.group, p)
    nxt, prv = ax.pos + 1 < ax.size, ax.pos > 0
    ops = []
    if nxt:
        ops.append(dist.P2POp(dist.isend, last.contiguous(), peer(ax.pos + 1),
                              ax.group))
    if prv:
        ops.append(dist.P2POp(dist.irecv, from_left, peer(ax.pos - 1), ax.group))
    if to_left and prv:
        ops.append(dist.P2POp(dist.isend, first.contiguous(), peer(ax.pos - 1),
                              ax.group))
    if to_left and nxt:
        ops.append(dist.P2POp(dist.irecv, from_right, peer(ax.pos + 1),
                              ax.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def _pad_band(band, n_parts: int):
    """Pad the block rows to a multiple of n_parts with identity rows.

    Pad rows have identity diagonal blocks and zero couplings, so the
    padded matrix is block diagonal [[A, 0], [0, I]]: solves and products
    on the original rows are unchanged and pad solution entries equal the
    (zero) pad right-hand side.  Returns (band, padded row count)."""
    nb, s = band.shape[-3], band.shape[-2]
    nb_pad = -(-nb // n_parts) * n_parts
    if nb_pad == nb:
        return band, nb_pad
    pad = band.new_zeros(band.shape[:-3] + (nb_pad - nb, s, 3 * s))
    pad[..., :, s : 2 * s] = torch.eye(s, dtype=band.dtype, device=band.device)
    return torch.cat([band, pad], dim=-3), nb_pad


def _pad_rhs(X, n: int, n_pad: int):
    """X (..., n, k) padded with zero rows to (..., n_pad, k)."""
    if n_pad == n:
        return X
    pad = X.new_zeros(X.shape[:-2] + (n_pad - n, X.shape[-1]))
    return torch.cat([X, pad], dim=-2)


def _local_rows(band, mesh, axis, n_parts=None):
    """(this rank's block rows, padded global row count, the axis): of a
    row-sharded band DTensor, or of the global band that every rank holds
    (padded to a multiple of ``n_parts``, the axis size by default)."""
    if _is_dtensor(band):
        mesh, axis = _row_sharding(band)
        return band.to_local(), band.shape[-3], _axis(mesh, axis)
    ax = _axis(mesh, axis)
    band_p, nb_pad = _pad_band(band, n_parts or ax.size)
    L = nb_pad // ax.size
    return band_p[..., ax.pos * L : (ax.pos + 1) * L, :, :], nb_pad, ax


def dist_block_tridiag_matmat(mesh, band, X, axis: str = "fem"):
    """A @ X with the block rows sharded over ``axis`` of ``mesh``.

    ``band`` (..., nb, s, 3s) is the global band every rank holds (padded
    here to a multiple of the axis size) or a DTensor sharded on its block
    rows; X (..., n) or (..., n, k) the global right-hand side, n at most
    the padded rows (a band padded by ``dist_assemble_band`` takes the
    true size).  Each rank multiplies its block rows: its own rows of X,
    and its neighbours' adjacent rows by a halo exchange each way; the
    ends of the axis take zeros, exact because the global matrix couples
    nothing there (a_0 = b_{nb-1} = 0; pad rows couple to nothing).  The
    rows meet in one ``all_gather``.  Per row the arithmetic of
    ``ops.structured.block_tridiag_matmat``."""
    loc, nb_pad, ax = _local_rows(band, mesh, axis)
    s = loc.shape[-2]
    L = loc.shape[-3]
    squeeze = X.ndim == loc.ndim - 2
    if squeeze:
        X = X[..., None]
    n_x = X.shape[-2]
    xb = _pad_rhs(X, n_x, nb_pad * s).reshape(X.shape[:-2] + (nb_pad, s, -1))
    x = xb[..., ax.pos * L : (ax.pos + 1) * L, :, :]
    a, d, b = loc[..., :s], loc[..., s : 2 * s], loc[..., 2 * s :]
    left, right = _halo(x[..., 0, :, :], x[..., -1, :, :], ax)
    x_prev = torch.cat([left[..., None, :, :], x[..., :-1, :, :]], dim=-3)
    x_next = torch.cat([x[..., 1:, :, :], right[..., None, :, :]], dim=-3)
    y = d @ x
    y += a @ x_prev
    y += b @ x_next
    y = _gather(y, ax, dim=-3)
    out = y.reshape(y.shape[:-3] + (nb_pad * s, -1))[..., :n_x, :]
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Partitioned SPIKE
# ---------------------------------------------------------------------------


class _SpikeSide(NamedTuple):
    """The partitioned factorization of one direction (A or A^T), of this
    rank's partitions: their cyclic-reduction factors over (..., P_local,
    L, s, s), their spikes (..., P_local, L s, s), and the LU factor of the
    reduced system (..., 2 P s, 2 P s), the same on every rank."""

    local_fac: object  # BlockCyclicFactor batched over (..., P_local)
    W: torch.Tensor  # left spikes
    V: torch.Tensor  # right spikes
    R: object  # ops.linalg.LUFactor


def _build_side(rows, n_parts: int, ax: _Axis) -> _SpikeSide:
    """The SPIKE factor of the band rows (..., P_local L, s, 3s) that this
    rank holds, partitions ``ax.pos * P_local ...`` of ``n_parts``."""
    s = rows.shape[-2]
    p_loc = n_parts // ax.size
    L = rows.shape[-3] // p_loc
    chunks = rows.reshape(rows.shape[:-3] + (p_loc, L, s, 3 * s))
    A_c = chunks[..., 0, :, :s]  # a_0 = 0 for the first partition
    B_c = chunks[..., -1, :, 2 * s :]
    local = chunks.clone()
    local[..., 0, :, :s] = 0.0
    local[..., -1, :, 2 * s :] = 0.0
    local_fac = factorize_block_cyclic(local[..., s : 2 * s], local[..., :s],
                                       local[..., 2 * s :], with_transpose=False)
    del local
    # both spikes from one solve of 2s columns:
    # [W_p V_p] = D_p^{-1} [e_first ⊗ A_p, e_last ⊗ B_p]
    rhs = rows.new_zeros(rows.shape[:-3] + (p_loc, L * s, 2 * s))
    rhs[..., :s, :s] = A_c
    rhs[..., -s:, s:] = B_c
    WV = local_fac.solve(rhs)
    del rhs
    W, V = WV[..., :s].contiguous(), WV[..., s:].contiguous()
    del WV
    # every partition's spike tips, on every rank
    tips = torch.stack([W[..., :s, :], W[..., -s:, :], V[..., :s, :],
                        V[..., -s:, :]], dim=-3)
    Wf, Wl, Vf, Vl = _gather(tips, ax, dim=-4).unbind(-3)
    # the reduced system over [t_0, u_0, t_1, u_1, ...]
    P = n_parts
    R = torch.eye(2 * P * s, dtype=rows.dtype, device=rows.device).expand(
        rows.shape[:-3] + (2 * P * s, 2 * P * s)).clone()
    Rb = R.view(rows.shape[:-3] + (2 * P, s, 2 * P, s))
    for p in range(1, P):  # rows with a left neighbour
        Rb[..., 2 * p, :, 2 * p - 1, :] += Wf[..., p, :, :]
        Rb[..., 2 * p + 1, :, 2 * p - 1, :] += Wl[..., p, :, :]
    for q in range(P - 1):  # rows with a right neighbour
        Rb[..., 2 * q, :, 2 * q + 2, :] += Vf[..., q, :, :]
        Rb[..., 2 * q + 1, :, 2 * q + 2, :] += Vl[..., q, :, :]
    return _SpikeSide(local_fac, W, V, factorize(R, symmetric=False))


def _solve_side(side: _SpikeSide, f, s: int, n_parts: int, ax: _Axis):
    """f (..., P_local, L s, k): this rank's partitions of the padded
    right-hand side.  Returns its partitions of the solution, same shape."""
    p_loc = side.W.shape[-3]
    lo = ax.pos * p_loc
    y = side.local_fac.solve(f)
    # interface tips -> the reduced solve, on every rank
    tips = torch.stack([y[..., :s, :], y[..., -s:, :]], dim=-3)
    tips = _gather(tips, ax, dim=-4)  # (..., P, 2, s, k)
    k = f.shape[-1]
    x_red = side.R.solve(tips.reshape(tips.shape[:-4] + (2 * n_parts * s, k)))
    x_red = x_red.reshape(tips.shape)
    t, u = x_red[..., 0, :, :], x_red[..., 1, :, :]
    zero = torch.zeros_like(t[..., :1, :, :])
    u_prev = torch.cat([zero, u[..., :-1, :, :]], dim=-3)[..., lo : lo + p_loc, :, :]
    t_next = torch.cat([t[..., 1:, :, :], zero], dim=-3)[..., lo : lo + p_loc, :, :]
    return y - side.W @ u_prev - side.V @ t_next


class DistributedBandedFactor:
    """Partitioned (SPIKE) factorization of a block-tridiagonal matrix, or
    of a batch of them: a drop-in for ``BlockCyclicFactor`` (the same
    ``solve(rhs, trans=...)``), so it slots into ``Linearization.factor``
    and the structured prior.

    Unplaced (``fem`` is ``_LOCAL``) it holds all ``n_parts`` partitions;
    placed (``place_on_mesh``, or built from a row-sharded band) it holds
    this rank's partitions, and with a sample axis this rank's samples.
    ``solve`` takes and returns the global tensors that every rank
    holds."""

    def __init__(self, fwd, adj, n: int, s: int, n_parts: int,
                 fem: _Axis = _LOCAL, sample: _Axis | None = None):
        self.fwd, self.adj = fwd, adj
        self.n, self.s = n, s  # the true (unpadded) matrix size; block size
        self.n_parts = n_parts
        self.fem, self.sample = fem, sample

    def solve(self, rhs, trans: bool = False):
        """Solve A x = rhs (or A^T x = rhs); rhs (..., n) or (..., n, k),
        with the factor's leading sample axes (global, with a sample axis:
        the solution is gathered over it)."""
        side = self.adj if trans else self.fwd
        if side is None:
            raise ValueError("factorized with with_transpose=False: adjoint "
                             "solves are not available")
        W = side.W
        squeeze = rhs.ndim == W.ndim - 2
        if squeeze:
            rhs = rhs[..., None]
        L_s = W.shape[-2]
        n_pad = self.n_parts * L_s
        f = _pad_rhs(rhs, self.n, n_pad)
        if self.sample is not None:
            share = f.shape[0] // self.sample.size
            f = f[self.sample.pos * share : (self.sample.pos + 1) * share]
        p_loc = W.shape[-3]
        lo = self.fem.pos * p_loc
        f = f.reshape(f.shape[:-2] + (self.n_parts, L_s, -1))[
            ..., lo : lo + p_loc, :, :]
        x = _gather(_solve_side(side, f, self.s, self.n_parts, self.fem),
                    self.fem, dim=-3)
        x = x.reshape(x.shape[:-3] + (n_pad, -1))[..., : self.n, :]
        if self.sample is not None:
            x = _gather(x, self.sample, dim=0)
        return x[..., 0] if squeeze else x


def _factor_rows(rows, nb_pad: int, n_parts: int, ax: _Axis,
                 with_transpose: bool, n_true):
    """The factor from this rank's block rows of the padded band."""
    s = rows.shape[-2]
    if n_parts % ax.size or nb_pad % n_parts:
        raise ValueError(f"{nb_pad} block rows in {n_parts} partitions over "
                         f"{ax.size} ranks")
    fwd = _build_side(rows, n_parts, ax)
    adj = None
    if with_transpose:
        a, d, b = rows[..., :s], rows[..., s : 2 * s], rows[..., 2 * s :]
        a_t, d_t, b_t = _transpose_band(a, d, b)
        # the transposed band's first and last rows need the neighbours'
        # couplings: (A^T)_{j,j-1} = b_{j-1}^T, (A^T)_{j,j+1} = a_{j+1}^T
        b_left, a_right = _halo(a[..., 0, :, :], b[..., -1, :, :], ax)
        if ax.pos > 0:
            a_t[..., 0, :, :] = b_left.mT
        if ax.pos + 1 < ax.size:
            b_t[..., -1, :, :] = a_right.mT
        adj = _build_side(torch.cat([a_t, d_t, b_t], dim=-1), n_parts, ax)
    return DistributedBandedFactor(fwd, adj, n_true or nb_pad * s, s, n_parts,
                                   fem=ax)


def factorize_distributed_banded(band, n_parts: int, with_transpose: bool = True,
                                 n_true: int | None = None, mesh=None,
                                 axis: str = "fem") -> DistributedBandedFactor:
    """Partitioned-SPIKE factorization from (..., nb, s, 3s) band storage.

    * A plain band and no ``mesh``: all ``n_parts`` partitions on this
      device (the JAX package's unplaced factor; ``place_on_mesh`` keeps a
      rank's share of it).
    * A plain band that every rank holds and a ``mesh``: each rank of
      ``axis`` factorizes only its own n_parts / size partitions.
    * A DTensor sharded on its block rows (``dist_assemble_band``): the
      same, from the rows this rank holds; ``mesh`` and ``axis`` are the
      band's.

    The spike tips meet in one ``all_gather`` per direction; the
    transposed band's boundary couplings in one halo hop.  ``n_true``
    declares the unpadded system size of a band given padded: solves then
    take and return vectors of that length."""
    if _is_dtensor(band) or mesh is not None:
        rows, nb_pad, ax = _local_rows(band, mesh, axis, n_parts)
        n_default = band.shape[-3] * band.shape[-2]
        return _factor_rows(rows, nb_pad, n_parts, ax, with_transpose,
                            n_true or n_default)
    nb, s = band.shape[-3], band.shape[-2]
    band_p, nb_pad = _pad_band(band, n_parts)
    return _factor_rows(band_p, nb_pad, n_parts, _LOCAL, with_transpose,
                        n_true or nb * s)


def _narrow(x, dim: int, ax: _Axis):
    """This rank's equal share of x along ``dim``, as its own storage."""
    share = x.shape[dim] // ax.size
    return x.narrow(dim, ax.pos * share, share).clone()


def place_on_mesh(factor, mesh, axis: str = "fem", sample_axis: str | None = None):
    """The rank's share of an unplaced factor: its partitions along
    ``axis`` (the axis size must divide ``n_parts``), and with
    ``sample_axis`` its samples of a batch factor (the leading axis; the
    sample axis's size must divide it) — the composition of sample and
    domain parallelism (reference strategy #3, ``splitCommunicators``,
    `comm_utils.py:19-40`).  The reduced-system factors stay whole on every
    rank (per sample).  Placement is structural: each leaf of a side is
    cut along its partition axis by what it is, not by its shape."""
    if not isinstance(factor, DistributedBandedFactor):
        raise TypeError("place_on_mesh expects a DistributedBandedFactor")
    if factor.fem.group is not None:
        raise ValueError("the factor is placed already")
    fem = _axis(mesh, axis)
    if factor.n_parts % fem.size:
        raise ValueError(f"{factor.n_parts} partitions over {fem.size} ranks")
    sample = None if sample_axis is None else _axis(mesh, sample_axis)
    W = factor.fwd.W  # every factor has its forward side
    if sample is not None and (W.ndim < 4 or W.shape[0] % sample.size):
        raise ValueError(f"a batch of {W.shape[:-3]} factors over "
                         f"{sample.size} sample ranks")

    def cut(x, part_dim):
        x = _narrow(x, x.ndim + part_dim, fem)
        return x if sample is None else _narrow(x, 0, sample)

    def whole(x):
        return x if sample is None else _narrow(x, 0, sample)

    def place_side(side):
        if side is None:
            return None
        lf = side.local_fac
        levels = tuple(type(lv)(*(cut(t, -4) for t in lv)) for lv in lf.levels)
        local_fac = lf._replace(levels=levels, Dinv_root=cut(lf.Dinv_root, -3))
        R = type(side.R)(*(whole(t) for t in side.R))
        return _SpikeSide(local_fac, cut(side.W, -3), cut(side.V, -3), R)

    return DistributedBandedFactor(place_side(factor.fwd), place_side(factor.adj),
                                   factor.n, factor.s, factor.n_parts, fem=fem,
                                   sample=sample)


# ---------------------------------------------------------------------------
# Dof-sharded banded assembly
# ---------------------------------------------------------------------------


def partition_cells_by_row(cell_rows: np.ndarray, nb: int, n_parts: int):
    """Static (numpy) partition plan for sharded assembly.

    cell_rows: (nc,) the least block row each cell touches.  A cell goes
    to the partition owning that row; it may also scatter into the first
    row of the NEXT partition (P1 structured cells span two adjacent
    rows), which a halo row carries.  Returns (cell_ids (P, Cmax) padded
    with -1, L) with L the padded rows per partition."""
    L = -(-nb // n_parts)
    part_of_cell = np.clip(cell_rows // L, 0, n_parts - 1)
    counts = np.bincount(part_of_cell, minlength=n_parts)
    cmax = int(counts.max())
    cell_ids = np.full((n_parts, cmax), -1, dtype=np.int64)
    for p in range(n_parts):
        ids = np.nonzero(part_of_cell == p)[0]
        cell_ids[p, : len(ids)] = ids
    return cell_ids, L


def dist_assemble_band(mesh, vals_e, band_idx, cell_ids, nb: int, s: int,
                       axis: str = "fem", pad_identity: bool = True):
    """Assemble a (P L, s, 3s) band with its block rows sharded over
    ``axis`` (P its size): each rank scatter-adds its own cells
    (``index_add_``) into its L rows plus ONE halo row (the first row of
    the next rank), and the halo row rides one hop to be added in; no rank
    holds the global band.

    Args:
        vals_e: (nc, e) each cell's flattened element-matrix entries.
        band_idx: (nc, e) their flat indices into the (nb, s, 3s) band.
        cell_ids: (P, Cmax) the plan of ``partition_cells_by_row``.
        nb, s: global block rows and block size.
        pad_identity: identity diagonal blocks on the pad rows (global rows
            >= nb), which keep the padded band factorizable; a term added
            to such a band takes none.
    Returns the band as a DTensor sharded on its block rows over
    ``axis``."""
    ax = _axis(mesh, axis)
    L = -(-nb // ax.size)
    vals = torch.as_tensor(vals_e)
    vals = vals.reshape(vals.shape[0], -1)
    idx = torch.as_tensor(band_idx, device=vals.device).reshape(vals.shape[0], -1)
    ids = np.asarray(cell_ids)[ax.pos]
    ids = torch.as_tensor(ids[ids >= 0], device=vals.device)
    row = 3 * s * s
    flat = vals.new_zeros((L + 1) * row)
    flat.index_add_(0, (idx[ids] - ax.pos * L * row).reshape(-1),
                    vals[ids].reshape(-1))
    buf = flat.reshape(L + 1, s, 3 * s)
    out = buf[:L].clone()
    from_left, _ = _halo(buf[L], buf[L], ax, to_left=False)
    out[0] += from_left
    if pad_identity:
        first_pad = max(0, nb - ax.pos * L)
        if first_pad < L:
            out[first_pad:, :, s : 2 * s] += torch.eye(s, dtype=out.dtype,
                                                       device=out.device)
    return _rows_dtensor(out, mesh, axis, ax.size * L)
