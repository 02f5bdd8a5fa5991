"""Two-grid transfers and grid-sequenced Newton warm starts, batched over
samples (port of ``hippyflow_tpu/fem/multigrid.py``).

Nested iteration: each sample's nonlinear forward problem is first solved
on 2x-coarser structured meshes (restricted parameter, coarsest level
cold-started), and the prolonged coarse solution starts the fine Newton
iteration.  The map is a pure function of the chunk's noise (noise -> m ->
restrict -> coarse solves -> prolong), so it draws nothing and the sample
stream stays what a cold-started run would draw.

Transfers assume the row-major P1 layout of ``unit_square_mesh``
(``mesh.structured_shape``) and act on a leading sample axis: x (N, n) or
(N, n, k) for k components.

Not ported: ``SplitWarmStartChain``, which only lets XLA compile the
levels concurrently; PyTorch runs the levels eagerly.  The port's own
``prolong_p1_to_p2`` carries a P1 field into the P2 space of its mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import annotate


def _grid_shape(V) -> tuple[int, int]:
    shape = getattr(V.mesh, "structured_shape", None)
    if shape is None:
        raise ValueError("multigrid transfers need a structured mesh")
    nx, ny = shape
    return nx + 1, ny + 1


def _check_2to1(V_fine, V_coarse):
    (sfx, sfy), (scx, scy) = _grid_shape(V_fine), _grid_shape(V_coarse)
    if (sfx - 1, sfy - 1) != (2 * (scx - 1), 2 * (scy - 1)):
        raise ValueError("the coarse mesh must be exactly 2x coarser")
    return sfx, sfy, scx, scy


def restrict_injection(x, V_fine, V_coarse):
    """Injection: keep every second grid node per axis.
    x (N, n_f) or (N, n_f, k) -> (N, n_c) or (N, n_c, k)."""
    sfx, sfy, scx, scy = _check_2to1(V_fine, V_coarse)
    N, trail = x.shape[0], x.shape[2:]
    g = x.reshape((N, sfy, sfx) + trail)
    return g[:, ::2, ::2].reshape((N, scx * scy) + trail)


def prolong_linear(xc, V_coarse, V_fine):
    """Exact 2:1 linear interpolation: coarse nodes inject, edge midpoints
    average their two endpoints, cell centres their four corners.
    xc (N, n_c) or (N, n_c, k) -> (N, n_f) or (N, n_f, k)."""
    sfx, sfy, scx, scy = _check_2to1(V_fine, V_coarse)
    N, trail = xc.shape[0], xc.shape[2:]
    g = xc.reshape((N, scy, scx) + trail)
    f = torch.zeros((N, sfy, sfx) + trail, dtype=xc.dtype, device=xc.device)
    f[:, ::2, ::2] = g
    f[:, 1::2, ::2] = 0.5 * (g[:, :-1, :] + g[:, 1:, :])
    f[:, ::2, 1::2] = 0.5 * (g[:, :, :-1] + g[:, :, 1:])
    f[:, 1::2, 1::2] = 0.25 * (
        g[:, :-1, :-1] + g[:, :-1, 1:] + g[:, 1:, :-1] + g[:, 1:, 1:]
    )
    return f.reshape((N, sfx * sfy) + trail)


def prolong_p1_to_p2(x, V1, V2):
    """The P2 interpolant, exact, of a P1 field on the same mesh: each
    vertex keeps its value, each edge midpoint takes its ends' mean.
    x (N, n_1) or (N, n_1, k) -> (N, n_2) or (N, n_2, k)."""
    if V1.mesh is not V2.mesh or (V1.degree, V2.degree) != (1, 2):
        raise ValueError("a P1 space and a P2 space on one mesh")
    # a vertex dof is its own two ends; local dof 3 + k of a cell is the
    # midpoint of the edge opposite the cell's vertex k
    cells = np.asarray(V2.cell_dofs)
    ends = np.tile(np.arange(V2.dim), (2, 1))
    for k, (i, j) in enumerate(((1, 2), (0, 2), (0, 1))):
        ends[:, cells[:, 3 + k]] = cells[:, i], cells[:, j]
    ends = torch.as_tensor(ends, device=x.device)
    return 0.5 * (x[:, ends[0]] + x[:, ends[1]])


def _finite_rows(x):
    return torch.isfinite(x).all(dim=1, keepdim=True)


class CoarseNewtonWarmStart:
    """The warm-start map noise (b, noise_dim) -> u0 (b, n_fine) of
    :func:`coarse_newton_warm_start`.  ``iterations`` collects, per level
    (0 = the first coarse level), the Newton iterations of every lane of
    every call; ``clear`` empties it.  Each call is a ``warm_start``
    span."""

    def __init__(self, prior, chain, V_fine):
        self.prior = prior
        self.chain = list(chain)  # [(problem, V)] fine to coarse
        self.V_fine = V_fine
        self.iterations = [[] for _ in self.chain]

    def clear(self) -> None:
        self.iterations = [[] for _ in self.chain]

    def __call__(self, noise):
        with annotate("warm_start", fine=True, N=noise.shape[0],
                      levels=len(self.chain)):
            return self._warm_start(noise)

    def _warm_start(self, noise):
        m = self.prior.sample(noise)
        ms, V_prev = [], self.V_fine
        for _, V in self.chain:
            m = restrict_injection(m, V_prev, V)
            ms.append(m)
            V_prev = V
        u0 = None  # the coarsest level cold-starts
        for k in reversed(range(len(self.chain))):
            problem, V = self.chain[k]
            u, info = problem.solve_fwd(ms[k], u0=u0)
            self.iterations[k].append(info.iterations)
            # a failed or non-finite lane hands a zero guess to the level
            # above
            ok = info.converged[:, None] & _finite_rows(u)
            V_up = self.V_fine if k == 0 else self.chain[k - 1][1]
            u0 = prolong_linear(torch.where(ok, u, 0.0), V, V_up)
            u0 = torch.where(ok & _finite_rows(u0), u0, 0.0)
        return u0


def coarse_newton_warm_start(prior, problem_coarse, V_fine, V_coarse,
                             coarser_levels=()):
    """Per-sample warm-start map for
    ``sample_until_solved(coarse_warm_start=...)``.

    Recomputes m = prior.sample(noise), restricts it to ``V_coarse``,
    solves the coarse problem and prolongs the solution to ``V_fine``.
    ``coarser_levels``: (problem, V) pairs, each 2x coarser than the level
    before; every level is warm-started from the next coarser one, and only
    the coarsest cold-starts.  A lane that fails or goes non-finite at any
    level hands a zero initial guess to the level above."""
    return CoarseNewtonWarmStart(
        prior, [(problem_coarse, V_coarse)] + list(coarser_levels), V_fine
    )
