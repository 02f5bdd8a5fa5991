"""hIPPYflow's confusion application: P1 on the unit square, s = nb =
nx + 1, with grid sequencing from nx/2, nx/4, ... where the traffic asks
for it.

The program is the port's confusion observable
(``applications/confusion.py``), its prior (``models/prior.py``), the
grid-sequencing map (``fem.coarse_newton_warm_start``) and a fresh
``ActiveSubspaceProjector`` a pass.  The reference is
``reference/confusion.py``'s ``Confusion``, built from the same
configuration keys; the band work a pass needs is a Newton pass's
(``roofline.newton_need_seconds``).
"""

from __future__ import annotations

import torch

from hfbench import roofline, spec
from hfbench.reference import blocktri
from hfbench.reference.confusion import Confusion


class Program:
    """The cell's program, built through its entry points."""

    def __init__(self, cell: spec.Cell, device):
        from hippyflow_tpu_torch.applications.confusion import (
            confusion_linear_observable,
            confusion_prior,
        )
        from hippyflow_tpu_torch.fem import (
            FunctionSpace,
            coarse_newton_warm_start,
            restrict_injection,
            unit_square_mesh,
        )
        from hippyflow_tpu_torch.models import ActiveSubspaceParameterList

        cfg, traffic = cell.config, cell.traffic
        self.dtype = getattr(torch, cfg["dtype"])
        velocity = spec.load_velocity(cfg)
        kw = dict(sqrt_n_obs=cfg["sqrt_n_obs"], c=cfg["c"], k=cfg["k"],
                  newton_max_iter=cfg["newton_max_iter"],
                  n_line_search=cfg["n_line_search"], dtype=self.dtype,
                  device=device)
        nx = cfg["nx"]
        self.obs, Vh = confusion_linear_observable(nx=nx, velocity=velocity,
                                                   **kw)
        self.prior = confusion_prior(Vh, gamma=cfg["gamma"], delta=cfg["delta"],
                                     dtype=self.dtype, device=device)
        # the grid-sequencing levels at nx/2, nx/4, ..., each on the
        # velocity restricted by injection from the level above
        levels, V_prev, vel_prev = [], Vh, velocity
        for depth in range(traffic["grid_sequencing_depth"]):
            nx_c = nx >> (depth + 1)
            V_c = FunctionSpace(unit_square_mesh(nx_c))
            vel_c = restrict_injection(torch.as_tensor(vel_prev)[None], V_prev,
                                       V_c)[0].numpy()
            obs_c, V_c = confusion_linear_observable(nx=nx_c, velocity=vel_c, **kw)
            levels.append((obs_c.problem, V_c))
            V_prev, vel_prev = V_c, vel_c
        # a P1 band on the unit square has s = nb = the side's vertices
        sides = [nx + 1] + [V.mesh.structured_shape[0] + 1 for _, V in levels]
        self.bands = [(s, s) for s in sides]
        self.warm = None
        if levels:
            self.warm = coarse_newton_warm_start(
                self.prior, levels[0][0], Vh, levels[0][1],
                coarser_levels=levels[1:])
        p = ActiveSubspaceParameterList()
        p["samples_per_process"] = cfg["samples_per_process"]
        p["rank"], p["oversampling"] = cfg["rank"], cfg["oversampling"]
        p["chunk_size"] = traffic["chunk_size"]
        p["jac_chunk_size"] = traffic["jac_chunk_size"]
        p["verbose"] = False
        p["coarse_warm_start"] = self.warm
        self.params = p
        self.dim = Vh.dim
        self.state_dim = self.obs.problem.state_dim
        self.dq = self.obs.dQ

    def run_pass(self, draws, noise):
        """One input active subspace: (projector, d, V, E)."""
        from hippyflow_tpu_torch.models import ActiveSubspaceProjector

        if self.warm is not None:
            self.warm.clear()
        proj = ActiveSubspaceProjector(self.obs, self.prior,
                                       parameters=self.params)
        proj.keychain = noise
        proj.Omega_GN = draws.omega
        d, V, E = proj.construct_input_subspace()
        return proj, d, V, E

    def coarse_iterations(self) -> list:
        """The last pass's Newton iterations on each coarse level, summed
        over its samples, as device scalars."""
        if self.warm is None:
            return []
        return [torch.stack([t.sum() for t in its]).sum()
                for its in self.warm.iterations]

    def free(self) -> None:
        del self.obs, self.prior, self.warm, self.params


class Reference(Confusion):
    """``Confusion`` with the check's names: ``solve`` is its Newton solve
    from 0, ``batch_size`` the samples it takes at once."""

    def solve(self, m):
        return self.newton(m)

    def batch_size(self, budget_bytes: float = 24e9) -> int:
        """Samples at once: the band and Schur inverses and the Jacobian's
        transposed solve and element products in float64, within the
        budget."""
        s, nc = self.s, self.cells.shape[0]
        per = 8 * (5 * s ** 3 + (nc + 4 * self.n) * self.dq)
        b = max(1, int(budget_bytes // per))
        return 1 << (b.bit_length() - 1)


def reference(cell: spec.Cell, dtype=torch.float64, device="cpu",
              arith: blocktri.Arith = blocktri.EXACT) -> Reference:
    """The plain reference of the cell's configuration."""
    cfg = cell.config
    return Reference(cfg["nx"], spec.load_velocity(cfg), cfg["sqrt_n_obs"],
                     cfg["c"], cfg["k"], cfg["gamma"], cfg["delta"],
                     dtype=dtype, device=device, arith=arith)


def band_need_seconds(levels, dq: int, n_samples: int, dtype: str) -> float:
    """A Newton pass's: a factorization and a one-column solve per
    iteration at each level, and the fine level's factorization and
    transposed solve of dq columns per sample."""
    return roofline.newton_need_seconds(levels, dq, n_samples, dtype)
