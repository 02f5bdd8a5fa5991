"""Multi-source PDE problems: one parameter, k independent states (port of
``hippyflow_tpu/models/multi_pde.py``, after the reference's
`multiPDEProblem.py:21-141`, `blockVector.py:20-96` and
`multiStateLinearObservable.py:20-212`).

States are stacked with the sub-problem first: u (k, N, n), so that u[k]
is the k-th sub-problem's batch of states (N, n), as the JAX package's
u[k] is its k-th state; blocks are (k, N, n, j).  Linearizations are a
list of the k sub-problems' ``Linearization``s.  ``solve_fwd`` loops over
the k sub-problems, each solved for all N samples at once (k is the
number of sources, small); the Jacobian J = sum_k -B_k A_k^{-1} C_k runs
through ``ObservableJacobian.mult`` / ``transpmult`` unchanged.
"""

from __future__ import annotations

import os

import torch

from ..utils.mesh_utils import export_vtk
from ..utils.mv_utilities import mv_to_dense
from .pde_problem import NewtonInfo, VariationalPDEProblem


class BlockVector:
    """A list of tensors with the reference's axpy / zero / scale / inner
    (`blockVector.py:20-96`)."""

    def __init__(self, data):
        self.data = list(data)

    @property
    def nv(self):
        return len(self.data)

    def __getitem__(self, k):
        return self.data[k]

    def __setitem__(self, k, v):
        self.data[k] = v

    def zero(self):
        self.data = [torch.zeros_like(d) for d in self.data]
        return self

    def axpy(self, a, other: "BlockVector"):
        self.data = [d + a * o for d, o in zip(self.data, other.data)]
        return self

    def scale(self, a):
        self.data = [a * d for d in self.data]
        return self

    def inner(self, other: "BlockVector"):
        return sum(torch.vdot(d.reshape(-1), o.reshape(-1))
                   for d, o in zip(self.data, other.data))

    def export(self, mesh, directory: str, name: str = "x") -> list[str]:
        """Write each sub-vector as a legacy-VTK file
        ``<directory>/<name>_<k>.vtk`` (the reference streams them into one
        dolfin .pvd collection; ParaView opens the file series as a
        group).  Returns the paths written."""
        os.makedirs(directory, exist_ok=True)
        return [
            export_vtk(os.path.join(directory, f"{name}_{k:04d}"), mesh,
                       {name: mv_to_dense(d)})
            for k, d in enumerate(self.data)
        ]


class MultiPDEProblem:
    """k PDE problems that share the parameter m
    (`multiPDEProblem.py:21-141`)."""

    def __init__(self, problems: list[VariationalPDEProblem]):
        if not problems:
            raise ValueError("MultiPDEProblem needs at least one problem")
        self.problems = list(problems)
        self.Vm = problems[0].Vm
        self.n_problems = len(problems)

    @property
    def has_control(self) -> bool:
        return False

    @property
    def Vu(self):
        return self.problems[0].Vu

    def generate_state(self, dtype=None):
        return torch.stack([p.generate_state(dtype) for p in self.problems])

    def generate_parameter(self, dtype=None):
        return self.problems[0].generate_parameter(dtype)

    def solve_fwd(self, m, z=None, u0=None):
        """u (k, N, n) and the samples' Newton info over the k solves:
        converged in all, the most iterations, the largest residual."""
        us, infos = [], []
        for k, p in enumerate(self.problems):
            u, info = p.solve_fwd(m, z=z, u0=None if u0 is None else u0[k])
            us.append(u)
            infos.append(info)
        info = NewtonInfo(
            converged=torch.stack([i.converged for i in infos]).all(dim=0),
            iterations=torch.stack([i.iterations for i in infos]).amax(dim=0),
            residual_norm=torch.stack([i.residual_norm for i in infos]).amax(dim=0),
        )
        return torch.stack(us), info

    def linearize(self, u, m, z=None, needs: str = "both"):
        return [p.linearize(u[k], m, z, needs=needs)
                for k, p in enumerate(self.problems)]

    def solve_incremental(self, lins, rhs, is_adj: bool = False):
        return torch.stack([p.solve_incremental(lin, rhs[k], is_adj=is_adj)
                            for k, (p, lin) in enumerate(zip(self.problems, lins))])

    def apply_C(self, lins, dm):
        return torch.stack([p.apply_C(lin, dm)
                            for p, lin in zip(self.problems, lins)])

    def apply_Ct(self, lins, dps):
        return sum(p.apply_Ct(lin, dps[k])
                   for k, (p, lin) in enumerate(zip(self.problems, lins)))


class MultiStateLinearObservable:
    """The observable of a MultiPDEProblem, q = sum_k B_k u_k
    (`multiStateLinearObservable.py:103-127`)."""

    def __init__(self, multi_problem: MultiPDEProblem, Bs):
        if not isinstance(Bs, (list, tuple)):
            Bs = [Bs] * multi_problem.n_problems
        if len(Bs) != multi_problem.n_problems:
            raise ValueError(f"{len(Bs)} observation operators for "
                             f"{multi_problem.n_problems} problems")
        self.problem = multi_problem
        self.Bs = list(Bs)
        self.is_control_problem = False

    @property
    def dQ(self):
        return self.Bs[0].dim

    @property
    def dM(self):
        return self.problem.Vm.dim

    def eval(self, m, z=None, u0=None):
        u, _ = self.problem.solve_fwd(m, z=z, u0=u0)
        return self.evalu(u)

    def evalu(self, u):
        return sum(B.apply(u[k]) for k, B in enumerate(self.Bs))

    def solve_fwd(self, m, z=None, u0=None):
        return self.problem.solve_fwd(m, z=z, u0=u0)

    def linearize(self, m, z=None, u=None, u0=None):
        if u is None:
            u, _ = self.problem.solve_fwd(m, z=z, u0=u0)
        return self.problem.linearize(u, m, z)

    def applyB(self, u):
        return self.evalu(u)

    def applyBt(self, q):
        return torch.stack([B.applyt(q) for B in self.Bs])

    def applyC(self, lins, dm):
        return self.problem.apply_C(lins, dm)

    def applyCt(self, lins, dps):
        return self.problem.apply_Ct(lins, dps)

    def solveFwdIncremental(self, lins, rhs):
        return self.problem.solve_incremental(lins, rhs, is_adj=False)

    def solveAdjIncremental(self, lins, rhs):
        return self.problem.solve_incremental(lins, rhs, is_adj=True)
