"""Constrained Newton energy minimization (port of
``hippyflow_tpu/models/cminimization.py``, after the reference's
`cMinimization.py:42-207`): Newton's method with an Armijo ladder for
min_u F(u) + C(u) with a linear constraint term C.

F and C are scalar torch functions of the dof vector (n,); the gradient
and the Hessian of L = F + C come from ``torch.func`` (``grad`` and
``jacfwd(grad)``), Dirichlet rows are eliminated symmetrically
(``bc_symmetrize``) and the Newton system is a dense Cholesky factor.
The control flow is the JAX package's: the first iteration's
constraint pre-step, the (g, du) exit, the halving ladder and the four
termination reasons.
"""

from __future__ import annotations

import torch

from ..fem import DirichletBC, bc_symmetrize
from ..ops.linalg import factorize
from ..utils import ParameterList


def newtonSolver_ParameterList() -> ParameterList:
    """The JAX package's list (reference `cMinimization.py:25-38`)."""
    return ParameterList(
        {
            "max_iter": [20, "maximum Newton iterations"],
            "rel_tolerance": [1e-6, "converged when ||g||/||g0|| <= rtol"],
            "abs_tolerance": [1e-9, "converged when ||g|| <= atol"],
            "gdu_tolerance": [1e-18, "converged when (g, du) <= tol"],
            "c_armijo": [1e-4, "Armijo sufficient-decrease constant"],
            "max_backtracking_iter": [10, "line-search backtracks"],
            "print_level": [-1, "print if > 0"],
        }
    )


class ConstrainedNSolver:
    """Newton + Armijo for  min_u  F(u) + C(u)  with a linear constraint C."""

    termination_reasons = [
        "Maximum number of Iteration reached",  # 0
        "Norm of the gradient less than tolerance",  # 1
        "Maximum number of backtracking reached",  # 2
        "Norm of (g, du) less than tolerance",  # 3
    ]

    def __init__(self, parameters: ParameterList | None = None):
        self.parameters = parameters or newtonSolver_ParameterList()
        self.it = 0
        self.converged = False
        self.reason = 0

    def solve(self, F, C, u0, constraint_vec, bc: DirichletBC | None = None):
        """Minimize L = F + C from the initial guess u0 (n,).

        ``constraint_vec`` (n,) is the direction of the first iteration's
        constraint check and correction.  Returns (u, reason index)."""
        p = self.parameters
        max_bt, prt = p["max_backtracking_iter"], p["print_level"]
        c_armijo = p["c_armijo"]
        L = lambda u: F(u) + C(u)
        grad_fn = torch.func.grad(L)
        hess_fn = torch.func.jacfwd(torch.func.grad(L))
        value = lambda u: float(F(u))

        u = torch.as_tensor(u0)
        mask = None
        if bc is not None:
            mask = torch.as_tensor(bc.mask, device=u.device)
            u = torch.where(mask, torch.as_tensor(bc.value, dtype=u.dtype,
                                                  device=u.device), u)
        Fn = value(u)
        g0_norm = float(torch.linalg.vector_norm(grad_fn(u)))
        tol = max(g0_norm * p["rel_tolerance"], p["abs_tolerance"])
        cvec = torch.as_tensor(constraint_vec, dtype=u.dtype, device=u.device)

        self.converged = False
        self.reason = 0
        for self.it in range(p["max_iter"]):
            gn = grad_fn(u)
            H = hess_fn(u)
            if bc is not None:
                H = bc_symmetrize(H, bc)
                gn = torch.where(mask, 0.0, gn)
            fac = factorize(H, symmetric=True)

            if self.it == 0:
                # the first iteration's constraint-violation correction
                violation = gn * cvec
                if float(torch.linalg.vector_norm(violation)) > 1e-6:
                    u = u - fac.solve(violation)
                    Fn = value(u)
                    continue

            du = -fac.solve(gn)
            du_gn = float(du @ gn)
            alpha = 1.0
            if abs(du_gn) < p["gdu_tolerance"]:
                self.converged = True
                self.reason = 3
                u = u + alpha * du
                Fn = value(u)
                break

            bk_converged = False
            for _ in range(max_bt):
                Fnext = value(u + alpha * du)
                if Fnext < Fn + alpha * c_armijo * du_gn:
                    u = u + alpha * du
                    Fn = Fnext
                    bk_converged = True
                    break
                alpha /= 2.0
            if not bk_converged:
                self.reason = 2
                break

            gn_norm = float(torch.linalg.vector_norm(grad_fn(u)))
            if prt > 0:
                print(f"{self.it + 1:3d} {Fn:15e} {gn_norm:15e} {du_gn:15e} "
                      f"{alpha:15e}")
            if gn_norm < tol:
                self.converged = True
                self.reason = 1
                break

        self.it += 1
        if prt > 0:
            print(self.termination_reasons[self.reason])
        return u, self.reason
