"""Nonlinear variational PDE problems, batched over samples.

Port of ``hippyflow_tpu/models/pde_problem.py`` with the inverse
block-Thomas (``thomas_inv``) solver, which the JAX package's 'auto' rule
picks at nx=64 and nx=192 for both the forward and the adjoint factor.  Every method
takes tensors with a leading sample axis:

* ``solve_fwd``: Newton with a backtracking Armijo ladder.  As in the JAX
  package's vmapped ``while_loop``, a lane whose residual norm is under its
  tolerance takes no more steps while the other lanes go on; here the
  loop runs on the still-active lanes only.
* ``linearize``: assemble and factorize the bc-symmetrized A = dr/du.
* ``solve_incremental``: A du = rhs or A^T dp = rhs with bc rows of the rhs
  zeroed; ``apply_Ct``: C^T dp with C = dr/dm of the masked residual.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config
from ..fem import (
    BoundGalerkinForm,
    DirichletBC,
    FunctionSpace,
    GalerkinForm,
    bc_symmetrize_banded_masked,
)
from ..ops.structured import factorize_thomas_inv_banded


class NewtonInfo(NamedTuple):
    converged: torch.Tensor  # (N,) bool
    iterations: torch.Tensor  # (N,) int64
    residual_norm: torch.Tensor  # (N,)


class Linearization(NamedTuple):
    """States and parameters (N, n) with the factor of the bc-symmetrized
    A = dr/du at each sample."""

    u: torch.Tensor
    m: torch.Tensor
    factor: object


class VariationalPDEProblem:
    """PDE problem defined by a GalerkinForm residual and Dirichlet BCs on a
    structured P1 mesh."""

    def __init__(
        self,
        Vu: FunctionSpace,
        Vm: FunctionSpace,
        form: GalerkinForm,
        bc: DirichletBC,
        newton_rtol: float = 1e-9,
        newton_atol: float = 1e-12,
        newton_max_iter: int = 25,
        n_line_search: int = 8,
        dtype=None,
        device=None,
    ):
        self.dtype, self.device = config.resolve(dtype, device)
        self.Vu, self.Vm, self.form, self.bc = Vu, Vm, form, bc
        self.bound = BoundGalerkinForm(Vu, Vm, form, self.dtype, self.device)
        self.state_dim = Vu.dim
        self._block_size = Vu.mesh.structured_shape[0] + 1
        if bc.mask.shape[0] != self.state_dim:
            raise ValueError("DirichletBC mask length must match the state")
        self._mask = torch.as_tensor(bc.mask, device=self.device)
        self._g = torch.as_tensor(bc.value, dtype=self.dtype, device=self.device)
        self._keep = (~self._mask).to(self.dtype)
        self.newton_rtol = newton_rtol
        self.newton_atol = newton_atol
        self.newton_max_iter = newton_max_iter
        self.n_line_search = n_line_search

    # -- residual and factorization ---------------------------------------
    def residual_masked(self, u, m):
        """Residual (N, n) with Dirichlet rows replaced by (u - g)."""
        return torch.where(self._mask, u - self._g, self.bound.residual(u, m))

    def _assemble_factorize(self, u, m):
        band = self.bound.assemble_A_banded(u, m)
        band = bc_symmetrize_banded_masked(band, self._mask)
        return factorize_thomas_inv_banded(band)

    # -- forward solve --------------------------------------------------------
    def solve_fwd(self, m, u0=None):
        """Newton solves for a batch of parameters m (N, n_m), optionally
        from initial guesses u0 (N, n).  Returns (u, NewtonInfo)."""
        N = m.shape[0]
        u = self._g.expand(N, -1) if u0 is None else u0
        u = torch.where(self._mask, self._g, u)
        r = self.residual_masked(u, m)
        rn = torch.linalg.vector_norm(r, dim=1)
        # dtype-aware tolerance: the float64 default rtol is out of reach
        # in float32
        eps = torch.finfo(m.dtype).eps
        rtol = max(self.newton_rtol, 100.0 * eps)
        atol = max(self.newton_atol, 10.0 * eps)
        tol = atol + rtol * rn
        alphas = 0.5 ** torch.arange(
            self.n_line_search, dtype=m.dtype, device=m.device
        )
        it = torch.zeros(N, dtype=torch.long, device=m.device)
        while True:
            active = ((rn > tol) & (it < self.newton_max_iter)).nonzero()[:, 0]
            if active.numel() == 0:
                break
            ua, ra, ma, rna = u[active], r[active], m[active], rn[active]
            du = -self._assemble_factorize(ua, ma).solve(ra)
            rnorms = torch.stack([
                torch.linalg.vector_norm(
                    self.residual_masked(ua + a * du, ma), dim=1
                )
                for a in alphas
            ])  # (n_line_search, Na)
            ok = rnorms < (1.0 - 1e-4 * alphas)[:, None] * rna
            first = ok.to(m.dtype).argmax(dim=0)  # first acceptable step
            pick = torch.where(ok.any(dim=0), first, rnorms.argmin(dim=0))
            ua = ua + alphas[pick][:, None] * du
            ra = self.residual_masked(ua, ma)
            u, r = u.index_copy(0, active, ua), r.index_copy(0, active, ra)
            rn = rn.index_copy(0, active, torch.linalg.vector_norm(ra, dim=1))
            it = it.index_add(0, active, torch.ones_like(active))
        info = NewtonInfo(converged=rn <= tol, iterations=it, residual_norm=rn)
        return u, info

    # -- linearization and incremental solves ----------------------------------
    def linearize(self, u, m, needs: str = "both") -> Linearization:
        """Assemble and factorize the bc-symmetrized A = dr/du at (u, m).
        The inverse-Thomas factor serves forward and adjoint solves, so
        ``needs`` ('both', 'fwd', 'adj') prunes nothing."""
        if needs not in ("both", "fwd", "adj"):
            raise ValueError(f"needs={needs!r}")
        return Linearization(u=u, m=m, factor=self._assemble_factorize(u, m))

    def _zero_bc_rows(self, x):
        return x * (self._keep[:, None] if x.ndim == 3 else self._keep)

    def solve_incremental(self, lin: Linearization, rhs, is_adj: bool = False):
        """A du = rhs (or A^T dp = rhs) with Dirichlet rows of the rhs
        zeroed first; rhs (N, n) or (N, n, k)."""
        return lin.factor.solve(self._zero_bc_rows(rhs), trans=is_adj)

    def apply_Ct(self, lin: Linearization, dp):
        """C^T dp with C = dr/dm of the masked residual at the linearization
        point: its Dirichlet rows are zero, so C^T dp = C_r^T (keep * dp)."""
        return self.bound.apply_Ct(lin.u, lin.m, self._zero_bc_rows(dp))
