"""Variational PDE problems, batched over samples.

Port of ``hippyflow_tpu/models/pde_problem.py`` with the inverse
block-Thomas (``thomas_inv``) solver.  Two band layouts:

* a scalar state on a structured P1 mesh: the mesh's row-major numbering
  is block-tridiagonal with blocks of s = nx + 1 (confusion);
* a P2 and/or vector state (``VectorGalerkinForm``, e.g. the helmholtz
  split-complex P2 state): the band is regained through the row ordering
  of ``fem/band_order.py``, assembled straight into permuted storage and
  factorized behind a ``PermutedFactor``; pad rows at the band tail count
  as constrained and factorize as identity rows.

Solver choice.  The JAX package's 'auto' rule factorizes forward solves
with ``thomas_inv`` and adjoint solves with ``thomas_inv`` where the
blocks are large (s >= 128) or the band short (nb <= 256), else with cyclic
reduction; every lane of the port falls in the first case, and the cyclic
adjoint factor is not ported, so a problem in the second case is refused.
``RefinedBandFactor`` is not ported either:
the JAX package wraps factors in it only under its lowered-precision
solver policy, and the port solves in IEEE precision.

Every method takes tensors with a leading sample axis:

* ``solve_fwd``: a linear problem (``is_fwd_linear``) assembles,
  factorizes and solves once and checks its residual
  (``linear_convergence_check``); a nonlinear one runs Newton with a
  backtracking Armijo ladder.  As in the JAX package's vmapped
  ``while_loop``, a lane whose residual norm is under its tolerance takes
  no more steps while the other lanes go on; here the loop runs on the
  still-active lanes only.
* ``linearize``: assemble and factorize the bc-symmetrized A = dr/du.
* ``solve_incremental``: A du = rhs or A^T dp = rhs with bc rows of the rhs
  zeroed; ``apply_C`` / ``apply_Ct``: C dm and C^T dp with C = dr/dm of
  the masked residual.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..fem import (
    BoundGalerkinForm,
    DirichletBC,
    FunctionSpace,
    bc_symmetrize_banded_masked,
)
from ..fem.band_order import ordered_band_mask, structured_band_order
from ..fem.vector_assembly import VectorBoundGalerkinForm, VectorGalerkinForm
from ..ops.structured import PermutedFactor, factorize_thomas_inv_banded


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
    """PDE problem defined by a (Vector)GalerkinForm residual and Dirichlet
    BCs on a structured mesh.

    is_fwd_linear: the residual is affine in u, so one factorization
    solves the forward problem.  rhs_vector: a distributional right-hand
    side (point sources), residual -> residual - rhs_vector.
    operator_symmetric: A^T = A as assembled (possibly indefinite), so an
    adjoint factor serves forward solves too (the fused sampling pass)."""

    def __init__(
        self,
        Vu: FunctionSpace,
        Vm: FunctionSpace,
        form,
        bc: DirichletBC,
        newton_rtol: float = 1e-9,
        newton_atol: float = 1e-12,
        newton_max_iter: int = 25,
        n_line_search: int = 8,
        dtype=None,
        device=None,
        is_fwd_linear: bool = False,
        rhs_vector=None,
        operator_symmetric: bool = False,
    ):
        if Vu.mesh.structured_shape is None:
            raise NotImplementedError("only structured rectangle meshes")
        self.dtype, self.device = config.resolve(dtype, device)
        self.Vu, self.Vm, self.form, self.bc = Vu, Vm, form, bc
        if isinstance(form, VectorGalerkinForm):
            self.bound = VectorBoundGalerkinForm(Vu, Vm, form, self.dtype,
                                                 self.device)
            self.state_dim = self.bound.n_total
        else:
            self.bound = BoundGalerkinForm(Vu, Vm, form, self.dtype, self.device)
            self.state_dim = Vu.dim
        if bc.mask.shape[0] != self.state_dim:
            raise ValueError("DirichletBC mask length must match the state")
        self._band_order = None
        if isinstance(form, VectorGalerkinForm) or Vu.degree != 1:
            border = structured_band_order(Vu, ncomp=form.ncomp)
            self._band_order = border
            self._block_size = border.s
            self.bound.prepare_banded_ordered(border)
            self._band_mask = torch.as_tensor(
                ordered_band_mask(np.asarray(bc.mask), border), device=self.device
            )
        else:
            self._block_size = Vu.mesh.structured_shape[0] + 1
        nb = self.state_dim // self._block_size
        if not (self._block_size >= 128 or nb <= 256):
            raise NotImplementedError(
                f"s={self._block_size}, nb={nb}: the JAX package's 'auto' "
                "rule takes the cyclic-reduction adjoint factor here, which "
                "is not ported"
            )
        self._mask = torch.as_tensor(bc.mask, device=self.device)
        self._has_bc = bool(np.asarray(bc.mask).any())
        self._g = torch.as_tensor(bc.value, dtype=self.dtype, device=self.device)
        self._keep = (~self._mask).to(self.dtype)
        self.is_fwd_linear = bool(is_fwd_linear)
        self.operator_symmetric = bool(operator_symmetric)
        self.rhs_vector = (
            None if rhs_vector is None
            else torch.as_tensor(rhs_vector, dtype=self.dtype, device=self.device)
        )
        self.newton_rtol = newton_rtol
        self.newton_atol = newton_atol
        self.newton_max_iter = newton_max_iter
        self.n_line_search = n_line_search

    # -- residual and factorization ---------------------------------------
    def residual_masked(self, u, m):
        """Residual (N, n) with Dirichlet rows replaced by (u - g)."""
        r = self.bound.residual(u, m)
        if self.rhs_vector is not None:
            r = r - self.rhs_vector
        return torch.where(self._mask, u - self._g, r)

    def _assemble_factorize(self, u, m):
        if self._band_order is None:
            band = self.bound.assemble_A_banded(u, m)
            band = bc_symmetrize_banded_masked(band, self._mask)
            return factorize_thomas_inv_banded(band)
        border = self._band_order
        band = self.bound.assemble_A_banded_ordered(u, m, border)
        band = bc_symmetrize_banded_masked(band, self._band_mask)
        return PermutedFactor(factorize_thomas_inv_banded(band), border)

    # -- linear forward solve -----------------------------------------------
    def linear_rhs(self, m):
        """Right-hand side (N, n) of the linear forward system: bc rows
        carry the Dirichlet values, and the lift of inhomogeneous values is
        a jvp of the residual (no assembled matrix)."""
        zero = torch.zeros((m.shape[0], self.state_dim), dtype=m.dtype,
                           device=m.device)
        b = -self.bound.residual(zero, m)
        if self.rhs_vector is not None:
            b = b + self.rhs_vector
        if self._has_bc:
            g = torch.where(self._mask, self._g, 0.0).expand_as(zero)
            lift = torch.func.jvp(lambda uu: self.bound.residual(uu, m),
                                  (zero,), (g,))[1]
            b = torch.where(self._mask, g, b - lift)
        return b

    def linear_convergence_check(self, u, m, b):
        """Per-lane convergence flag of solved linear systems: the residual
        norm against ~1.5e-5 (float64) or ~1.2e-4 (float32) relative to
        1 + |b|, loose enough for direct-factor roundoff and tight enough
        to flag a stagnated solve in both dtypes.
        Returns (converged (N,), residual_norm (N,))."""
        rn = torch.linalg.vector_norm(self.residual_masked(u, m), dim=1)
        eps = torch.finfo(m.dtype).eps
        tol_rel = max(1e3 * eps, min(1e3 * eps**0.5, 1e-4))
        tol = tol_rel * (1.0 + torch.linalg.vector_norm(b, dim=1))
        return rn <= tol, rn

    def _solve_linear(self, m):
        zero = torch.zeros((m.shape[0], self.state_dim), dtype=m.dtype,
                           device=m.device)
        b = self.linear_rhs(m)
        u = self._assemble_factorize(zero, m).solve(b)
        ok, rn = self.linear_convergence_check(u, m, b)
        it = torch.ones(m.shape[0], dtype=torch.long, device=m.device)
        return u, NewtonInfo(converged=ok, iterations=it, residual_norm=rn)

    # -- forward solve --------------------------------------------------------
    def solve_fwd(self, m, u0=None):
        """Forward solves for a batch of parameters m (N, n_m): linear, or
        Newton from initial guesses u0 (N, n) (zero where None).
        Returns (u, NewtonInfo); a linear solve reports 1 iteration."""
        if self.is_fwd_linear:
            return self._solve_linear(m)
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

    def apply_C(self, lin: Linearization, dm):
        """C dm with C = dr/dm of the masked residual (its Dirichlet rows
        are zero); dm (N, n_m) or (N, n_m, k)."""
        return self._zero_bc_rows(self.bound.apply_C(lin.u, lin.m, dm))

    def apply_Ct(self, lin: Linearization, dp):
        """C^T dp with C = dr/dm of the masked residual at the linearization
        point: its Dirichlet rows are zero, so C^T dp = C_r^T (keep * dp)."""
        return self.bound.apply_Ct(lin.u, lin.m, self._zero_bc_rows(dp))
