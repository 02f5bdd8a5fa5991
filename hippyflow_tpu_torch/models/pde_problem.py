"""Variational PDE problems, batched over samples.

Port of ``hippyflow_tpu/models/pde_problem.py``.  Two band layouts on
structured meshes:

* a scalar state on a structured P1 mesh: the mesh's row-major numbering
  is block-tridiagonal with blocks of s = nx + 1 (confusion, the Poisson
  control problem);
* a scalar P2 state (``GalerkinForm``) or a vector state
  (``VectorGalerkinForm``, e.g. the helmholtz split-complex P2 state):
  the band is regained through the row ordering
  of ``fem/band_order.py``, assembled straight into permuted storage and
  factorized behind a ``PermutedFactor``; pad rows at the band tail count
  as constrained and factorize as identity rows.

Solver choices (``solver=``), as in the JAX package:

* ``thomas_inv``: inverse block-Thomas, K1/K2 on the card;
* ``block_cyclic``: block cyclic reduction, K3 once per level on all
  samples' eliminated blocks; ``needs`` prunes the forward or the
  transposed half;
* ``block_tridiag``: block-Thomas with pivoted LU blocks;
* ``dense``: dense assembly and Cholesky (a ``symmetric`` form) or
  pivoted LU, on any mesh;
* ``iterative``: matrix-free Jacobi-preconditioned BiCGStab on the jvp /
  vjp action of the bc-symmetrized A (``IterativeFactor``), on any mesh;
* ``auto``: on a structured mesh forward solves take ``thomas_inv`` and
  the adjoint factor (``needs`` != "fwd") takes ``thomas_inv`` where the
  blocks are large (s >= 128) or the band short (nb <= 256), else cyclic
  reduction; elsewhere ``dense``.

* ``dist_banded``: the band's block rows sharded over the ``dist_axis``
  of ``dist_mesh`` (a ``torch.distributed`` device mesh): each rank
  factorizes its own partitions of the partitioned SPIKE solve
  (``parallel/dist_banded.py``; K3 once per cyclic-reduction level), in as
  many partitions as the axis has ranks; forward and transposed solves
  take and return the global tensors every rank holds.

``RefinedBandFactor`` is not ported: the JAX
package wraps factors in it only under its lowered-precision solver
policy, and the port solves in IEEE precision.  On the card that policy
could only put the library products of ``block_cyclic`` and
``block_tridiag`` in TF32 (K1-K3 are IEEE); with the refinement sweep it
needs, it made neither faster (``python3 -m
hippyflow_tpu_torch.ops.tf32_sweep``).

Every method takes tensors with a leading sample axis, and the control z
(N, dz) where the problem has one (``control_dim``):

* ``solve_fwd``: a linear problem (``is_fwd_linear``) assembles,
  factorizes and solves once and checks its residual
  (``linear_convergence_check``); a nonlinear one runs Newton with a
  backtracking Armijo ladder and ``newton_stale_factor - 1`` chord steps
  per factorization.  As in the JAX package's vmapped ``while_loop``, a
  lane whose residual norm is under its tolerance takes no more steps
  while the other lanes go on; here the loop runs on the still-active
  lanes only.
* ``linearize``: assemble and factorize the bc-symmetrized A = dr/du.
* ``solve_incremental``: A du = rhs or A^T dp = rhs with bc rows of the rhs
  zeroed; ``apply_C`` / ``apply_Ct`` / ``apply_Cz`` / ``apply_Czt``: C dm,
  C^T dp, Cz dz and Cz^T dp with C = dr/dm and Cz = dr/dz of the masked
  residual.
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
    bc_symmetrize,
    bc_symmetrize_banded_masked,
)
from ..fem.band_order import ordered_band_mask, structured_band_order
from ..fem.vector_assembly import VectorBoundGalerkinForm, VectorGalerkinForm
from ..ops.linalg import factorize
from ..ops.structured import (
    PermutedFactor,
    factorize_block_cyclic_banded,
    factorize_block_tridiag_banded,
    factorize_thomas_inv_banded,
)
from ..utils.profiling import annotate, host_syncs

STATE, PARAMETER, ADJOINT, CONTROL = 0, 1, 2, 3
SOLVERS = ("auto", "dense", "block_tridiag", "block_cyclic", "thomas_inv",
           "iterative", "dist_banded")
BAND_SOLVERS = ("block_tridiag", "block_cyclic", "thomas_inv", "dist_banded")


class NewtonInfo(NamedTuple):
    converged: torch.Tensor  # (N,) bool
    iterations: torch.Tensor  # (N,) int64
    residual_norm: torch.Tensor  # (N,)


class Linearization(NamedTuple):
    """States and parameters (N, n), the controls (N, dz) or None, and the
    factor of the bc-symmetrized A = dr/du at each sample; the JAX
    package's field order."""

    u: torch.Tensor
    m: torch.Tensor
    z: torch.Tensor | None
    factor: object


def bicgstab(A, b, M, tol: float, maxiter: int, atol: float = 0.0):
    """Preconditioned BiCGStab on independent lanes b (L, n), A and M maps
    (L, n) -> (L, n) acting lane by lane.

    The recurrences, the stopping rule ||r|| <= max(tol ||b||, atol) and
    the breakdown exits (rho = 0, or alpha or omega = 0, end a lane) of
    ``jax.scipy.sparse.linalg.bicgstab``, from x0 = 0.  Every lane runs
    the same body and a lane that has stopped keeps its state, as a
    vmapped ``while_loop`` does, so each lane's iterates are those of its
    own solve.  A lane that reaches ``maxiter`` returns its last iterate:
    the caller reads the residual (``IterativeFactor.solve_info``)."""
    dot = lambda x, y: (x * y).sum(-1)
    col = lambda v: v[:, None]
    atol2 = torch.clamp(tol * tol * dot(b, b), min=atol * atol)
    x = torch.zeros_like(b)
    r = b - A(x)
    rhat, p, q = r, r, r
    alpha = omega = rho = torch.ones_like(atol2)
    k = torch.zeros(b.shape[0], dtype=torch.long, device=b.device)
    while True:
        active = (dot(r, r) > atol2) & (k < maxiter) & (k >= 0)
        if not bool(active.any()):
            return x
        rho_ = dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + col(beta) * (p - col(omega) * q)
        phat = M(p_)
        q_ = A(phat)
        alpha_ = rho_ / dot(rhat, q_)
        s = r - col(alpha_) * q_
        exit_early = col(dot(s, s) < atol2)
        shat = M(s)
        t = A(shat)
        omega_ = dot(t, s) / dot(t, t)
        x_ = torch.where(exit_early, x + col(alpha_) * phat,
                         x + (col(alpha_) * phat + col(omega_) * shat))
        r_ = torch.where(exit_early, s, s - col(omega_) * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        keep = col(active)
        x, r = torch.where(keep, x_, x), torch.where(keep, r_, r)
        p, q = torch.where(keep, p_, p), torch.where(keep, q_, q)
        alpha = torch.where(active, alpha_, alpha)
        omega = torch.where(active, omega_, omega)
        rho = torch.where(active, rho_, rho)
        k = torch.where(active, k_, k)


class IterativeFactor:
    """Matrix-free 'factorization': the linearization points and a Jacobi
    preconditioner; solves run BiCGStab (``bicgstab``) against the jvp /
    vjp action of the bc-symmetrized A, no operator matrix, O(n) memory.

    The rhs (N, n) or (N, n, k) becomes N k lanes, each with its sample's
    linearization point, solved at once.  The JAX package's argument
    order (u, m, z, diag, problem, tol, maxiter)."""

    def __init__(self, u, m, z, diag, problem, tol: float, maxiter: int):
        self.problem = problem
        self.u, self.m, self.z, self.diag = u, m, z, diag
        self.tol, self.maxiter = tol, maxiter

    def _operator(self, u, m, z, trans: bool):
        problem = self.problem
        keep, mask = problem._keep, problem._keep.new_ones(()) - problem._keep
        rm = lambda uu: problem.residual_masked(uu, m, z)
        if not trans:
            return lambda x: torch.func.jvp(rm, (u,), (keep * x,))[1] + mask * x
        _, pull = torch.func.vjp(rm, u)
        return lambda x: keep * pull(keep * x)[0] + mask * x

    def _solve_lanes(self, b, trans: bool):
        """(x like b, the operator on the lanes, lanes of b, lanes of x)."""
        squeeze = b.ndim == 2
        B = b[..., None] if squeeze else b
        N, n, k = B.shape
        lanes = B.transpose(1, 2).reshape(N * k, n)
        rep = lambda t: None if t is None else t.repeat_interleave(k, dim=0)
        op = self._operator(rep(self.u), rep(self.m), rep(self.z), trans)
        Minv = rep(1.0 / self.diag)
        x = bicgstab(op, lanes, lambda r: Minv * r, self.tol, self.maxiter)
        X = x.reshape(N, k, n).transpose(1, 2)
        return (X[..., 0] if squeeze else X), op, lanes, x

    def solve(self, b, trans: bool = False):
        return self._solve_lanes(b, trans)[0]

    def solve_info(self, b, trans: bool = False):
        """Solve and report health: (x, rel (N,)) with rel each sample's
        worst column ||A x - b|| / ||b||.  BiCGStab can stagnate silently;
        the explicit residual makes a stagnated solve visible."""
        X, op, lanes, x = self._solve_lanes(b, trans)
        tiny = torch.finfo(b.dtype).tiny
        rel = (torch.linalg.vector_norm(op(x) - lanes, dim=1)
               / torch.linalg.vector_norm(lanes, dim=1).clamp(min=tiny))
        return X, rel.reshape(b.shape[0], -1).amax(dim=1)


def _factorize_band(band, solver: str, with_transpose: bool,
                    with_forward: bool, dist=None):
    if solver == "dist_banded":
        from ..parallel.dist_banded import factorize_distributed_banded

        mesh, axis = dist
        return factorize_distributed_banded(
            band, mesh.size(mesh.mesh_dim_names.index(axis)),
            with_transpose=with_transpose, mesh=mesh, axis=axis)
    if solver == "thomas_inv":
        return factorize_thomas_inv_banded(band)
    if solver == "block_cyclic":
        return factorize_block_cyclic_banded(
            band, with_transpose=with_transpose, with_forward=with_forward)
    return factorize_block_tridiag_banded(band)


class VariationalPDEProblem:
    """PDE problem defined by a (Vector)GalerkinForm residual and Dirichlet
    BCs.

    is_fwd_linear: the residual is affine in u, so one factorization
    solves the forward problem.  control_dim: the size of the control z,
    or None.  newton_stale_factor: each factorization serves this many
    Newton steps (Shamanskii; 1 is classical Newton).  rhs_vector: a
    distributional right-hand side (point sources), residual -> residual -
    rhs_vector.  operator_symmetric: A^T = A as assembled (possibly
    indefinite), so an adjoint factor serves forward solves too (the fused
    sampling pass).  solver: see the module doc; ``dist_banded`` takes
    ``dist_mesh`` and ``dist_axis``.  The parameters are in the JAX
    package's order, then the port's ``dtype`` and ``device``."""

    def __init__(
        self,
        Vu: FunctionSpace,
        Vm: FunctionSpace,
        form,
        bc: DirichletBC,
        is_fwd_linear: bool = False,
        control_dim: int | None = None,
        newton_rtol: float = 1e-9,
        newton_atol: float = 1e-12,
        newton_max_iter: int = 25,
        n_line_search: int = 8,
        newton_stale_factor: int = 1,
        rhs_vector=None,
        solver: str = "auto",
        dist_mesh=None,
        dist_axis: str = "fem",
        operator_symmetric: bool = False,
        dtype=None,
        device=None,
    ):
        if solver not in SOLVERS:
            raise ValueError(f"solver={solver!r}: one of {SOLVERS}")
        if solver == "dist_banded" and (
                dist_mesh is None or dist_axis not in dist_mesh.mesh_dim_names):
            raise ValueError("solver='dist_banded' needs a dist_mesh with the "
                             f"axis {dist_axis!r}")
        self._dist = (dist_mesh, dist_axis) if solver == "dist_banded" else None
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
        structured = Vu.mesh.structured_shape is not None
        if solver in BAND_SOLVERS and not structured:
            raise ValueError(f"solver={solver!r} needs a structured mesh")
        self.solver = solver
        self._iterative_tol = 1e-10
        self._iterative_maxiter = 1000
        self._band_order = self._block_size = None
        if solver == "auto" and not structured:
            solver = "dense"
        if solver in ("dense", "iterative"):
            self.fwd_solver = self.adj_solver = solver
        else:
            if isinstance(form, VectorGalerkinForm) or Vu.degree != 1:
                border = structured_band_order(
                    Vu, ncomp=getattr(form, "ncomp", 1))
                self._band_order, self._block_size = border, border.s
                self.bound.prepare_banded_ordered(border)
                self._band_mask = torch.as_tensor(
                    ordered_band_mask(np.asarray(bc.mask), border),
                    device=self.device)
            else:
                self._block_size = Vu.mesh.structured_shape[0] + 1
            self.fwd_solver = self.adj_solver = solver
            if solver == "auto":
                # forward solves by inverse-Thomas; the adjoint factor too
                # where the blocks are large or the band short, cyclic
                # reduction on long thin bands
                nb = self.state_dim // self._block_size
                self.fwd_solver = "thomas_inv"
                self.adj_solver = ("thomas_inv" if self._block_size >= 128
                                   or nb <= 256 else "block_cyclic")
        self._mask = torch.as_tensor(bc.mask, device=self.device)
        self._has_bc = bool(np.asarray(bc.mask).any())
        self._g = torch.as_tensor(bc.value, dtype=self.dtype, device=self.device)
        self._keep = (~self._mask).to(self.dtype)
        self.is_fwd_linear = bool(is_fwd_linear)
        self.operator_symmetric = bool(operator_symmetric)
        self.control_dim = control_dim
        self.rhs_vector = (
            None if rhs_vector is None
            else torch.as_tensor(rhs_vector, dtype=self.dtype, device=self.device)
        )
        self.newton_rtol = newton_rtol
        self.newton_atol = newton_atol
        self.newton_max_iter = newton_max_iter
        self.n_line_search = n_line_search
        self.newton_stale_factor = max(1, int(newton_stale_factor))

    # read-only views of (fwd_solver, adj_solver) under the JAX package's
    # names, for the parity tests
    @property
    def _use_block_tridiag(self) -> bool:
        return self._block_size is not None

    @property
    def _structured_solver(self):
        return self.adj_solver if self._use_block_tridiag else None

    @property
    def _structured_solver_fwd(self):
        return self.fwd_solver if self._use_block_tridiag else None

    def bytes_per_sample(self, dtype) -> float:
        """Memory one sample's factorization takes: ~16 n s bytes for a
        band, its factor blocks and solve temporaries; 3 n^2 for a dense
        matrix and its factor (the ``dense`` and ``iterative`` solvers, as
        in the JAX package)."""
        itemsize = torch.tensor([], dtype=dtype).element_size()
        n = self.state_dim
        if self._block_size is not None:
            return 16.0 * n * self._block_size * itemsize
        return 3.0 * n * n * itemsize

    # -- hippyflow-parity helpers -------------------------------------------
    @property
    def has_control(self) -> bool:
        return self.control_dim is not None

    def _zeros(self, n, dtype):
        return torch.zeros(n, dtype=dtype or self.dtype, device=self.device)

    def generate_state(self, dtype=None):
        return self._zeros(self.state_dim, dtype)

    def generate_parameter(self, dtype=None):
        return self._zeros(self.Vm.dim, dtype)

    def generate_control(self, dtype=None):
        if not self.has_control:
            raise ValueError("the problem has no control")
        return self._zeros(self.control_dim, dtype)

    # -- residual and factorization ---------------------------------------
    def residual_masked(self, u, m, z=None):
        """Residual (N, n) with Dirichlet rows replaced by (u - g)."""
        with annotate("fem.residual", fine=True):
            r = self.bound.residual(u, m, z)
            if self.rhs_vector is not None:
                r = r - self.rhs_vector
            return torch.where(self._mask, u - self._g, r)

    def _assemble_factorize(self, u, m, z=None, needs: str = "both"):
        """Assemble the bc-symmetrized A = dr/du at (u, m, z) and factorize.
        ``needs`` ('both', 'fwd', 'adj') prunes the cyclic factor: 'fwd'
        skips A^T, 'adj' skips A; the other factors serve both."""
        if needs not in ("both", "fwd", "adj"):
            raise ValueError(f"needs={needs!r}")
        solver = self.fwd_solver if needs == "fwd" else self.adj_solver
        if solver == "iterative":
            diag = torch.where(self._mask, 1.0,
                               self.bound.assemble_A_diag(u, m, z))
            return IterativeFactor(u, m, z, diag, self, self._iterative_tol,
                                   self._iterative_maxiter)
        if solver == "dense":
            A = bc_symmetrize(self.bound.assemble_A(u, m, z), self.bc)
            return factorize(A, self.form.symmetric)
        if self._band_order is None:
            with annotate("fem.assemble", fine=True):
                band = bc_symmetrize_banded_masked(
                    self.bound.assemble_A_banded(u, m, z), self._mask)
            return _factorize_band(band, solver, needs != "fwd", needs != "adj",
                                   self._dist)
        border = self._band_order
        with annotate("fem.assemble", fine=True):
            band = bc_symmetrize_banded_masked(
                self.bound.assemble_A_banded_ordered(u, m, z, border),
                self._band_mask)
        return PermutedFactor(
            _factorize_band(band, solver, needs != "fwd", needs != "adj",
                            self._dist),
            border)

    # -- linear forward solve -----------------------------------------------
    def linear_rhs(self, m, z=None):
        """Right-hand side (N, n) of the linear forward system: bc rows
        carry the Dirichlet values, and the lift of inhomogeneous values is
        a jvp of the residual (no assembled matrix)."""
        with annotate("fem.residual", fine=True):
            zero = torch.zeros((m.shape[0], self.state_dim), dtype=m.dtype,
                               device=m.device)
            b = -self.bound.residual(zero, m, z)
            if self.rhs_vector is not None:
                b = b + self.rhs_vector
            if self._has_bc:
                g = torch.where(self._mask, self._g, 0.0).expand_as(zero)
                lift = torch.func.jvp(lambda uu: self.bound.residual(uu, m, z),
                                      (zero,), (g,))[1]
                b = torch.where(self._mask, g, b - lift)
            return b

    def linear_convergence_check(self, u, m, b, z=None):
        """Per-lane convergence flag of solved linear systems: the residual
        norm against ~1.5e-5 (float64) or ~1.2e-4 (float32) relative to
        1 + |b|, loose enough for direct-factor roundoff and tight enough
        to flag a stagnated solve in both dtypes.
        Returns (converged (N,), residual_norm (N,))."""
        rn = torch.linalg.vector_norm(self.residual_masked(u, m, z), dim=1)
        eps = torch.finfo(m.dtype).eps
        tol_rel = max(1e3 * eps, min(1e3 * eps**0.5, 1e-4))
        tol = tol_rel * (1.0 + torch.linalg.vector_norm(b, dim=1))
        return rn <= tol, rn

    def _solve_linear(self, m, z):
        zero = torch.zeros((m.shape[0], self.state_dim), dtype=m.dtype,
                           device=m.device)
        b = self.linear_rhs(m, z)
        u = self._assemble_factorize(zero, m, z, needs="fwd").solve(b)
        ok, rn = self.linear_convergence_check(u, m, b, z)
        it = torch.ones(m.shape[0], dtype=torch.long, device=m.device)
        return u, NewtonInfo(converged=ok, iterations=it, residual_norm=rn)

    # -- forward solve --------------------------------------------------------
    def _line_search(self, fac, u, r, rn, m, z, alphas, chord: bool):
        """One damped step u - alpha A^{-1} r with the first alpha of the
        ladder that passes Armijo, else the one of least residual.  A chord
        step (stale factor) that would raise the residual keeps u."""
        du = -fac.solve(r)
        rnorms = torch.stack([
            torch.linalg.vector_norm(self.residual_masked(u + a * du, m, z),
                                     dim=1)
            for a in alphas
        ])  # (n_line_search, Na)
        ok = rnorms < (1.0 - 1e-4 * alphas)[:, None] * rn
        first = ok.to(m.dtype).argmax(dim=0)  # first acceptable step
        pick = torch.where(ok.any(dim=0), first, rnorms.argmin(dim=0))
        u_new = u + alphas[pick][:, None] * du
        if chord:
            take = rnorms.gather(0, pick[None])[0] < rn
            u_new = torch.where(take[:, None], u_new, u)
        return u_new, self.residual_masked(u_new, m, z)

    def solve_fwd(self, m, z=None, u0=None):
        """Forward solves for a batch of parameters m (N, n_m) and controls
        z (N, dz): linear, or Newton from initial guesses u0 (N, n) (zero
        where None).  Returns (u, NewtonInfo); a linear solve reports 1
        iteration.  Each call is a ``newton.solve`` span; each round's read
        of the active lanes is a ``newton.sync`` span and counts in
        ``host_syncs``."""
        with annotate("newton.solve", fine=True, N=m.shape[0],
                      s=self._block_size):
            if self.is_fwd_linear:
                return self._solve_linear(m, z)
            return self._solve_newton(m, z, u0)

    def _solve_newton(self, m, z, u0):
        N = m.shape[0]
        u = self._g.expand(N, -1) if u0 is None else u0
        u = torch.where(self._mask, self._g, u)
        r = self.residual_masked(u, m, z)
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
            with annotate("newton.sync", fine=True):
                active = ((rn > tol) & (it < self.newton_max_iter)).nonzero()[:, 0]
            host_syncs.add("newton.sync")
            if active.numel() == 0:
                break
            ua, ra, ma = u[active], r[active], m[active]
            za = None if z is None else z[active]
            fac = self._assemble_factorize(ua, ma, za, needs="fwd")
            ua, ra = self._line_search(fac, ua, ra, rn[active], ma, za, alphas,
                                       chord=False)
            # Shamanskii: chord steps on the same factor, on the lanes
            # still above tolerance
            for _ in range(self.newton_stale_factor - 1):
                rna = torch.linalg.vector_norm(ra, dim=1)
                u2, r2 = self._line_search(fac, ua, ra, rna, ma, za, alphas,
                                           chord=True)
                take = (rna > tol[active])[:, None]
                ua, ra = torch.where(take, u2, ua), torch.where(take, r2, ra)
            u, r = u.index_copy(0, active, ua), r.index_copy(0, active, ra)
            rn = rn.index_copy(0, active, torch.linalg.vector_norm(ra, dim=1))
            it = it.index_add(0, active, torch.ones_like(active))
        info = NewtonInfo(converged=rn <= tol, iterations=it, residual_norm=rn)
        return u, info

    # -- linearization and incremental solves ----------------------------------
    def linearize(self, u, m, z=None, needs: str = "both") -> Linearization:
        """Assemble and factorize the bc-symmetrized A = dr/du at (u, m, z).
        ``needs='adj'`` builds a factor for adjoint solves only (what
        Jacobian materialization wants), ``'fwd'`` for forward solves
        only; only the cyclic factor is pruned."""
        return Linearization(u=u, m=m, z=z,
                             factor=self._assemble_factorize(u, m, z, needs))

    def _zero_bc_rows(self, x):
        return x * (self._keep[:, None] if x.ndim == 3 else self._keep)

    def solve_incremental(self, lin: Linearization, rhs, is_adj: bool = False,
                          return_info: bool = False):
        """A du = rhs (or A^T dp = rhs) with Dirichlet rows of the rhs
        zeroed first; rhs (N, n) or (N, n, k).  ``return_info`` also
        returns each sample's relative residual (N,): the iterative
        factor's ``solve_info``, 0 for the direct factors."""
        rhs = self._zero_bc_rows(rhs)
        if not return_info:
            return lin.factor.solve(rhs, trans=is_adj)
        if isinstance(lin.factor, IterativeFactor):
            return lin.factor.solve_info(rhs, trans=is_adj)
        return (lin.factor.solve(rhs, trans=is_adj),
                rhs.new_zeros(rhs.shape[0]))

    def apply_C(self, lin: Linearization, dm):
        """C dm with C = dr/dm of the masked residual (its Dirichlet rows
        are zero); dm (N, n_m) or (N, n_m, k)."""
        with annotate("fem.apply_c", fine=True):
            return self._zero_bc_rows(self.bound.apply_C(lin.u, lin.m, dm, lin.z))

    def apply_Ct(self, lin: Linearization, dp):
        """C^T dp with C = dr/dm of the masked residual at the linearization
        point: its Dirichlet rows are zero, so C^T dp = C_r^T (keep * dp)."""
        with annotate("fem.apply_c", fine=True):
            return self.bound.apply_Ct(lin.u, lin.m, self._zero_bc_rows(dp),
                                       lin.z)

    def _check_control(self):
        if not self.has_control:
            raise ValueError("the problem has no control")

    def apply_Cz(self, lin: Linearization, dz):
        """Cz dz with Cz = dr/dz of the masked residual; dz (N, dz) or
        (N, dz, k)."""
        self._check_control()
        return self._zero_bc_rows(self.bound.apply_Cz(lin.u, lin.m, lin.z, dz))

    def apply_Czt(self, lin: Linearization, dp):
        """Cz^T dp; dp (N, n) or (N, n, k) -> (N, dz) or (N, dz, k)."""
        self._check_control()
        return self.bound.apply_Czt(lin.u, lin.m, lin.z, self._zero_bc_rows(dp))

    def evalGradientParameter(self, u, m, p, z=None):
        """C^T p, the m-gradient of the Lagrangian's residual term."""
        return self.apply_Ct(Linearization(u, m, z, None), p)
