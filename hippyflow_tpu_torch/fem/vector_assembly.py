"""Multi-component (vector-valued state) Galerkin assembly, batched over
samples (port of ``hippyflow_tpu/fem/vector_assembly.py``).

States with ``ncomp`` components of a P1 or P2 space on one mesh, in the
component-major layout ``u = [u_0, ..., u_{ncomp-1}]`` (each block of
length ``n = Vu.dim``); the parameter m is a scalar field of any degree
on the same mesh.  The form callables act on whole tensors with leading
(sample, cell, quadrature point) axes:

    flux(x, u, grad_u, m, z, c)   -> (..., ncomp, 2)
    source(x, u, grad_u, m, z, c) -> (..., ncomp)

with ``u`` (..., ncomp), ``grad_u`` (..., ncomp, 2), ``m`` (...), and the
residual is  sum_e int F[k] . grad v_k + S[k] v_k  per component k.

Element Jacobians dr_e/du_e and dr_e/dm_e are forward-mode derivatives of
the element residual (``torch.func.jvp``, one tangent per local dof), as
``jax.jacfwd`` gives them in the JAX package, so they agree with the
residual by construction.  The band of dr/du is gathered straight into the
permuted (nb, s, 3s) storage of a ``BandOrder`` (``fem/band_order.py``):
each nonzero band slot sums its element contributions, with no scatter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from .. import config
from .assembly import _OrderedBand
from .space import FunctionSpace


@dataclass(frozen=True)
class VectorGalerkinForm:
    """Weak form of an ``ncomp``-component state (see the module doc).
    The callables receive the control ``z`` (N, dz) or None and ``c``, a
    dict of coefficient values at the points, each (nc, nq) or (nc, nq, k)
    and so broadcast over the sample axis:

    coefficients: name -> (n_vertices,) or (n_vertices, k) P1 dof values
        on the mesh, interpolated at the quadrature points;
    cell_coefficients: name -> (nc,) per-cell constants (e.g. the cell
        diameters of a stabilization term).

    ``symmetric``: dr/du is SPD (Cholesky in the ``dense`` solver).  The
    fields are in the JAX package's order."""

    ncomp: int
    flux: Callable | None = None
    source: Callable | None = None
    quad_degree: int = 2
    symmetric: bool = False
    coefficients: Mapping[str, np.ndarray] = field(default_factory=dict)
    cell_coefficients: Mapping[str, np.ndarray] = field(default_factory=dict)


class VectorBoundGalerkinForm(_OrderedBand):
    """A VectorGalerkinForm bound to (state space, parameter space) on
    one device; the parameter space may have any degree (its own dofmap
    ``cells_m`` and basis ``phi_m`` (nq, nd_m)).  Entry points, all batched
    over a leading sample axis (m (N, n_m)):

      residual(u, m)                        (N, n_total) -> (N, n_total)
      assemble_A(u, m)                      dense dr/du (N, n_total, n_total)
      assemble_A_diag(u, m)                 its diagonal (N, n_total)
      assemble_A_banded_ordered(u, m, z, border)
                                            dr/du in band order (N, nb, s, 3s)
      apply_C(u, m, dm), apply_Ct(u, m, dp) (dr/dm) dm and (dr/dm)^T dp
    """

    def __init__(self, Vu: FunctionSpace, Vm: FunctionSpace,
                 form: VectorGalerkinForm, dtype=None, device=None):
        if Vu.mesh is not Vm.mesh:
            raise ValueError("state/parameter spaces must share a mesh")
        self.dtype, self.device = config.resolve(dtype, device)
        self.Vu, self.Vm, self.form = Vu, Vm, form
        self.ncomp = form.ncomp
        self.nd = Vu.nd
        self.n = Vu.dim
        self.n_m = Vm.dim
        self.n_total = self.n * self.ncomp
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        cells = np.asarray(Vu.cell_dofs, dtype=np.int64)
        self.cells = torch.as_tensor(cells, device=self.device)
        self.cells_m = torch.as_tensor(np.asarray(Vm.cell_dofs, dtype=np.int64),
                                       device=self.device)
        # (nc, nd, ncomp) stacked dof id of each local (dof, component)
        segs = cells[:, :, None] + np.arange(self.ncomp)[None, None, :] * self.n
        self._band_dofs = segs.reshape(-1, self.nd * self.ncomp)
        self._segs = torch.as_tensor(segs.reshape(-1), device=self.device)
        phi, gphi, xq, wdet = Vu.quad_data(form.quad_degree)
        phi_m = Vm.quad_data(form.quad_degree)[0]
        nq = phi.shape[0]
        self._phi = t(phi)  # (nq, nd)
        self._phi_m = t(phi_m)  # (nq, nd_m)
        # (nc, nq, nd, 2) physical basis gradients (P1: constant in q)
        self._grads = t(
            np.broadcast_to(gphi, (gphi.shape[0], nq) + gphi.shape[2:]).copy())
        self._xq = t(xq)  # (nc, nq, 2)
        self._wdet = t(wdet)  # (nc, nq)
        # P1 dof values at the points through the vertex cells, then the
        # per-cell constants, each (nc, nq, ...)
        lam = Vu.quad_points(form.quad_degree)[0]
        coef = {name: t(np.einsum("qi,ci...->cq...", lam,
                                  np.asarray(dofs)[Vu.mesh.cells]))
                for name, dofs in form.coefficients.items()}
        for name, vals in form.cell_coefficients.items():
            coef[name] = t(np.repeat(np.asarray(vals)[:, None], nq, axis=1))
        self._coef = coef

    # -- element kernel ----------------------------------------------------
    def _r_elem(self, u_e, m_e, z=None):
        """Element residuals (N, nc, nd, ncomp) from element values u_e
        (N, nc, nd, ncomp) and m_e (N, nc, nd_m)."""
        uq = torch.einsum("qi,ncik->ncqk", self._phi, u_e)
        gu = torch.einsum("cqid,ncik->ncqkd", self._grads, u_e)
        mq = torch.einsum("qi,nci->ncq", self._phi_m, m_e)
        out = 0.0
        if self.form.flux is not None:
            F = self.form.flux(self._xq, uq, gu, mq, z, self._coef)
            F = F * self._wdet[:, :, None, None]
            out = out + torch.einsum("cqid,ncqkd->ncik", self._grads, F)
        if self.form.source is not None:
            S = self.form.source(self._xq, uq, gu, mq, z, self._coef)
            out = out + torch.einsum("qi,ncqk->ncik", self._phi,
                                     S * self._wdet[:, :, None])
        return out

    def _elements(self, u, m):
        N = u.shape[0]
        u_e = u.reshape(N, self.ncomp, self.n)[:, :, self.cells]
        return u_e.permute(0, 2, 3, 1), m[:, self.cells_m]

    def _elem_jacobian(self, u, m, z, wrt: str):
        """Element blocks (N, nc, nd*ncomp, L): d r_e[(a, k)] / d x_e[l]
        with x = u (L = nd*ncomp, local order (dof, component)) or m
        (L = nd_m)."""
        u_e, m_e = self._elements(u, m)
        if wrt == "u":
            f, x = (lambda xx: self._r_elem(xx, m_e, z)), u_e
        else:
            f, x = (lambda xx: self._r_elem(u_e, xx, z)), m_e
        flat = x.reshape(x.shape[0], x.shape[1], -1)
        cols = []
        for j in range(flat.shape[-1]):
            tangent = torch.zeros_like(flat)
            tangent[..., j] = 1.0
            cols.append(torch.func.jvp(f, (x,), (tangent.reshape(x.shape),))[1])
        J = torch.stack(cols, dim=-1)  # (N, nc, nd, ncomp, L)
        return J.reshape(J.shape[0], J.shape[1], self.nd * self.ncomp, -1)

    # -- entry points --------------------------------------------------------
    def residual(self, u, m, z=None):
        """Global residual r(u, m, z): (N, n_total)."""
        r_e = self._r_elem(*self._elements(u, m), z)
        out = torch.zeros((u.shape[0], self.n_total), dtype=r_e.dtype,
                          device=r_e.device)
        return out.index_add_(1, self._segs, r_e.reshape(u.shape[0], -1))

    def assemble_A(self, u, m, z=None):
        """Dense dr/du (N, n_total, n_total)."""
        A_e = self._elem_jacobian(u, m, z, "u")
        rows = self._segs.reshape(-1, self.nd * self.ncomp)
        flat = (rows[:, :, None] * self.n_total + rows[:, None, :]).reshape(-1)
        N = u.shape[0]
        A = torch.zeros((N, self.n_total * self.n_total), dtype=A_e.dtype,
                        device=A_e.device)
        A.index_add_(1, flat, A_e.reshape(N, -1))
        return A.reshape(N, self.n_total, self.n_total)

    def assemble_A_diag(self, u, m, z=None):
        """The diagonal of dr/du (N, n_total), one element pass."""
        A_e = self._elem_jacobian(u, m, z, "u")
        out = A_e.new_zeros((u.shape[0], self.n_total))
        return out.index_add_(1, self._segs,
                              torch.diagonal(A_e, dim1=-2, dim2=-1).reshape(
                                  u.shape[0], -1))

    def apply_C(self, u, m, dm, z=None):
        """(dr/dm) dm for dm (N, n_m) or (N, n_m, k)."""
        squeeze = dm.ndim == 2
        if squeeze:
            dm = dm[..., None]
        C = self._elem_jacobian(u, m, z, "m")  # (N, nc, a, nd_m)
        N, k = dm.shape[0], dm.shape[-1]
        r_e = torch.einsum("ncab,ncbk->ncak", C, dm[:, self.cells_m])
        out = torch.zeros((N, self.n_total, k), dtype=r_e.dtype,
                          device=r_e.device)
        out.index_add_(1, self._segs, r_e.reshape(N, -1, k))
        return out[..., 0] if squeeze else out

    def apply_Ct(self, u, m, dp, z=None):
        """(dr/dm)^T dp for dp (N, n_total) or (N, n_total, k)."""
        squeeze = dp.ndim == 2
        if squeeze:
            dp = dp[..., None]
        C = self._elem_jacobian(u, m, z, "m")  # (N, nc, a, nd_m)
        N, k = dp.shape[0], dp.shape[-1]
        dp_e = dp[:, self._segs].reshape(N, C.shape[1], C.shape[2], k)
        contrib = torch.einsum("ncab,ncak->ncbk", C, dp_e)
        out = torch.zeros((N, self.n_m, k), dtype=contrib.dtype,
                          device=contrib.device)
        out.index_add_(1, self.cells_m.reshape(-1), contrib.reshape(N, -1, k))
        return out[..., 0] if squeeze else out


class ComponentObservation:
    """Pointwise observation of one component of a vector state: wraps a
    scalar ``PointwiseObservation`` (B (n_obs, n))."""

    materializable = True

    def __init__(self, B_scalar, ncomp: int, component: int = 0):
        self.inner = B_scalar
        self.ncomp = ncomp
        self.component = component

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def state_dim(self) -> int:
        return self.inner.B.shape[1] * self.ncomp

    def _cols(self):
        n = self.inner.B.shape[1]
        return slice(self.component * n, (self.component + 1) * n)

    def apply(self, u):
        """B u for states (N, n * ncomp) -> (N, n_obs), or blocks
        (N, n * ncomp, k) -> (N, n_obs, k)."""
        return self.inner.apply(u[:, self._cols()])

    def applyt(self, q):
        """B^T q for (N, n_obs) -> (N, n * ncomp), or (N, n_obs, k) ->
        (N, n * ncomp, k): the scalar B^T q in the component's slot, zeros
        in the others."""
        inner = self.inner.applyt(q)
        out = inner.new_zeros((inner.shape[0], self.state_dim)
                              + inner.shape[2:])
        out[:, self._cols()] = inner
        return out

    def dense(self):
        Bd = self.inner.dense()
        out = torch.zeros((Bd.shape[0], self.state_dim), dtype=Bd.dtype,
                          device=Bd.device)
        out[:, self._cols()] = Bd
        return out
