"""Steady incompressible Navier-Stokes for the confusion velocity field
(port of ``applications/navier_stokes.py``).

Steady NS at Re = 100 on the unit square, driven up the left wall and down
the right wall

    g = (0, (x<eps) - (x>1-eps))  on the whole boundary,

pressure pinned at the origin corner.  Equal-order P1 velocity and
pressure with Brezzi-Pitkaranta pressure stabilization
(+ delta h^2 grad p . grad q), solved by Newton with Reynolds
continuation.  The weak form

    (2/Re) strain(v):strain(w) + (grad v . v) . w - p div w + div v q = 0

is a 3-component ``VectorGalerkinForm`` (vx, vy, p), written batch-first on
(..., ncomp) arrays.  On a structured mesh the state is solved in the band
order of ``fem/band_order.py``: velocity and pressure interleaved per node,
blocks of s = 3 (nx + 1), an indefinite nonsymmetric saddle-point band
factorized by the inverse block-Thomas kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..fem import DirichletBC, FunctionSpace
from ..fem.vector_assembly import VectorGalerkinForm
from ..models import VariationalPDEProblem


class NSInfo(NamedTuple):
    """The last Newton solve's ``NewtonInfo`` fields, each of length 1,
    and ``history``: (Re, Newton iterations, converged) of every
    continuation step."""

    converged: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    history: list


def _ns_form(V: FunctionSpace, Re: float, stab_delta: float = 0.05) -> VectorGalerkinForm:
    h = V.mesh.cell_diameters()

    def flux(x, u, gu, m, z, c):
        gv = gu[..., :2, :]  # (..., 2, 2) velocity gradient
        p = u[..., 2]
        strain = 0.5 * (gv + gv.transpose(-1, -2))
        eye = torch.eye(2, dtype=u.dtype, device=u.device)
        F_v = (2.0 / Re) * strain - p[..., None, None] * eye
        F_p = stab_delta * (c["h"] ** 2)[..., None] * gu[..., 2, :]  # Brezzi-Pitkaranta
        return torch.cat([F_v, F_p[..., None, :]], dim=-2)

    def source(x, u, gu, m, z, c):
        gv = gu[..., :2, :]
        adv = torch.einsum("...ij,...j->...i", gv, u[..., :2])  # (grad v) v
        div_v = gv[..., 0, 0] + gv[..., 1, 1]
        return torch.cat([adv, div_v[..., None]], dim=-1)

    return VectorGalerkinForm(
        ncomp=3,
        flux=flux,
        source=source,
        quad_degree=3,
        symmetric=False,
        cell_coefficients={"h": h},
    )


def _ns_bc(V: FunctionSpace) -> DirichletBC:
    n = V.dim
    x = V.dof_coords
    on_boundary = V.mesh.boundary_mask
    mask = np.zeros(3 * n, dtype=bool)
    value = np.zeros(3 * n)
    # vx = 0 on the whole boundary
    mask[:n] = on_boundary
    # vy = (x<eps) - (x>1-eps) on the whole boundary
    mask[n : 2 * n] = on_boundary
    g = (x[:, 0] < 1e-14).astype(float) - (x[:, 0] > 1 - 1e-14).astype(float)
    value[n : 2 * n] = np.where(on_boundary, g, 0.0)
    # pressure pinned at the origin corner
    corner = int(np.argmin(x[:, 0] ** 2 + x[:, 1] ** 2))
    mask[2 * n + corner] = True
    return DirichletBC(mask=mask, value=value)


def steady_navier_stokes(
    V: FunctionSpace,
    Re: float = 100.0,
    continuation=(10.0, 40.0),
    newton_max_iter: int = 50,
    dtype=torch.float64,
    device=None,
):
    """Solve steady NS; returns (velocity (n, 2), pressure (n,), info) as
    tensors on ``device``, and an ``NSInfo``.

    Reynolds continuation: solve at each Re of ``continuation`` below
    ``Re`` and then at ``Re``, each Newton solve warm-started from the last.
    Raises RuntimeError if the last solve did not converge."""
    dtype, device = config.resolve(dtype, device)
    bc = _ns_bc(V)
    n = V.dim
    u = None
    m_dummy = torch.zeros((1, V.dim), dtype=dtype, device=device)
    history = []
    for re_k in [r for r in continuation if r < Re] + [Re]:
        problem = VariationalPDEProblem(
            V,
            V,
            _ns_form(V, re_k),
            bc,
            is_fwd_linear=False,
            newton_max_iter=newton_max_iter,
            newton_rtol=1e-8,
            dtype=dtype,
            device=device,
        )
        u, info = problem.solve_fwd(m_dummy, u0=u)
        history.append((re_k, int(info.iterations[0]), bool(info.converged[0])))
    if not history[-1][2]:
        raise RuntimeError(
            f"steady Navier-Stokes at Re={Re} did not converge in "
            f"{newton_max_iter} Newton steps (residual "
            f"{float(info.residual_norm[0]):.3e}; steps {history})")
    u = u[0]
    velocity = torch.stack([u[:n], u[n : 2 * n]], dim=1)
    return velocity, u[2 * n :], NSInfo(*info, history)

