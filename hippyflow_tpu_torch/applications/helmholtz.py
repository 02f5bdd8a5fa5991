"""Frequency-domain acoustic Helmholtz with PML absorbing layers.

Port of ``applications/helmholtz.py``: the complex field split into a
2-component real state (u1, u2) on a P2 space, on a rectangle with
quadratic-profile PML stretching

    sigma_x = (x<xL) A (x-xL)^2/tL^2 + (x>xR) A (x-xR)^2/tR^2      (A = 50)

and wavenumber k = (omega / (c rho)) e^m with m a P1 field.  The PML
tensors reduce to the identity and zero where sigma = 0, so one unified
form over the whole domain is evaluated, sigma in closed form at each
quadrature point.  A unit point source near the top boundary drives the
real component (the problem's ``rhs_vector``); the observable reads both
components at a grid of targets near the source.

The split form [[P, Q], [Q, -P]] assembles to A^T = A (indefinite), so the
problem is marked ``operator_symmetric`` and the active-subspace pipeline
takes the fused pass (one factorization per sample).  With its row order
(``fem/band_order.py``) the P2 split state at nx=64 (ny=51) is a band of
nb=52 block rows of s=516 (26574 dofs, 258 pad rows at the tail).

The prior is the dense BiLaplacian with gamma=1, delta=5 on the P1
parameter space (``helmholtz_problem_setup.py:42-55`` of the reference
setup scripts), or with ``use_bilaplacian=False`` the Laplacian prior.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..fem import (
    DirichletBC,
    FunctionSpace,
    assemble_pointwise_observation,
    rectangle_mesh,
)
from ..fem.vector_assembly import VectorGalerkinForm
from ..models import (
    BiLaplacian2D,
    LaplacianPrior,
    LinearStateObservable,
    VariationalPDEProblem,
)

SPEED_OF_SOUND = 343.4  # m/s
AIR_DENSITY = 1.204  # kg/m^3

BOX = (0.0, 0.0, 3.0, 3.0)
BOX_PML = (-1.0, -1.0, 4.0, 3.0)
PML_A = 50.0


class VectorPointwiseObservation:
    """All components of a vector state observed at target points:
    q[t * ncomp + k] = u_k(x_t), a dense B (nt * ncomp, n * ncomp) on the
    device."""

    materializable = True

    def __init__(self, space: FunctionSpace, targets, ncomp: int, dtype=None,
                 device=None):
        dtype, device = config.resolve(dtype, device)
        Bs = assemble_pointwise_observation(space, np.asarray(targets))
        nt, n = Bs.shape
        Bfull = np.zeros((nt * ncomp, n * ncomp))
        for k in range(ncomp):
            Bfull[k::ncomp, k * n : (k + 1) * n] = Bs
        self.B = torch.as_tensor(Bfull, dtype=dtype, device=device)
        self.targets = np.asarray(targets)

    @property
    def dim(self) -> int:
        return self.B.shape[0]

    @property
    def state_dim(self) -> int:
        return self.B.shape[1]

    def apply(self, u):
        """B u for states (N, n * ncomp) -> (N, nt * ncomp), or blocks
        (N, n * ncomp, k) -> (N, nt * ncomp, k)."""
        return u @ self.B.T if u.ndim == 2 else self.B @ u

    def applyt(self, q):
        """B^T q for (N, nt * ncomp) -> (N, n * ncomp), or blocks
        (N, nt * ncomp, k) -> (N, n * ncomp, k)."""
        return q @ self.B if q.ndim == 2 else self.B.T @ q

    def dense(self):
        return self.B


def _sigma(x, lo, hi, t_lo, t_hi):
    below = torch.where(x < lo, PML_A * (x - lo) ** 2 / t_lo**2, 0.0)
    above = torch.where(x > hi, PML_A * (x - hi) ** 2 / t_hi**2, 0.0)
    return below + above


def helmholtz_form(wave_number: float, box=BOX, box_pml=BOX_PML) -> VectorGalerkinForm:
    t = [box_pml[i] - box[i] for i in range(4)]
    t = [1.0 if abs(ti) < 1e-14 else abs(ti) for ti in t]

    def pml_tensors(x, m):
        """(Dr, Di) (..., 2) diagonal PML tensors and (Kr, Ki) (...) at the
        points x (..., 2) for the parameter values m (...)."""
        k = wave_number * torch.exp(m)
        ksq = k * k
        sx = _sigma(x[..., 0], box[0], box[2], t[0], t[2])
        sy = _sigma(x[..., 1], box[1], box[3], t[1], t[3])
        Dr = torch.stack(
            [(ksq + sx * sy) / (ksq + sx * sx), (ksq + sx * sy) / (ksq + sy * sy)],
            dim=-1,
        )
        Di = torch.stack(
            [k * (sx - sy) / (ksq + sx * sx), k * (sy - sx) / (ksq + sy * sy)],
            dim=-1,
        )
        return Dr, Di, ksq - sx * sy, -k * (sx + sy)

    def flux(x, u, gu, m, z, c):
        Dr, Di, _, _ = pml_tensors(x, m)
        F1 = Dr * gu[..., 0, :] + Di * gu[..., 1, :]
        F2 = -Dr * gu[..., 1, :] + Di * gu[..., 0, :]
        return torch.stack([F1, F2], dim=-2)

    def source(x, u, gu, m, z, c):
        _, _, Kr, Ki = pml_tensors(x, m)
        S1 = -Kr * u[..., 0] - Ki * u[..., 1]
        S2 = Kr * u[..., 1] - Ki * u[..., 0]
        return torch.stack([S1, S2], dim=-1)

    return VectorGalerkinForm(ncomp=2, flux=flux, source=source, quad_degree=4)


def helmholtz_linear_observable(
    nx: int = 64,
    ny: int | None = None,
    sqrt_n_obs: int = 10,
    frequency: float = 300.0,
    box=BOX,
    box_pml=BOX_PML,
    state_degree: int = 2,
    operator_symmetric: bool = True,
    dtype=None,
    device=None,
    **pde_kwargs,
):
    """Build the Helmholtz observable.  State: the (re, im) field on a P2
    space (``state_degree``); parameter: P1.  Returns (observable, Vh) with
    Vh the parameter space; the state space is ``observable.problem.Vu``.
    ``operator_symmetric=False`` keeps the staged pipeline (forward solves,
    then Jacobians), for comparison with the fused pass; other keywords
    (``solver``, ``dist_mesh``, ``dist_axis``, ...) pass through to
    ``VariationalPDEProblem``."""
    if ny is None:
        ny = int(round(nx * (box_pml[3] - box_pml[1]) / (box_pml[2] - box_pml[0])))
    mesh = rectangle_mesh(nx, ny, box_pml[0], box_pml[1], box_pml[2], box_pml[3])
    Vu = FunctionSpace(mesh, degree=state_degree)
    Vh = FunctionSpace(mesh)
    n = Vu.dim

    omega = 2.0 * math.pi * frequency
    wave_number = omega / (SPEED_OF_SOUND * AIR_DENSITY)

    # unit point source on the real component near the top boundary
    source_loc = ((box[0] + 0.1 + (box[2] - 0.1) / 2) / 2, box[3] - 0.15)
    rhs = np.zeros(2 * n)
    rhs[:n] = assemble_pointwise_observation(Vu, np.array([source_loc]))[0]
    # no Dirichlet conditions: the PML absorbs outgoing waves
    bc = DirichletBC(mask=np.zeros(2 * n, dtype=bool), value=np.zeros(2 * n))
    pde = VariationalPDEProblem(
        Vu,
        Vh,
        helmholtz_form(wave_number, box, box_pml),
        bc,
        is_fwd_linear=True,
        rhs_vector=rhs,
        operator_symmetric=operator_symmetric,
        dtype=dtype,
        device=device,
        **pde_kwargs,
    )

    obs_length = 0.2
    x_targets = np.linspace(
        source_loc[0] - obs_length, source_loc[0] + obs_length, sqrt_n_obs
    )
    y_targets = np.linspace(
        box[3] - 0.05 - obs_length, box[3] - obs_length + 0.15, sqrt_n_obs
    )
    targets = np.array([(xi, yi) for xi in x_targets for yi in y_targets])
    B = VectorPointwiseObservation(Vu, targets, ncomp=2, dtype=pde.dtype,
                                   device=pde.device)
    return LinearStateObservable(pde, B), Vh


def helmholtz_prior(Vh, gamma: float = 1.0, delta: float = 5.0,
                    use_bilaplacian: bool = True, dtype=None, device=None):
    """The prior with the reference setup's defaults (gamma=1, delta=5):
    the dense BiLaplacian, or with ``use_bilaplacian=False`` the Laplacian
    prior (``LaplacianPrior``)."""
    if use_bilaplacian:
        return BiLaplacian2D(Vh, gamma=gamma, delta=delta, dtype=dtype,
                             device=device)
    return LaplacianPrior(Vh, gamma, delta, dtype=dtype, device=device)
