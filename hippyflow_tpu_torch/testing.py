"""The log-diffusion Poisson control problem (the port's copy of
``hippyflow_tpu/testing.py``, the reference's canonical unit-test PDE,
``hippyflow/test/setupPoissonControlProblem.py:391-482``):

    exp(m) grad(u) . grad(p) dx  [+ u^3 p dx]  - (mollifiers(x) . z) p dx

with 25 Gaussian-mollifier wells on a grid, Dirichlet data u = x_1 on the
top/bottom boundaries, a Robin-corrected anisotropic BiLaplacian prior,
and a uniform control distribution; pointwise and full-state
observables of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .fem import DirichletBC, FunctionSpace, GalerkinForm, unit_square_mesh
from .models import (
    BiLaplacianPrior,
    LinearStateObservable,
    PointwiseObservation,
    StateSpaceIdentityOperator,
    UniformDistribution,
    VariationalPDEProblem,
)


def poisson_control_settings() -> dict:
    """Mirrors `setupPoissonControlProblem.py:417-441`."""
    return {
        "nx": 20,
        "ny": 20,
        "STRENGTH_UPPER": 1.0,
        "STRENGTH_LOWER": -1.0,
        "LINEAR": True,
        "N_WELLS_PER_SIDE": 5,
        "LOC_LOWER": 0.25,
        "LOC_UPPER": 0.75,
        "WELL_WIDTH": 0.1,
        "GAMMA": 1.0,
        "DELTA": 20.0,
        "THETA0": 2.0,
        "THETA1": 0.5,
        "ALPHA": math.pi / 4,
    }


def make_poisson_varf(settings) -> GalerkinForm:
    """GalerkinForm of the Poisson control residual
    (`setupPoissonControlProblem.py:478-482`).  The source contracts the
    wells' mollifiers at the points (cells, points, wells) with each
    sample's control (N, wells) in one einsum."""
    grid = np.linspace(
        settings["LOC_LOWER"], settings["LOC_UPPER"], settings["N_WELLS_PER_SIDE"]
    )
    wx, wy = np.meshgrid(grid, grid)
    wells = np.stack([wx.ravel(), wy.ravel()], axis=1)  # (25, 2)
    b = settings["WELL_WIDTH"]
    a = 1.0 / (2.0 * math.pi * b**2)
    linear = settings["LINEAR"]

    def mollifiers(x):
        w = torch.as_tensor(wells, dtype=x.dtype, device=x.device)
        d2 = ((x[..., None, :] - w) ** 2).sum(-1)
        return a * torch.exp(-d2 / b**2)

    def flux(x, u, gu, m, z, c):
        return torch.exp(m)[..., None] * gu

    def source(x, u, gu, m, z, c):
        s = -torch.einsum("cqw,nw->ncq", mollifiers(x), z)
        if not linear:
            s = s + u**3
        return s

    return GalerkinForm(flux=flux, source=source, quad_degree=4, symmetric=True)


def _u_boundary(x):
    """Top/bottom boundary predicate (`setupPoissonControlProblem.py:386`)."""
    return (x[:, 1] < 1e-12) | (x[:, 1] > 1.0 - 1e-12)


def setup_poisson_control_problem(settings=None, mesh=None, dtype=None,
                                  device=None, **pde_kwargs):
    """Build (pde, prior, control_dist, Vh) as in
    `setupPoissonControlProblem.py:391-413`.  ``mesh`` replaces the unit
    square of ``settings`` (any numbering of it); ``pde_kwargs`` go to
    ``VariationalPDEProblem`` (``solver``, ``newton_stale_factor``, ...)."""
    settings = settings or poisson_control_settings()
    dtype, device = config.resolve(dtype, device)
    if mesh is None:
        mesh = unit_square_mesh(settings["nx"], settings["ny"])
    Vh = FunctionSpace(mesh)
    n_wells = settings["N_WELLS_PER_SIDE"] ** 2

    bc = DirichletBC.from_predicate(Vh, _u_boundary, lambda x: x[:, 1])
    form = make_poisson_varf(settings)
    pde = VariationalPDEProblem(
        Vh, Vh, form, bc, is_fwd_linear=settings["LINEAR"],
        control_dim=n_wells, dtype=dtype, device=device, **pde_kwargs,
    )
    prior = BiLaplacianPrior(
        Vh,
        settings["GAMMA"],
        settings["DELTA"],
        theta0=settings["THETA0"],
        theta1=settings["THETA1"],
        alpha=settings["ALPHA"],
        mean=torch.ones(Vh.dim, dtype=dtype, device=device),
        robin_bc=True,
        dtype=dtype,
        device=device,
    )
    control_dist = UniformDistribution(
        n_wells, settings["STRENGTH_LOWER"], settings["STRENGTH_UPPER"]
    )
    return pde, prior, control_dist, Vh


def poisson_pointwise_observable(pde, Vh, n_obs: int = 10, seed: int = 0):
    """Pointwise observable at random interior targets (the reference
    tests' setup, `test_derivativeSubspace.py:66-77`)."""
    rng = np.random.RandomState(seed)
    targets = rng.uniform(0.1, 0.9, (n_obs, 2))
    B = PointwiseObservation(Vh, targets, dtype=pde.dtype, device=pde.device)
    return LinearStateObservable(pde, B)


def poisson_full_state_observable(pde, Vh, use_mass_matrix: bool = True):
    """The full-state observable q = u, its transpose the mass matrix with
    ``use_mass_matrix``."""
    B = StateSpaceIdentityOperator(Vh, use_mass_matrix=use_mass_matrix,
                                   dtype=pde.dtype, device=pde.device)
    return LinearStateObservable(pde, B)
