"""Confusion problem: advection-reaction-diffusion with cubic nonlinearity.

Port of ``applications/confusion.py``:

    (h/|v|) (v . grad u)(v . grad p) dx      SUPG-like stabilization
  + k grad(u) . grad(p) dx                  diffusion, k = 0.01
  + (v . grad u) p dx                       advection
  + c e^m u^3 p dx                          cubic reaction, c = 1
  - f p dx                                  Gaussian-blob source

with homogeneous Dirichlet BCs, 100 pointwise observations on a grid in
[0.6, 0.8]^2, and the BiLaplacian prior: dense up to 20000 dofs, banded
(``StructuredBiLaplacianPrior``) above, as in the JAX package.

Two lanes of ``bench.py`` run here: nx=64 (4225 dofs, blocks s=65) and
nx=192 (37249 dofs, s=193, the structured prior).  Newton cold-starts
every lane: the grid-sequenced warm starts of the JAX package
(``fem/multigrid.py``) are not ported.

The velocity is either 'analytic' (the stream-function vortex of the JAX
package) or an (n, 2) array of P1 dof values, e.g. the steady
Navier-Stokes field that ``load_ns_velocity`` reads from
``.bench/ns_velocity_nx<nx>.npy``.  The Navier-Stokes solver itself is not
ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..fem import (
    DirichletBC,
    FunctionSpace,
    GalerkinForm,
    grid_targets,
    unit_square_mesh,
)
from ..models import (
    BiLaplacian2D,
    LinearStateObservable,
    PointwiseObservation,
    StructuredBiLaplacianPrior,
    VariationalPDEProblem,
)

_BENCH_DIR = Path(__file__).resolve().parents[2] / ".bench"


def load_ns_velocity(nx: int) -> np.ndarray:
    """The cached steady-NS velocity (n, 2) at mesh size nx."""
    return np.load(_BENCH_DIR / f"ns_velocity_nx{nx}.npy")


def confusion_velocity(V: FunctionSpace, kind="analytic") -> np.ndarray:
    """(n, 2) P1 dof values: kind='analytic' or an (n, 2) array."""
    if not isinstance(kind, str):
        vel = np.asarray(kind)
        if vel.shape != (V.dim, 2):
            raise ValueError(f"velocity array shape {vel.shape}")
        return vel
    if kind != "analytic":
        raise NotImplementedError(
            f"velocity={kind!r}: pass 'analytic' or an array "
            "(load_ns_velocity reads the cached Navier-Stokes field)"
        )
    x = V.dof_coords
    vx = -np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])
    vy = np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    return np.stack([vx, vy], axis=1)


def confusion_source(V: FunctionSpace) -> np.ndarray:
    """f = max(0.5, exp(-25 |x - (0.7, 0.7)|^2)) at the dofs."""
    x = V.dof_coords
    blob = np.exp(-25.0 * ((x[:, 0] - 0.7) ** 2 + (x[:, 1] - 0.7) ** 2))
    return np.maximum(0.5, blob)


def confusion_form(V: FunctionSpace, c: float = 1.0, k: float = 0.01,
                   velocity="analytic") -> GalerkinForm:
    vel = confusion_velocity(V, kind=velocity)
    f = confusion_source(V)
    h = V.mesh.cell_diameters()

    def flux(x, u, gu, m, z, coef):
        v = coef["vel"]
        v_norm = torch.sqrt((v * v).sum(-1) + 1e-6)
        # SUPG-like term (h/|v|)(v . grad u) v, plus diffusion k grad u
        vgu = (v * gu).sum(-1)
        return (coef["h"] / v_norm * vgu)[..., None] * v + k * gu

    def source(x, u, gu, m, z, coef):
        return (coef["vel"] * gu).sum(-1) + c * torch.exp(m) * u**3 - coef["f"]

    return GalerkinForm(
        flux=flux,
        source=source,
        quad_degree=4,
        coefficients={"vel": vel, "f": f},
        cell_coefficients={"h": h},
    )


def confusion_linear_observable(
    nx: int = 64,
    sqrt_n_obs: int = 10,
    c: float = 1.0,
    k: float = 0.01,
    newton_max_iter: int = 25,
    velocity="analytic",
    n_line_search: int = 4,
    dtype=None,
    device=None,
    **pde_kwargs,
):
    """Build the confusion observable.  Returns (observable, Vh)."""
    mesh = unit_square_mesh(nx)
    Vh = FunctionSpace(mesh)
    bc = DirichletBC.from_predicate(Vh, None, 0.0)
    pde = VariationalPDEProblem(
        Vh,
        Vh,
        confusion_form(Vh, c=c, k=k, velocity=velocity),
        bc,
        newton_max_iter=newton_max_iter,
        n_line_search=n_line_search,
        dtype=dtype,
        device=device,
        **pde_kwargs,
    )
    targets = grid_targets(0.6, 0.8, sqrt_n_obs)
    B = PointwiseObservation(Vh, targets, dtype=pde.dtype, device=pde.device)
    return LinearStateObservable(pde, B), Vh


def confusion_prior(Vh: FunctionSpace, gamma: float = 0.1, delta: float = 1.0,
                    dtype=None, device=None):
    """BiLaplacian prior with the confusion setup's defaults (gamma=0.1,
    delta=1.0, ``confusion_problem_setup.py``): beyond 20000 dofs the
    banded ``StructuredBiLaplacianPrior`` (same distribution, O(n s)
    memory; the nx=192 lane), else the dense one."""
    if Vh.mesh.structured_shape is not None and Vh.dim > 20000:
        return StructuredBiLaplacianPrior(Vh, gamma=gamma, delta=delta,
                                          dtype=dtype, device=device)
    return BiLaplacian2D(Vh, gamma=gamma, delta=delta, dtype=dtype,
                         device=device)
