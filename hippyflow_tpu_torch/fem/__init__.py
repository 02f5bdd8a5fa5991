"""Finite elements: numpy host modules copied from the JAX package (mesh,
quadrature, space, observation, native, band_order), the torch assembly
(scalar P1 and vector/P2) and the multigrid transfers."""

from .assembly import (
    BoundGalerkinForm,
    DirichletBC,
    GalerkinForm,
    banded_from_elements,
    bc_symmetrize,
    bc_symmetrize_banded_from_mask,
    bc_symmetrize_banded_masked,
    boundary_mass_matrix,
    boundary_mass_matrix_banded,
    mask_residual,
    mass_matrix,
    mass_matrix_banded,
    stiffness_matrix,
    stiffness_matrix_banded,
    structured_plan,
)
from .band_order import BandOrder, ordered_band_mask, structured_band_order
from .mesh import Mesh2D, boundary_edges, rectangle_mesh, unit_square_mesh
from .observation import assemble_pointwise_observation, grid_targets
from .multigrid import (
    CoarseNewtonWarmStart,
    coarse_newton_warm_start,
    prolong_linear,
    restrict_injection,
)
from .space import FunctionSpace
from .vector_assembly import (
    ComponentObservation,
    VectorBoundGalerkinForm,
    VectorGalerkinForm,
)
