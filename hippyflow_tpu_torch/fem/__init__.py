"""Finite elements: numpy host modules copied from the JAX package (mesh,
quadrature, space, observation, native, band_order), the torch assembly
(scalar P1 and P2, and vector states) and the multigrid transfers."""

from .assembly import (
    BoundGalerkinForm,
    DirichletBC,
    GalerkinForm,
    band_bc_masks,
    banded_from_elements,
    bc_apply_rhs,
    bc_symmetrize,
    bc_symmetrize_banded,
    bc_symmetrize_banded_from_mask,
    bc_symmetrize_banded_masked,
    bc_zero_rows,
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
from .observation import (
    assemble_pointwise_observation,
    grid_targets,
    locate_points,
    vector_to_function,
)
from .multigrid import (
    CoarseNewtonWarmStart,
    coarse_newton_warm_start,
    prolong_linear,
    prolong_p1_to_p2,
    restrict_injection,
)
from .quadrature import triangle_rule
from .space import FunctionSpace
from .vector_assembly import (
    ComponentObservation,
    VectorBoundGalerkinForm,
    VectorGalerkinForm,
)
