"""Finite elements: numpy host modules copied from the JAX package (mesh,
quadrature, space, observation, native) and the torch assembly."""

from .assembly import (
    BoundGalerkinForm,
    DirichletBC,
    GalerkinForm,
    banded_from_elements,
    bc_symmetrize_banded_from_mask,
    bc_symmetrize_banded_masked,
    boundary_mass_matrix_banded,
    mask_residual,
    mass_matrix,
    mass_matrix_banded,
    stiffness_matrix,
    stiffness_matrix_banded,
    structured_plan,
)
from .mesh import Mesh2D, boundary_edges, rectangle_mesh, unit_square_mesh
from .observation import assemble_pointwise_observation, grid_targets
from .space import FunctionSpace
