"""Finite elements: numpy host modules copied from the JAX package (mesh,
quadrature, space, observation, native) and the torch assembly."""

from .assembly import (
    BoundGalerkinForm,
    DirichletBC,
    GalerkinForm,
    bc_symmetrize_banded_from_mask,
    bc_symmetrize_banded_masked,
    mask_residual,
    mass_matrix,
    stiffness_matrix,
    structured_plan,
)
from .mesh import Mesh2D, rectangle_mesh, unit_square_mesh
from .observation import assemble_pointwise_observation, grid_targets
from .space import FunctionSpace
