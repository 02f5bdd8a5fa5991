from .mesh_utils import export_vtk, load_mesh, save_mesh
from .mv_utilities import dense_to_mv_local, mv_to_dense, mv_to_dense_local
from .parameter_list import ParameterList
from .prandom import GivenNoise, KeyChain
from .profiling import PhaseTimer, annotate, trace
from .plotting import (
    generic_semilogy_plot,
    plot,
    plot_accs_vs_data,
    plot_eigenvector,
    plot_pts,
    plot_singular_values_with_std,
    spectrum_plot,
    subspace_angle_video,
)
