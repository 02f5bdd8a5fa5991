from .mesh_utils import export_vtk, load_mesh, save_mesh
from .mv_utilities import dense_to_mv_local, mv_to_dense, mv_to_dense_local
from .parameter_list import ParameterList
from .prandom import GivenNoise, KeyChain
