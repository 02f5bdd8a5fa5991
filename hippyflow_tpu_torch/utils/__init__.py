from .mesh_utils import export_vtk, load_mesh, save_mesh
from .parameter_list import ParameterList
from .prandom import GivenNoise, KeyChain
