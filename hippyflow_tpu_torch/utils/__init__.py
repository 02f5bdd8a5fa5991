from .parameter_list import ParameterList
from .prandom import KeyChain
