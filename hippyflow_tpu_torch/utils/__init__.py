from .parameter_list import ParameterList
from .prandom import GivenNoise, KeyChain
