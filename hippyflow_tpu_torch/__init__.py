"""hippyflow_tpu_torch: the PyTorch/CUDA port of hippyflow_tpu.

The main path of the JAX package (batched Newton forward solves of the
confusion problem, dense Jacobians from 100-rhs adjoint solves, and the
prior-preconditioned randomized GHEP of the input active subspace) runs
here on an NVIDIA H100 at nx=64 (dense prior) and nx=192 (the structured,
banded prior), through four hand-written CUDA kernels
(``ops/hopper_kernels.py``): the banded inverse block-Thomas
factorization and solve, and the batched Gauss-Jordan inverse of the
prior's cyclic reduction (at pivot widths 13 and 1).  The package imports
torch and never jax; ``hippyflow_tpu`` stays the reference it is tested
against.
"""

from . import config
from .fem import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .utils import KeyChain, ParameterList
