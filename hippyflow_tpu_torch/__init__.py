"""hippyflow_tpu_torch: the PyTorch/CUDA port of hippyflow_tpu.

The main path of the JAX package (batched Newton forward solves of the
confusion problem, dense Jacobians from 100-rhs adjoint solves, and the
prior-preconditioned randomized GHEP of the input active subspace) runs
here on an NVIDIA H100 at nx=64 (dense prior) and nx=192 (the structured,
banded prior), through four hand-written CUDA kernels
(``ops/hopper_kernels.py``): the banded inverse block-Thomas
factorization and solve, and the batched Gauss-Jordan inverse of the
prior's cyclic reduction (at pivot widths 13 and 1).  The surrogate layer
(``nn``: DIPNet / DIPResNet, l2 and H1 losses, AdamW and inexact
Newton-CG) trains on the reduced bases and the POD from data
(``models.pod``).  The reduced-basis setup (the output active subspace,
KLE, the sampled POD, the projection error tests, the low-rank Jacobian
data and ``DataGenerator``) runs through the same solves, driven by
``applications.confusion_setup``.  ``VariationalPDEProblem`` takes the
JAX package's solver choices (inverse and pivoted block-Thomas, batched
cyclic reduction through K3, dense, BiCGStab) on structured and
unstructured meshes, and the control paths (``z``, dq/dz) run through
sampling, POD, ``DataGenerator`` and the active subspace; ``testing``
holds the reference's Poisson control problem.  ``parallel`` splits the
samples over the ranks of a ``torch.distributed`` device mesh and shards
the bands' block rows over its 'fem' axis (the partitioned SPIKE solve
of ``solver="dist_banded"`` and the dof-sharded structured prior).
Entry points run on the
card unless the caller passes ``device="cpu"``.  The package imports
torch and never jax; ``hippyflow_tpu`` stays the reference it is tested
against.
"""

from . import config
from .version import __version__
from .fem import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .parallel import (
    DeviceCollective,
    NullCollective,
    check_consistent_sharding,
    make_sample_fem_mesh,
)
from .utils import (
    GivenNoise,
    KeyChain,
    ParameterList,
    dense_to_mv_local,
    mv_to_dense,
)
