"""Linear algebra: the hand-written Hopper kernels K1-K4 and the solvers,
factors and randomized eigensolvers built on them."""

from .hopper_kernels import (
    banded_factorize,
    banded_factorize_plain,
    banded_solve,
    banded_solve_plain,
    batched_inverse,
    batched_inverse_plain,
    build_kernels,
    reset_launch_counts,
)
from .linalg import CholeskyFactor, eigh_descending, generalized_eigh
from .randomized import double_pass_g, orthogonalize
from .structured import (
    BlockBidiagCholesky,
    BlockCyclicFactor,
    BlockTridiagFactor,
    InverseThomasFactor,
    PermutedFactor,
    block_cholesky_tridiag,
    block_tridiag_matmat,
    block_tridiag_matmat_trans,
    factorize_block_cyclic,
    factorize_block_cyclic_banded,
    factorize_block_tridiag_dense,
    factorize_thomas_inv_banded,
)
