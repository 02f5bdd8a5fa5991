"""Linear algebra: the hand-written Hopper kernels K1/K2 and the solvers,
factors and randomized eigensolvers built on them."""

from .hopper_kernels import (
    banded_factorize,
    banded_factorize_plain,
    banded_solve,
    banded_solve_plain,
    build_kernels,
    reset_launch_counts,
)
from .linalg import CholeskyFactor, eigh_descending
from .randomized import double_pass_g, orthogonalize
from .structured import (
    BlockTridiagFactor,
    InverseThomasFactor,
    block_tridiag_matmat,
    block_tridiag_matmat_trans,
    factorize_block_tridiag_dense,
    factorize_thomas_inv_banded,
)
