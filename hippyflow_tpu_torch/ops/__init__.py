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
from .linalg import (
    CholeskyFactor,
    LUFactor,
    cg_solve,
    eigh_descending,
    factorize,
    generalized_eigh,
    solve_refined,
)
from .operators import (
    averaged_operator,
    dense_operator,
    low_rank_operator,
    low_rank_rectangular_operator,
    mean_jtj_from_data_operator,
    prior_preconditioned_projector,
    solver_to_operator,
    transpose_operator,
)
from .randomized import (
    accuracy_enhanced_svd,
    double_pass,
    double_pass_g,
    lanczos_ghep,
    orthogonalize,
)
from .structured import (
    BlockBidiagCholesky,
    BlockCyclicFactor,
    BlockTridiagFactor,
    InverseThomasFactor,
    PermutedFactor,
    block_cholesky_tridiag,
    block_tridiag_matmat,
    block_tridiag_matmat_trans,
    extract_block_tridiag,
    factorize_block_cyclic,
    factorize_block_cyclic_banded,
    factorize_block_tridiag,
    factorize_block_tridiag_banded,
    factorize_block_tridiag_dense,
    factorize_thomas_inv_banded,
    thomas_inv_bytes,
    thomas_inv_flops,
)
