"""Surrogate (NN) layer: projected networks and derivative-informed
training."""

from .networks import (
    DIPNet,
    DIPResNet,
    GenericDense,
    GenericLinear,
    LowRankLinear,
    projected_dense,
    projected_low_rank_residual_network,
)
from .training import (
    accuracy,
    apply_fn_of,
    gauss_newton_cg_step,
    jstarphi_from_jsvd,
    l2_loss,
    make_h1_loss,
    parameters_of,
    train,
)
