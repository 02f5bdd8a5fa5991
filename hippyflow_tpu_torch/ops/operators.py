"""Linear-operator combinators on dense blocks (port of
``hippyflow_tpu/ops/operators.py``).

An operator is a callable ``matmat(X: (n, k)) -> (m, k)``; these helpers
build the reference's ``mult``/``transpmult`` operator objects as closures
over tensors.
"""

from __future__ import annotations

import torch


def dense_operator(A):
    """Operator from a dense matrix (reference npToDolfinOperator)."""
    return lambda X: A @ X


def low_rank_operator(d, U):
    """The action of U diag(d) U^T (hp.LowRankOperator)."""
    return lambda X: U @ (d[:, None] * (U.T @ X))


def low_rank_rectangular_operator(U, s, V):
    """U diag(s) V^T and its transpose; returns (matmat, rmatmat)."""
    mat = lambda X: U @ (s[:, None] * (V.T @ X))
    rmat = lambda X: V @ (s[:, None] * (U.T @ X))
    return mat, rmat


def prior_preconditioned_projector(U, Cinv_matmat):
    """Oblique projector P = U U^T C^{-1} onto span(U) (the projection
    error tests of AS and KLE)."""
    return lambda X: U @ (U.T @ Cinv_matmat(X))


def mean_jtj_from_data_operator(J_data, noise_precision=None):
    """Monte-Carlo mean of J^T Sigma^{-1} J over stored dense Jacobians
    J_data (n_samples, dq, dm) (reference MeanJTJfromDataOperator)."""
    J = torch.as_tensor(J_data)

    def matmat(X):
        JX = torch.einsum("sqm,mk->sqk", J, X)
        if noise_precision is not None:
            JX = torch.einsum("qp,spk->sqk", noise_precision, JX)
        return torch.einsum("sqm,sqk->mk", J, JX) / J.shape[0]

    return matmat


def solver_to_operator(solve):
    """A solver (a callable on right-hand-side blocks) as a matmat
    operator (hp.Solver2Operator)."""
    return lambda X: solve(X)


def transpose_operator(A):
    """The action of A^T, for a dense matrix or a (matmat, rmatmat) pair
    from ``low_rank_rectangular_operator`` (hp.Transpose)."""
    if isinstance(A, tuple):
        return A[1]
    return lambda X: A.T @ X


def averaged_operator(matmats, average: bool = True):
    """Sum, or average, of a list of operators (reference
    SummedListOperator)."""

    def matmat(X):
        Y = None
        for op in matmats:
            Yi = op(X)
            Y = Yi if Y is None else Y + Yi
        return Y / len(matmats) if average else Y

    return matmat
