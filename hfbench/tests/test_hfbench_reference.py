"""The plain reference against the program at a tiny size on the CPU, in
float64: the same prior samples, states, observations, Jacobians and
GHEP to rounding; and the reference's block algebra against dense
PyTorch."""

import pytest
import torch

from hfbench import check
from hfbench.reference import blocktri
from hfbench.check import input_subspace
from hfbench.reference.confusion import Confusion

from conftest import tiny_velocity

F64 = dict(dtype=torch.float64, device="cpu")


def _velocity(nx):
    return tiny_velocity({"velocity_file": "hfbench/data/ns_velocity_nx64.npy",
                          "nx": nx})


@pytest.mark.parametrize("nx", [8, 16])
def test_reference_matches_program_float64(nx):
    from hippyflow_tpu_torch.applications.confusion import (
        confusion_linear_observable,
        confusion_prior,
    )
    from hippyflow_tpu_torch.models.jacobian import ObservableJacobian
    from hippyflow_tpu_torch.ops.randomized import double_pass_g

    vel = _velocity(nx)
    obs, Vh = confusion_linear_observable(nx=nx, velocity=vel, **F64)
    prior = confusion_prior(Vh, **F64)
    ref = Confusion(nx, vel)
    g = torch.Generator().manual_seed(7)
    xi = torch.randn(5, Vh.dim, generator=g, dtype=torch.float64)
    m_p, m_r = prior.sample(xi), ref.sample(xi)
    assert check._rel(m_p, m_r, 1) < 1e-12
    u_p, info = obs.problem.solve_fwd(m_p)
    u_r, ok, _ = ref.newton(m_r)
    assert bool(ok.all()) and bool(info.converged.all())
    assert check._rel(u_p, u_r, 1) < 1e-10
    assert check._rel(obs.evalu(u_p), ref.observe(u_r), 1) < 1e-10
    u_off = 1.1 * u_r  # away from the solution, where the residual is not 0
    assert check._rel(obs.problem.residual_masked(u_off, m_r),
                      ref.residual(u_off, m_r), 1) < 1e-12
    # both Jacobians at the reference's state: the program's Newton stops
    # at its own tolerance
    J_p = ObservableJacobian(obs).materialize(
        obs.problem.linearize(u_r, m_r, needs="adj"))
    J_r = ref.jacobians(u_r, m_r)
    assert check._rel(J_p, J_r, (1, 2)) < 1e-12
    omega = torch.randn(Vh.dim, 12, generator=g, dtype=torch.float64)
    Jf = J_p.reshape(-1, Vh.dim)
    d_p, V_p = double_pass_g(lambda X: Jf.T @ (Jf @ X) / 5, prior.R_matmat,
                             prior.Rsolver_matmat, omega, 6)
    d_r, V_r = input_subspace(ref, J_r, omega, 6)
    assert ((d_p - d_r).abs().max() / d_r[0]).item() < 1e-10
    assert check.v_gap(ref, d_r, V_r, V_p) < 1e-6


def test_block_algebra_against_dense():
    g = torch.Generator().manual_seed(3)
    N, nb, s = 2, 4, 3
    blocks = torch.randn(N, nb, 3, s, s, generator=g, dtype=torch.float64)
    blocks[:, :, 1] += 8 * torch.eye(s, dtype=torch.float64)
    blocks[:, 0, 0] = 0
    blocks[:, -1, 2] = 0
    dense = torch.zeros(N, nb * s, nb * s, dtype=torch.float64)
    for j in range(nb):
        for slot, c in ((0, j - 1), (1, j), (2, j + 1)):
            if 0 <= c < nb:
                dense[:, j * s:(j + 1) * s, c * s:(c + 1) * s] = blocks[:, j, slot]
    X = torch.randn(N, nb * s, 2, generator=g, dtype=torch.float64)
    assert torch.allclose(blocktri.matmat(blocks, X), dense @ X)
    Sinv = blocktri.factor(blocks)
    assert torch.allclose(blocktri.solve(blocks, Sinv, X), torch.linalg.solve(dense, X))
    assert torch.allclose(blocktri.solve(blocks, Sinv, X, trans=True),
                          torch.linalg.solve(dense.mT, X))
    spd = dense[:1] @ dense[:1].mT  # pentadiagonal in blocks: keep tridiagonal
    spd_blocks = blocks[:1].clone()
    spd_blocks[:, :, 1] = spd_blocks[:, :, 1] @ spd_blocks[:, :, 1].mT
    spd_blocks[:, 1:, 0] = 0.1 * torch.ones(s, s, dtype=torch.float64)
    spd_blocks[:, :-1, 2] = spd_blocks[:, 1:, 0].mT
    del spd
    L = blocktri.cholesky_lower(spd_blocks)
    A = blocktri.matmat(spd_blocks, torch.eye(nb * s, dtype=torch.float64)[None])
    LL = blocktri.matmat(L, torch.eye(nb * s, dtype=torch.float64)[None])
    assert torch.allclose(LL @ LL.mT, A)
    assert torch.allclose(LL, torch.linalg.cholesky(A))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12], dtype=torch.float32)
    got = blocktri.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0])
    assert torch.equal(got, want)
