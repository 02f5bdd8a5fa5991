"""The frozen bound arithmetic against sizes worked by hand."""

import pytest

from hfbench import roofline, trace


def test_k1_bound_by_hand():
    # N=1, nb=s=65, float32: 6*64+2 = 386 rows' worth of s^3 = 274625
    # operations each: 106,005,250 at 67e12/s = 1.582e-6 s; bytes
    # 5*65*65*65*4 = 5,492,500 at 3.35e12/s = 1.640e-6 s: bytes bound
    assert roofline.k1_bound(1, 65, 65, "float32") == pytest.approx(
        5 * 65 ** 3 * 4 / 3.35e12)
    # s=193: 6*192+2 = 1154 * 193^3 operations = 8.296e9 / 67e12
    assert roofline.k1_bound(1, 193, 193, "float32") == pytest.approx(
        1154 * 193 ** 3 / 67e12)


def test_k2_bound_by_hand():
    # k=1: blocks 3*65-2 = 193 of 65^2 floats, plus rhs and solution
    by = (193 * 65 * 65 + 2 * 65 * 65) * 4
    assert roofline.k2_bound(1, 65, 65, 1, "float32") == pytest.approx(by / 3.35e12)
    # k=100: 2*193*65^2*100 operations = 163,085,000 / 67e12 = 2.434e-6 s
    # against (193*4225 + 2*4225*100)*4 = 6,641,700 B / 3.35e12 = 1.98e-6 s
    assert roofline.k2_bound(1, 65, 65, 100, "float32") == pytest.approx(
        2 * 193 * 65 ** 2 * 100 / 67e12)


def test_pass_need_adds_levels_and_jacobians():
    levels = [(65, 2048), (33, 2048), (17, 4096)]
    want = sum(it * (roofline.k1_bound(1, s, s, "float32")
                     + roofline.k2_bound(1, s, s, 1, "float32"))
               for s, it in levels)
    want += 1024 * (roofline.k1_bound(1, 65, 65, "float32")
                    + roofline.k2_bound(1, 65, 65, 100, "float32"))
    assert roofline.pass_need_seconds(levels, 100, 1024, "float32") == \
        pytest.approx(want)


@pytest.mark.parametrize("name, base", [
    ("(anonymous namespace)::banded_chain_kernel<float>(float const*, int)",
     "banded_chain_kernel"),
    ("void at::native::elementwise_kernel<128, 2, (lambda)>(int, (lambda))",
     "elementwise_kernel"),
    ("(anonymous namespace)::banded_solve_kernel<float, 8>(float const*)",
     "banded_solve_kernel"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8",
     "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8"),
])
def test_kernel_base_name(name, base):
    assert trace.kernel_base_name(name) == base
