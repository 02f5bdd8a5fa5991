// Launch geometry shared by the kernels and their host entries.
#pragma once

#include <cstddef>

// Threads per block of K1's one-block chain and of K2.
#define HF_THREADS 256
// Threads per block of the Gauss-Jordan inverse (K3/K4).
#define HF_GJ_THREADS 512
// Threads per block, and rows per block, of K1's row-panel Schur step.
#define HF_SCHUR_THREADS 256
#define HF_SCHUR_PANEL 16
// Widest pivot block the Gauss-Jordan inverse takes.
#define HF_GJ_MAX_W 16

// Shared-memory elements of one block of K1's one-block chain: the
// Dinv_{j-1}, B_{j-1} and M_j tiles (s x s each), the (s, 2s) Gauss-Jordan
// tile, and the pivot row and column scratch (s + 1 and s).
inline std::size_t hf_factorize_smem_elems(int s) {
  return 5 * (std::size_t)s * s + 2 * (std::size_t)s + 1;
}

// Shared-memory elements of one block of K1's row-panel Schur step: the
// A_j and M_j row panels (HF_SCHUR_PANEL x s each).
inline std::size_t hf_schur_smem_elems(int s) {
  return 2 * (std::size_t)HF_SCHUR_PANEL * s;
}

// Shared-memory elements of one Gauss-Jordan block at pivot width w: the
// pivot columns (s rows of HF_GJ_MAX_W, for 16-byte loads), the pivot rows
// before and after the step (w x s each) and two (w x 2w) tiles of the
// pivot block's own inverse.
inline std::size_t hf_gj_smem_elems(int s, int w) {
  return (std::size_t)HF_GJ_MAX_W * s + 2 * (std::size_t)w * s +
         4 * (std::size_t)w * w;
}

// A 16-byte vector of T, and a[0..n) = p[0..n) from 16-byte aligned
// shared memory, n a multiple of the vector's length.
template <typename T>
struct HfVec16;
template <>
struct HfVec16<float> {
  using type = float4;
};
template <>
struct HfVec16<double> {
  using type = double2;
};

template <typename T, int n>
__device__ __forceinline__ void hf_load16(const T* p, T (&a)[n]) {
  using V = typename HfVec16<T>::type;
  constexpr int m = sizeof(V) / sizeof(T);
#pragma unroll
  for (int q = 0; q < n; q += m) {
    const V v = *reinterpret_cast<const V*>(p + q);
    const T* t = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int u = 0; u < m; ++u) a[q + u] = t[u];
  }
}

// Rows of one factor panel of K2's panel design.
#define HF_SOLVE_PANEL_ROWS 64

// Shared-memory elements of K2's factor panel (panel design only).
__host__ __device__ inline std::size_t hf_solve_panel_elems(int s,
                                                         bool panels) {
  return panels ? (std::size_t)s * HF_SOLVE_PANEL_ROWS : 0;
}

// Shared-memory elements of one K2 block: the panel, and the carry and
// temporary of one (s, kt) column tile.
inline std::size_t hf_solve_smem_elems(int s, int kt, bool panels) {
  return hf_solve_panel_elems(s, panels) + 2 * (std::size_t)s * kt;
}

// K3/K4 host entries (csrc/batched_inverse.cu), also launched row by row
// by K1's row-panel design.
extern "C" int hf_batched_inverse_f32(void* x, int n, int s, long long stride,
                                      int w, void* stream);
extern "C" int hf_batched_inverse_f64(void* x, int n, int s, long long stride,
                                      int w, void* stream);
