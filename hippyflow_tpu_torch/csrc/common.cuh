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
// Widest pivot block the Gauss-Jordan inverse takes (the TPU kernel's 13;
// the update keeps this many entries per column in registers), and the
// row stride of its staged pivot columns (whole 16-byte vectors).
#define HF_GJ_MAX_W 13
#define HF_GJ_ROW 16
// Largest cluster of thread blocks per matrix of the Gauss-Jordan inverse
// (the portable cluster size).
#define HF_GJ_MAX_CLUSTER 8

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

// Columns one block of a Gauss-Jordan cluster of c blocks owns at most:
// the s columns in 32-column chunks, rank r of c taking chunks
// [r nchunk / c, (r + 1) nchunk / c).
__host__ __device__ inline int hf_gj_own_cols(int s, int c) {
  const int nchunk = (s + 31) / 32;
  const int cols = 32 * ((nchunk + c - 1) / c);
  return cols < s ? cols : s;
}

// Shared-memory elements of one Gauss-Jordan block at pivot width w in a
// cluster of c: the pivot columns (s rows of HF_GJ_ROW, for 16-byte
// loads), the block's own slice of the pivot rows before and after the
// step (w x own columns each) and the pivot block's inverse (w rows of
// HF_GJ_ROW).
inline std::size_t hf_gj_smem_elems(int s, int w, int c) {
  return (std::size_t)HF_GJ_ROW * s +
         2 * (std::size_t)w * hf_gj_own_cols(s, c) +
         (std::size_t)w * HF_GJ_ROW;
}

// A 16-byte vector of T, and a[0..n) = p[0..n) from shared memory: in
// 16-byte loads where n fills whole vectors (p 16-byte aligned), else
// element by element.
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
  if constexpr (n % m == 0) {
#pragma unroll
    for (int q = 0; q < n; q += m) {
      const V v = *reinterpret_cast<const V*>(p + q);
      const T* t = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int u = 0; u < m; ++u) a[q + u] = t[u];
    }
  } else {
#pragma unroll
    for (int q = 0; q < n; ++q) a[q] = p[q];
  }
}

// Rows of one factor panel of K2's panel design: 64, 32 or 16 (the host
// picks them by s and the element size); 0 selects the streamed design.
// Shared-memory elements of one K2 block: the panel (s x rows, panel
// design only), and the carry and temporary of one (s, kt) column tile.
__host__ __device__ inline std::size_t hf_solve_panel_elems(int s,
                                                         int panel_rows) {
  return (std::size_t)s * panel_rows;
}

inline std::size_t hf_solve_smem_elems(int s, int kt, int panel_rows) {
  return hf_solve_panel_elems(s, panel_rows) + 2 * (std::size_t)s * kt;
}

// K3/K4 host entries (csrc/batched_inverse.cu), also launched row by row
// by K1's row-panel design: n matrices of s x s, `stride` elements apart,
// pivot width w (1 to HF_GJ_MAX_W), c blocks per matrix (1 to
// HF_GJ_MAX_CLUSTER); any other w or c returns cudaErrorInvalidValue.
extern "C" int hf_batched_inverse_f32(void* x, int n, int s, long long stride,
                                      int w, int c, void* stream);
extern "C" int hf_batched_inverse_f64(void* x, int n, int s, long long stride,
                                      int w, int c, void* stream);
