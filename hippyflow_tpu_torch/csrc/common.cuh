// Launch geometry shared by the kernels and their host entries.
#pragma once

#include <cstddef>

// Threads per block of the Gauss-Jordan inverse (K3/K4).
#define HF_GJ_THREADS 512
// K1's row-panel Schur step: rows of a panel (one tile of outputs per
// thread), and the most threads a block (a warp per 128 columns: s up to
// 2048).
#define HF_SCHUR_ROWS 8
#define HF_SCHUR_MAX_THREADS 512
// Widest pivot block the Gauss-Jordan inverse takes (the TPU kernel's 13;
// the update keeps this many entries per column in registers), and the
// row stride of its staged pivot columns (whole 16-byte vectors).
#define HF_GJ_MAX_W 13
#define HF_GJ_ROW 16
// Largest cluster of thread blocks per matrix of the Gauss-Jordan inverse
// (the portable cluster size).
#define HF_GJ_MAX_CLUSTER 8

// Most threads per block of K1's chain.
#define HF_CHAIN_MAX_THREADS 640

// Shared-memory elements of one block of K1's chain, tiles of s rows at
// stride ld: the Dinv_{j-1}, T_j (A_j before the first product) and
// B_{j-1} tiles and the M_j tile, which the Gauss-Jordan scratch overlays:
// two buffers of staged pivot columns (s rows of HF_GJ_ROW), the pivot
// block's inverse, and the new pivot rows (HF_GJ_MAX_W rows).
inline std::size_t hf_factorize_smem_elems(int s, int ld) {
  const std::size_t tile = (std::size_t)s * ld;
  const std::size_t scratch = 2 * (std::size_t)HF_GJ_ROW * s +
                              (std::size_t)HF_GJ_ROW * HF_GJ_MAX_W +
                              (std::size_t)HF_GJ_MAX_W * ld;
  return 3 * tile + (tile > scratch ? tile : scratch);
}

// Row stride, in elements, of the Schur step's transposed panel: its rows
// and a 16-byte pad, so that the 16-byte stores down a column (M_j's
// panel) from the lanes of a warp fall in distinct banks.
#define HF_SCHUR_PP (HF_SCHUR_ROWS + 4)

// Threads of one block of the Schur step at block size s: a warp per 128
// columns.
inline int hf_schur_threads(int s) { return 32 * ((s + 127) / 128); }

// Shared memory of one block of the Schur step: the panel, transposed
// (s x HF_SCHUR_PP: A_j's, then M_j's).
inline std::size_t hf_schur_smem_size(int s, int itemsize) {
  return (std::size_t)s * HF_SCHUR_PP * itemsize;
}

// Columns one block of a Gauss-Jordan cluster of c blocks owns at most:
// the s columns in 32-column chunks, rank r of c taking chunks
// [r nchunk / c, (r + 1) nchunk / c).
__host__ __device__ inline int hf_gj_own_cols(int s, int c) {
  const int nchunk = (s + 31) / 32;
  const int cols = 32 * ((nchunk + c - 1) / c);
  return cols < s ? cols : s;
}

// Row length of the resident Gauss-Jordan design's own columns in shared
// memory: the most whole 32-column chunks a block of c owns.
__host__ __device__ inline int hf_gj_res_ld(int s, int c) {
  return 32 * (((s + 31) / 32 + c - 1) / c);
}

// Shared-memory elements of one Gauss-Jordan block at pivot width w in a
// cluster of c: the pivot columns (s rows of HF_GJ_ROW, for 16-byte
// loads) and the pivot block's inverse (w rows of HF_GJ_ROW).  The L2
// design adds the block's own slice of the pivot rows before and after
// the step (w x own columns each); the resident design the new pivot rows
// and the block's own columns of the matrix, in rows of hf_gj_res_ld.
inline std::size_t hf_gj_smem_elems(int s, int w, int c, bool resident) {
  const std::size_t common = (std::size_t)HF_GJ_ROW * (s + w);
  if (resident) {
    return common + (std::size_t)(w + s) * hf_gj_res_ld(s, c);
  }
  return common + 2 * (std::size_t)w * hf_gj_own_cols(s, c);
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

// p[0..n) = a[0..n) in 16-byte stores (n whole vectors, p 16-byte
// aligned).
template <typename T, int n>
__device__ __forceinline__ void hf_store16(T* p, const T (&a)[n]) {
  using V = typename HfVec16<T>::type;
  constexpr int m = sizeof(V) / sizeof(T);
  static_assert(n % m == 0, "whole 16-byte vectors");
#pragma unroll
  for (int q = 0; q < n; q += m) {
    V v;
    T* t = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int u = 0; u < m; ++u) t[u] = a[q + u];
    *reinterpret_cast<V*>(p + q) = v;
  }
}

#ifdef __CUDACC__
// IEEE round-to-nearest reciprocals
__device__ __forceinline__ float hf_rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double hf_rcp(double x) { return __drcp_rn(x); }

// P^{-1} of a wp x wp pivot block P by one warp, into pinv (rows at
// stride HF_GJ_ROW in shared memory).  Lane l < 2 wp holds column l of
// [P | I] in col (rows past wp zero in every lane); pivot step k scales
// row k by the pivot's reciprocal (a division's latency, twice, would lie
// on the chain of w dependent steps) and subtracts the multiples of it
// from the other rows, with the pivot and the multipliers (column k)
// shuffled from lane k.  Called by all 32 lanes of one warp.  Shared by
// K3/K4 and K1's chain.
template <typename T>
__device__ __forceinline__ void pivot_block_inverse_cols(
    T (&col)[HF_GJ_MAX_W], int wp, T* pinv) {
  const int lane = threadIdx.x & 31;
  // rows past wp are zero in every lane, so they are shuffled and updated
  // without a branch (a shuffle under a per-row branch costs the warp a
  // reconvergence each)
#pragma unroll
  for (int k = 0; k < HF_GJ_MAX_W; ++k) {
    if (k < wp) {
      T m[HF_GJ_MAX_W];
#pragma unroll
      for (int r = 0; r < HF_GJ_MAX_W; ++r) {
        m[r] = __shfl_sync(0xffffffffu, col[r], k);
      }
      const T rk = col[k] * hf_rcp(m[k]);
#pragma unroll
      for (int r = 0; r < HF_GJ_MAX_W; ++r) {
        if (r != k) col[r] -= m[r] * rk;
      }
      col[k] = rk;
    }
  }
  if (lane >= wp && lane < 2 * wp) {
#pragma unroll
    for (int r = 0; r < HF_GJ_MAX_W; ++r) {
      if (r < wp) pinv[r * HF_GJ_ROW + lane - wp] = col[r];
    }
  }
}

// What a lane holds of [P | I] given its column of P: the identity's
// columns in lanes wp.., zeros in rows past wp.
template <typename T>
__device__ __forceinline__ void pivot_block_augment(T (&col)[HF_GJ_MAX_W],
                                                    int wp) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < HF_GJ_MAX_W; ++r) {
    if (lane >= wp) col[r] = (lane - wp == r) ? T(1) : T(0);
    if (r >= wp) col[r] = T(0);
  }
}

// The same with P read from shared memory (rows at stride ldp).
template <typename T>
__device__ __forceinline__ void pivot_block_inverse(const T* P, int ldp,
                                                    int wp, T* pinv) {
  const int lane = threadIdx.x & 31;
  T col[HF_GJ_MAX_W];
  // every load is started before the first is used: addresses are clamped
  // into P, and what lies outside it is replaced afterwards
  const int lc = lane < wp ? lane : wp - 1;
#pragma unroll
  for (int r = 0; r < HF_GJ_MAX_W; ++r) {
    col[r] = P[(r < wp ? r : wp - 1) * ldp + lc];
  }
  pivot_block_augment(col, wp);
  pivot_block_inverse_cols(col, wp, pinv);
}
#endif  // __CUDACC__

// K2's panel design (many rhs columns): the k columns in `tiles` column
// tiles whose widths differ by at most one, a tile's carry padded to whole
// register tiles of HF_SOLVE_COL_TILE columns; each thread accumulates an
// RT x HF_SOLVE_COL_TILE tile of a product's output (RT = 4 or 8 rows of
// op(H)) over one of `lsplit` slices of the inner index; at most
// HF_SOLVE_MAX_THREADS threads a block.
#define HF_SOLVE_COL_TILE 4
#define HF_SOLVE_MAX_THREADS 512

// Columns of the widest tile of k columns split into `tiles`, padded to
// whole register tiles.
__host__ __device__ inline int hf_solve_tile_cols(int k, int tiles) {
  const int kt = (k + tiles - 1) / tiles;
  return (kt + HF_SOLVE_COL_TILE - 1) / HF_SOLVE_COL_TILE * HF_SOLVE_COL_TILE;
}

// Threads of one block: a thread per output tile of a panel of `rows`
// rows and per slice of the inner index, in whole warps.
inline int hf_solve_threads(int k, int tiles, int rows, int row_tile,
                            int lsplit) {
  const int work = rows / row_tile *
                   (hf_solve_tile_cols(k, tiles) / HF_SOLVE_COL_TILE) * lsplit;
  return (work + 31) / 32 * 32;
}

// Shared-memory elements of one block: the panel (s x rows, transposed),
// the carry and its partner (s x padded tile columns each), and the
// partial sums of the `lsplit` slices (rows x padded tile columns each).
inline std::size_t hf_solve_smem_elems(int s, int k, int tiles, int rows,
                                       int lsplit) {
  const std::size_t kp = hf_solve_tile_cols(k, tiles);
  return (std::size_t)s * rows + 2 * (std::size_t)s * kp +
         (std::size_t)lsplit * rows * kp;
}

// K2's streamed design (few rhs columns): a cluster of c thread blocks per
// sample, each of which owns one slab of rows of every factor block and
// draws it through a ring of `nstage` shared-memory stages of `rows` rows.
// Most columns of a column tile, blocks of a cluster, stages of a ring and
// threads of a block in a cluster (a warp that feeds the ring and 17 that
// compute: one per 32 columns at s = 516) and of a block on its own.
#define HF_STREAM_MAX_COLS 7
#define HF_STREAM_MAX_CLUSTER 8
#define HF_STREAM_MAX_STAGES 16
#define HF_STREAM_MAX_THREADS 576
#define HF_STREAM_MAX_THREADS_ONE 512
// Bytes ahead of the carry: the ring's full and empty barriers and the
// byte offset of each stage's chunk.
#define HF_STREAM_BAR_BYTES (20 * HF_STREAM_MAX_STAGES)

// Rows of the widest slab: rank r of c owns rows [r s / c, (r + 1) s / c).
__host__ __device__ inline int hf_stream_slab(int s, int c) {
  return (s + c - 1) / c;
}

// Bytes of one ring stage: `rows` rows of s elements and the 16-byte
// alignment of a copy's two ends (a slab starts on an element, the bulk
// copy that fetches it on 16 bytes).
__host__ __device__ inline std::size_t hf_stream_stage_bytes(int s, int rows,
                                                          int itemsize) {
  return ((std::size_t)rows * s * itemsize + 15) / 16 * 16 + 16;
}

// Elements of a streamed block's carry region for an (s, kt) column tile.
// Forward sweeps: the carry, twice (every block holds all of it), and the
// rhs rows of its slab, three times (fetched two products ahead).
// Transposed sweeps: the carry, the partial sums of the `rsplit` row
// splits, the partial sums the c ranks send (twice), and the rhs rows
// (three times).
__host__ __device__ inline std::size_t hf_stream_carry_elems(int s, int kt,
                                                          int c, int rsplit,
                                                          bool trans) {
  const std::size_t full = (std::size_t)s * kt;
  const std::size_t slab = (std::size_t)hf_stream_slab(s, c) * kt;
  return trans ? full * (1 + rsplit) + 2 * c * slab + 3 * slab
               : 2 * full + 3 * slab;
}

inline std::size_t hf_stream_smem_size(int s, int kt, int c, int rows,
                                       int nstage, int rsplit, bool trans,
                                       int itemsize) {
  const std::size_t carry =
      (hf_stream_carry_elems(s, kt, c, rsplit, trans) * itemsize + 15) / 16 *
      16;
  return HF_STREAM_BAR_BYTES + carry +
         (std::size_t)nstage * hf_stream_stage_bytes(s, rows, itemsize);
}

// K3/K4 host entries (csrc/batched_inverse.cu), also launched row by row
// by K1's row-panel design: n matrices of s x s, `stride` elements apart,
// pivot width w (1 to HF_GJ_MAX_W), c blocks per matrix (1 to
// HF_GJ_MAX_CLUSTER), the L2 (resident 0) or resident (1) design; any
// other w, c or resident returns cudaErrorInvalidValue.
extern "C" int hf_batched_inverse_f32(void* x, int n, int s, long long stride,
                                      int w, int c, int resident,
                                      void* stream);
extern "C" int hf_batched_inverse_f64(void* x, int n, int s, long long stride,
                                      int w, int c, int resident,
                                      void* stream);
