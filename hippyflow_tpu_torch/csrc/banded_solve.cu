// K2: batched back-solve through an inverse block-Thomas factor.
//
// Replaces the Pallas kernel `banded_solve_batch` (sweeps `_run_sweep`,
// body `_sweep_kernel_factory`) of hippyflow_tpu/ops/pallas_kernels.py.
// With factor blocks M, Dinv, B of shape (N, nb, s, s) and right-hand
// sides b of shape (N, nb, s, k), A x = b is solved by two sweeps:
//
//     fwd   (rows ascend):   y_j = b_j - M_j y_{j-1}
//     bwd   (rows descend):  x_j = Dinv_j (y_j - B_j x_{j+1})
//
// and A^T x = b by
//
//     fwd_t (rows ascend):   z_j = Dinv_j^T (b_j - B_{j-1}^T z_{j-1})
//     bwd_t (rows descend):  x_j = z_j - M_{j+1}^T x_{j+1}
//
// The first row of each sweep takes no neighbour term (a zero carry), so
// M_0 and B_{nb-1} are never read.
//
// What bounds it on the card: the bytes of factor read per column tile
// (two s x s blocks per block row and sweep step) against the 2 s^2 kt
// multiply-adds they feed.  Unlike on the TPU, the rhs columns are
// independent, so the grid runs over (sample, column tile): each block owns
// kt columns of one sample and keeps its (s, kt) carry in shared memory.
// Both sweeps run in one launch: the first writes its result to the
// output, the second reads it back row by row and overwrites it in place.
// Two designs, which the wrapper picks by the number of columns (measured
// on the H100 at s=65 and s=193, each faster than the first design, which
// staged both whole blocks in shared memory and which they replace):
//
// * panels (k >= 8, the Jacobian's k=100 and k=200 solves): the k columns
//   go to `tiles` column tiles whose widths differ by at most one (the
//   host picks the count, `panel_geometry` in ops/hopper_kernels.py, so
//   that the grid of N x tiles blocks fills the card: 8 at N=16, 1 at
//   N=256).  Each product streams its factor block through shared memory
//   in panels of `rows` rows of op(H) (a multiple of 8 that splits s with
//   at most s/8 rows past it: 72 at s=65, 200 at s=193 in float32), stored
//   transposed and filled by asynchronous copies (16 bytes a copy where
//   the rows of H start on 16 bytes, s=516), and waited for whole.  Each
//   thread accumulates an RT x 4 register tile of the panel's output (RT
//   = 4 or 8 rows; 4 columns, the padded carry's 16-byte vector) over one
//   of `lsplit` slices of the inner index: a panel entry feeds 4
//   multiply-adds, a carry entry RT.  The slices' partial sums go through
//   shared memory, and the block adds them up and writes the output, so
//   that a narrow tile still gives every thread a register tile.  Shared
//   memory holds the panel, the carry and its partner (s x padded tile
//   columns each) and the partial sums.
// * streamed (k < 8, the Newton solves; bound by the bytes of the factor,
//   each read once, and by the chain of 3 nb - 2 dependent products): the
//   addresses of the factor blocks do not depend on the carry, so the
//   factor is fetched ahead of the recurrence.  A cluster of c thread
//   blocks works on one sample (c = 1 to 8, picked by the host:
//   `stream_cluster` in ops/hopper_kernels.py; c = 1 is a plain launch).
//   Rank r owns rows [r s / c, (r + 1) s / c) of every factor block, a
//   contiguous run of memory, so each byte of the factor is read by one
//   block only.  The run passes in chunks of whole rows (up to 64 KB)
//   through a ring of shared-memory stages: thread 0 requests one bulk copy
//   (`cp.async.bulk`, completion counted by an `mbarrier` per stage) per
//   chunk, as far ahead of the chunk in use as the ring is deep, across
//   products and across the cluster barrier, and the warps give a stage
//   back through a second `mbarrier`.  Warp 0 takes no part in the
//   products: in a block on its own it only feeds the ring and joins no
//   barrier; in a cluster it feeds the ring between the barriers.  A bulk
//   copy needs 16-byte ends and a slab starts on an element (s is odd on
//   most lanes), so a copy takes the 16-byte span around its chunk and
//   the reader adds the offset.  One access pattern serves both
//   orientations:
//   - op(H) = H: a group of lanes (a power of two, up to a warp; about
//     s / 16) takes a row of the chunk and strides over it, a shuffle
//     tree sums the group, and the result goes into every rank's copy of
//     the carry (distributed shared memory); one cluster barrier per
//     product;
//   - op(H) = H^T: a warp owns 32 output columns and one of `rsplit` row
//     splits of the chunk; the block's partial sums over its slab of rows
//     go to the ranks that own the outputs, which after one cluster
//     barrier add them up: the carry a rank needs for the next product is
//     the slice it has summed.
//   In both a lane loads eight factor entries and the carry entries they
//   meet before it multiplies any.  The rhs rows of a product are fetched
//   two products ahead (`cp.async`), and each rank reads and writes only
//   its own rows of the rhs and the output.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// The panel design's layout of one block: kp padded tile columns (a
// multiple of HF_SOLVE_COL_TILE), panels of `rows` rows, `lsplit` slices
// of the inner index.  Thread t takes slice t / ntile and output tile
// t % ntile of a panel: row group (RT rows) tile / cg, column group (of
// HF_SOLVE_COL_TILE) tile % cg, neighbouring lanes on neighbouring column
// groups.
struct PanelLayout {
  int s, k, kw, kp, rows, lsplit;
};

// panel[a * pa + b * pb] = src[a * sa + b] for a < na, b < nb by
// asynchronous copies, the element e = a nb + b to thread e % blockDim.x,
// a and b stepped, not divided out; with `vec`, 16 bytes a copy (nb, sa,
// pa and src in whole 16-byte vectors, pb = 1).
template <typename T>
__device__ __forceinline__ void panel_fill(const T* src, int na, int nb,
                                           int sa, int pa, int pb, T* panel,
                                           bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int w = vec ? V : 1;
  const int nbw = nb / w;
  const int da = blockDim.x / nbw, db = (blockDim.x - da * nbw) * w;
  const int tid = threadIdx.x;
  int a = tid / nbw, b = (tid - a * nbw) * w;
  if (vec) {
    for (; a < na;) {
      __pipeline_memcpy_async(panel + a * pa + b, src + (size_t)a * sa + b, 16);
      a += da;
      b += db;
      if (b >= nb) {
        b -= nb;
        ++a;
      }
    }
  } else {
    for (; a < na;) {
      __pipeline_memcpy_async(panel + a * pa + b * pb, src + (size_t)a * sa + b,
                              sizeof(T));
      a += da;
      b += db;
      if (b >= nb) {
        b -= nb;
        ++a;
      }
    }
  }
}

// y = op(A) x, or y = in - op(A) x when `in` is given, on one column tile
// of kw columns: x and y (s, kp) in shared memory, `in` and `y_out` (may
// be null) rows of stride k in device memory.  op(A) passes through
// `panel` (s, rows) in shared memory, panel[l * rows + r] = op(A)[i0 + r,
// l], filled by asynchronous copies of its rows below s.  Each thread
// accumulates an RT x HF_SOLVE_COL_TILE tile of a panel's output over its
// slice of l (a panel entry read as part of a 16-byte vector feeds
// HF_SOLVE_COL_TILE multiply-adds, a carry entry RT), writes it to `red`
// (lsplit, rows, kp), and the block sums the slices of each output.  A
// thread whose tile lies past the panel's rows or the tile's columns
// skips its products.
template <typename T, int RT>
__device__ void panel_product(const T* __restrict__ A, bool trans,
                              const T* x, const T* in, T* y, T* y_out,
                              const PanelLayout& g, T* panel, T* red) {
  constexpr int CT = HF_SOLVE_COL_TILE;
  const int s = g.s, rows = g.rows, kp = g.kp, kw = g.kw;
  const int cg = kp / CT;
  const int ntile = rows / RT * cg;
  const int tid = threadIdx.x;
  const int q = tid / ntile, tile = tid - q * ntile;
  const int r0 = tile / cg * RT, c0 = (tile - tile / cg * cg) * CT;
  const int l0 = q * s / g.lsplit, l1 = (q + 1) * s / g.lsplit;
  T* red_q = red + (size_t)q * rows * kp;
  // a transposed panel's rows are copied 16 bytes at a time where the rows
  // of A start on 16 bytes (s = 516) and every panel is whole vectors
  constexpr int V = 16 / sizeof(T);
  const bool vec_rows = s % V == 0 && rows % V == 0 &&
                        reinterpret_cast<uintptr_t>(A) % 16 == 0;
  for (int i0 = 0; i0 < s; i0 += rows) {
    const int pr = min(rows, s - i0);
    __syncthreads();  // the previous panel and its sums are consumed, x is complete
    // op(A)[i0 + r, l] is A[l, i0 + r] (a row of A, copied along r) or
    // A[i0 + r, l] (copied along the row l); all of a thread's copies in
    // flight before the wait
    if (trans) {
      panel_fill<T>(A + i0, s, pr, s, rows, 1, panel, vec_rows);
    } else {
      panel_fill<T>(A + (size_t)i0 * s, pr, s, s, 1, rows, panel, false);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (q < g.lsplit && r0 < pr && c0 < kw) {
      T acc[RT][CT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[r][c] = T(0);
      }
      const T* pa = panel + r0;
      const T* px = x + c0;
#pragma unroll 4
      for (int l = l0; l < l1; ++l) {
        T a[RT], v[CT];
        hf_load16(pa + l * rows, a);
        hf_load16(px + l * kp, v);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[r][c] += a[r] * v[c];
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) hf_store16(red_q + (r0 + r) * kp + c0, acc[r]);
    }
    __syncthreads();
    // output (r, c), r < pr, c < kw, in the order e = r kw + c: r and c
    // stepped, not divided out
    const int dr = blockDim.x / kw, dc = blockDim.x - dr * kw;
    for (int r = tid / kw, c = tid - tid / kw * kw; r < pr;) {
      T sum = red[r * kp + c];
      for (int u = 1; u < g.lsplit; ++u) sum += red[((size_t)u * rows + r) * kp + c];
      const int i = i0 + r;
      const T v = in != nullptr ? in[(size_t)i * g.k + c] - sum : sum;
      y[i * kp + c] = v;
      if (y_out != nullptr) y_out[(size_t)i * g.k + c] = v;
      r += dr;
      c += dc;
      if (c >= kw) {
        c -= kw;
        ++r;
      }
    }
  }
  __syncthreads();
}

// One sweep step on a column tile: out = op(G) (in - op(H) carry), or
// out = in - op(H) carry when G is null, with op(X) = X^T when the flag is
// set, both products through panels.  H is null on the sweep's first row.
// `in` and `out` point at row j of the (s, k) rhs block at the tile's first
// column and may alias.  The result is also the new carry; `carry` and
// `tmp` swap roles when there is no G.
template <typename T, int RT>
__device__ void panel_step(const T* __restrict__ H, bool trans_h,
                           const T* __restrict__ G, bool trans_g, const T* in,
                           T* out, const PanelLayout& g, T* panel, T* red,
                           T*& carry, T*& tmp) {
  T* first_out = G == nullptr ? out : nullptr;
  if (H != nullptr) {
    panel_product<T, RT>(H, trans_h, carry, in, tmp, first_out, g, panel, red);
  } else {
    for (int e = threadIdx.x; e < g.s * g.kw; e += blockDim.x) {
      const int i = e / g.kw, c = e - (e / g.kw) * g.kw;
      const T v = in[(size_t)i * g.k + c];
      tmp[i * g.kp + c] = v;
      if (first_out != nullptr) first_out[(size_t)i * g.k + c] = v;
    }
    __syncthreads();
  }
  if (G == nullptr) {
    T* t = carry;
    carry = tmp;
    tmp = t;
    return;
  }
  panel_product<T, RT>(G, trans_g, tmp, static_cast<const T*>(nullptr), carry,
                       out, g, panel, red);
}

// Grid (N, tiles): block (n, y) owns columns [y k / tiles, (y + 1) k /
// tiles) of sample n.
template <typename T, int RT>
__global__ void __launch_bounds__(HF_SOLVE_MAX_THREADS)
    banded_solve_kernel(const T* __restrict__ m, const T* __restrict__ dinv,
                        const T* __restrict__ b, const T* __restrict__ rhs,
                        T* __restrict__ out, int nb, int s, int k, int tiles,
                        int rows, int lsplit, bool trans) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ss = s * s;
  const int c0 = (int)((long long)blockIdx.y * k / tiles);
  PanelLayout g;
  g.s = s;
  g.k = k;
  g.kw = (int)((long long)(blockIdx.y + 1) * k / tiles) - c0;
  g.kp = hf_solve_tile_cols(k, tiles);
  g.rows = rows;
  g.lsplit = lsplit;
  // [panel | carry | tmp | partial sums]
  T* panel = smem;
  T* carry = panel + (size_t)s * rows;
  T* tmp = carry + (size_t)s * g.kp;
  T* red = tmp + (size_t)s * g.kp;

  const size_t n = blockIdx.x;
  const T* m_n = m + n * nb * ss;
  const T* d_n = dinv + n * nb * ss;
  const T* b_n = b + n * nb * ss;
  const size_t rb = (size_t)s * k;  // elements of one (s, k) rhs block
  const T* rhs_n = rhs + n * nb * rb + c0;
  T* out_n = out + n * nb * rb + c0;

  if (!trans) {
    for (int j = 0; j < nb; ++j) {  // fwd
      const T* H = j > 0 ? m_n + (size_t)j * ss : nullptr;
      panel_step<T, RT>(H, false, nullptr, false, rhs_n + j * rb,
                        out_n + j * rb, g, panel, red, carry, tmp);
    }
    for (int j = nb - 1; j >= 0; --j) {  // bwd, in place
      const T* H = j < nb - 1 ? b_n + (size_t)j * ss : nullptr;
      panel_step<T, RT>(H, false, d_n + (size_t)j * ss, false, out_n + j * rb,
                        out_n + j * rb, g, panel, red, carry, tmp);
    }
  } else {
    for (int j = 0; j < nb; ++j) {  // fwd_t
      const T* H = j > 0 ? b_n + (size_t)(j - 1) * ss : nullptr;
      panel_step<T, RT>(H, true, d_n + (size_t)j * ss, true, rhs_n + j * rb,
                        out_n + j * rb, g, panel, red, carry, tmp);
    }
    for (int j = nb - 1; j >= 0; --j) {  // bwd_t, in place
      const T* H = j < nb - 1 ? m_n + (size_t)(j + 1) * ss : nullptr;
      panel_step<T, RT>(H, true, nullptr, false, out_n + j * rb,
                        out_n + j * rb, g, panel, red, carry, tmp);
    }
  }
}

template <typename T, int RT>
int launch_solve(const void* m, const void* dinv, const void* b,
                 const void* rhs, void* out, int n, int nb, int s, int k,
                 int tiles, int trans, int rows, int lsplit, void* stream) {
  const size_t smem =
      hf_solve_smem_elems(s, k, tiles, rows, lsplit) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_solve_kernel<T, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = hf_solve_threads(k, tiles, rows, RT, lsplit);
  banded_solve_kernel<T, RT>
      <<<dim3(n, tiles), threads, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(m), static_cast<const T*>(dinv),
          static_cast<const T*>(b), static_cast<const T*>(rhs),
          static_cast<T*>(out), nb, s, k, tiles, rows, lsplit, trans != 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const void* m, const void* dinv, const void* b,
                 const void* rhs, void* out, int n, int nb, int s, int k,
                 int tiles, int trans, int rows, int row_tile, int lsplit,
                 void* stream) {
  if (tiles < 1 || tiles > k || rows < 8 || rows % 8 != 0 || lsplit < 1 ||
      lsplit > s || (row_tile != 4 && row_tile != 8) ||
      hf_solve_threads(k, tiles, rows, row_tile, lsplit) >
          HF_SOLVE_MAX_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  if (row_tile == 4) {
    return launch_solve<T, 4>(m, dinv, b, rhs, out, n, nb, s, k, tiles, trans,
                              rows, lsplit, stream);
  }
  return launch_solve<T, 8>(m, dinv, b, rhs, out, n, nb, s, k, tiles, trans,
                            rows, lsplit, stream);
}

// ---------------------------------------------------------------------------
// The streamed design
// ---------------------------------------------------------------------------

// Factor entries a lane loads, with the carry entries they meet, before it
// multiplies any (the loads of a batch are all in flight together; written
// one load and one multiply-add after the other, the compiler kept them so
// and every multiply-add waited a shared-memory latency): 8 at one rhs
// column, 2 at up to 7, for registers.
template <int KW>
struct StreamBatch {
  static constexpr int n = KW == 1 ? 8 : 2;
};

// Cycles a wait on a ring barrier may last before the block gives up (a
// lost copy must end the launch with an error, not hang the card).
constexpr long long kStreamTimeout = 4000000000ll;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0xfffu) == 0) {
      const long long now = clock64();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > kStreamTimeout) {
        __trap();
      }
    }
  }
}

// `bytes` (a multiple of 16) from device memory at src to shared memory at
// dst (both on 16 bytes), counted down on `bar` as they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The factor block of product t of the 3 nb - 2 of a solve, in the order
// the sweeps take them (m, d, b: the sample's M, Dinv and B).
template <typename T, bool kTrans>
__device__ __forceinline__ const T* stream_block(const T* m, const T* d,
                                                 const T* b, int nb, size_t ss,
                                                 int t) {
  if constexpr (!kTrans) {
    if (t < nb - 1) return m + (size_t)(t + 1) * ss;    // fwd: M_{t+1}
    if (t == nb - 1) return d + (size_t)(nb - 1) * ss;  // bwd, last row
    const int u = t - nb, j = nb - 2 - (u >> 1);        // bwd: B_j, Dinv_j
    return ((u & 1) ? d : b) + (size_t)j * ss;
  } else {
    if (t == 0) return d;  // fwd_t, row 0
    if (t < 2 * nb - 1) {  // fwd_t: B_{j-1}, Dinv_j
      const int j = (t + 1) >> 1;
      return (t & 1) ? b + (size_t)(j - 1) * ss : d + (size_t)j * ss;
    }
    return m + (size_t)(nb - 1 - (t - (2 * nb - 1))) * ss;  // bwd_t: M_{j+1}
  }
}

// What product t subtracts its result from (`in`: a row block of the rhs
// or of the output, null when the product stands alone) and where its
// result goes (`out`, null when it is only the next carry).  rb: elements
// of one (s, k) row block.
template <typename T, bool kTrans>
__device__ __forceinline__ void stream_rows(const T* rhs, T* out, int nb,
                                            size_t rb, int t, const T** in_t,
                                            T** out_t) {
  *in_t = nullptr;
  *out_t = nullptr;
  if (t < 0 || t >= 3 * nb - 2) return;
  if constexpr (!kTrans) {
    if (t < nb - 1) {  // y_j = b_j - M_j y_{j-1}
      *in_t = rhs + (size_t)(t + 1) * rb;
      *out_t = out + (size_t)(t + 1) * rb;
    } else if (t == nb - 1) {  // x = Dinv y on the last row
      *out_t = out + (size_t)(nb - 1) * rb;
    } else {
      const int u = t - nb, j = nb - 2 - (u >> 1);
      if (u & 1) {  // x_j = Dinv_j tmp
        *out_t = out + (size_t)j * rb;
      } else {  // tmp = y_j - B_j x_{j+1}
        *in_t = out + (size_t)j * rb;
      }
    }
  } else {
    if (t == 0) {  // z_0 = Dinv_0^T b_0
      *out_t = out;
    } else if (t < 2 * nb - 1) {
      const int j = (t + 1) >> 1;
      if (t & 1) {  // tmp = b_j - B_{j-1}^T z_{j-1}
        *in_t = rhs + (size_t)j * rb;
      } else {  // z_j = Dinv_j^T tmp
        *out_t = out + (size_t)j * rb;
      }
    } else {  // x_j = z_j - M_{j+1}^T x_{j+1}
      const int j = nb - 2 - (t - (2 * nb - 1));
      *in_t = out + (size_t)j * rb;
      *out_t = out + (size_t)j * rb;
    }
  }
}

// One block's ring of factor chunks.  Chunk q of the solve is chunk q % nch
// of the slab of product q / nch; it lands in stage q % nstage.  The
// position of the chunk in use and of the chunk to request are kept as
// counters (a division per chunk and thread would show at s = 17).
template <typename T, bool kTrans>
struct StreamRing {
  uint64_t* full;
  uint64_t* empty;
  uint32_t* offset;  // per stage: where its chunk starts, in bytes
  unsigned char* stages;
  const T* m;
  const T* d;
  const T* b;
  size_t ss;
  uint32_t stage_bytes;
  int nb, s, rows, nstage, nch, r0, slab_rows;
  int total;  // chunks of the whole solve
  // the chunk in use (every thread): its product, chunk of the slab, stage
  // and the parity of its round of the ring
  int use_t, use_ci, use_st;
  uint32_t use_par;
  // the chunk to request next (thread 0)
  int requested, req_t, req_ci, req_st, req_round;

  __device__ __forceinline__ void init() {
    use_t = use_ci = use_st = 0;
    use_par = 0;
    requested = req_t = req_ci = req_st = req_round = 0;
  }

  __device__ __forceinline__ void chunk_rows(int ci, int* row0,
                                             int* nrows) const {
    *row0 = ci * rows;
    *nrows = min(rows, slab_rows - *row0);
  }

  // thread 0: request every chunk below `upto`; a stage is free once all
  // warps have given back the chunk that used it a round earlier
  __device__ __forceinline__ void request(int upto) {
    upto = min(upto, total);
    while (requested < upto) {
      if (req_round > 0) mbar_wait(&empty[req_st], (req_round - 1) & 1);
      int row0, nrows;
      chunk_rows(req_ci, &row0, &nrows);
      const uintptr_t a =
          (uintptr_t)(stream_block<T, kTrans>(m, d, b, nb, ss, req_t) +
                      (size_t)(r0 + row0) * s);
      const uintptr_t a0 = a & ~(uintptr_t)15;
      offset[req_st] = (uint32_t)(a - a0);
      const uintptr_t a1 =
          (a + (size_t)nrows * s * sizeof(T) + 15) & ~(uintptr_t)15;
      mbar_expect_tx(&full[req_st], (uint32_t)(a1 - a0));
      bulk_load(stages + (size_t)req_st * stage_bytes, (const void*)a0,
                (uint32_t)(a1 - a0), &full[req_st]);
      ++requested;
      if (++req_ci == nch) {
        req_ci = 0;
        ++req_t;
      }
      if (++req_st == nstage) {
        req_st = 0;
        ++req_round;
      }
    }
  }

  // every thread that computes: the next chunk, once it has landed.  In a
  // cluster (kInline) thread 0 first requests the chunks up to a ring's
  // depth ahead; a block on its own has thread 0 do nothing else.
  template <bool kInline>
  __device__ __forceinline__ const T* acquire(int* row0, int* nrows) {
    if (kInline && threadIdx.x < 32) {
      // the lanes beside thread 0 wait here, not in the poll below: a
      // polling lane holds the warp and starves the thread that requests
      if (threadIdx.x == 0) {
        request(use_t * nch + use_ci + max(1, nstage - 1));
      }
      __syncwarp();
    }
    mbar_wait(&full[use_st], use_par);
    chunk_rows(use_ci, row0, nrows);
    return reinterpret_cast<const T*>(stages + (size_t)use_st * stage_bytes +
                                      offset[use_st]);
  }

  // every thread, after its last read of the chunk
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[use_st]);
    if (++use_ci == nch) {
      use_ci = 0;
      ++use_t;
    }
    if (++use_st == nstage) {
      use_st = 0;
      use_par ^= 1;
    }
  }
};

// The warps that compute, of one block: all of them in a cluster, where
// warp 0 feeds the ring between its barriers, and all but warp 0 in a block
// on its own, where warp 0 only feeds the ring and joins no barrier (named
// barrier 1; its work would lie on the path of every product at s = 17).
template <bool kCluster>
__device__ __forceinline__ void stream_block_sync() {
  if constexpr (kCluster) {
    __syncthreads();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"r"(blockDim.x - 32) : "memory");
  }
}

// The same across the cluster.
template <bool kCluster>
__device__ __forceinline__ void stream_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    stream_block_sync<false>();
  }
}

// Index and number of the threads that share a block's elementwise loops.
template <bool kCluster>
__device__ __forceinline__ int stream_tid() {
  return kCluster ? (int)threadIdx.x : (int)threadIdx.x - 32;
}
template <bool kCluster>
__device__ __forceinline__ int stream_threads() {
  return kCluster ? (int)blockDim.x : (int)blockDim.x - 32;
}

// p in the shared memory of rank q of the cluster.
template <bool kCluster, typename T>
__device__ __forceinline__ T* stream_remote(T* p, int q) {
  if constexpr (kCluster) {
    return cg::this_cluster().map_shared_rank(p, q);
  } else {
    return p;
  }
}

// Forward product: rows [r0, r0 + slab_rows) of v_new = in - H v_old (or
// H v_old), written into every rank's v_new and, where `out` is given,
// into the output.  in_s: the slab's rows of `in` in shared memory.  A
// group of `fg` lanes (a power of two up to 32) takes a row: 32 / fg rows
// a warp at once, fg - 1 additions in a shuffle tree of log2 fg steps.
template <typename T, int KW, bool kCluster>
__device__ __forceinline__ void stream_forward(
    StreamRing<T, false>& ring, const T* v_old, T* v_new, const T* in_s,
    T* out, int k, int kw_, int nc, int fg) {
  const int kw = KW == 1 ? 1 : kw_;
  // warp 0 feeds the ring; the others share the rows
  const int lane = threadIdx.x & 31, warp = (int)(threadIdx.x >> 5) - 1;
  const int nwarps = (int)(blockDim.x >> 5) - 1;
  const int s = ring.s;
  const int fg_log = __ffs(fg) - 1;
  const int rpw = 32 >> fg_log;  // rows a warp takes at once
  const int sub = lane & (fg - 1);
  for (int ci = 0; ci < ring.nch; ++ci) {
    int row0, nrows;
    const T* base = ring.template acquire<kCluster>(&row0, &nrows);
    for (int rb = warp * rpw; warp >= 0 && rb < nrows; rb += nwarps * rpw) {
      const int rr = rb + (lane >> fg_log);
      const T* row = base + (size_t)min(rr, nrows - 1) * s;
      constexpr int U = StreamBatch<KW>::n;
      T acc[2][KW];
#pragma unroll
      for (int c = 0; c < KW; ++c) acc[0][c] = acc[1][c] = T(0);
      for (int l0 = sub; l0 < s; l0 += U * fg) {
        T h[U], vv[U][KW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int l = l0 + u * fg;
          h[u] = l < s ? row[l] : T(0);
#pragma unroll
          for (int c = 0; c < KW; ++c) {
            vv[u][c] = (l < s && c < kw) ? v_old[l * kw + c] : T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int c = 0; c < KW; ++c) acc[u & 1][c] += h[u] * vv[u][c];
        }
      }
      T sum[KW];
#pragma unroll
      for (int c = 0; c < KW; ++c) sum[c] = acc[0][c] + acc[1][c];
      for (int off = fg >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < KW; ++c) {
          sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], off);
        }
      }
      if (rr < nrows) {
        const int ii = row0 + rr, i = ring.r0 + ii;
#pragma unroll
        for (int c = 0; c < KW; ++c) {
          if (c >= kw) continue;
          const T val = in_s != nullptr ? in_s[ii * kw + c] - sum[c] : sum[c];
          for (int q = sub; q < nc; q += fg) {
            stream_remote<kCluster>(v_new, q)[i * kw + c] = val;
          }
          if (sub == 0 && out != nullptr) out[(size_t)i * k + c] = val;
        }
      }
    }
    ring.release();
  }
  __pipeline_wait_prior(1);  // the next product's rows of `in`
  stream_sync<kCluster>();
}

// Transposed product on the rank's slab of rows l: the partial sums
// sum_l H[l, i] v[l] for all s outputs i go to the ranks that own them
// (`inbox`: (nc, mslab, kw) on every rank), and after the cluster barrier
// the rank adds up its own outputs: v = in - sum (or the sum) on
// [r0, r0 + slab_rows), also written to `out` where given.  part:
// (rsplit, s, kw) partial sums of the block's row splits.
template <typename T, int KW, bool kCluster>
__device__ __forceinline__ void stream_transposed(
    StreamRing<T, true>& ring, T* v, T* part, T* inbox, const T* in_s, T* out,
    int k, int kw_, int nc, int rank, int rsplit) {
  const int kw = KW == 1 ? 1 : kw_;
  const int lane = threadIdx.x & 31, warp = (int)(threadIdx.x >> 5) - 1;
  const int nwarps = (int)(blockDim.x >> 5) - 1;
  const int s = ring.s;
  const int groups = (s + 31) >> 5;
  const int mslab = hf_stream_slab(s, nc);
  for (int ci = 0; ci < ring.nch; ++ci) {
    int row0, nrows;
    const T* base = ring.template acquire<kCluster>(&row0, &nrows);
    const T* vl = v + (size_t)(ring.r0 + row0) * kw;
    for (int item = warp; warp >= 0 && item < groups * rsplit; item += nwarps) {
      const int g = item % groups, rs = item / groups;
      const int i = 32 * g + lane;
      const T* col = base + min(i, s - 1);
      constexpr int U = StreamBatch<KW>::n;
      T acc[2][KW];
#pragma unroll
      for (int c = 0; c < KW; ++c) acc[0][c] = acc[1][c] = T(0);
      for (int rr0 = rs; rr0 < nrows; rr0 += rsplit * U) {
        T h[U], vv[U][KW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int rr = rr0 + u * rsplit;
          h[u] = rr < nrows ? col[rr * s] : T(0);
#pragma unroll
          for (int c = 0; c < KW; ++c) {
            vv[u][c] = (rr < nrows && c < kw) ? vl[rr * kw + c] : T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int c = 0; c < KW; ++c) acc[u & 1][c] += h[u] * vv[u][c];
        }
      }
      if (i < s) {
#pragma unroll
        for (int c = 0; c < KW; ++c) {
          if (c >= kw) continue;
          const T sum = acc[0][c] + acc[1][c];
          T* p = part + ((size_t)rs * s + i) * kw + c;
          *p = ci == 0 ? sum : *p + sum;
        }
      }
    }
    ring.release();
  }
  stream_block_sync<kCluster>();
  for (int e = stream_tid<kCluster>(); e < s * kw;
       e += stream_threads<kCluster>()) {
    const int i = e / kw, c = e - i * kw;
    T sum = T(0);
    for (int rs = 0; rs < rsplit; ++rs) sum += part[(size_t)rs * s * kw + e];
    const int q = ((i + 1) * nc - 1) / s;  // the rank that owns output i
    T* box = stream_remote<kCluster>(inbox, q);
    box[((size_t)rank * mslab + i - q * s / nc) * kw + c] = sum;
  }
  __pipeline_wait_prior(2);  // this product's rows of `in`
  stream_sync<kCluster>();
  for (int e = stream_tid<kCluster>(); e < ring.slab_rows * kw;
       e += stream_threads<kCluster>()) {
    const int ii = e / kw, c = e - ii * kw;
    T sum = T(0);
    for (int q = 0; q < nc; ++q) {
      sum += inbox[((size_t)q * mslab + ii) * kw + c];
    }
    const T val = in_s != nullptr ? in_s[e] - sum : sum;
    v[(size_t)(ring.r0 + ii) * kw + c] = val;
    if (out != nullptr) out[(size_t)(ring.r0 + ii) * k + c] = val;
  }
  stream_block_sync<kCluster>();
}

// Grid (N c, column tiles), cluster (c, 1, 1) where kCluster.  KW: 1, or
// HF_STREAM_MAX_COLS for any tile of 1 to 7 columns.  One block per sample
// (more samples than SMs on the lanes that take it) keeps to 64 registers,
// so that the blocks of one wave share an SM; a cluster's block has an SM
// to itself and takes what lets its loads run ahead.
template <typename T, int KW, bool kTrans, bool kCluster>
__global__ void __launch_bounds__(
    kCluster ? HF_STREAM_MAX_THREADS : HF_STREAM_MAX_THREADS_ONE,
    kCluster ? 1 : 2)
    banded_stream_kernel(const T* __restrict__ m, const T* __restrict__ dinv,
                         const T* __restrict__ b, const T* __restrict__ rhs,
                         T* __restrict__ out, int nb, int s, int k, int kt,
                         int rows, int nstage, int rsplit, int fgroup) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int nc = 1, rank = 0;
  if constexpr (kCluster) {
    nc = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kt;
  const int kw = KW == 1 ? 1 : min(kt, k - c0);
  const size_t n = blockIdx.x / nc;
  const size_t ss = (size_t)s * s;
  const size_t rb = (size_t)s * k;
  const T* rhs_n = rhs + n * nb * rb + c0;
  T* out_n = out + n * nb * rb + c0;
  const int mslab = hf_stream_slab(s, nc);
  const int ntot = 3 * nb - 2;

  StreamRing<T, kTrans> ring;
  ring.full = reinterpret_cast<uint64_t*>(smem_raw);
  ring.empty = ring.full + HF_STREAM_MAX_STAGES;
  ring.offset = reinterpret_cast<uint32_t*>(ring.empty + HF_STREAM_MAX_STAGES);
  T* carry = reinterpret_cast<T*>(smem_raw + HF_STREAM_BAR_BYTES);
  const size_t carry_bytes =
      (hf_stream_carry_elems(s, kt, nc, rsplit, kTrans) * sizeof(T) + 15) /
      16 * 16;
  ring.stages = smem_raw + HF_STREAM_BAR_BYTES + carry_bytes;
  ring.stage_bytes = (uint32_t)hf_stream_stage_bytes(s, rows, (int)sizeof(T));
  ring.m = m + n * nb * ss;
  ring.d = dinv + n * nb * ss;
  ring.b = b + n * nb * ss;
  ring.ss = ss;
  ring.nb = nb;
  ring.s = s;
  ring.rows = rows;
  ring.nstage = nstage;
  ring.r0 = rank * s / nc;
  ring.slab_rows = (rank + 1) * s / nc - ring.r0;
  ring.nch = (ring.slab_rows + rows - 1) / rows;
  ring.total = ntot * ring.nch;
  ring.init();
  if (tid == 0) {
    for (int q = 0; q < nstage; ++q) {
      mbar_init(&ring.full[q], 1);
      mbar_init(&ring.empty[q], stream_threads<kCluster>() >> 5);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (kCluster) {
    if (tid == 0) ring.request(max(1, nstage - 1));
  } else if (tid < 32) {
    // a block on its own: thread 0 requests every chunk of the solve, each
    // as soon as its stage is free, and its warp does nothing else
    if (tid == 0) ring.request(ring.total);
    return;
  }

  // the carry region, in tile elements of kt columns (kw <= kt of them
  // used): see hf_stream_carry_elems
  const size_t full_el = (size_t)s * kt, slab_el = (size_t)mslab * kt;
  T* in_buf;  // (3, mslab, kw): the slab's rows of `in`, two products ahead
  T* v0;      // forward: the carry, twice; transposed: the carry
  T* part = nullptr;
  T* inbox = nullptr;
  if constexpr (!kTrans) {
    v0 = carry;
    in_buf = carry + 2 * full_el;
  } else {
    v0 = carry;
    part = carry + full_el;
    inbox = part + (size_t)rsplit * full_el;
    in_buf = inbox + 2 * (size_t)nc * slab_el;
  }

  // the carry before the first product is the first row of the rhs: all
  // of it on a forward sweep (which also is y_0, kept in the output), the
  // rank's slab on a transposed one
  if constexpr (!kTrans) {
    for (int e = stream_tid<kCluster>(); e < s * kw;
         e += stream_threads<kCluster>()) {
      const int i = e / kw, c = e - i * kw;
      const T val = rhs_n[(size_t)i * k + c];
      v0[e] = val;
      if (i >= ring.r0 && i < ring.r0 + ring.slab_rows) {
        out_n[(size_t)i * k + c] = val;
      }
    }
  } else {
    for (int e = stream_tid<kCluster>(); e < ring.slab_rows * kw;
         e += stream_threads<kCluster>()) {
      const int ii = e / kw, c = e - ii * kw;
      v0[(size_t)(ring.r0 + ii) * kw + c] =
          rhs_n[(size_t)(ring.r0 + ii) * k + c];
    }
  }
  // request the slab's rows of `in` (null: none) into buffer q of in_buf
  auto prefetch_in = [&](int q, const T* in_t) {
    if (in_t != nullptr) {
      T* dst = in_buf + (size_t)q * slab_el;
      for (int e = stream_tid<kCluster>(); e < ring.slab_rows * kw;
           e += stream_threads<kCluster>()) {
        const int ii = e / kw, c = e - ii * kw;
        __pipeline_memcpy_async(dst + e, in_t + (size_t)(ring.r0 + ii) * k + c,
                                sizeof(T));
      }
    }
    __pipeline_commit();
  };

  // the rows of `in` of product t + 2 are requested at the start of product
  // t (one product ahead left their latency in the open at s = 17) and
  // those of product t waited for before a cluster barrier ahead of their
  // use (forward: the last of product t - 1; transposed: the one inside
  // product t), which makes them visible to all warps.  in_t, out_t: those
  // of products t, t + 1 and t + 2, decoded once each
  const T* in_t[3];
  T* out_t[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    stream_rows<T, kTrans>(rhs_n, out_n, nb, rb, q, &in_t[q], &out_t[q]);
  }
  prefetch_in(0, in_t[0]);
  prefetch_in(1, in_t[1]);
  __pipeline_wait_prior(1);
  // every block of the cluster runs before any writes into its shared
  // memory; the block's own writes above are visible to all its warps
  stream_sync<kCluster>();
  int cur = 0;
  int buf = 0;  // t % 3
  for (int t = 0; t < ntot; ++t) {
    prefetch_in(buf == 0 ? 2 : buf - 1, in_t[2]);  // buffer (t + 2) % 3
    const T* in_s =
        in_t[0] != nullptr ? in_buf + (size_t)buf * slab_el : nullptr;
    T* const out_now = out_t[0];
    in_t[0] = in_t[1];
    out_t[0] = out_t[1];
    in_t[1] = in_t[2];
    out_t[1] = out_t[2];
    stream_rows<T, kTrans>(rhs_n, out_n, nb, rb, t + 3, &in_t[2], &out_t[2]);
    buf = buf == 2 ? 0 : buf + 1;
    if constexpr (!kTrans) {
      stream_forward<T, KW, kCluster>(ring, v0 + (size_t)cur * full_el,
                                      v0 + (size_t)(cur ^ 1) * full_el, in_s,
                                      out_now, k, kw, nc, fgroup);
      cur ^= 1;
    } else {
      stream_transposed<T, KW, kCluster>(
          ring, v0, part, inbox + (size_t)(t & 1) * nc * slab_el, in_s, out_now,
          k, kw, nc, rank, rsplit);
    }
  }
}

template <typename T, int KW, bool kTrans, bool kCluster>
int launch_stream(const void* m, const void* dinv, const void* b,
                  const void* rhs, void* out, int n, int nb, int s, int k,
                  int kt, int c, int rows, int nstage, int threads, int rsplit,
                  int fgroup, void* stream) {
  auto kernel = banded_stream_kernel<T, KW, kTrans, kCluster>;
  const size_t smem =
      hf_stream_smem_size(s, kt, c, rows, nstage, rsplit, kTrans, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3((unsigned)n * (unsigned)c, (unsigned)((k + kt - 1) / kt), 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(m),
                           static_cast<const T*>(dinv),
                           static_cast<const T*>(b),
                           static_cast<const T*>(rhs), static_cast<T*>(out), nb,
                           s, k, kt, rows, nstage, rsplit, fgroup);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename T>
int launch_stream(const void* m, const void* dinv, const void* b,
                  const void* rhs, void* out, int n, int nb, int s, int k,
                  int kt, int trans, int c, int rows, int nstage, int threads,
                  int rsplit, int fgroup, void* stream) {
  if (kt < 1 || kt > HF_STREAM_MAX_COLS || c < 1 || c > HF_STREAM_MAX_CLUSTER ||
      c > s || rows < 1 || nstage < 2 || nstage > HF_STREAM_MAX_STAGES ||
      threads < 64 || threads % 32 != 0 ||
      threads > (c > 1 ? HF_STREAM_MAX_THREADS : HF_STREAM_MAX_THREADS_ONE) ||
      rsplit < 1 || fgroup < 1 || fgroup > 32 || (fgroup & (fgroup - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
#define HF_STREAM_CASE(KW, TRANS, CLUSTER)                                    \
  if ((kt == 1) == (KW == 1) && (trans != 0) == TRANS && (c > 1) == CLUSTER)  \
    return launch_stream<T, KW, TRANS, CLUSTER>(m, dinv, b, rhs, out, n, nb,  \
                                                s, k, kt, c, rows, nstage,    \
                                                threads, rsplit, fgroup,      \
                                                stream);
  HF_STREAM_CASE(1, false, false)
  HF_STREAM_CASE(1, false, true)
  HF_STREAM_CASE(1, true, false)
  HF_STREAM_CASE(1, true, true)
  HF_STREAM_CASE(HF_STREAM_MAX_COLS, false, false)
  HF_STREAM_CASE(HF_STREAM_MAX_COLS, false, true)
  HF_STREAM_CASE(HF_STREAM_MAX_COLS, true, false)
  HF_STREAM_CASE(HF_STREAM_MAX_COLS, true, true)
#undef HF_STREAM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The panel design: k columns in `tiles` (1 to k) tiles, panels of
// `rows` rows (a multiple of 8), register tiles of `row_tile` (4 or 8)
// rows, `lsplit` (1 to s) slices of the inner index, at most
// HF_SOLVE_MAX_THREADS threads (hf_solve_threads); anything else returns
// cudaErrorInvalidValue.
extern "C" int hf_banded_solve_f32(const void* m, const void* dinv,
                                   const void* b, const void* rhs, void* out,
                                   int n, int nb, int s, int k, int tiles,
                                   int trans, int rows, int row_tile,
                                   int lsplit, void* stream) {
  return launch_solve<float>(m, dinv, b, rhs, out, n, nb, s, k, tiles, trans,
                             rows, row_tile, lsplit, stream);
}

extern "C" int hf_banded_solve_f64(const void* m, const void* dinv,
                                   const void* b, const void* rhs, void* out,
                                   int n, int nb, int s, int k, int tiles,
                                   int trans, int rows, int row_tile,
                                   int lsplit, void* stream) {
  return launch_solve<double>(m, dinv, b, rhs, out, n, nb, s, k, tiles, trans,
                              rows, row_tile, lsplit, stream);
}

extern "C" long long hf_solve_smem_bytes(int s, int k, int tiles, int rows,
                                         int lsplit, int itemsize) {
  if (tiles < 1 || rows < 1 || lsplit < 1) return -1;
  return (long long)(hf_solve_smem_elems(s, k, tiles, rows, lsplit) * itemsize);
}

extern "C" int hf_solve_threads_of(int k, int tiles, int rows, int row_tile,
                                   int lsplit) {
  if (tiles < 1 || row_tile < 1) return -1;
  return hf_solve_threads(k, tiles, rows, row_tile, lsplit);
}

// The streamed design (kt <= 7 columns a tile): c blocks per sample (1 to
// 8), ring stages of `rows` rows, `nstage` of them (2 to 16), `threads` per
// block (whole warps, at most HF_STREAM_MAX_THREADS), `rsplit` row splits
// of a transposed product and `fgroup` lanes a row of a forward one (a
// power of two up to 32); anything else returns cudaErrorInvalidValue.
extern "C" int hf_banded_solve_stream_f32(const void* m, const void* dinv,
                                          const void* b, const void* rhs,
                                          void* out, int n, int nb, int s,
                                          int k, int kt, int trans, int c,
                                          int rows, int nstage, int threads,
                                          int rsplit, int fgroup,
                                          void* stream) {
  return launch_stream<float>(m, dinv, b, rhs, out, n, nb, s, k, kt, trans, c,
                              rows, nstage, threads, rsplit, fgroup, stream);
}

extern "C" int hf_banded_solve_stream_f64(const void* m, const void* dinv,
                                          const void* b, const void* rhs,
                                          void* out, int n, int nb, int s,
                                          int k, int kt, int trans, int c,
                                          int rows, int nstage, int threads,
                                          int rsplit, int fgroup,
                                          void* stream) {
  return launch_stream<double>(m, dinv, b, rhs, out, n, nb, s, k, kt, trans, c,
                               rows, nstage, threads, rsplit, fgroup, stream);
}

extern "C" long long hf_stream_smem_bytes(int s, int kt, int c, int rows,
                                          int nstage, int rsplit, int trans,
                                          int itemsize) {
  if (c < 1 || rows < 1 || nstage < 1 || rsplit < 1) return -1;
  return (long long)hf_stream_smem_size(s, kt, c, rows, nstage, rsplit,
                                        trans != 0, itemsize);
}

extern "C" const char* hf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
