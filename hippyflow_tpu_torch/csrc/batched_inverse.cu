// K3/K4: batched inverse by Gauss-Jordan without pivoting, in place.
//
// Replaces the Pallas kernels `_batched_inverse_blocked` (K3, body
// `_gj_blocked_kernel_factory`, 13-wide pivot blocks and rank-13 updates)
// and `_batched_inverse_pallas` (K4, body `_gj_kernel`, rank-1 updates) of
// hippyflow_tpu/ops/pallas_kernels.py.  One kernel serves both: the pivot
// block width w is a runtime argument (13 for K3, 1 for K4).
//
// In-place Gauss-Jordan needs no augmented [X | I] half.  Per block step
// with pivot rows and columns p = [kb, kb + w), P = X[p, p], R = X[p, ~p],
// C = X[~p, p] and Y = X[~p, ~p]:
//
//     X[p, p]   <- P^{-1}
//     X[p, ~p]  <- P^{-1} R
//     X[~p, p]  <- -C P^{-1}
//     X[~p, ~p] <- Y - C P^{-1} R
//
// and after the last step X holds its inverse.  No pivoting relies on
// diagonally dominant or SPD inputs (the diagonal blocks of the prior's K
// and M and of the bc-symmetrized Newton operator) and on the helmholtz
// Schur complements, whose identity residuals stay within a few times the
// pivoted inverse's: the same contract as the TPU kernels.
//
// What bounds it on this card: 2 s^3 flops per matrix against 2 s^2
// elements moved, so at s=193 and 516 the arithmetic bound is 15-40 times
// the byte bound; but the ceil(s / w) block steps of one matrix are
// sequential, and a step costs its latencies: one pass over the block's
// columns, and a fixed part (staging the pivot columns, the w dependent
// pivot steps, the barriers).  With one thread block per matrix, 16
// matrices of s=516 keep 16 of the 132 SMs busy.  The design:
//
// * A cluster of c thread blocks per matrix (grid N c, cluster (c, 1, 1),
//   1 <= c <= 8, picked by the host: `gj_cluster` in ops/hopper_kernels.py)
//   splits its columns: rank r owns a run of whole 32-column chunks, so
//   that loads stay coalesced, and writes only those.  Each step: (a) a
//   cluster barrier, whose release/acquire orders the previous step's
//   writes; (b) every block stages the pivot columns C = X[:, p] (with P
//   in them) in shared memory, the L2 design also its own slice of the
//   pivot rows R; (c) a
//   cluster barrier, after which the blocks that own the pivot columns may
//   overwrite them; (d) each block forms its slice of P^{-1} R and applies
//   the rank-w update to its own columns.  A block needs nothing of
//   another but C and P.  Every c, 1 included, is one cluster launch with
//   the same barriers.
// * Where the matrix lives, two designs (a template parameter of the one
//   kernel, `gj_inverse_kernel`, so that the profiler names both alike):
//   - L2: the matrix lives in the output buffer (in L2: 96 float64
//     matrices of 193 x 193 are 29 MB of the 50 MB L2), every step reads
//     and writes it there past L1 (ld.cg), with four rows in flight per
//     thread; the same code takes any s and both dtypes.
//   - resident: each block copies its own columns into its shared memory
//     once (4- or 8-byte asynchronous copies, all in flight: rows start on
//     any element), in rows padded to whole 32-column chunks, runs every
//     step there and writes them back once.  In (b) warp 0 reads P from
//     the shared memory of the block(s) that own it (distributed shared
//     memory, explicit shared::cluster loads) and inverts it while the
//     other warps stage C the same way; barrier (c) is split, its arrival
//     after the reads and its wait after the new pivot rows are formed,
//     so that its latency lies under them.  The update runs whole groups
//     of 32 columns, q per lane as the block's column count allows, in
//     tiles of two rows; fewer than 16 columns past the last whole group
//     (one at s = 193) take a thread per entry rather than a group of 32
//     lanes.  At c = 1 block barriers replace the cluster's.
//   Measured on the H100 (PERF.md), the L2 design's steps were not bound
//   by the L2 round trips but by what every step pays: the update's
//   predicates and idle lanes, the staging and the barriers; the resident
//   design cut those and runs K1's (32, 193) row in about half the time.
//   The host takes the resident design wherever its shared memory fits a
//   block's limit at the c that `gj_cluster` picks, at pivot width 13 for
//   K3 and K4 alike (`gj_resident` in ops/hopper_kernels.py): every
//   float32 shape of the lanes up to s=258 at c=3; not helmholtz's
//   (16, 516) in either dtype nor (32, 258) or (96, 193) in float64,
//   which keep the L2 design.  The two designs do the same arithmetic on
//   every entry in the same order: their results are equal bit for bit.
// * P^{-1} in one warp: lane l < 2w holds column l of [P | I] in
//   registers, and pivot step k takes the pivot and the column-k
//   multipliers from lane k by warp shuffles, so the w pivot steps need no
//   block barrier.  Every block of the cluster forms P^{-1} itself.
// * In the update each thread owns q columns, 32 apart (the L2 design 4,
//   2 in float64): it keeps their slices of P^{-1} R in registers and
//   reads each row's pivot columns once, as 16-byte shared-memory
//   broadcasts, for all of them.
//
// Plain IEEE arithmetic in the working type (no tensor cores: a float32
// mma would be TF32); the pivot row is scaled by the pivot's rounded
// reciprocal, where the plain version divides.  `stride` (elements
// between consecutive matrices) lets K1's row-panel design invert
// Dinv[:, j] of a (N, nb, s, s) factor in place.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowUnroll = 4;
constexpr int kStageUnroll = 4;

// Columns of the update one thread owns (32 apart, so each load of a warp
// stays one coalesced row segment): a row's pivot columns, read once from
// shared memory, serve all of them.  Fewer in float64, for registers.
template <typename T>
struct GjCols {
  static constexpr int n = 4;
};
template <>
struct GjCols<double> {
  static constexpr int n = 2;
};

// The L2 design.
template <typename T>
__device__ __forceinline__ void gj_inverse_l2(T* x, int s, long long stride,
                                              int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int mc = hf_gj_own_cols(s, nc);
  T* cs = reinterpret_cast<T*>(smem_raw);  // (s, 16) pivot columns
  T* rs = cs + (size_t)s * HF_GJ_ROW;      // (w, mc) own pivot rows as read
  T* rn = rs + (size_t)w * mc;             // (w, mc) own pivot rows after
  T* pinv = rn + (size_t)w * mc;           // (w, 16) P^{-1}
  T* a = x + (size_t)(blockIdx.x / nc) * stride;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  // this block's columns [j0, j0 + ncols): chunks [ch0, ch0 + nch)
  const int nchunk = (s + 31) >> 5;
  const int ch0 = rank * nchunk / nc;
  const int nch = (rank + 1) * nchunk / nc - ch0;
  const int j0 = 32 * ch0;
  const int ncols = min(s, 32 * (ch0 + nch)) - j0;
  const int ncs = s * HF_GJ_ROW;

  for (int kb = 0; kb < s; kb += w) {
    const int wp = min(w, s - kb);
    // (a) every block's writes of the previous step are visible
    if (kb > 0) cg::this_cluster().sync();
    // (b) stage the pivot columns (zero past wp) and the own pivot rows,
    // the loads of kStageUnroll entries in flight before their stores
    for (int e0 = tid; e0 < ncs; e0 += nth * kStageUnroll) {
      T v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * nth;
        const int l = e & (HF_GJ_ROW - 1);
        v[u] = (e < ncs && l < wp)
                   ? __ldcg(a + (size_t)(e / HF_GJ_ROW) * s + kb + l)
                   : T(0);
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * nth;
        if (e < ncs) cs[e] = v[u];
      }
    }
    const int nrs = wp * mc;
    for (int e0 = tid; e0 < nrs; e0 += nth * kStageUnroll) {
      T v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * nth;
        const int r = e / mc, jj = e - (e / mc) * mc;
        v[u] = (e < nrs && jj < ncols)
                   ? __ldcg(a + (size_t)(kb + r) * s + j0 + jj)
                   : T(0);
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * nth;
        if (e < nrs) rs[e] = v[u];
      }
    }
    __syncthreads();
    if (warp == 0) pivot_block_inverse(cs + (size_t)kb * HF_GJ_ROW, HF_GJ_ROW, wp, pinv);
    // (c) every block has staged the pivot columns; P^{-1} is published
    cg::this_cluster().sync();

    // (d) own slice of the new pivot rows: P^{-1} R off the block, P^{-1}
    // on it
    for (int e = tid; e < nrs; e += nth) {
      const int r = e / mc, jj = e - (e / mc) * mc;
      if (jj >= ncols) continue;
      const int j = j0 + jj;
      T v;
      if (j >= kb && j < kb + wp) {
        v = pinv[r * HF_GJ_ROW + j - kb];
      } else {
        v = T(0);
        for (int m = 0; m < wp; ++m) v += pinv[r * HF_GJ_ROW + m] * rs[m * mc + jj];
      }
      rn[e] = v;
    }
    __syncthreads();

    // rank-wp update of the own columns: X[i, j] <- X[i, j] - C[i] rn[:, j],
    // with X[i, p] read as 0; warp items are (run of 32 q columns, row
    // group), lane l taking columns l, l + 32, ... of the run
    constexpr int q = GjCols<T>::n;
    const int nrun = (ncols + 32 * q - 1) / (32 * q);
    for (int item = warp; item < nrun * nwarps; item += nwarps) {
      const int jb = (item % nrun) * 32 * q + lane;
      const int g = item / nrun;
      if (jb >= ncols) continue;
      T r[q][HF_GJ_MAX_W];
      bool own[q], load[q];
#pragma unroll
      for (int c = 0; c < q; ++c) {
        const int jj = jb + 32 * c, j = j0 + jj;
        own[c] = jj < ncols;
        load[c] = own[c] && !(j >= kb && j < kb + wp);
#pragma unroll
        for (int l = 0; l < HF_GJ_MAX_W; ++l) {
          r[c][l] = (own[c] && l < wp) ? rn[l * mc + jj] : T(0);
        }
      }
      for (int i0 = g; i0 < s; i0 += nwarps * kRowUnroll) {
        T v[kRowUnroll][q];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int i = i0 + u * nwarps;
#pragma unroll
          for (int c = 0; c < q; ++c) {
            v[u][c] = (i < s && load[c])
                          ? __ldcg(a + (size_t)i * s + j0 + jb + 32 * c)
                          : T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int i = i0 + u * nwarps;
          if (i >= s) continue;
          T* ai = a + (size_t)i * s + j0 + jb;
          if (i >= kb && i < kb + wp) {
#pragma unroll
            for (int c = 0; c < q; ++c) {
              if (own[c]) ai[32 * c] = rn[(i - kb) * mc + jb + 32 * c];
            }
          } else {
            T cv[HF_GJ_ROW];
            hf_load16(cs + i * HF_GJ_ROW, cv);
#pragma unroll
            for (int c = 0; c < q; ++c) {
              T d = T(0);
#pragma unroll
              for (int l = 0; l < HF_GJ_MAX_W; ++l) {
                if (l < wp) d += cv[l] * r[c][l];
              }
              if (own[c]) ai[32 * c] = v[u][c] - d;
            }
          }
        }
      }
    }
  }
}

// The entry at p's offset in the shared memory of block q of the
// cluster: an explicit shared::cluster load (a generic one would order
// the warp's later shared-memory accesses behind it).
template <typename T>
__device__ __forceinline__ T ld_cluster(const T* p, int q) {
  const unsigned local = (unsigned)__cvta_generic_to_shared(p);
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(q));
  T v;
  if constexpr (sizeof(T) == 4) {
    asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  } else {
    asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(remote));
  }
  return v;
}

// The two halves of a cluster barrier, the arrival relaxed (no release
// fence): it orders only what the thread has finished, such as loads
// whose values it has used.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Loads of the resident design's staging that one thread keeps in flight.
constexpr int kResStage = 8;

// Rows of the resident design's update tile: a thread reads the pivot
// columns of these rows and its columns of them before any product.
constexpr int kResRows = 2;

// Own columns past the last whole group of 32 that the resident update
// leaves to a thread per entry rather than to a group of 32 lanes.
constexpr int kResRagged = 16;

// R rows i0, i0 + nw, ... of the resident update of q groups of 32
// columns from jb, lane l taking columns jb + l + 32 c: X[i, j] <- X[i, j]
// - C[i] rn[:, j] with X[i, p] read as 0 (load[c] false), the pivot rows
// <- rn.  xs and rn have rows of ld >= jb + 32 q entries, so lanes past
// the own columns write padding.  Past wp both C (staged as zeros) and
// the lane's slices r of rn are 0, and d, which starts at +0, is never
// -0, so the products 0 * 0 leave it bit for bit as the L2 design's loop,
// which stops at wp.
template <typename T, int Q, int W, int R>
__device__ __forceinline__ void gj_rows_resident(
    const T (&r)[Q][W], const bool (&load)[Q], T* __restrict__ xs,
    const T* __restrict__ cs, const T* __restrict__ rn, int ld, int i0,
    int nw, int kb, int wp, int jl) {
  T cv[R][HF_GJ_ROW], v[R][Q], d[R][Q];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = i0 + u * nw;
    if constexpr (W == 1) {
      cv[u][0] = cs[i * HF_GJ_ROW];
    } else {
      hf_load16(cs + i * HF_GJ_ROW, cv[u]);
    }
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      v[u][c] = load[c] ? xs[i * ld + jl + 32 * c] : T(0);
      d[u][c] = T(0);
    }
  }
#pragma unroll
  for (int l = 0; l < W; ++l) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int c = 0; c < Q; ++c) d[u][c] += cv[u][l] * r[c][l];
    }
  }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = i0 + u * nw;
    T* xi = xs + i * ld + jl;
    if (i >= kb && i < kb + wp) {
      const T* ri = rn + (i - kb) * ld + jl;
#pragma unroll
      for (int c = 0; c < Q; ++c) xi[32 * c] = ri[32 * c];
    } else {
#pragma unroll
      for (int c = 0; c < Q; ++c) xi[32 * c] = v[u][c] - d[u][c];
    }
  }
}

// The resident update of q groups of 32 own columns from jb, rows g,
// g + nw, ...: whole tiles of R rows, then the rest a row at a time.
template <typename T, int Q, int W>
__device__ __forceinline__ void gj_update_resident(
    T* xs, const T* cs, const T* rn, int ld, int s, int kb, int wp, int j0,
    int jb, int g, int nw) {
  constexpr int R = kResRows;
  const int jl = jb + (threadIdx.x & 31);
  T r[Q][W];
  bool load[Q];
#pragma unroll
  for (int c = 0; c < Q; ++c) {
    const int j = j0 + jl + 32 * c;
    load[c] = !(j >= kb && j < kb + wp);
#pragma unroll
    for (int l = 0; l < W; ++l) {
      r[c][l] = l < wp ? rn[l * ld + jl + 32 * c] : T(0);
    }
  }
  int i0 = g;
  for (; i0 + (R - 1) * nw < s; i0 += R * nw) {
    gj_rows_resident<T, Q, W, R>(r, load, xs, cs, rn, ld, i0, nw, kb, wp, jl);
  }
  for (; i0 < s; i0 += nw) {
    gj_rows_resident<T, Q, W, 1>(r, load, xs, cs, rn, ld, i0, nw, kb, wp, jl);
  }
}

template <typename T, int W>
__device__ __forceinline__ void gj_update_resident_q(
    int q, T* xs, const T* cs, const T* rn, int ld, int s, int kb, int wp,
    int j0, int jb, int g, int nw) {
  if (q == 1) {
    gj_update_resident<T, 1, W>(xs, cs, rn, ld, s, kb, wp, j0, jb, g, nw);
  } else if (q == 2) {
    gj_update_resident<T, 2, W>(xs, cs, rn, ld, s, kb, wp, j0, jb, g, nw);
  } else if constexpr (GjCols<T>::n > 2) {
    if (q == 3) {
      gj_update_resident<T, 3, W>(xs, cs, rn, ld, s, kb, wp, j0, jb, g, nw);
    } else {
      gj_update_resident<T, 4, W>(xs, cs, rn, ld, s, kb, wp, j0, jb, g, nw);
    }
  }
}

// The resident design.
template <typename T>
__device__ __forceinline__ void gj_inverse_resident(T* x, int s,
                                                    long long stride, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ld = hf_gj_res_ld(s, nc);
  // the (s, 16) pivot columns, the (w, ld) new pivot rows, the (w, 16)
  // P^{-1} and the (s, ld) own columns
  T* cs = reinterpret_cast<T*>(smem_raw);
  T* rn = cs + (size_t)s * HF_GJ_ROW;
  T* pinv = rn + (size_t)w * ld;
  T* xs = pinv + (size_t)w * HF_GJ_ROW;
  T* a = x + (size_t)(blockIdx.x / nc) * stride;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int nchunk = (s + 31) >> 5;
  const int ch0 = rank * nchunk / nc;
  const int nch = (rank + 1) * nchunk / nc - ch0;
  const int j0 = 32 * ch0;
  const int ncols = min(s, 32 * (ch0 + nch)) - j0;
  // the own columns in groups of 32 lanes, the last one ragged where it
  // holds kResRagged columns or more; else the ragged ones a thread each
  constexpr int qmax = GjCols<T>::n;
  const int ngroup = (ncols & 31) >= kResRagged ? (ncols + 31) >> 5 : ncols >> 5;
  const int nrag = ncols - min(ncols, 32 * ngroup);
  const int nrun = (ngroup + qmax - 1) / qmax;

  // the own columns into shared memory, a row a warp, every copy in flight
  // at once (rows start on any element: s is odd at the lanes' shapes)
  for (int i = warp; i < s; i += nwarps) {
    for (int jj = lane; jj < ncols; jj += 32) {
      __pipeline_memcpy_async(xs + (size_t)i * ld + jj,
                              a + (size_t)i * s + j0 + jj, sizeof(T));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);

  for (int kb = 0; kb < s; kb += w) {
    const int wp = min(w, s - kb);
    // (a) every block's writes of the previous step (or its copy in) are
    // visible
    if (nc > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    // (b) warp 0 reads P, a column a lane, from the blocks that own it
    // (a pivot block may span two; chunk ch belongs to rank
    // ((ch + 1) nc - 1) / nchunk) and inverts it; the other warps, once
    // P is in, stage the pivot columns of every row (zero past wp) the
    // same way, beside the inverse.  Each thread, once it has used what it
    // read, then makes the first half of barrier (c), whose second half
    // comes before the update: a block overwrites its own columns only
    // after every block has read them.
    if (warp == 0) {
      const int lc = min(lane, wp - 1), j = kb + lc;
      const int o = (((j >> 5) + 1) * nc - 1) / nchunk;
      const T* src = xs + (j - 32 * (o * nchunk / nc));
      T col[HF_GJ_MAX_W];
#pragma unroll
      for (int r = 0; r < HF_GJ_MAX_W; ++r) {
        col[r] = ld_cluster(src + (size_t)(kb + min(r, wp - 1)) * ld, o);
      }
      // P is in: the other warps' loads may start
      asm volatile("bar.arrive 1, %0;" ::"r"(nth) : "memory");
      pivot_block_augment(col, wp);
      pivot_block_inverse_cols(col, wp, pinv);
      if (nc > 1) cluster_arrive_relaxed();
    } else {
      const int t = tid - 32, lt = t & (HF_GJ_ROW - 1);
      const int rstep = (nth - 32) / HF_GJ_ROW;
      const int j = kb + min(lt, wp - 1);
      const int o = (((j >> 5) + 1) * nc - 1) / nchunk;
      const T* src = xs + (j - 32 * (o * nchunk / nc));
      // after warp 0's loads of P, which lie on the step's critical path
      asm volatile("bar.sync 1, %0;" ::"r"(nth) : "memory");
      for (int i0 = t / HF_GJ_ROW; i0 < s; i0 += rstep * kResStage) {
        T v[kResStage];
#pragma unroll
        for (int u = 0; u < kResStage; ++u) {
          const int i = min(i0 + u * rstep, s - 1);
          v[u] = lt < wp ? ld_cluster(src + (size_t)i * ld, o) : T(0);
        }
#pragma unroll
        for (int u = 0; u < kResStage; ++u) {
          const int i = i0 + u * rstep;
          if (i < s) cs[i * HF_GJ_ROW + lt] = v[u];
        }
      }
      if (nc > 1) cluster_arrive_relaxed();
    }
    __syncthreads();

    // (d) the own slice of the new pivot rows, from the own pivot rows in
    // place: P^{-1} R off the block, P^{-1} on it; warp r forms row r
    if (warp < wp) {
      const T* pr = pinv + warp * HF_GJ_ROW;
      const T* xr = xs + (size_t)kb * ld;
      for (int jj = lane; jj < ncols; jj += 32) {
        const int j = j0 + jj;
        T v;
        if (j >= kb && j < kb + wp) {
          v = pr[j - kb];
        } else if (wp == HF_GJ_MAX_W) {
          v = T(0);
#pragma unroll
          for (int m = 0; m < HF_GJ_MAX_W; ++m) v += pr[m] * xr[m * ld + jj];
        } else {
          v = T(0);
          for (int m = 0; m < wp; ++m) v += pr[m] * xr[m * ld + jj];
        }
        rn[warp * ld + jj] = v;
      }
    }
    __syncthreads();
    if (nc > 1) cluster_wait();

    // then the update: warp items (run of at most qmax groups of 32 own
    // columns, row group), then the ragged columns a thread per entry
    for (int item = warp; item < nrun * nwarps; item += nwarps) {
      const int run = item % nrun, g = item / nrun;
      const int jb = run * 32 * qmax;
      const int q = min(qmax, ngroup - run * qmax);
      if (w == 1) {
        gj_update_resident_q<T, 1>(q, xs, cs, rn, ld, s, kb, wp, j0, jb, g,
                                   nwarps);
      } else {
        gj_update_resident_q<T, HF_GJ_MAX_W>(q, xs, cs, rn, ld, s, kb, wp, j0,
                                             jb, g, nwarps);
      }
    }
    for (int e = tid; e < s * nrag; e += nth) {
      const int i = e / nrag, jj = 32 * ngroup + e - (e / nrag) * nrag;
      const int j = j0 + jj;
      T* xi = xs + (size_t)i * ld + jj;
      if (i >= kb && i < kb + wp) {
        *xi = rn[(i - kb) * ld + jj];
      } else {
        T cv[HF_GJ_ROW];
        hf_load16(cs + i * HF_GJ_ROW, cv);
        T d = T(0);
#pragma unroll
        for (int l = 0; l < HF_GJ_MAX_W; ++l) {
          if (l < wp) d += cv[l] * rn[l * ld + jj];
        }
        *xi = (j >= kb && j < kb + wp ? T(0) : *xi) - d;
      }
    }
  }
  // the own columns back, once (no other block reads them after the last
  // step's barrier (c))
  __syncthreads();
  for (int i = warp; i < s; i += nwarps) {
    for (int jj = lane; jj < ncols; jj += 32) {
      a[(size_t)i * s + j0 + jj] = xs[(size_t)i * ld + jj];
    }
  }
}

// One kernel, so that the profiler names both designs alike.
template <typename T, bool Resident>
__global__ void __launch_bounds__(HF_GJ_THREADS)
    gj_inverse_kernel(T* x, int s, long long stride, int w) {
  if constexpr (Resident) {
    gj_inverse_resident<T>(x, s, stride, w);
  } else {
    gj_inverse_l2<T>(x, s, stride, w);
  }
}

template <typename T>
int launch_inverse(void* x, int n, int s, long long stride, int w, int c,
                   int resident, void* stream) {
  if (w < 1 || w > HF_GJ_MAX_W || c < 1 || c > HF_GJ_MAX_CLUSTER ||
      (resident != 0 && resident != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  void (*kernel)(T*, int, long long, int) =
      resident ? gj_inverse_kernel<T, true> : gj_inverse_kernel<T, false>;
  const size_t smem = hf_gj_smem_elems(s, w, c, resident != 0) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * (unsigned)c, 1, 1);
  cfg.blockDim = dim3(HF_GJ_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<T*>(x), s, stride, w);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" int hf_batched_inverse_f32(void* x, int n, int s, long long stride,
                                      int w, int c, int resident,
                                      void* stream) {
  return launch_inverse<float>(x, n, s, stride, w, c, resident, stream);
}

extern "C" int hf_batched_inverse_f64(void* x, int n, int s, long long stride,
                                      int w, int c, int resident,
                                      void* stream) {
  return launch_inverse<double>(x, n, s, stride, w, c, resident, stream);
}

extern "C" long long hf_gj_smem_bytes(int s, int w, int c, int resident,
                                      int itemsize) {
  if (c < 1) return -1;
  return (long long)(hf_gj_smem_elems(s, w, c, resident != 0) * itemsize);
}
