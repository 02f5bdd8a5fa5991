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
// sequential, each one pass over the s x s matrix in L2, and a step costs
// its latencies: the pass itself, which one SM runs far below its
// arithmetic and L2 rates, and a fixed part (staging the pivot columns,
// the w dependent pivot steps, the barriers).  With one thread block per matrix, 16
// matrices of s=516 keep 16 of the 132 SMs busy.  The design:
//
// * A cluster of c thread blocks per matrix (grid N c, cluster (c, 1, 1),
//   1 <= c <= 8, picked by the host: `gj_cluster` in ops/hopper_kernels.py)
//   splits its columns: rank r owns a run of whole 32-column chunks, so
//   that loads stay coalesced, and writes only those.  Each step: (a) a
//   cluster barrier, whose release/acquire orders the previous step's L2
//   writes; (b) every block stages the pivot columns C = X[:, p] (with P
//   in them) and its own slice of the pivot rows R in shared memory; (c) a
//   cluster barrier, after which the blocks that own the pivot columns may
//   overwrite them; (d) each block forms its slice of P^{-1} R and applies
//   the rank-w update to its own columns.  A block needs nothing of
//   another but C and P, through L2: no distributed shared memory.  Matrix
//   reads bypass L1 (ld.cg).  Every c, 1 included, is one cluster
//   launch with the same barriers.
// * P^{-1} in one warp: lane l < 2w holds column l of [P | I] in
//   registers, and pivot step k takes the pivot and the column-k
//   multipliers from lane k by warp shuffles, so the w pivot steps need no
//   block barrier.  Every block of the cluster forms P^{-1} itself.
// * In the update each thread owns 4 columns (2 in float64), 32 apart: it
//   keeps their slices of P^{-1} R in registers and reads each row's pivot
//   columns once, as 16-byte shared-memory broadcasts, for all of them,
//   with four rows in flight.
//
// The matrix lives in the output buffer (in L2: 96 float64 matrices of
// 193 x 193 are 29 MB of the 50 MB L2), so the same code takes any s and
// both dtypes.  Plain IEEE arithmetic in the working type (no tensor
// cores: a float32 mma would be TF32); the pivot row is scaled by the
// pivot's rounded reciprocal, where the plain version divides.  `stride`
// (elements between consecutive matrices) lets K1's row-panel design
// invert Dinv[:, j] of a (N, nb, s, s) factor in place.
#include <cooperative_groups.h>
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

template <typename T>
__global__ void __launch_bounds__(HF_GJ_THREADS)
    gj_inverse_kernel(T* x, int s, long long stride, int w) {
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

template <typename T>
int launch_inverse(void* x, int n, int s, long long stride, int w, int c,
                   void* stream) {
  if (w < 1 || w > HF_GJ_MAX_W || c < 1 || c > HF_GJ_MAX_CLUSTER) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = hf_gj_smem_elems(s, w, c) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
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
  err = cudaLaunchKernelEx(&cfg, gj_inverse_kernel<T>, static_cast<T*>(x), s,
                           stride, w);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" int hf_batched_inverse_f32(void* x, int n, int s, long long stride,
                                      int w, int c, void* stream) {
  return launch_inverse<float>(x, n, s, stride, w, c, stream);
}

extern "C" int hf_batched_inverse_f64(void* x, int n, int s, long long stride,
                                      int w, int c, void* stream) {
  return launch_inverse<double>(x, n, s, stride, w, c, stream);
}

extern "C" long long hf_gj_smem_bytes(int s, int w, int c, int itemsize) {
  if (c < 1) return -1;
  return (long long)(hf_gj_smem_elems(s, w, c) * itemsize);
}
