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
// and after the last step X holds its inverse.  P^{-1} itself comes from w
// rank-1 Gauss-Jordan steps on the small [P | I] tile, as in the TPU
// kernel.  No pivoting relies on diagonally dominant or SPD inputs (the
// diagonal blocks of the prior's K and M and of the bc-symmetrized Newton
// operator), the same contract as the TPU kernels.
//
// What bounds it on the card: each block step is one pass over the s x s
// matrix (read and write) with w multiply-adds per element, so s / w
// passes in all; the work of one matrix is sequential in its passes and
// the batch gives the parallelism, so a pass costs its latencies more than
// its arithmetic.  The design: one thread block per matrix; the matrix
// lives in the output buffer, which stays in L2 (96 float64 matrices of
// 193 x 193 are 29 MB of the 50 MB L2), so the same code takes any s and
// both dtypes; only the w pivot rows and columns are staged in shared
// memory.  (Keeping the whole matrix in shared memory where it fits was
// measured 9% faster at s=193 in float32 and slower at s=65 in float64,
// too little for a second design.)  In the pass each thread owns one
// column j: it keeps P^{-1} R[:, j] in registers and reads each row's
// pivot columns as 16-byte shared-memory broadcasts, four rows in flight
// at a time.  `stride` (elements between consecutive matrices) lets K1's
// row-panel design invert Dinv[:, j] of a (N, nb, s, s) factor in place.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRowUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(HF_GJ_THREADS)
    gj_inverse_kernel(T* x, int s, long long stride, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // (s, 16) pivot columns
  T* rs = cs + (size_t)s * HF_GJ_MAX_W;    // (w, s) pivot rows as read
  T* rn = rs + (size_t)w * s;              // (w, s) pivot rows after the step
  T* ga = rn + (size_t)w * s;              // (w, 2w) ping-pong tiles of the
  T* gb = ga + 2 * w * w;                  // pivot block's [P | I]
  T* a = x + (size_t)blockIdx.x * stride;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int nchunk = (s + 31) >> 5;

  for (int kb = 0; kb < s; kb += w) {
    const int wp = min(w, s - kb);
    const int w2 = 2 * wp;
    for (int e = tid; e < wp * s; e += nth) rs[e] = a[(size_t)kb * s + e];
    for (int e = tid; e < s * wp; e += nth) {
      const int i = e / wp, l = e - (e / wp) * wp;
      cs[i * HF_GJ_MAX_W + l] = a[(size_t)i * s + kb + l];
    }
    for (int e = tid; e < wp * w2; e += nth) {
      const int r = e / w2, c = e - (e / w2) * w2;
      ga[e] = c < wp ? a[(size_t)(kb + r) * s + kb + c]
                     : (c - wp == r ? T(1) : T(0));
    }
    __syncthreads();

    // P^{-1}: wp rank-1 steps on [P | I], reading one tile and writing the
    // other so that a step needs a single barrier.
    T* src = ga;
    T* dst = gb;
    for (int k = 0; k < wp; ++k) {
      const T piv = src[k * w2 + k];
      for (int e = tid; e < wp * w2; e += nth) {
        const int r = e / w2, c = e - (e / w2) * w2;
        const T rk = src[k * w2 + c] / piv;
        dst[e] = r == k ? rk : src[e] - src[r * w2 + k] * rk;
      }
      __syncthreads();
      T* t = src;
      src = dst;
      dst = t;
    }

    // New pivot rows: P^{-1} R off the block, P^{-1} on it.
    for (int e = tid; e < wp * s; e += nth) {
      const int r = e / s, j = e - (e / s) * s;
      T v;
      if (j >= kb && j < kb + wp) {
        v = src[r * w2 + wp + (j - kb)];
      } else {
        v = T(0);
        for (int m = 0; m < wp; ++m) v += src[r * w2 + wp + m] * rs[m * s + j];
      }
      rn[e] = v;
    }
    __syncthreads();

    // Rank-wp update of the other rows: X[i, j] <- X[i, j] - C[i] rn[:, j],
    // with X[i, p] read as 0.  Warp items are (32-column chunk, row group).
    for (int item = warp; item < nchunk * nwarps; item += nwarps) {
      const int j = (item % nchunk) * 32 + lane;
      const int g = item / nchunk;
      if (j >= s) continue;
      T r[HF_GJ_MAX_W];
#pragma unroll
      for (int l = 0; l < HF_GJ_MAX_W; ++l) r[l] = l < wp ? rn[l * s + j] : T(0);
      const bool jpiv = j >= kb && j < kb + wp;
      for (int i0 = g; i0 < s; i0 += nwarps * kRowUnroll) {
        T v[kRowUnroll];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int i = i0 + u * nwarps;
          v[u] = (i < s && !jpiv) ? a[(size_t)i * s + j] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int i = i0 + u * nwarps;
          if (i < s) {
            if (i >= kb && i < kb + wp) {
              a[(size_t)i * s + j] = rn[(i - kb) * s + j];
            } else {
              T cv[HF_GJ_MAX_W];
              hf_load16(cs + i * HF_GJ_MAX_W, cv);
              T d = T(0);
#pragma unroll
              for (int l = 0; l < HF_GJ_MAX_W; ++l) {
                if (l < wp) d += cv[l] * r[l];
              }
              a[(size_t)i * s + j] = v[u] - d;
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_inverse(void* x, int n, int s, long long stride, int w,
                   void* stream) {
  if (w < 1 || w > HF_GJ_MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem = hf_gj_smem_elems(s, w) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gj_inverse_kernel<T><<<n, HF_GJ_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<T*>(x), s, stride, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hf_batched_inverse_f32(void* x, int n, int s, long long stride,
                                      int w, void* stream) {
  return launch_inverse<float>(x, n, s, stride, w, stream);
}

extern "C" int hf_batched_inverse_f64(void* x, int n, int s, long long stride,
                                      int w, void* stream) {
  return launch_inverse<double>(x, n, s, stride, w, stream);
}

extern "C" long long hf_gj_smem_bytes(int s, int w, int itemsize) {
  return (long long)(hf_gj_smem_elems(s, w) * itemsize);
}
