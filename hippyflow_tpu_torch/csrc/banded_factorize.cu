// K1: batched inverse block-Thomas factorization of (N, nb, s, 3s) bands.
//
// Replaces the Pallas kernel `banded_factorize_batch` (body
// `_factorize_kernel_factory`, in-kernel inverse `_gj_invert_ref`) of
// hippyflow_tpu/ops/pallas_kernels.py.  Per block row j of each sample:
//
//     M_j    = A_j Dinv_{j-1}                       (M_0 = 0)
//     Dinv_j = (D_j - M_j B_{j-1})^{-1}             (Gauss-Jordan, no pivoting)
//
// with A_j, D_j, B_j the sub-, main and super-diagonal blocks of the band.
// No pivoting relies on the bc-symmetrized, diagonally dominant blocks of
// the assembled P1 operators (the same contract as the TPU kernel).
//
// What bounds it on the card: the recurrence is a chain of nb dependent
// steps per sample, and each step is two s^3 products plus an s-step
// Gauss-Jordan whose pivot steps are separated by block-wide barriers.
// Device memory traffic is small (one read of the band, one write of M and
// Dinv).  Two designs, which the wrapper picks by shape:
//
// * One-block chain (s whose tiles fit, s=65): the whole chain of one
//   sample runs inside one thread block, so both carries (Dinv_{j-1} and
//   B_{j-1}) stay in shared memory and the batch of samples fills the SMs.
//   Shared memory holds five s x s tiles: 85 KB at s=65 in float32 and
//   169 KB in float64.  The pivot loop is a runtime loop: nothing is
//   unrolled in s.
// * Row panels (larger s; s=193 needs 746 KB for the five tiles): one
//   launch pair per block row j over all samples.  `schur_rows_kernel`
//   runs on a grid of sample x 16-row panel and writes M_j and
//   T_j = D_j - M_j B_{j-1} of its panel, reading Dinv_{j-1} and B_{j-1}
//   from device memory (L2), where the previous row just wrote them; the
//   Gauss-Jordan kernel of K3 (csrc/batched_inverse.cu) then inverts
//   Dinv[:, j] in place.  2 nb launches per factorization, and
//   N ceil(s/16) blocks per Schur step instead of N.  Products are plain
//   IEEE multiply-adds in the working type (no TF32).  Measured faster than
//   the chain at s=65 too (9.7 against 11.7 ms at N=256, float32); the
//   wrapper keeps the chain there until a benchmark lane confirms the
//   switch end to end.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// In-place Gauss-Jordan on the augmented (s, 2s) tile [T | I] in shared
// memory; on return the right half holds T^{-1}.  One rank-1 update per
// pivot.  Before pivot k, the left columns < k are unit vectors and the
// right columns > s + k are still unit vectors, so only the s + 1 columns
// [k, s + k] change.  `row` (s + 1) and `col` (s) are shared scratch.
template <typename T>
__device__ void gj_invert_inplace(T* aug, T* row, T* col, int s) {
  const int w = 2 * s;
  const int live = s + 1;
  for (int k = 0; k < s; ++k) {
    const T piv = aug[k * w + k];
    for (int c = threadIdx.x; c < live; c += blockDim.x) {
      row[c] = aug[k * w + k + c] / piv;
    }
    for (int i = threadIdx.x; i < s; i += blockDim.x) {
      col[i] = (i == k) ? T(0) : aug[i * w + k];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < s * live; e += blockDim.x) {
      const int i = e / live;
      const int c = e - i * live;
      T* a = aug + i * w + k + c;
      *a = (i == k) ? row[c] : *a - col[i] * row[c];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void banded_factorize_kernel(const T* __restrict__ band,
                                        T* __restrict__ m_out,
                                        T* __restrict__ dinv_out, int nb,
                                        int s) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ss = s * s;
  const int w = 2 * s;
  T* dprev = smem;     // Dinv_{j-1}
  T* bprev = dprev + ss;  // B_{j-1}
  T* mj = bprev + ss;  // M_j
  T* aug = mj + ss;    // (s, 2s) augmented tile
  T* row = aug + 2 * ss;
  T* col = row + s + 1;

  const size_t n = blockIdx.x;
  const T* band_n = band + n * nb * ss * 3;
  T* m_n = m_out + n * nb * ss;
  T* d_n = dinv_out + n * nb * ss;

  // Shared memory starts as garbage, which may decode as NaN, and
  // 0 * NaN = NaN: zero both carries so row 0 gives M_0 = 0 and T_0 = D_0.
  for (int e = threadIdx.x; e < ss; e += blockDim.x) {
    dprev[e] = T(0);
    bprev[e] = T(0);
  }
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const T* bj = band_n + (size_t)j * ss * 3;  // (s, 3s): [A_j | D_j | B_j]
    for (int e = threadIdx.x; e < ss; e += blockDim.x) {
      const int i = e / s, c = e - (e / s) * s;
      aug[i * w + c] = bj[i * 3 * s + c];  // stage A_j
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ss; e += blockDim.x) {
      const int i = e / s, c = e - (e / s) * s;
      T acc = T(0);
      for (int l = 0; l < s; ++l) acc += aug[i * w + l] * dprev[l * s + c];
      mj[e] = acc;
      m_n[(size_t)j * ss + e] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ss; e += blockDim.x) {
      const int i = e / s, c = e - (e / s) * s;
      T acc = T(0);
      for (int l = 0; l < s; ++l) acc += mj[i * s + l] * bprev[l * s + c];
      aug[i * w + c] = bj[i * 3 * s + s + c] - acc;
      aug[i * w + s + c] = (i == c) ? T(1) : T(0);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ss; e += blockDim.x) {
      const int i = e / s, c = e - (e / s) * s;
      bprev[e] = bj[i * 3 * s + 2 * s + c];  // carry B_j to row j + 1
    }
    gj_invert_inplace(aug, row, col, s);
    for (int e = threadIdx.x; e < ss; e += blockDim.x) {
      const int i = e / s, c = e - (e / s) * s;
      const T v = aug[i * w + s + c];
      dprev[e] = v;
      d_n[(size_t)j * ss + e] = v;
    }
    __syncthreads();
  }
}

// Row panel [r0, r0 + 16) of one sample's row j: M_j = A_j Dinv_{j-1} into
// m_out and T_j = D_j - M_j B_{j-1} into dinv_out[:, j] (inverted next by
// K3).  The A_j and M_j panels are kept transposed in shared memory,
// (s, 16), so that the 16 rows a thread accumulates are contiguous; each
// thread owns one output column c and reads Dinv_{j-1}[:, c] and
// B_{j-1}[:, c] straight from device memory, coalesced across the warp.
template <typename T>
__global__ void __launch_bounds__(HF_SCHUR_THREADS)
    schur_rows_kernel(const T* __restrict__ band, T* __restrict__ m_out,
                      T* dinv_out, int nb, int s, int j) {
  extern __shared__ unsigned char smem_raw[];
  T* at = reinterpret_cast<T*>(smem_raw);  // (s, 16): A_j panel transposed
  T* mt = at + (size_t)s * HF_SCHUR_PANEL;  // (s, 16): M_j panel transposed
  const int r0 = blockIdx.y * HF_SCHUR_PANEL;
  const int rows = min(HF_SCHUR_PANEL, s - r0);
  const size_t ss = (size_t)s * s;
  const size_t row = (size_t)blockIdx.x * nb + j;
  const int w3 = 3 * s;
  const T* bj = band + row * ss * 3 + (size_t)r0 * w3;  // rows r0.. of [A|D|B]
  T* mj = m_out + row * ss + (size_t)r0 * s;
  T* tj = dinv_out + row * ss + (size_t)r0 * s;
  if (j == 0) {
    for (int e = threadIdx.x; e < rows * s; e += blockDim.x) {
      const int r = e / s, c = e - (e / s) * s;
      mj[e] = T(0);
      tj[e] = bj[(size_t)r * w3 + s + c];
    }
    return;
  }
  const T* dprev = dinv_out + (row - 1) * ss;
  const T* bprev = band + (row - 1) * ss * 3 + 2 * s;  // row stride 3s
  for (int e = threadIdx.x; e < HF_SCHUR_PANEL * s; e += blockDim.x) {
    const int r = e / s, l = e - (e / s) * s;
    if (r < rows) {
      __pipeline_memcpy_async(at + l * HF_SCHUR_PANEL + r,
                              bj + (size_t)r * w3 + l, sizeof(T));
    } else {
      at[l * HF_SCHUR_PANEL + r] = T(0);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int c = threadIdx.x; c < s; c += blockDim.x) {
    T acc[HF_SCHUR_PANEL];
#pragma unroll
    for (int r = 0; r < HF_SCHUR_PANEL; ++r) acc[r] = T(0);
    for (int l = 0; l < s; ++l) {
      const T d = dprev[(size_t)l * s + c];
#pragma unroll
      for (int r = 0; r < HF_SCHUR_PANEL; ++r) {
        acc[r] += at[l * HF_SCHUR_PANEL + r] * d;
      }
    }
#pragma unroll
    for (int r = 0; r < HF_SCHUR_PANEL; ++r) {
      mt[c * HF_SCHUR_PANEL + r] = acc[r];
      if (r < rows) mj[(size_t)r * s + c] = acc[r];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < s; c += blockDim.x) {
    T acc[HF_SCHUR_PANEL];
#pragma unroll
    for (int r = 0; r < HF_SCHUR_PANEL; ++r) acc[r] = T(0);
    for (int l = 0; l < s; ++l) {
      const T b = bprev[(size_t)l * w3 + c];
#pragma unroll
      for (int r = 0; r < HF_SCHUR_PANEL; ++r) {
        acc[r] += mt[l * HF_SCHUR_PANEL + r] * b;
      }
    }
#pragma unroll
    for (int r = 0; r < HF_SCHUR_PANEL; ++r) {
      if (r < rows) tj[(size_t)r * s + c] = bj[(size_t)r * w3 + s + c] - acc[r];
    }
  }
}

template <typename T>
int launch_factorize(const void* band, void* m_out, void* dinv_out, int n,
                     int nb, int s, void* stream) {
  const size_t smem = hf_factorize_smem_elems(s) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_factorize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_factorize_kernel<T><<<n, HF_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(band), static_cast<T*>(m_out),
      static_cast<T*>(dinv_out), nb, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factorize_rows(const void* band, void* m_out, void* dinv_out,
                          int n, int nb, int s, int w, void* stream,
                          int (*invert)(void*, int, int, long long, int,
                                        void*)) {
  const size_t smem = hf_schur_smem_elems(s) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      schur_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, (s + HF_SCHUR_PANEL - 1) / HF_SCHUR_PANEL);
  const long long ss = (long long)s * s;
  T* dinv = static_cast<T*>(dinv_out);
  for (int j = 0; j < nb; ++j) {
    schur_rows_kernel<T><<<grid, HF_SCHUR_THREADS, smem,
                           (cudaStream_t)stream>>>(
        static_cast<const T*>(band), static_cast<T*>(m_out), dinv, nb, s, j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int code = invert(dinv + j * ss, n, s, nb * ss, w, stream);
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

extern "C" int hf_banded_factorize_f32(const void* band, void* m_out,
                                       void* dinv_out, int n, int nb, int s,
                                       void* stream) {
  return launch_factorize<float>(band, m_out, dinv_out, n, nb, s, stream);
}

extern "C" int hf_banded_factorize_f64(const void* band, void* m_out,
                                       void* dinv_out, int n, int nb, int s,
                                       void* stream) {
  return launch_factorize<double>(band, m_out, dinv_out, n, nb, s, stream);
}

extern "C" int hf_banded_factorize_rows_f32(const void* band, void* m_out,
                                            void* dinv_out, int n, int nb,
                                            int s, int w, void* stream) {
  return launch_factorize_rows<float>(band, m_out, dinv_out, n, nb, s, w,
                                      stream, hf_batched_inverse_f32);
}

extern "C" int hf_banded_factorize_rows_f64(const void* band, void* m_out,
                                            void* dinv_out, int n, int nb,
                                            int s, int w, void* stream) {
  return launch_factorize_rows<double>(band, m_out, dinv_out, n, nb, s, w,
                                       stream, hf_batched_inverse_f64);
}

extern "C" long long hf_factorize_smem_bytes(int s, int itemsize) {
  return (long long)(hf_factorize_smem_elems(s) * itemsize);
}

extern "C" long long hf_schur_smem_bytes(int s, int itemsize) {
  return (long long)(hf_schur_smem_elems(s) * itemsize);
}
