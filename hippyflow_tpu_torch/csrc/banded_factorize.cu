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
// Dinv).  The simple design runs the whole chain of one sample inside one
// thread block, so both carries (Dinv_{j-1} and B_{j-1}) stay in shared
// memory and the batch of samples fills the SMs.  Shared memory holds five
// s x s tiles: 85 KB at s=65 in float32 and 169 KB in float64.  The pivot
// loop is a runtime loop: nothing is unrolled in s.
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
