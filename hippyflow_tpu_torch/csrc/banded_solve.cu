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
// What bounds it on the card: the bytes of factor streamed per column tile
// (two s x s blocks per block row and sweep step) against the 2 s^2 kt
// multiply-adds they feed.  Unlike on the TPU, the rhs columns are
// independent, so the grid runs over (sample, column tile): each block owns
// kt columns of one sample and keeps its (s, kt) carry in shared memory.
// Factor blocks are staged in shared memory once per step and stay in L2
// for the sibling column tiles of the same sample.  Both sweeps run in one
// launch: the first writes its result to the output, the second reads it
// back row by row and overwrites it in place.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// One sweep step on a column tile: out = op(G) (in - op(H) carry), or
// out = in - op(H) carry when G is null, with op(X) = X^T when the flag is
// set.  H is null on the sweep's first row.  `in` and `out` point at row j
// of the (s, k) rhs block at the tile's first column and may alias.  The
// result is also the new carry; `carry` and `tmp` swap roles when there
// is no G.
template <typename T>
__device__ void sweep_step(const T* __restrict__ H, bool trans_h,
                           const T* __restrict__ G, bool trans_g, const T* in,
                           T* out, int s, int k, int kw, T* hs, T* gs,
                           T*& carry, T*& tmp) {
  const int ss = s * s;
  if (H != nullptr) {
    for (int e = threadIdx.x; e < ss; e += blockDim.x) hs[e] = H[e];
  }
  if (G != nullptr) {
    for (int e = threadIdx.x; e < ss; e += blockDim.x) gs[e] = G[e];
  }
  __syncthreads();
  const int n_el = s * kw;
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int i = e / kw, c = e - (e / kw) * kw;
    T acc = in[(size_t)i * k + c];
    if (H != nullptr) {
      if (trans_h) {
        for (int l = 0; l < s; ++l) acc -= hs[l * s + i] * carry[l * kw + c];
      } else {
        for (int l = 0; l < s; ++l) acc -= hs[i * s + l] * carry[l * kw + c];
      }
    }
    tmp[e] = acc;
    if (G == nullptr) out[(size_t)i * k + c] = acc;
  }
  __syncthreads();
  if (G == nullptr) {
    T* t = carry;
    carry = tmp;
    tmp = t;
    return;
  }
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int i = e / kw, c = e - (e / kw) * kw;
    T acc = T(0);
    if (trans_g) {
      for (int l = 0; l < s; ++l) acc += gs[l * s + i] * tmp[l * kw + c];
    } else {
      for (int l = 0; l < s; ++l) acc += gs[i * s + l] * tmp[l * kw + c];
    }
    carry[e] = acc;
    out[(size_t)i * k + c] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void banded_solve_kernel(const T* __restrict__ m,
                                    const T* __restrict__ dinv,
                                    const T* __restrict__ b,
                                    const T* __restrict__ rhs,
                                    T* __restrict__ out, int nb, int s, int k,
                                    int kt, bool trans) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ss = s * s;
  const int c0 = blockIdx.y * kt;
  const int kw = min(kt, k - c0);
  T* hs = smem;
  T* gs = hs + ss;
  T* carry = gs + ss;
  T* tmp = carry + s * kt;

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
      sweep_step<T>(H, false, nullptr, false, rhs_n + j * rb, out_n + j * rb,
                    s, k, kw, hs, gs, carry, tmp);
    }
    for (int j = nb - 1; j >= 0; --j) {  // bwd, in place
      const T* H = j < nb - 1 ? b_n + (size_t)j * ss : nullptr;
      sweep_step<T>(H, false, d_n + (size_t)j * ss, false, out_n + j * rb,
                    out_n + j * rb, s, k, kw, hs, gs, carry, tmp);
    }
  } else {
    for (int j = 0; j < nb; ++j) {  // fwd_t
      const T* H = j > 0 ? b_n + (size_t)(j - 1) * ss : nullptr;
      sweep_step<T>(H, true, d_n + (size_t)j * ss, true, rhs_n + j * rb,
                    out_n + j * rb, s, k, kw, hs, gs, carry, tmp);
    }
    for (int j = nb - 1; j >= 0; --j) {  // bwd_t, in place
      const T* H = j < nb - 1 ? m_n + (size_t)(j + 1) * ss : nullptr;
      sweep_step<T>(H, true, nullptr, false, out_n + j * rb, out_n + j * rb,
                    s, k, kw, hs, gs, carry, tmp);
    }
  }
}

template <typename T>
int launch_solve(const void* m, const void* dinv, const void* b,
                 const void* rhs, void* out, int n, int nb, int s, int k,
                 int kt, int trans, void* stream) {
  const size_t smem = hf_solve_smem_elems(s, kt) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, (k + kt - 1) / kt);
  banded_solve_kernel<T><<<grid, HF_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(m), static_cast<const T*>(dinv),
      static_cast<const T*>(b), static_cast<const T*>(rhs),
      static_cast<T*>(out), nb, s, k, kt, trans != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hf_banded_solve_f32(const void* m, const void* dinv,
                                   const void* b, const void* rhs, void* out,
                                   int n, int nb, int s, int k, int kt,
                                   int trans, void* stream) {
  return launch_solve<float>(m, dinv, b, rhs, out, n, nb, s, k, kt, trans,
                             stream);
}

extern "C" int hf_banded_solve_f64(const void* m, const void* dinv,
                                   const void* b, const void* rhs, void* out,
                                   int n, int nb, int s, int k, int kt,
                                   int trans, void* stream) {
  return launch_solve<double>(m, dinv, b, rhs, out, n, nb, s, k, kt, trans,
                              stream);
}

extern "C" long long hf_factorize_smem_bytes(int s, int itemsize) {
  return (long long)(hf_factorize_smem_elems(s) * itemsize);
}

extern "C" long long hf_solve_smem_bytes(int s, int kt, int itemsize) {
  return (long long)(hf_solve_smem_elems(s, kt) * itemsize);
}

extern "C" const char* hf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
