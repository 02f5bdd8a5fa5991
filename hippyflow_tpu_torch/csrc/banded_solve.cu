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
// * panels (k >= 8, the Jacobian's k=100 solves): each product streams its
//   factor block through shared memory in panels of 64 rows of op(H),
//   stored transposed so that the 8 rows a thread accumulates are
//   contiguous (16-byte loads), filled by asynchronous copies; each warp
//   owns 8 rows and each lane one column of the tile, so a carry element
//   read from shared memory feeds 8 multiply-adds.  Shared memory holds
//   one panel, the carry and its partner: 99 KB in float32 and 198 KB in
//   float64 at s=193, kt=32.
// * streamed (k < 8, the Newton solves): one output element per thread,
//   the factor blocks read where they lie (L1/L2); shared memory holds
//   only the carry and its partner.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// One sweep step on a column tile: out = op(G) (in - op(H) carry), or
// out = in - op(H) carry when G is null, with op(X) = X^T when the flag is
// set.  H is null on the sweep's first row.  `in` and `out` point at row j
// of the (s, k) rhs block at the tile's first column and may alias.  The
// result is also the new carry; `carry` and `tmp` swap roles when there
// is no G.  H and G are read where they lie.
template <typename T>
__device__ void sweep_step(const T* __restrict__ H, bool trans_h,
                           const T* __restrict__ G, bool trans_g, const T* in,
                           T* out, int s, int k, int kw, T*& carry, T*& tmp) {
  const int n_el = s * kw;
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int i = e / kw, c = e - (e / kw) * kw;
    T acc = in[(size_t)i * k + c];
    if (H != nullptr) {
      if (trans_h) {
        for (int l = 0; l < s; ++l) acc -= H[l * s + i] * carry[l * kw + c];
      } else {
        for (int l = 0; l < s; ++l) acc -= H[i * s + l] * carry[l * kw + c];
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
      for (int l = 0; l < s; ++l) acc += G[l * s + i] * tmp[l * kw + c];
    } else {
      for (int l = 0; l < s; ++l) acc += G[i * s + l] * tmp[l * kw + c];
    }
    carry[e] = acc;
    out[(size_t)i * k + c] = acc;
  }
  __syncthreads();
}

// Rows of op(A) per panel: 8 warps of HF_THREADS, 8 rows each.
constexpr int kPanelRows = HF_SOLVE_PANEL_ROWS;
constexpr int kRowsPerWarp = kPanelRows / (HF_THREADS / 32);

// y = op(A) x, or y = in - op(A) x when `in` is given, on one (s, kw)
// column tile: x and y (s, kw) in shared memory, `in` and `y_out` (may be
// null) rows of stride k in device memory.  op(A) passes through `panel`
// (s, 64) in shared memory, panel[l * 64 + r] = op(A)[i0 + r, l].
template <typename T>
__device__ void panel_product(const T* __restrict__ A, bool trans,
                              const T* x, const T* in, T* y, T* y_out, int s,
                              int k, int kw, T* panel) {
  const int c = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;
  for (int i0 = 0; i0 < s; i0 += kPanelRows) {
    const int pr = min(kPanelRows, s - i0);
    __syncthreads();  // the previous panel is consumed, x is complete
    // op(A)[i0 + r, l] is A[l, i0 + r] (a coalesced row of A) or
    // A[i0 + r, l] (a strided column, whose lines the next l reuse in L1);
    // asynchronous copies, so that a thread's loads are all in flight
    for (int e = threadIdx.x; e < s * kPanelRows; e += blockDim.x) {
      const int l = e / kPanelRows, r = e - (e / kPanelRows) * kPanelRows;
      const size_t src = trans ? (size_t)l * s + i0 + r : (size_t)(i0 + r) * s + l;
      if (r < pr) {
        __pipeline_memcpy_async(panel + e, A + src, sizeof(T));
      } else {
        panel[e] = T(0);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (c < kw) {
      T acc[kRowsPerWarp];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = T(0);
#pragma unroll 4
      for (int l = 0; l < s; ++l) {
        const T xv = x[l * kw + c];
        T a[kRowsPerWarp];
        hf_load16(panel + l * kPanelRows + r0, a);
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) acc[q] += a[q] * xv;
      }
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int i = i0 + r0 + q;
        if (r0 + q < pr) {
          const T v = in != nullptr ? in[(size_t)i * k + c] - acc[q] : acc[q];
          y[i * kw + c] = v;
          if (y_out != nullptr) y_out[(size_t)i * k + c] = v;
        }
      }
    }
  }
  __syncthreads();
}

// The sweep step of `sweep_step` with both products through panels.
template <typename T>
__device__ void panel_step(const T* __restrict__ H, bool trans_h,
                           const T* __restrict__ G, bool trans_g, const T* in,
                           T* out, int s, int k, int kw, T* panel, T*& carry,
                           T*& tmp) {
  T* first_out = G == nullptr ? out : nullptr;
  if (H != nullptr) {
    panel_product(H, trans_h, carry, in, tmp, first_out, s, k, kw, panel);
  } else {
    for (int e = threadIdx.x; e < s * kw; e += blockDim.x) {
      const int i = e / kw, c = e - (e / kw) * kw;
      tmp[e] = in[(size_t)i * k + c];
      if (first_out != nullptr) first_out[(size_t)i * k + c] = tmp[e];
    }
    __syncthreads();
  }
  if (G == nullptr) {
    T* t = carry;
    carry = tmp;
    tmp = t;
    return;
  }
  panel_product(G, trans_g, tmp, static_cast<const T*>(nullptr), carry, out, s,
                k, kw, panel);
}

template <typename T, bool kPanels>
__device__ __forceinline__ void step(const T* H, bool trans_h, const T* G,
                                     bool trans_g, const T* in, T* out, int s,
                                     int k, int kw, T* panel, T*& carry,
                                     T*& tmp) {
  if (kPanels) {
    panel_step<T>(H, trans_h, G, trans_g, in, out, s, k, kw, panel, carry,
                  tmp);
  } else {
    sweep_step<T>(H, trans_h, G, trans_g, in, out, s, k, kw, carry, tmp);
  }
}

template <typename T, bool kPanels>
__global__ void banded_solve_kernel(const T* __restrict__ m,
                                    const T* __restrict__ dinv,
                                    const T* __restrict__ b,
                                    const T* __restrict__ rhs,
                                    T* __restrict__ out, int nb, int s, int k,
                                    int kt, bool trans) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ss = s * s;
  const int c0 = blockIdx.y * kt;
  const int kw = min(kt, k - c0);
  // [panel (panels only) | carry | tmp]
  T* panel = smem;
  T* carry = smem + hf_solve_panel_elems(s, kPanels);
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
      step<T, kPanels>(H, false, nullptr, false, rhs_n + j * rb,
                       out_n + j * rb, s, k, kw, panel, carry, tmp);
    }
    for (int j = nb - 1; j >= 0; --j) {  // bwd, in place
      const T* H = j < nb - 1 ? b_n + (size_t)j * ss : nullptr;
      step<T, kPanels>(H, false, d_n + (size_t)j * ss, false, out_n + j * rb,
                       out_n + j * rb, s, k, kw, panel, carry, tmp);
    }
  } else {
    for (int j = 0; j < nb; ++j) {  // fwd_t
      const T* H = j > 0 ? b_n + (size_t)(j - 1) * ss : nullptr;
      step<T, kPanels>(H, true, d_n + (size_t)j * ss, true, rhs_n + j * rb,
                       out_n + j * rb, s, k, kw, panel, carry, tmp);
    }
    for (int j = nb - 1; j >= 0; --j) {  // bwd_t, in place
      const T* H = j < nb - 1 ? m_n + (size_t)(j + 1) * ss : nullptr;
      step<T, kPanels>(H, true, nullptr, false, out_n + j * rb,
                       out_n + j * rb, s, k, kw, panel, carry, tmp);
    }
  }
}

template <typename T, bool kPanels>
int launch_solve(const void* m, const void* dinv, const void* b,
                 const void* rhs, void* out, int n, int nb, int s, int k,
                 int kt, int trans, void* stream) {
  const size_t smem = hf_solve_smem_elems(s, kt, kPanels) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_solve_kernel<T, kPanels>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, (k + kt - 1) / kt);
  banded_solve_kernel<T, kPanels>
      <<<grid, HF_THREADS, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(m), static_cast<const T*>(dinv),
          static_cast<const T*>(b), static_cast<const T*>(rhs),
          static_cast<T*>(out), nb, s, k, kt, trans != 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const void* m, const void* dinv, const void* b,
                 const void* rhs, void* out, int n, int nb, int s, int k,
                 int kt, int trans, int panels, void* stream) {
  return panels ? launch_solve<T, true>(m, dinv, b, rhs, out, n, nb, s, k, kt,
                                        trans, stream)
                : launch_solve<T, false>(m, dinv, b, rhs, out, n, nb, s, k,
                                         kt, trans, stream);
}

}  // namespace

extern "C" int hf_banded_solve_f32(const void* m, const void* dinv,
                                   const void* b, const void* rhs, void* out,
                                   int n, int nb, int s, int k, int kt,
                                   int trans, int panels, void* stream) {
  return launch_solve<float>(m, dinv, b, rhs, out, n, nb, s, k, kt, trans,
                             panels, stream);
}

extern "C" int hf_banded_solve_f64(const void* m, const void* dinv,
                                   const void* b, const void* rhs, void* out,
                                   int n, int nb, int s, int k, int kt,
                                   int trans, int panels, void* stream) {
  return launch_solve<double>(m, dinv, b, rhs, out, n, nb, s, k, kt, trans,
                              panels, stream);
}

extern "C" long long hf_solve_smem_bytes(int s, int kt, int panels,
                                         int itemsize) {
  return (long long)(hf_solve_smem_elems(s, kt, panels != 0) * itemsize);
}

extern "C" const char* hf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
