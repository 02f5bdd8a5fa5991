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
// steps per sample, and each step is two s^3 products plus an s^3
// Gauss-Jordan inverse whose pivot steps depend on one another.  Device
// memory traffic is small (one read of the band, one write of M and
// Dinv), so the time is what one sample's block row costs in latencies:
// a lone warp runs a dependent instruction every few cycles, the 13 pivot
// steps of a pivot block are one warp's dependent chain, and a phase that
// few warps run is bound by its instruction count per warp, not by bytes
// or multiply-adds.  Two designs, which the wrapper picks by shape:
//
// * The chain (s whose tiles fit: s <= 120 in float32, 84 in float64): the
//   whole chain of one sample runs in one launch, in one thread block, so
//   both carries (Dinv_{j-1} and B_{j-1}) stay in shared memory.
//   - Products: each thread accumulates a 4 x 4 tile of outputs in
//     registers.  The left operand (A_j, then M_j) is kept transposed in
//     shared memory, so that per inner index a thread reads its 4 rows and
//     its 4 columns as one 16-byte vector each (two in float64): 2 loads per
//     16 multiply-adds where one output per thread took 2 per 1.  The
//     host pads row strides to an odd number of 16-byte vectors
//     (`chain_ld` in ops/hopper_kernels.py), so that s = 64 or 96 spread
//     over the banks like s = 65.
//   - Inverse: in place in T_j's tile, in 13-wide pivot blocks (the block
//     step of csrc/batched_inverse.cu): the pivot columns are staged
//     (s x 16), one warp inverts the pivot block by shuffles
//     (`pivot_block_inverse`), the new pivot rows P^{-1} R are formed, and
//     in the rank-13 update each thread keeps its columns' slice of
//     P^{-1} R in registers and reads a row's pivot columns as 16-byte
//     broadcasts, with several independent sums interleaved.  The block
//     looks ahead: the update itself stages the next step's pivot
//     columns, and warp 0, instead of rows of the update, forms the next
//     pivot block and inverts it, so the dependent pivot steps run beside
//     the update and a block step has two block barriers where the rank-1
//     kernel took 26.  No identity half: four s x s tiles (Dinv_{j-1},
//     B_{j-1}, M_j, T_j; A_j is staged in T_j's tile, T_j^{-1} becomes the
//     next carry by a pointer swap, the Gauss-Jordan scratch overlays
//     M_j's tile), 70.7 KB at s=65 in float32: three blocks per SM.
//   - The band: A_j (transposed) and B_{j-1} are read at the top of row j
//     by plain coalesced loads, all of a pass in flight before their
//     stores; D_j is read into registers before the second product's loop.
//     Asynchronous 4-byte copies of A_{j+1} and B_j started during row j
//     (rows are not 16-byte aligned: s is odd) were measured and dropped:
//     starting them cost the block more cycles per block row, at every s,
//     than the loads expose at the top of the row.
// * Row panels (larger s; the chain's tiles need 596 KB at s=193): one
//   launch pair per block row j over all samples.  `schur_tile_kernel`
//   runs on a grid of sample x row panel and writes M_j and
//   T_j = D_j - M_j B_{j-1} of its panel; the Gauss-Jordan kernel of K3
//   (csrc/batched_inverse.cu) then inverts Dinv[:, j] in place, with the
//   cluster of c blocks per matrix and the design (L2 or resident) that
//   the host picked.  2 nb launches
//   per factorization.  The Schur step is two panel products whose right
//   operands (Dinv_{j-1}, which the previous row just wrote, and B_{j-1})
//   every panel of the sample reads from L2: 4 N s^3 multiply-adds over
//   N ceil(s/8) blocks of 8-row panels.  Each thread keeps an 8 x 4 tile
//   of outputs in registers over the left operand, transposed in shared
//   memory, and reads the right operands straight from device memory,
//   coalesced, several rows ahead of their use.  Staging them in shared
//   memory instead (a three-stage ring of asynchronous copies, 16 bytes
//   where rows are aligned, with panels of 8, 16 and 32 rows sharing each
//   staged row, lanes laid out 1 x 32, 2 x 16 or 4 x 8) was built on
//   these tiles and measured slower at every lane shape (PERF.md).
//
// Products are plain IEEE multiply-adds in the working type (no TF32); the
// pivot row is scaled by the pivot's rounded reciprocal.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// Outputs per thread of the chain's products: kTile x kTile.
constexpr int kTile = 4;
// Pivot rows of one warp's item in the chain's P^{-1} R, and the groups of
// them in a 13-wide block.
constexpr int kRowGroup = 5;
constexpr int kGroups = (HF_GJ_MAX_W + kRowGroup - 1) / kRowGroup;
// A ragged last chunk of at most this many columns is updated one row per
// thread; a wider one as a 32-column chunk with idle lanes.
constexpr int kRemMax = 8;

// 32-column chunks one thread of the Gauss-Jordan update owns a column of
// (their slices of P^{-1} R stay in registers), and the rows it has in
// flight; fewer in float64, for registers.
template <typename T>
struct ChainCols {
  static constexpr int n = 3;
  static constexpr int rows = 2;
};
template <>
struct ChainCols<double> {
  static constexpr int n = 2;
  static constexpr int rows = 1;
};

template <typename T, int TM>
__device__ __forceinline__ void tile_fma(const T (&a)[TM], const T (&v)[kTile],
                                         T (&acc)[TM][kTile]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[r][q] += a[r] * v[q];
  }
}

template <typename T, int TM>
__device__ __forceinline__ void tile_zero(T (&acc)[TM][kTile]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[r][q] = T(0);
  }
}

// acc[r][q] = sum_l at[l lda + r] b[l ldb + q]: the kTile x kTile outputs
// of rows at.. and columns b.. of (left operand, stored transposed) x
// (right operand); at and b are 16-byte aligned, lda and ldb whole vectors.
// The operands of step l + 1 are loaded before the multiply-adds of step l
// (two register sets in turn), so that a warp does not wait for shared
// memory at every step.
template <typename T>
__device__ __forceinline__ void tile_product(const T* at, int lda, const T* b,
                                             int ldb, int s,
                                             T (&acc)[kTile][kTile]) {
  tile_zero(acc);
  T a0[kTile], v0[kTile], a1[kTile], v1[kTile];
  hf_load16(at, a0);
  hf_load16(b, v0);
#pragma unroll 2
  for (int l = 1; l < s; l += 2) {
    hf_load16(at + l * lda, a1);
    hf_load16(b + l * ldb, v1);
    tile_fma(a0, v0, acc);
    const int l2 = min(l + 1, s - 1);  // read twice where s is even
    hf_load16(at + l2 * lda, a0);
    hf_load16(b + l2 * ldb, v0);
    tile_fma(a1, v1, acc);
  }
  if (s & 1) tile_fma(a0, v0, acc);
}

// One block row of the band (bj: (s, 3s)) into shared memory: its A
// block, transposed, into at, and the previous row's B block into bp (prev
// null: none), both at row stride ld.  Plain coalesced loads, a warp per
// band row, kLoadRows rows of up to 32 kLoadChunks columns in flight
// before their stores.
template <typename T>
__device__ __forceinline__ void load_band_row(T* at, T* bp, int ld,
                                              const T* bj, const T* prev,
                                              int s) {
  constexpr int kLoadRows = 4, kLoadChunks = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int lb = 0; lb < s; lb += 32 * kLoadChunks) {
    for (int i0 = warp; i0 < s; i0 += kLoadRows * nwarps) {
      T a[kLoadRows][kLoadChunks], b[kLoadRows][kLoadChunks];
#pragma unroll
      for (int u = 0; u < kLoadRows; ++u) {
        const int i = min(i0 + u * nwarps, s - 1);
#pragma unroll
        for (int q = 0; q < kLoadChunks; ++q) {
          const int l = lb + 32 * q + lane;
          a[u][q] = l < s ? bj[(size_t)i * 3 * s + l] : T(0);
          b[u][q] = (prev != nullptr && l < s) ? prev[(size_t)i * 3 * s + l]
                                               : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadRows; ++u) {
        const int i = i0 + u * nwarps;
#pragma unroll
        for (int q = 0; q < kLoadChunks; ++q) {
          const int l = lb + 32 * q + lane;
          if (i < s && l < s) at[l * ld + i] = a[u][q];
          if (i < s && prev != nullptr && l < s) bp[i * ld + l] = b[u][q];
        }
      }
    }
  }
}

// The rank-13 update of one run of NQ 32-column chunks (from column jb) in
// the Gauss-Jordan block step at kb:
// X[i, j] <- X[i, j] - C[i] rn[:, j] with X[i, p] read as 0, and
// X[p, j] <- rn[:, j].  Warps w0.. take a row each (R rows in flight),
// lane l the columns l, l + 32, ... of the run; the NQ R sums of a pass
// are independent chains of 13 multiply-adds, interleaved.  What lands in
// the next step's pivot columns [kbn, kbn + wpn) is also written into
// their staging buffer csn (wpn <= 0: none).
template <typename T, int NQ>
__device__ __forceinline__ void gj_update_run(T* x, int ld, int s, int kb,
                                              int wp, int jb, int nmain,
                                              const T* cs, const T* rn, int w0,
                                              T* csn, int kbn, int wpn) {
  constexpr int R = ChainCols<T>::rows;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0;
  const int nw = (blockDim.x >> 5) - w0;
  T r[NQ][HF_GJ_MAX_W];
  bool own[NQ], piv[NQ], nxt[NQ];
  int jcl[NQ];
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    const int j = jb + 32 * c + lane;
    own[c] = j < nmain;
    piv[c] = j >= kb && j < kb + wp;
    nxt[c] = own[c] && j >= kbn && j < kbn + wpn;
    jcl[c] = min(j, nmain - 1);
#pragma unroll
    for (int l = 0; l < HF_GJ_MAX_W; ++l) {
      r[c][l] = rn[l * ld + jcl[c]];
    }
#pragma unroll
    for (int l = 0; l < HF_GJ_MAX_W; ++l) {
      if (l >= wp) r[c][l] = T(0);
    }
  }
  for (int i0 = warp; i0 < s; i0 += R * nw) {
    T cv[R][HF_GJ_ROW], xv[R][NQ], d[R][NQ];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = min(i0 + u * nw, s - 1);
      hf_load16(cs + i * HF_GJ_ROW, cv[u]);
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        xv[u][c] = x[i * ld + jcl[c]];
        d[u][c] = T(0);
      }
    }
#pragma unroll
    for (int l = 0; l < HF_GJ_MAX_W; ++l) {
#pragma unroll
      for (int u = 0; u < R; ++u) {
#pragma unroll
        for (int c = 0; c < NQ; ++c) d[u][c] += cv[u][l] * r[c][l];
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = i0 + u * nw;
      if (i < s && !(i >= kb && i < kb + wp)) {
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          const T v = (piv[c] ? T(0) : xv[u][c]) - d[u][c];
          const int j = jb + 32 * c + lane;
          if (own[c]) x[i * ld + j] = v;
          if (nxt[c]) csn[i * HF_GJ_ROW + j - kbn] = v;
        }
      }
    }
  }
  for (int rr = warp; rr < wp; rr += nw) {
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int j = jb + 32 * c + lane;
      if (own[c]) {
        const T v = rn[rr * ld + j];
        x[(kb + rr) * ld + j] = v;
        if (nxt[c]) csn[(kb + rr) * HF_GJ_ROW + j - kbn] = v;
      }
    }
  }
}

// In-place Gauss-Jordan inverse, without pivoting, of the s x s matrix x
// (rows of stride ld in shared memory).  Per 13-wide block step at kb,
// with the pivot columns staged in cs (s x HF_GJ_ROW, zero past the
// block's width) and P^{-1} in pinv: (c) the new pivot rows, P^{-1} R
// (P^{-1} on the pivot block itself), go into rn; a block barrier; (d) the
// rank-13 update; a block barrier.  The update also writes the next step's
// pivot columns into the other staging buffer, and warp 0 takes no rows of
// it: from the old next pivot block (read before the barrier) it forms the
// updated one in registers and inverts it (`pivot_block_inverse_cols`), so
// the 13 dependent pivot steps of step k + 1 run beside the update of step
// k, and a step has two block barriers.  Before the first step warp 0
// inverts P straight from x while the others stage.
// Loads are started ahead of their uses: addresses are clamped into range
// and the values replaced afterwards, because a load under a branch waits
// for the one before it.
template <typename T>
__device__ __forceinline__ void chain_gj(T* x, int ld, int s, T* cs0, T* pinv,
                                         T* rn) {
  constexpr int Q = ChainCols<T>::n;
  constexpr int kStage = 4;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  // columns updated as 32-column chunks, and the ragged rest
  int nmain = s & ~31;
  if (s - nmain > kRemMax) nmain = s;
  const int nch = (s + 31) >> 5;
  const int ncs = HF_GJ_ROW * s;
  {
    const int wp = min(HF_GJ_MAX_W, s);
    if (warp == 0) {
      pivot_block_inverse(x, ld, wp, pinv);
    } else {
      const int nst = nth - 32;
      for (int e0 = tid - 32; e0 < ncs; e0 += nst * kStage) {
        T v[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int e = e0 + u * nst;
          const int i = min(e / HF_GJ_ROW, s - 1);
          v[u] = x[i * ld + min(e & (HF_GJ_ROW - 1), s - 1)];
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int e = e0 + u * nst;
          if (e < ncs) cs0[e] = (e & (HF_GJ_ROW - 1)) < wp ? v[u] : T(0);
        }
      }
    }
    __syncthreads();
  }
  int buf = 0;
  for (int kb = 0; kb < s; kb += HF_GJ_MAX_W, buf ^= 1) {
    const int wp = min(HF_GJ_MAX_W, s - kb);
    const int kbn = kb + HF_GJ_MAX_W, wpn = min(HF_GJ_MAX_W, s - kbn);
    const T* cs = cs0 + buf * ncs;
    T* csn = cs0 + (buf ^ 1) * ncs;
    const bool ahead = wpn > 0;  // all but the last step
    // the old next pivot block, a column per lane of warp 0, and the
    // zeros past a narrow last block in its staging buffer
    T pnext[HF_GJ_MAX_W];
    const int ln = kbn + min(lane, wpn - 1);
    if (ahead) {
      if (warp == 0) {
#pragma unroll
        for (int r = 0; r < HF_GJ_MAX_W; ++r) {
          pnext[r] = x[(kbn + min(r, wpn - 1)) * ld + ln];
        }
      }
      if (wpn < HF_GJ_MAX_W) {
        for (int e = tid; e < ncs; e += nth) {
          if ((e & (HF_GJ_ROW - 1)) >= wpn) csn[e] = T(0);
        }
      }
    }
    // (c) a warp per (32-column chunk, group of kRowGroup pivot rows): the
    // chunk's 13 pivot-row entries are read once for the group's rows
    for (int item = warp; item < nch * kGroups; item += nwarps) {
      const int ch = item / kGroups, r0 = kRowGroup * (item - kGroups * ch);
      const int j = 32 * ch + lane, jc = min(j, s - 1);
      const bool on_block = jc >= kb && jc < kb + wp;
      const int jp = max(0, min(jc - kb, wp - 1));
      T xv[HF_GJ_MAX_W], pr[kRowGroup][HF_GJ_ROW], v[kRowGroup];
#pragma unroll
      for (int m = 0; m < HF_GJ_MAX_W; ++m) {
        xv[m] = x[min(kb + m, s - 1) * ld + jc];
      }
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        hf_load16(pinv + min(r0 + q, HF_GJ_MAX_W - 1) * HF_GJ_ROW, pr[q]);
        v[q] = T(0);
      }
#pragma unroll
      for (int m = 0; m < HF_GJ_MAX_W; ++m) {
        if (m < wp) {
#pragma unroll
          for (int q = 0; q < kRowGroup; ++q) v[q] += pr[q][m] * xv[m];
        }
      }
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        const int r = r0 + q;
        if (r < wp && j < s) {
          rn[r * ld + j] = on_block ? pinv[r * HF_GJ_ROW + jp] : v[q];
        }
      }
    }
    __syncthreads();
    // (d)
    const int w0 = ahead ? 1 : 0;
    if (ahead && warp == 0) {
      // the next pivot block after this step's update, and its inverse
      T rv[HF_GJ_MAX_W], col[HF_GJ_MAX_W];
#pragma unroll
      for (int m = 0; m < HF_GJ_MAX_W; ++m) {
        rv[m] = m < wp ? rn[m * ld + ln] : T(0);
      }
      // four rows' sums at a time: independent chains, interleaved
#pragma unroll
      for (int r0 = 0; r0 < HF_GJ_MAX_W; r0 += 4) {
        T cv[4][HF_GJ_ROW], d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = min(r0 + q, HF_GJ_MAX_W - 1);
          hf_load16(cs + (kbn + min(r, wpn - 1)) * HF_GJ_ROW, cv[q]);
          d[q] = T(0);
        }
#pragma unroll
        for (int m = 0; m < HF_GJ_MAX_W; ++m) {
#pragma unroll
          for (int q = 0; q < 4; ++q) d[q] += cv[q][m] * rv[m];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (r0 + q < HF_GJ_MAX_W) col[r0 + q] = pnext[r0 + q] - d[q];
        }
      }
      pivot_block_augment(col, wpn);
      pivot_block_inverse_cols(col, wpn, pinv);
    } else {
      const int wn = ahead ? wpn : 0;
      for (int jb = 0; jb < nmain; jb += 32 * Q) {
        const int nq = (nmain - jb + 31) >> 5;
        if (nq == 1) {
          gj_update_run<T, 1>(x, ld, s, kb, wp, jb, nmain, cs, rn, w0, csn,
                              kbn, wn);
        } else if (Q == 2 || nq == 2) {
          gj_update_run<T, 2>(x, ld, s, kb, wp, jb, nmain, cs, rn, w0, csn,
                              kbn, wn);
        } else {
          gj_update_run<T, Q>(x, ld, s, kb, wp, jb, nmain, cs, rn, w0, csn,
                              kbn, wn);
        }
      }
      // the ragged columns, a thread per row
      for (int j = nmain; j < s; ++j) {
        const bool piv = j >= kb && j < kb + wp;
        const bool nxt = ahead && j >= kbn && j < kbn + wpn;
        T rv[HF_GJ_MAX_W];
#pragma unroll
        for (int l = 0; l < HF_GJ_MAX_W; ++l) rv[l] = rn[l * ld + j];
#pragma unroll
        for (int l = 0; l < HF_GJ_MAX_W; ++l) {
          if (l >= wp) rv[l] = T(0);
        }
        for (int i = tid - 32 * w0; i < s; i += nth - 32 * w0) {
          T cv[HF_GJ_ROW];
          hf_load16(cs + i * HF_GJ_ROW, cv);
          const T old = x[i * ld + j];
          const T row = rn[max(0, min(i - kb, wp - 1)) * ld + j];
          T d = T(0);
#pragma unroll
          for (int l = 0; l < HF_GJ_MAX_W; ++l) d += cv[l] * rv[l];
          const T v =
              (i >= kb && i < kb + wp) ? row : (piv ? T(0) : old) - d;
          x[i * ld + j] = v;
          if (nxt) csn[i * HF_GJ_ROW + j - kbn] = v;
        }
      }
    }
    __syncthreads();
  }
}

// The whole chain of one sample in one thread block.  Shared memory, in
// elements (hf_factorize_smem_elems), tiles of s rows at stride ld: the
// Dinv_{j-1}, T_j and B_{j-1} tiles, then the M_j tile, transposed, which
// the Gauss-Jordan scratch overlays; A_j, transposed, is staged in T_j's
// tile.
template <typename T>
__global__ void __launch_bounds__(HF_CHAIN_MAX_THREADS)
    banded_chain_kernel(const T* __restrict__ band, T* __restrict__ m_out,
                        T* __restrict__ dinv_out, int nb, int s, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;

  const size_t ss = (size_t)s * s;
  const size_t tile = (size_t)s * ld;
  T* dprev = reinterpret_cast<T*>(smem_raw);  // Dinv_{j-1}
  T* ttile = dprev + tile;                    // T_j, A_j^T before it
  T* bprev = ttile + tile;                    // B_{j-1}
  T* mt = bprev + tile;                       // M_j^T
  T* cs0 = mt;
  T* pinv = cs0 + 2 * (size_t)HF_GJ_ROW * s;
  T* rn = pinv + HF_GJ_ROW * HF_GJ_MAX_W;

  const size_t n = blockIdx.x;
  const T* band_n = band + n * nb * ss * 3;
  T* m_n = m_out + n * nb * ss;
  T* d_n = dinv_out + n * nb * ss;

  // Shared memory starts as garbage, which may decode as NaN, and
  // 0 * NaN = NaN: zero both carries so row 0 gives M_0 = 0 and T_0 = D_0.
  for (size_t e = tid; e < tile; e += nth) {
    dprev[e] = T(0);
    bprev[e] = T(0);
  }

  const int nt = (s + kTile - 1) / kTile;
  for (int j = 0; j < nb; ++j) {
    const T* bj = band_n + (size_t)j * ss * 3;  // (s, 3s): [A_j | D_j | B_j]
    T* at = ttile;
    load_band_row(at, bprev, ld, bj, j > 0 ? bj - ss * 3 + 2 * s : nullptr, s);
    __syncthreads();

    // M_j = A_j Dinv_{j-1}, to device memory and, transposed, into mt
    for (int t = tid; t < nt * nt; t += nth) {
      const int ti = t / nt, i0 = kTile * ti, c0 = kTile * (t - ti * nt);
      T acc[kTile][kTile];
      tile_product(at + i0, ld, dprev + c0, ld, s, acc);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (i0 + r < s) {
          T* mi = m_n + (size_t)j * ss + (size_t)(i0 + r) * s + c0;
#pragma unroll
          for (int q = 0; q < kTile; ++q) {
            if (c0 + q < s) mi[q] = acc[r][q];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        if (c0 + q < s) {
          T v[kTile];
#pragma unroll
          for (int r = 0; r < kTile; ++r) v[r] = acc[r][q];
          hf_store16(mt + (size_t)(c0 + q) * ld + i0, v);
        }
      }
    }
    __syncthreads();
    // T_j = D_j - M_j B_{j-1}
    for (int t = tid; t < nt * nt; t += nth) {
      const int ti = t / nt, i0 = kTile * ti, c0 = kTile * (t - ti * nt);
      T d[kTile][kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const T* di = bj + (size_t)(i0 + r) * 3 * s + s + c0;
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          d[r][q] = (i0 + r < s && c0 + q < s) ? di[q] : T(0);
        }
      }
      T acc[kTile][kTile];
      tile_product(mt + i0, ld, bprev + c0, ld, s, acc);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (i0 + r < s) {
          T v[kTile];
#pragma unroll
          for (int q = 0; q < kTile; ++q) v[q] = d[r][q] - acc[r][q];
          hf_store16(ttile + (size_t)(i0 + r) * ld + c0, v);
        }
      }
    }
    __syncthreads();

    chain_gj(ttile, ld, s, cs0, pinv, rn);

    for (int i = warp; i < s; i += nwarps) {
      T* di = d_n + (size_t)j * ss + (size_t)i * s;
      for (int c = lane; c < s; c += 32) di[c] = ttile[(size_t)i * ld + c];
    }
    // T_j^{-1} is the next row's Dinv carry
    T* swap = dprev;
    dprev = ttile;
    ttile = swap;
  }
}

// The Schur step: rows of a thread's tile (and of a panel), the columns
// one warp covers (lane l takes cb + l + 32 u, u < kTile, of its group),
// and the rows of the right operand a thread has in flight: 8 in float32,
// 4 in float64 (8 would spill its registers).
constexpr int kSchurRows = HF_SCHUR_ROWS;
constexpr int kGroupCols = 32 * kTile;
template <typename T>
constexpr int kSchurDepth = sizeof(T) == 4 ? 8 : 4;

// v[u] = row[cc[u]], u < NU: one coalesced 128-byte load per u across
// the warp, through L1 (the warps of a block that share a column group
// read the same rows).
template <int NU, typename T>
__device__ __forceinline__ void load_cols(T (&v)[NU], const T* row,
                                          const int (&cc)[kTile]) {
#pragma unroll
  for (int u = 0; u < NU; ++u) v[u] = __ldg(row + cc[u]);
}

template <int NU, typename T>
__device__ __forceinline__ void cols_fma(const T (&a)[kSchurRows],
                                         const T (&v)[NU],
                                         T (&acc)[kSchurRows][kTile]) {
#pragma unroll
  for (int r = 0; r < kSchurRows; ++r) {
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[r][u] += a[r] * v[u];
  }
}

// acc[r][u] += sum_l pt[l pp + r] src[l sld + cc[u]], l < s, u < NU:
// the left operand transposed in shared memory (rows of pp, 16-byte loads
// that the warp shares), the right one straight from device memory, D of
// its rows in flight in registers ahead of the multiply-adds (the loads
// of row l + D are issued as row l is used).
template <typename T, int D, int NU>
__device__ __forceinline__ void direct_product(const T* pt, int pp,
                                               const T* src, int sld, int s,
                                               const int (&cc)[kTile],
                                               T (&acc)[kSchurRows][kTile]) {
  T v[D][NU];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    load_cols<NU>(v[d], src + (size_t)min(d, s - 1) * sld, cc);
  }
  const T* a_row = pt;
  const T* next = src + (size_t)D * sld;  // the row D steps ahead
  int k = 0;
  // whole passes whose loads ahead stay inside the operand: no clamps,
  // addresses stepped
  for (; k + 2 * D <= s; k += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      T a[kSchurRows];
      hf_load16(a_row, a);
      a_row += pp;
      cols_fma<NU>(a, v[d], acc);
      load_cols<NU>(v[d], next, cc);
      next += sld;
    }
  }
  for (; k + D <= s; k += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      T a[kSchurRows];
      hf_load16(pt + (size_t)(k + d) * pp, a);
      cols_fma<NU>(a, v[d], acc);
      load_cols<NU>(v[d], src + (size_t)min(k + d + D, s - 1) * sld, cc);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (k + d < s) {
      T a[kSchurRows];
      hf_load16(pt + (size_t)(k + d) * pp, a);
      cols_fma<NU>(a, v[d], acc);
    }
  }
}

// The same over the warp's whole group, or over its first 32 columns
// alone where the group holds no more (the last group where s is 1 to 32
// past a multiple of kGroupCols: 4 columns at s = 516), so that the warp
// loads and multiplies only those.  A group of 2 or 3 chunks (s = 193)
// takes the whole group: a second code path beside the first warp's cost
// the block more than the idle chunk (PERF.md).
template <typename T>
__device__ __forceinline__ void group_product(bool one, const T* pt, int pp,
                                              const T* src, int sld, int s,
                                              const int (&cc)[kTile],
                                              T (&acc)[kSchurRows][kTile]) {
  constexpr int D = kSchurDepth<T>;
  if (one) {
    direct_product<T, D, 1>(pt, pp, src, sld, s, cc, acc);
  } else {
    direct_product<T, D, kTile>(pt, pp, src, sld, s, cc, acc);
  }
}

// The Schur step of block row j (j >= 1) for row panel [r0, r0 + 8) of one
// sample: M_j = A_j Dinv_{j-1} into m_out and T_j = D_j - M_j B_{j-1} into
// dinv_out[:, j] (which K3 inverts next); at j = 0, M_0 = 0 and T_0 = D_0.
// Each thread accumulates a kSchurRows x kTile tile of the panel's outputs
// in registers: the panel's rows, and the columns cb + lane + 32 u of its
// warp's group of kGroupCols.  The left operand (A_j's panel, then M_j's)
// lies transposed in shared memory, (s, 12): per row l the warp's lanes
// share one 16-byte load of it.  The right ones, Dinv_{j-1} and then
// B_{j-1} (rows 3s apart in the band; at s = 193 a row starts on 4 bytes),
// are read straight from device memory, a 128-byte line per u across the
// warp, through L1 and L2 (every panel of the sample reads them), D rows
// ahead of their use: no block barrier in the loop.
template <typename T>
__global__ void __launch_bounds__(HF_SCHUR_MAX_THREADS)
    schur_tile_kernel(const T* __restrict__ band, T* __restrict__ m_out,
                      T* dinv_out, int nb, int s, int j) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int pp = HF_SCHUR_PP;
  T* pt = reinterpret_cast<T*>(smem_raw);  // (s, pp): A_j's panel, then M_j's
  const int tid = threadIdx.x, nth = blockDim.x;
  const int r0 = blockIdx.y * kSchurRows;
  const int rows = min(kSchurRows, s - r0);
  const size_t ss = (size_t)s * s;
  const size_t row = (size_t)blockIdx.x * nb + j;
  const int w3 = 3 * s;
  const T* bj = band + row * ss * 3 + (size_t)r0 * w3;  // rows r0.. of [A|D|B]
  T* mj = m_out + row * ss + (size_t)r0 * s;
  T* tj = dinv_out + row * ss + (size_t)r0 * s;
  if (j == 0) {
    for (int e = tid; e < rows * s; e += nth) {
      const int r = e / s, c = e - r * s;
      mj[e] = T(0);
      tj[e] = bj[(size_t)r * w3 + s + c];
    }
    return;
  }
  const int lane = tid & 31, cg = kGroupCols * (tid >> 5), cb = cg + lane;
  const bool one = s - cg <= 32;  // the group holds one 32-column chunk
  int cc[kTile];  // the thread's columns, clamped into the row
#pragma unroll
  for (int u = 0; u < kTile; ++u) cc[u] = min(cb + 32 * u, s - 1);
  // A_j's panel, transposed: pt[l pp + r] = A_j[r0 + r, l], zero past the
  // panel's rows.  A warp copies 4 rows x 8 columns at a time: whole
  // 32-byte sectors of the band, into 32 distinct banks
  {
    const int nl8 = (s + 7) / 8, groups = kSchurRows / 4 * nl8;
    for (int e = tid; e < 32 * groups; e += nth) {
      const int g = e >> 5, rb = g / nl8;
      const int r = 4 * rb + ((e >> 3) & 3), l = 8 * (g - rb * nl8) + (e & 7);
      if (l < s) {
        if (r < rows) {
          __pipeline_memcpy_async(pt + (size_t)l * pp + r,
                                  bj + (size_t)r * w3 + l, sizeof(T));
        } else {
          pt[(size_t)l * pp + r] = T(0);
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  T acc[kSchurRows][kTile];
  tile_zero(acc);
  group_product<T>(one, pt, pp, dinv_out + (row - 1) * ss, s, s, cc, acc);
  // M_j: to device memory, and transposed over A_j's panel once every
  // read of that has ended
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
    const int c = cb + 32 * u;
    if (c < s) {
#pragma unroll
      for (int r = 0; r < kSchurRows; ++r) {
        if (r < rows) mj[(size_t)r * s + c] = acc[r][u];
      }
      T v[kSchurRows];
#pragma unroll
      for (int r = 0; r < kSchurRows; ++r) v[r] = acc[r][u];
      hf_store16(pt + (size_t)c * pp, v);
    }
  }
  __syncthreads();
  tile_zero(acc);
  group_product<T>(one, pt, pp, band + (row - 1) * ss * 3 + 2 * s, w3, s, cc,
                   acc);
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
    const int c = cb + 32 * u;
    if (c < s) {
#pragma unroll
      for (int r = 0; r < kSchurRows; ++r) {
        if (r < rows) {
          tj[(size_t)r * s + c] = bj[(size_t)r * w3 + s + c] - acc[r][u];
        }
      }
    }
  }
}

// The Schur step's launch at block size s: a block per (sample, panel), a
// warp per kGroupCols columns, its shared memory opted into;
// cudaErrorInvalidValue (before any launch) where s needs more threads
// than a block takes.
template <typename T>
int schur_configure(int s, int* threads, size_t* smem) {
  *threads = hf_schur_threads(s);
  *smem = hf_schur_smem_size(s, (int)sizeof(T));
  if (s < 1 || *threads > HF_SCHUR_MAX_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaFuncSetAttribute(schur_tile_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

template <typename T>
int schur_launch(int threads, size_t smem, const void* band, void* m_out,
                 void* dinv_out, int n, int nb, int s, int j, void* stream) {
  const dim3 grid(n, (s + kSchurRows - 1) / kSchurRows);
  schur_tile_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(band), static_cast<T*>(m_out),
      static_cast<T*>(dinv_out), nb, s, j);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_schur(const void* band, void* m_out, void* dinv_out, int n, int nb,
                 int s, int j, void* stream) {
  if (j < 0 || j >= nb) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  const int err = schur_configure<T>(s, &threads, &smem);
  if (err != 0) return err;
  return schur_launch<T>(threads, smem, band, m_out, dinv_out, n, nb, s, j,
                         stream);
}

template <typename T>
int launch_factorize(const void* band, void* m_out, void* dinv_out, int n,
                     int nb, int s, int ld, int threads, void* stream) {
  constexpr int vec = 16 / (int)sizeof(T);
  // warp 0 inverts the pivot blocks; the other warps stage and update
  if (threads < 64 || threads > HF_CHAIN_MAX_THREADS || threads % 32 != 0 ||
      ld % vec != 0 || ld < (s + kTile - 1) / kTile * kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = hf_factorize_smem_elems(s, ld) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      banded_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_chain_kernel<T><<<n, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(band), static_cast<T*>(m_out),
      static_cast<T*>(dinv_out), nb, s, ld);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factorize_rows(const void* band, void* m_out, void* dinv_out,
                          int n, int nb, int s, int w, int c, int resident,
                          void* stream,
                          int (*invert)(void*, int, int, long long, int, int,
                                        int, void*)) {
  int threads;
  size_t smem;
  int code = schur_configure<T>(s, &threads, &smem);
  if (code != 0) return code;
  const long long ss = (long long)s * s;
  T* dinv = static_cast<T*>(dinv_out);
  for (int j = 0; j < nb; ++j) {
    code = schur_launch<T>(threads, smem, band, m_out, dinv_out, n, nb, s, j,
                           stream);
    if (code != 0) return code;
    code = invert(dinv + j * ss, n, s, nb * ss, w, c, resident, stream);
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

// The chain: n samples, a block of `threads` threads each, tiles at row
// stride ld; what the kernel does not take returns cudaErrorInvalidValue.
extern "C" int hf_banded_factorize_f32(const void* band, void* m_out,
                                       void* dinv_out, int n, int nb, int s,
                                       int ld, int threads, void* stream) {
  return launch_factorize<float>(band, m_out, dinv_out, n, nb, s, ld, threads,
                                 stream);
}

extern "C" int hf_banded_factorize_f64(const void* band, void* m_out,
                                       void* dinv_out, int n, int nb, int s,
                                       int ld, int threads, void* stream) {
  return launch_factorize<double>(band, m_out, dinv_out, n, nb, s, ld, threads,
                                  stream);
}

// The row design: n samples, per block row the Schur step, then K3 at
// pivot width w in clusters of c blocks, in the L2 (resident 0) or
// resident (1) design; what the kernels do not take returns
// cudaErrorInvalidValue before any launch.
extern "C" int hf_banded_factorize_rows_f32(const void* band, void* m_out,
                                            void* dinv_out, int n, int nb,
                                            int s, int w, int c, int resident,
                                            void* stream) {
  return launch_factorize_rows<float>(band, m_out, dinv_out, n, nb, s, w, c,
                                      resident, stream,
                                      hf_batched_inverse_f32);
}

extern "C" int hf_banded_factorize_rows_f64(const void* band, void* m_out,
                                            void* dinv_out, int n, int nb,
                                            int s, int w, int c, int resident,
                                            void* stream) {
  return launch_factorize_rows<double>(band, m_out, dinv_out, n, nb, s, w, c,
                                       resident, stream,
                                       hf_batched_inverse_f64);
}

// The Schur step of block row j alone (M_j into m, T_j into dinv[:, j];
// Dinv_{j-1} read from dinv[:, j - 1]), as the row design launches it.
extern "C" int hf_schur_step_f32(const void* band, void* m, void* dinv, int n,
                                 int nb, int s, int j, void* stream) {
  return launch_schur<float>(band, m, dinv, n, nb, s, j, stream);
}

extern "C" int hf_schur_step_f64(const void* band, void* m, void* dinv, int n,
                                 int nb, int s, int j, void* stream) {
  return launch_schur<double>(band, m, dinv, n, nb, s, j, stream);
}

extern "C" long long hf_factorize_smem_bytes(int s, int ld, int itemsize) {
  return (long long)(hf_factorize_smem_elems(s, ld) * itemsize);
}

extern "C" long long hf_schur_smem_bytes(int s, int itemsize) {
  return (long long)hf_schur_smem_size(s, itemsize);
}
