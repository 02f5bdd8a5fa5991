// Launch geometry shared by the banded kernels and their host entries.
#pragma once

#include <cstddef>

// Threads per block of both kernels.
#define HF_THREADS 256

// Shared-memory elements of one K1 block: the Dinv_{j-1}, B_{j-1} and M_j
// tiles (s x s each), the (s, 2s) Gauss-Jordan tile, and the pivot row and
// column scratch (s + 1 and s).
inline std::size_t hf_factorize_smem_elems(int s) {
  return 5 * (std::size_t)s * s + 2 * (std::size_t)s + 1;
}

// Shared-memory elements of one K2 block: the two staged factor blocks
// (s x s each) and the carry and temporary of one (s, kt) column tile.
inline std::size_t hf_solve_smem_elems(int s, int kt) {
  return 2 * (std::size_t)s * s + 2 * (std::size_t)s * kt;
}
