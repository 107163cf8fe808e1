// Shared definitions of the port's Smith-Waterman kernels (sm_90a).
//
// Layout contract, the same as the JAX package's lane-packed chunks
// (swipe_tpu/batching.py pack_stream): a chunk is [L, NSEQS] int8 with
// L a multiple of KSEG; lane i holds a concatenation of sequences; symbols
// are 0..31, PAD_SYMBOL = 31 scoring -128 against everything.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace swipe {

constexpr int KSEG = 16;               // db columns per block
constexpr int NSYM = 32;               // alphabet incl. PAD
constexpr int PAD_SYMBOL = NSYM - 1;   // scores -128 against everything
constexpr int NEG_INF = -(1 << 30);    // survives adds without overflow
constexpr int THREADS = 128;           // lanes per thread block

// The [32, 32] score matrix as int32 in shared memory: int8
// (build_matrix8), or int32 for matrices outside int8
// (build_matrix_wide, a separate instantiation of the kernels that take
// it).  Every thread of a warp walks the same query row, so a lookup
// m8s[qsym * 32 + dsym] reads one 32-word row, one bank per db symbol:
// no bank conflicts whatever the db symbols are.
template <typename M>
__device__ __forceinline__ void load_matrix(int* m8s, const M* m8) {
  for (int i = threadIdx.x; i < NSYM * NSYM; i += blockDim.x) {
    m8s[i] = m8[i];
  }
  __syncthreads();
}

// One DP cell of the recurrence shared by the stream and segment kernels
// (the TPU kernels' _make_row_body_multi): H from the diagonal plus the
// score, E from the left and F from above, both stored pre-advanced;
// then E and F advance into the next cell, so H - Q is formed once.
template <bool CLAMP>
__device__ __forceinline__ int sw_cell(int diag_p, int& e, int& f, int Q,
                                       int R, int clamp) {
  int h = max(max(diag_p, 0), max(e, f));
  if (CLAMP) h = min(h, clamp);
  const int hq = h - Q;
  e = max(e - R, hq);
  f = max(f - R, hq);
  return h;
}

}  // namespace swipe
