// The band walker of the row-form kernels: a warp takes one (query, lane)
// pair and sweeps a chunk's columns as a systolic pipeline over the
// query's rows.  Included by carry_rows.cu (K2, K3's two forms, K5, K6),
// hint.cu (K4) and segment.cu (K8, K9).
//
//   * a band is 32 * RS consecutive query rows; thread t owns a strip of
//     RS rows, their H and pre-advanced E in registers for the whole walk.
//     RS is a template parameter: 16 (int8 matrix) and 8 (int32) for K3's
//     row form, K4, K5 and K6; 4, 8 or 16 for K2, K3's flow form and the
//     int8 K8 and K9, whose launches pick the band from the query length;
//   * at step s thread t computes column s - t: F runs down its strip,
//     and it hands its bottom row's H and F to thread t + 1 with
//     __shfl_up_sync; H that arrived one step earlier is the diagonal
//     into its top row;
//   * row -1 of a band comes from planes [L] of the pair, staged through
//     shared memory with the db symbols; thread 31 writes the band's
//     bottom row back to the planes.  Threads whose strip lies past the
//     query's last row only relay, so the planes hold the last real row.
// The cell, with the DPX instructions:
//   hn = __viaddmax_s32_relu(diag, p, E)    max(diag + p, E, 0)
//   H  = max(hn, F);  S = max(S, H)
//   E  = __viaddmax_s32(E, -R, H - Q)
//   F  = __viaddmax_s32(F, -R, hn - Q)      F into the row below
// F from hn and not from H is exact because Q >= R (a gap open penalty of
// at least 0, which the wrappers check): the term F - Q is dominated by
// F - R.  So the chain down a strip is one instruction a row, and the
// cell's other work (E, S, the next H) is off it.
// Scores come from a per-band query profile in shared memory laid out
// [sym][row of the strip][thread]: a warp's 32 lookups (32 columns, any
// db symbols) hit 32 consecutive elements, so no bank conflicts.  int8
// entries for the int8 matrix (RS KB a band), int32 for the wide matrix.
// In a block of one warp each thread fills its own column of it
// (strip_profile); in a block of several (K2, K3's flow form, K5, K8, K9)
// every warp walks the same band of the same query, so the warps share
// one (block_profile).  db
// symbols, start bits and the planes are staged 32 columns at a time,
// one window ahead of the pipeline, through a 64-column ring per warp.
#pragma once

#include "sw_common.cuh"

namespace swipe {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WIN = 32;            // columns staged at a time
constexpr int RING = 2 * WIN;      // staged columns
constexpr int RESET = 32;          // ring code bit: a start bit at this column

// rows a thread of the carry and hint kernels (K3's row form, K4, K5,
// K6), by matrix element type (chosen by timing 8, 16 and 32;
// ops/sw_stream.py ROW_BANDS mirrors the band heights, 32 * RS).  Every
// function below takes RS as a template parameter defaulting to these, so
// K2 and K3's flow form instantiate bands of 128, 256 and 512 rows
// (ops/sw_stream.py STREAM_BANDS).
template <typename M> struct Rows;
template <> struct Rows<int8_t> { static constexpr int RS = 16; };
template <> struct Rows<int32_t> { static constexpr int RS = 8; };

// A thread's lane in its warp, the strip it owns, in blocks of WARPS
// warps.  In one-warp blocks it is threadIdx.x itself, unmasked: the mask
// cost K6 registers and time.
template <int WARPS>
__device__ __forceinline__ int strip_of_thread() {
  return WARPS == 1 ? (int)threadIdx.x : (int)(threadIdx.x & 31);
}

// The strip's rows of the band's profile, in a block of one warp:
// thread t fills prof[(sym * RS + i) * 32 + t] for query row row0 + i,
// the PAD row's scores outside [lo, nr), and reads only what it fills.
// No block barrier: block_profile in the one-warp kernels cost K6 6%
// (PERF.md §6, PR 7).
template <typename M, int RS = Rows<M>::RS>
__device__ __forceinline__ void strip_profile(const int32_t* qc, const M* m,
                                              int row0, int lo, int nr,
                                              int t, M* prof) {
  __syncwarp();
  for (int i = 0; i < RS; ++i) {
    const bool real = i >= lo && i < nr;
    const M* mrow =
        m + (real ? qc[row0 + i] & (NSYM - 1) : PAD_SYMBOL) * NSYM;
    for (int sym = 0; sym < NSYM; ++sym)
      prof[(sym * RS + i) * 32 + t] = mrow[sym];
  }
}

// The band's profile in a block of WARPS > 1 warps sharing it: warp w
// fills rows w, w + WARPS, ... of every strip, the layout of
// strip_profile for rows [r0, r1).  Barriers on both sides: no warp still
// reads the previous band's, and every warp sees the whole of this one.
template <int WARPS, typename M, int RS = Rows<M>::RS>
__device__ __forceinline__ void block_profile(const int32_t* qc, const M* m,
                                              int r0, int r1, M* prof) {
  const int t = threadIdx.x & 31;
  const int row0 = r0 + t * RS;
  __syncthreads();
  for (int i = threadIdx.x >> 5; i < RS; i += WARPS) {
    const int r = row0 + i;
    const M* mrow =
        m + (r >= 0 && r < r1 ? qc[r] & (NSYM - 1) : PAD_SYMBOL) * NSYM;
    for (int sym = 0; sym < NSYM; ++sym)
      prof[(sym * RS + i) * 32 + t] = mrow[sym];
  }
  __syncthreads();
}

// block_profile from a transposed query profile instead of codes and a
// matrix (the segment kernels' qpt [rows, NSYM], ops/sw_segmented.py
// build_qpt): row r's scores are qp[r * NSYM + sym].  Rows above row 0
// take the PAD column of row 0, which holds qpt's pad in every row; the
// rows past the query hold it already.
template <int WARPS, typename M, int RS = Rows<M>::RS>
__device__ __forceinline__ void block_profile(const M* qp, int r0, M* prof) {
  const int t = threadIdx.x & 31;
  const int row0 = r0 + t * RS;
  __syncthreads();
  for (int i = threadIdx.x >> 5; i < RS; i += WARPS) {
    const int r = row0 + i;
    const M* prow = qp + max(r, 0) * NSYM;
    for (int sym = 0; sym < NSYM; ++sym)
      prof[(sym * RS + i) * 32 + t] = prow[r >= 0 ? sym : PAD_SYMBOL];
  }
  __syncthreads();
}

// The strip's RS cells of one column, every row computed: rows outside
// the query score as PAD (past its end; virtual rows above its start, see
// carry_rows_kernel), so they never raise S above a real cell and their
// state is neither read nor written.  In three passes over the strip:
// every row's H without F (the rows independent), then F down the strip
// (the only chain: one instruction a row), then H, E and S off it.
// (hout, fout) come in as the row above's and go out as the bottom real
// row's: row RS - 1, or with PARTIAL row nr - 1 (none: a relay passes
// them on), picked from a shared-memory copy of every row's (H, F) -- the
// same pick made with a predicated select in the unrolled loop gave wrong
// results at RS = 16 on the card unless ptxas ran at -O0 (not
// understood).  Predicating each row on being the query's instead of
// computing it was slower.
template <typename M, bool CLAMP, bool PARTIAL, int RS = Rows<M>::RS>
__device__ __forceinline__ void strip_cells(
    const M* __restrict__ pr, int2* cap, int (&H)[RS], int (&E)[RS], int nr,
    int d, int& hout, int& fout, int& S, int Q, int R, int clamp) {
  int hn[RS], fv[RS + 1];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    hn[i] = __viaddmax_s32_relu(i == 0 ? d : H[i - 1], (int)pr[i * 32],
                                E[i]);
    if (CLAMP) hn[i] = min(hn[i], clamp);
  }
  fv[0] = fout;
#pragma unroll
  for (int i = 0; i < RS; ++i)
    fv[i + 1] = __viaddmax_s32(fv[i], -R, hn[i] - Q);
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    int h = max(hn[i], fv[i]);
    if (CLAMP) h = min(h, clamp);
    H[i] = h;
    E[i] = __viaddmax_s32(E[i], -R, h - Q);
    hn[i] = h;
    if (PARTIAL) cap[i * 32] = make_int2(h, fv[i + 1]);
  }
#pragma unroll
  for (int w = 1; w < RS; w *= 2)     // S: a tree over the strip
#pragma unroll
    for (int i = 0; i + w < RS; i += 2 * w) hn[i] = max(hn[i], hn[i + w]);
  S = max(S, hn[0]);
  if (!PARTIAL) {
    hout = H[RS - 1];
    fout = fv[RS];
  } else if (nr > 0) {
    const int2 v = cap[(nr - 1) * 32];
    hout = v.x;
    fout = v.y;
  }
}

// shared memory of a block of W warps: each warp's staged planes (int2
// [RING]), rows' (H, F) of a partial band (int2 [RS][32]) and staged
// symbols (uint8 [RING]), then the profile (M [NSYM][RS][32])
template <typename M, int RS = Rows<M>::RS>
__host__ __device__ constexpr size_t profile_bytes() {
  return sizeof(M) * NSYM * RS * 32;
}

template <typename M, int RS = Rows<M>::RS>
__host__ __device__ constexpr size_t warp_smem_bytes() {
  return sizeof(int2) * (RING + RS * 32) + RING;
}

template <typename M, int RS = Rows<M>::RS>
__host__ __device__ constexpr size_t smem_bytes(int warps) {
  return warps * warp_smem_bytes<M, RS>() + profile_bytes<M, RS>();
}

template <int WARPS, typename M, int RS = Rows<M>::RS>
__device__ void carve(M*& prof, int2*& tring, int2*& cap, uint8_t*& ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  tring = reinterpret_cast<int2*>(
      smem + (WARPS == 1 ? 0 : threadIdx.x >> 5) * warp_smem_bytes<M, RS>());
  cap = tring + RING;
  ring = reinterpret_cast<uint8_t*>(cap + RS * 32);
  prof = reinterpret_cast<M*>(smem + WARPS * warp_smem_bytes<M, RS>());
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)
             : cudaSuccess;
}

}  // namespace swipe
