// Segment-packed Smith-Waterman on the band walker: one kernel for the
// untiled (K9) and the query-tiled (K8) entry points.
//
// Replaces the TPU kernels swipe_tpu/ops/sw_pallas.py sw_scores_segmented
// (_sw_kernel; its lax twin sw_scores_lax takes an int32 profile, which
// the wide instantiation covers) and swipe_tpu/ops/sw_tiled.py
// sw_scores_tiled (_tiled_kernel), which compute the same function.
// Exact affine-gap Smith-Waterman of NQ queries against a segment-packed
// chunk (batching.pack_database): the chunk's [L, NSEQS] columns are cut
// into blocks of SEG_BLK = 32, a block->segment map names each block's
// segment, and lane i of segment k holds one sequence.  A lane's state
// resets at a segment's first column, and at its last column the lane's
// best score is written to out[q, seg, lane].  Segments that seg_ids never
// names stay as the wrapper zeroed them.  The score of row i against db
// symbol d comes from the query's transposed profile qpt[q, i, d]
// (ops/sw_segmented.py build_qpt), whose rows past the query and whose PAD
// column hold a strongly negative pad.  The TPU's 64-row tile and its
// whole-query scan are the TPU's layout; K8's wrapper keeps only the
// contract's check that QLEN is a multiple of 64.
//
// Design: K2's (carry_rows.cu stream_rows_kernel) on the walker of
// rows.cuh.  A warp takes one (query, lane) and sweeps the chunk over the
// query's rows, thread t owning a strip of RS rows and computing column
// s - t at step s; SEG_WARPS lanes of one query a block share the band's
// profile, staged from qpt (block_profile's qpt overload).  The bands,
// 32 x RS rows (RS 4, 8 or 16 from QLEN for an int8 profile, 8 for an
// int32 one), are laid from each query's last row up, so every band is
// whole: the first starts above row 0 with virtual rows that score as
// PAD and stay at H = 0.  The wrapper derives each query's length from
// qpt (its last row with an entry other than the pad), so no rows past
// the query are walked.  Band k + 1 reads band k's bottom row from planes
// [L] of the pair.
//   * Segment starts are the same for every lane: column c starts one when
//     c % SEG_BLK == 0 and block c / SEG_BLK is 0 or is named by another
//     segment than the block before it.  The staging marks it with the
//     ring's RESET bit, and a thread reaching it zeroes its rows' H, sets
//     E to -inf, takes 0 as the diagonal from the left and restarts S.
//     What arrives from above (the thread above, or band k's plane) was
//     itself reset at that column.  A warp spans 32 columns, so it can be
//     on two segments at once: every reset and every max belongs to its
//     column.
//   * The output: each thread hands the column's running max over the
//     strips above and its own down the pipeline with H and F (K2's
//     chained dump), so the max that thread 31 holds at a segment's last
//     column (the ring's END bit) is the segment's over the band.  The
//     first band stores it to out[q, seg, lane]; later bands max-merge.
//
// Bound: operations (16 queries of 200 rows against 512 lanes x 16,384
// columns).  A cell is 6 instructions with the DPX add-max (rows.cuh); a
// band takes L + 31 steps of RS cells a thread, and a chunk's 512 lanes
// give NQ x 64 blocks of 8 warps.
#include "rows.cuh"

using namespace swipe;

namespace {

constexpr int SEG_BLK = 32;     // db columns per block (segment grain)
constexpr int SEG_WARPS = 8;    // lanes of one query a block
constexpr int END = 64;         // ring code bit: a segment's last column
static_assert(WIN == SEG_BLK, "a staged window is one block");

// One band of a pair.
struct SegBand {
  const int8_t* db;           // column 0 of the lane; column stride n
  const int32_t* seg_ids;     // [nblocks + 1] block -> segment
  long long n;
  int L;
  const int32_t* top_h;       // row r0 - 1 per column, or null: H 0, F -inf
  const int32_t* top_f;
  int32_t* bot_h;             // the band's bottom row per column, or null
  int32_t* bot_f;
  int32_t* out;               // segment 0 of the pair; segment stride n
  int Q, R;
};

// Walk one band over the chunk (all 32 threads of the warp), its rows
// fresh at column 0 and at every segment start.
template <typename M, int RS>
__device__ void walk_segment_band(const SegBand& b, const M* prof,
                                  uint8_t* ring, int2* tring, int2* cap) {
  const int t = threadIdx.x & 31;
  const long long n = b.n;
  const int nblocks = b.L / SEG_BLK;
  int H[RS], E[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    H[i] = 0;
    E[i] = NEG_INF;
  }

  // one window of staged columns, held in registers until it is stored;
  // a window is one block, so thread 0 stages its first column and
  // thread 31 its last
  int code = 0, th = 0, tf = NEG_INF;
  auto fetch = [&](int c0) {
    const int c = c0 + t;
    if (c < b.L) {
      code = b.db[c * n] & (NSYM - 1);
      const int k = c / SEG_BLK;
      if (t == 0 && (k == 0 || b.seg_ids[k - 1] != b.seg_ids[k]))
        code |= RESET;
      if (t == SEG_BLK - 1 &&
          (k == nblocks - 1 || b.seg_ids[k + 1] != b.seg_ids[k]))
        code |= END;
      th = b.top_h ? b.top_h[c * n] : 0;
      tf = b.top_f ? b.top_f[c * n] : NEG_INF;
    }
  };
  fetch(0);

  int S = 0;
  int hin = 0, fin = NEG_INF;       // from the row above, this column
  int hprev = 0;                    // from the row above, the column before
  int hout = 0, fout = NEG_INF;
  int mup = 0, mout = 0;            // the column's max from above, and out
  const int steps = b.L + 31;
  for (int s = 0; s < steps; ++s) {
    if ((s & (WIN - 1)) == 0) {
      // store window s / WIN (fetched one window ago), fetch the next; its
      // ring slot last held columns no thread reads any more
      __syncwarp();
      ring[(s + t) & (RING - 1)] = (uint8_t)code;
      tring[(s + t) & (RING - 1)] = make_int2(th, tf);
      __syncwarp();
      fetch(s + WIN);
    }
    const int j = s - t;
    if (t == 0 && s < b.L) {
      const int2 v = tring[s & (RING - 1)];
      hin = v.x;
      fin = v.y;
    }
    if (j >= 0 && j < b.L) {
      const int c = ring[j & (RING - 1)];
      int d = hprev;
      if (c & RESET) {
        d = 0;
        S = 0;
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          H[i] = 0;
          E[i] = NEG_INF;
        }
      }
      const M* pr = prof + (c & (NSYM - 1)) * RS * 32 + t;
      hout = hin;
      fout = fin;
      strip_cells<M, false, false, RS>(pr, cap + t, H, E, RS, d, hout, fout,
                                       S, b.Q, b.R, 0);
      mout = max(mup, S);
      if (t == 31 && (c & END)) {
        int32_t* o = b.out + b.seg_ids[j / SEG_BLK] * n;
        *o = b.top_h == nullptr ? mout : max(*o, mout);
      }
      if (t == 31 && b.bot_h != nullptr) {
        b.bot_h[j * n] = hout;
        b.bot_f[j * n] = fout;
      }
    }
    hprev = hin;
    hin = __shfl_up_sync(FULL, hout, 1);
    fin = __shfl_up_sync(FULL, fout, 1);
    mup = __shfl_up_sync(FULL, mout, 1);
    if (t == 0) mup = 0;
  }
  __syncwarp();      // the planes, for the next band
}

// Every band of the query, laid from its last row up, SEG_WARPS lanes of
// one query a block sharing the band's profile.  qlens: each query's rows
// (the wrapper derives them from qpt).  bh/bf: the planes between bands,
// [nq, L, nseqs] (null when no query has more than one band).
template <typename M, int RS>
__global__ void __launch_bounds__(32 * SEG_WARPS)
segment_rows_kernel(const M* __restrict__ qpt,
                    const int32_t* __restrict__ qlens,
                    const int8_t* __restrict__ db,
                    const int32_t* __restrict__ seg_ids, int32_t* out,
                    int32_t* bh, int32_t* bf, int qlen_pad, int nblocks,
                    int nseqs, int nsegs, int Q, int R) {
  M* prof;
  int2 *tring, *cap;
  uint8_t* ring;
  carve<SEG_WARPS, M, RS>(prof, tring, cap, ring);
  const int lane = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  const int q = blockIdx.y;
  const long long n = nseqs;
  const int L = nblocks * SEG_BLK;
  const int qlen = min(qlens[q], qlen_pad);
  // no rows (the whole block: one query): its segments stay 0
  if (qlen <= 0) return;
  const M* qp = qpt + (long long)q * qlen_pad * NSYM;
  const long long plane = (long long)q * L * n + lane;
  SegBand b{db + lane, seg_ids, n, L, nullptr, nullptr, nullptr, nullptr,
            out + (long long)q * nsegs * n + lane, Q, R};
  constexpr int BAND = 32 * RS;
  for (int r1 = qlen - (qlen - 1) / BAND * BAND; r1 <= qlen; r1 += BAND) {
    const bool last = r1 == qlen;
    b.bot_h = last ? nullptr : bh + plane;
    b.bot_f = last ? nullptr : bf + plane;
    block_profile<SEG_WARPS, M, RS>(qp, r1 - BAND, prof);
    if (lane < nseqs) walk_segment_band<M, RS>(b, prof, ring, tring, cap);
    b.top_h = bh + plane;
    b.top_f = bf + plane;
  }
}

template <typename M, int RS>
int launch(dim3 grid, cudaStream_t st, const void* qpt, const int32_t* qlens,
           const int8_t* db, const int32_t* seg_ids, int32_t* out,
           int32_t* bh, int32_t* bf, int qlen_pad, int nblocks, int nseqs,
           int nsegs, int Q, int R) {
  const size_t smem = smem_bytes<M, RS>(SEG_WARPS);
  const auto kernel = segment_rows_kernel<M, RS>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * SEG_WARPS, smem, st>>>(
      (const M*)qpt, qlens, db, seg_ids, out, bh, bf, qlen_pad, nblocks,
      nseqs, nsegs, Q, R);
  return (int)cudaGetLastError();
}

}  // namespace

// K9: out [nq, nsegs, nseqs] zeroed by the caller (segments no block names
// stay 0); qlens [nq] each query's rows of qpt; wide: the profile is
// int32 (rs 8), else int8 (rs 4, 8 or 16: bands of 128, 256 or 512 rows);
// bh/bf [nq, L, nseqs] a scratch for the planes between bands (null when
// qlen_pad fits one band).  Needs Q >= R.
extern "C" int swipe_segment(const void* qpt, const int32_t* qlens, int wide,
                             const int8_t* db, const int32_t* seg_ids,
                             int32_t* out, int32_t* bh, int32_t* bf, int nq,
                             int qlen_pad, int nblocks, int nseqs, int nsegs,
                             int Q, int R, int rs, void* stream) {
  if (Q < R || (wide ? rs != Rows<int32_t>::RS
                     : rs != 4 && rs != 8 && rs != 16))
    return (int)cudaErrorInvalidValue;
  if (qlen_pad > 32 * rs && bh == nullptr) return (int)cudaErrorInvalidValue;
  if (nq <= 0 || nseqs <= 0 || nblocks <= 0) return (int)cudaGetLastError();
  const dim3 grid((nseqs + SEG_WARPS - 1) / SEG_WARPS, nq);
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch<int32_t, Rows<int32_t>::RS>(grid, st, qpt, qlens, db,
                                              seg_ids, out, bh, bf, qlen_pad,
                                              nblocks, nseqs, nsegs, Q, R);
#define SEGMENT_RS(RS)                                                     \
  if (rs == RS)                                                            \
    return launch<int8_t, RS>(grid, st, qpt, qlens, db, seg_ids, out, bh, \
                              bf, qlen_pad, nblocks, nseqs, nsegs, Q, R);
  SEGMENT_RS(4)
  SEGMENT_RS(8)
  SEGMENT_RS(16)
#undef SEGMENT_RS
  return (int)cudaErrorInvalidValue;
}

// K8: as swipe_segment with an int8 profile; qlen_pad a multiple of 64
// (the TPU kernel's tile, the contract's check).
extern "C" int swipe_segment_tiled(const int8_t* qpt, const int32_t* qlens,
                                   const int8_t* db, const int32_t* seg_ids,
                                   int32_t* out, int32_t* bh, int32_t* bf,
                                   int nq, int qlen_pad, int nblocks,
                                   int nseqs, int nsegs, int Q, int R,
                                   int rs, void* stream) {
  if (qlen_pad % 64) return (int)cudaErrorInvalidValue;
  return swipe_segment(qpt, qlens, 0, db, seg_ids, out, bh, bf, nq,
                       qlen_pad, nblocks, nseqs, nsegs, Q, R, rs, stream);
}
