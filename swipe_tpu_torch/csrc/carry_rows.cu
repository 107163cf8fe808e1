// Stream scoring with a query's rows spread over a warp: the plain-pack
// kernel (K2), the tile pass (K5), the tile carry pass (K6) and both
// forms of the carry kernel (K3), all on the band walker of rows.cuh.
//
// Replaces the TPU kernels swipe_tpu/ops/sw_stream.py sw_scores_stream
// (:568, _stream_kernel_grouped: every plain pack of a blastp/blastn
// search, and the segmented giants' pieces), _stream_tile_pass (:1263,
// _stream_tile_kernel, driven by sw_scores_stream_long),
// _stream_tile_carry_pass (:1419, _stream_tile_carry_kernel, driven by
// sw_scores_stream_carry_long) and sw_scores_stream_carry (:733) in two
// forms, which ops/sw_stream.py carry_form picks by the launch's lanes:
// the flow form (K2's 8-warp blocks and bands sized to the query, with
// the state carried) for the flow series' chunks and drains of 1,024 and
// 2,048 lanes, and the row form (one-warp blocks, bands of Rows<M>::RS
// rows, also the int32 matrix) for the giant carry series, whose state
// is the chromosomes' compact lane count rounded to a warp, so a launch
// holds a few hundred (query, lane) pairs, most of them PAD.
//
// Why a warp per pair.  One thread per pair (the old K2, K5 and K6) walks
// a pair's whole chain: a giant launch's two to sixteen real pairs left
// 130 of the 132 SMs idle, a long-query slot group's 4,096 pairs made one
// warp an SM, a Swiss-Prot chunk's 32,768 pairs in blocks of 128 about 8
// warps an SM, and every cell paid its dependent chain and a global
// round trip of the row state.  Here one warp takes one (query, lane) and
// sweeps the chunk over the query's rows (rows.cuh), H and E of its rows
// in registers for the whole chunk:
//   * K2 walks every band of the query, laid from its last row up as K3's
//     row form lays them; the rows start fresh at column 0, band k + 1
//     reads band k's planes from a scratch (only queries over 512 rows
//     have two), and no state leaves the chunk.  The band's height is
//     chosen from qlen_pad by the wrapper: 32 threads x 4, 8 or 16 rows,
//     so a 200-row query (qlen_pad 256) walks a 256-row band, not a
//     512-row one of which 61% would be PAD.  TILE_WARPS warps of one
//     query a block share the band's profile, as K5's do;
//   * K5 walks the bands of one 512-row tile of a plain-pack chunk: the
//     rows start fresh at column 0 (as at a start bit), the planes [L] of
//     the pair are the pass's bh/bf (the tile above's bottom row, updated
//     in place), and no row state leaves the chunk.  A long-query slot
//     group holds 4 queries x 1024 lanes, so a block holds TILE_WARPS
//     warps of one query over neighbouring lanes: they share the band's
//     profile, which leaves room for more warps an SM than one-warp
//     blocks, and read neighbouring lanes' db bytes and planes, the same
//     sectors, through one L1;
//   * K6 walks the bands of one 512-row tile of a carry chunk, the tile's
//     rows' H/E read at the chunk's first column and written at its last;
//   * K3's row form walks every band of the query in turn, band k + 1
//     reading band k's planes from a scratch; its flow form does the
//     same in K2's blocks and bands, the rows' H/E read at the chunk's
//     first column and written at its last.
//   The diagonal into band k + 1's top row at column 0 is the carried H of
//   band k's last row, which band k overwrites: thread 31 keeps the value
//   it read and hands it on.
// The dump out[q, b, lane] is the maximum of every thread's S at the end
// of block b.  In K3's row form, K5 and K6 threads reach it at different
// steps, so each thread whose strip has rows stores it with atomicMax
// into the dump (K5's and K6's dumps are max-merged already; the row
// form's wrapper zeroes its dump).  K2 and K3's flow form hand the
// column's running max down the pipeline with H and F instead, and thread
// 31 alone stores it (the first band) or max-merges it (the bands below):
// timed 11% faster at Swiss-Prot's chunk than every thread's atomicMax
// (PERF.md).
// Start bits (lane refill at KSEG): at a block whose start bit is set, a
// thread zeroes its rows' H, sets E to -inf, takes the diagonal from the
// left as 0 and restarts S; what arrives from above is not reset (the
// thread above applied the reset at the same column).
//
// Bound: K2 and K5 by their operations (32,768 pairs of 200 rows over
// 8,192 columns; 4,096 pairs of 512 rows over 16,384), K3's row form and
// K6 by the DP's critical path (a giant launch holds few pairs).  Each
// band takes L + 31 steps of RS cells; the card runs a few warps an SM,
// so a step's latency, not the ALU rate, sets the time.
#include "rows.cuh"

using namespace swipe;

namespace {

// warps of a K5 block (1, 2, 4 and 8 timed at the long routes' shapes:
// 8 was fastest at all three, PERF.md)
constexpr int TILE_WARPS = 8;

// One band of a pair: rows [r0, r1) of the query, at most 32 * RS.
template <typename M>
struct Band {
  const int32_t* qc;          // the query's codes
  const M* m;                 // [32, 32] matrix
  int r0, r1;
  const int8_t* db;           // column 0 of the lane; column stride n
  const int8_t* start;        // block 0 of the lane; block stride n
  long long n;
  int L;
  const int32_t* top_h;       // row r0 - 1 per column, or null: H 0, F -inf
  const int32_t* top_f;
  int32_t* bot_h;             // row r1 - 1 per column, or null: not kept
  int32_t* bot_f;
  int32_t* hst;               // row 0 of the query's state; row stride n
  int32_t* est;
  int32_t* dump;              // block 0 of the pair; block stride n
  bool fresh0;                // block 0 starts fresh (no carry, start bit)
  int Q, R, clamp;
};

// Walk one band over the chunk (all 32 threads of the warp).  In a block
// of one warp it fills the band's profile first; the warps of a larger
// block share one that block_profile filled.  diag0: H of row r0 - 1 at
// column -1; s_in: the running max thread 0 starts from.  Returns the
// thread's S at the last column; `below` gets thread 31's carried H of
// row r1 - 1 as read (the next band's diag0).  PARTIAL: the band has
// fewer than 32 * RS rows (the query's last band, or a short tile).
// CARRY: the rows' H/E come from and go back to the state (K3, K6);
// without, they start fresh (K2, K5).  WARPS: the warps of the block.
// RS: rows a thread.  CHAIN: instead of every thread's atomicMax into the
// dump, each thread hands the column's max over the strips above and its
// own down the pipeline with H and F, and thread 31 alone stores it (the
// band without a top plane) or max-merges it (K2, K3's flow form).
template <typename M, bool CLAMP, bool PARTIAL, bool CARRY, int WARPS,
          int RS = Rows<M>::RS, bool CHAIN = false>
__device__ int walk_band(const Band<M>& b, M* prof, uint8_t* ring,
                         int2* tring, int2* cap, int diag0, int s_in,
                         int& below) {
  const int t = strip_of_thread<WARPS>();
  const long long n = b.n;
  const int row0 = b.r0 + t * RS;
  // the strip's rows of the query: [lo, nr)
  const int lo = max(0, min(RS, -row0));
  const int nr = max(0, min(RS, b.r1 - row0));
  if (WARPS == 1) strip_profile<M, RS>(b.qc, b.m, row0, lo, nr, t, prof);

  int H[RS], E[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    H[i] = 0;
    E[i] = NEG_INF;
    if (CARRY && !b.fresh0 && i >= lo && i < nr) {
      H[i] = b.hst[(long long)(row0 + i) * n];
      E[i] = b.est[(long long)(row0 + i) * n];
    }
  }
  below = H[RS - 1];

  // one window of staged columns, held in registers until it is stored
  int code = 0, th = 0, tf = NEG_INF;
  auto fetch = [&](int c0) {
    const int c = c0 + t;
    if (c < b.L) {
      code = b.db[c * n] & (NSYM - 1);
      if ((c & (KSEG - 1)) == 0 &&
          (b.start[(c / KSEG) * n] != 0 || (c == 0 && b.fresh0)))
        code |= RESET;
      th = b.top_h ? b.top_h[c * n] : 0;
      tf = b.top_f ? b.top_f[c * n] : NEG_INF;
    }
  };
  fetch(0);

  int S = t == 0 ? s_in : 0;
  // H from the row above, this column; before the first column it is the
  // carried H of the row above at column -1, thread 1's diagonal at
  // column 0 (threads t >= 2 receive it by the shuffle at step t - 2;
  // thread 0 takes its own from the staged planes)
  int hin = __shfl_up_sync(FULL, H[RS - 1], 1), fin = NEG_INF;
  int hprev = diag0;                // from the row above, the column before
  int hout = H[RS - 1], fout = NEG_INF;
  int mup = 0, mout = 0;            // CHAIN: the column's max from above
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
      strip_cells<M, CLAMP, PARTIAL, RS>(pr, cap + t, H, E, nr, d, hout,
                                         fout, S, b.Q, b.R, b.clamp);
      if constexpr (CHAIN) {
        mout = max(mup, S);
        if (t == 31 && (j & (KSEG - 1)) == KSEG - 1) {
          int32_t* dump = b.dump + (j / KSEG) * n;
          if (b.top_h == nullptr)
            *dump = mout;
          else
            atomicMax(dump, mout);
        }
      } else if ((j & (KSEG - 1)) == KSEG - 1 && (lo < nr || t == 0)) {
        // thread 0 also holds s_in, on the query's virtual rows too
        atomicMax(b.dump + (j / KSEG) * n, S);
      }
      if (t == 31 && b.bot_h != nullptr) {
        b.bot_h[j * n] = hout;
        b.bot_f[j * n] = fout;
      }
    }
    hprev = hin;
    hin = __shfl_up_sync(FULL, hout, 1);
    fin = __shfl_up_sync(FULL, fout, 1);
    if constexpr (CHAIN) {
      mup = __shfl_up_sync(FULL, mout, 1);
      if (t == 0) mup = 0;
    }
  }
  if (CARRY) {
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      if (i >= lo && i < nr) {
        b.hst[(long long)(row0 + i) * n] = H[i];
        b.est[(long long)(row0 + i) * n] = E[i];
      }
    }
  }
  __syncwarp();      // the planes and state, for the next band
  return S;
}

// S of a pair without rows: the carried value, restarted at start bits;
// its dump max-merged (or, into a zeroed dump, written).
__device__ int no_rows(const int8_t* start, int32_t* dump, long long n,
                       int nblocks, int S) {
  for (int k = 0; k < nblocks; ++k) {
    if (start[k * n] != 0) S = 0;
    dump[k * n] = max(dump[k * n], S);
  }
  return S;
}

// The bands of query rows [r0, r1) of one tile, top down (K5, K6); the
// last one partial where the tile is.  diag0 and s as walk_band's for the
// first band.  In a block of several warps (K5) they share the band's
// profile, and a warp that is not `live` (a lane past the chunk's) only
// joins its barriers.
template <bool CLAMP, bool CARRY, int WARPS>
__device__ __forceinline__ void walk_tile(Band<int8_t>& b, int8_t* prof,
                                          uint8_t* ring, int2* tring,
                                          int2* cap, int r0, int r1,
                                          int diag0, int s, bool live) {
  constexpr int BAND = 32 * Rows<int8_t>::RS;
  for (int r = r0; r < r1; r += BAND) {
    b.r0 = r;
    b.r1 = min(r + BAND, r1);
    if (WARPS > 1) {
      block_profile<WARPS>(b.qc, b.m, b.r0, b.r1, prof);
      if (!live) continue;
    }
    int below;
    if (b.r1 - b.r0 == BAND)
      walk_band<int8_t, CLAMP, false, CARRY, WARPS>(b, prof, ring, tring,
                                                    cap, diag0, s, below);
    else
      walk_band<int8_t, CLAMP, true, CARRY, WARPS>(b, prof, ring, tring, cap,
                                                   diag0, s, below);
    diag0 = __shfl_sync(FULL, below, 31);
    s = 0;
  }
}

// K5: the bands of query rows [tile * tile_rows, + tile_rows), TILE_WARPS
// lanes of one query a block.
template <bool CLAMP>
__global__ void __launch_bounds__(32 * TILE_WARPS)
tile_kernel(const int32_t* __restrict__ qcodes,
            const int32_t* __restrict__ qlens,
            const int8_t* __restrict__ m8, const int8_t* __restrict__ db,
            const int8_t* __restrict__ start, int32_t* out, int32_t* bh,
            int32_t* bf, int tile, int tile_rows, int qlen_pad, int nblocks,
            int nseqs, int Q, int R, int clamp) {
  int8_t* prof;
  int2 *tring, *cap;
  uint8_t* ring;
  carve<TILE_WARPS>(prof, tring, cap, ring);
  const int lane = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
  const int q = blockIdx.y;
  const long long n = nseqs;
  const int L = nblocks * KSEG;
  const int r0 = tile * tile_rows;
  const int r1 = min(min(qlens[q], qlen_pad), r0 + tile_rows);
  // no rows (the whole block: one query): the planes pass through and
  // the dump keeps its value
  if (r1 <= r0) return;
  const long long plane = (long long)q * L * n + lane;
  Band<int8_t> b{qcodes + (long long)q * qlen_pad, m8, 0, 0, db + lane,
                 start + lane, n, L, bh + plane, bf + plane, bh + plane,
                 bf + plane, nullptr, nullptr,
                 out + (long long)q * nblocks * n + lane, true, Q, R, clamp};
  walk_tile<CLAMP, false, TILE_WARPS>(b, prof, ring, tring, cap, r0, r1, 0,
                                      0, lane < nseqs);
}

// K6: the bands of query rows [tile * tile_rows, + tile_rows).
template <bool CLAMP>
__global__ void __launch_bounds__(32)
tile_carry_kernel(const int32_t* __restrict__ qcodes,
                  const int32_t* __restrict__ qlens,
                  const int8_t* __restrict__ m8,
                  const int8_t* __restrict__ db,
                  const int8_t* __restrict__ start, int32_t* out,
                  int32_t* bh, int32_t* bf, int32_t* hst, int32_t* est,
                  const int32_t* __restrict__ s_in,
                  const int32_t* __restrict__ bh0c, int tile, int tile_rows,
                  int qlen_pad, int nblocks, int nseqs, int Q, int R,
                  int clamp) {
  int8_t* prof;
  int2 *tring, *cap;
  uint8_t* ring;
  carve<1>(prof, tring, cap, ring);
  const int lane = blockIdx.x, q = blockIdx.y;
  const long long n = nseqs;
  const int L = nblocks * KSEG;
  const int r0 = tile * tile_rows;
  const int r1 = min(min(qlens[q], qlen_pad), r0 + tile_rows);
  int32_t* dump = out + (long long)q * nblocks * n + lane;
  const int s = tile == 0 ? s_in[q * n + lane] : 0;
  if (r1 <= r0) {          // no rows: the planes pass through
    if (tile == 0 && threadIdx.x == 0) no_rows(start + lane, dump, n,
                                               nblocks, s);
    return;
  }
  const long long plane = (long long)q * L * n + lane;
  const long long srow = (long long)q * qlen_pad * n + lane;
  Band<int8_t> b{qcodes + (long long)q * qlen_pad, m8, 0, 0, db + lane,
                 start + lane, n, L, bh + plane, bf + plane, bh + plane,
                 bf + plane, hst + srow, est + srow, dump, start[lane] != 0,
                 Q, R, clamp};
  const int diag0 =
      bh0c[((long long)q * (qlen_pad / tile_rows + 1) + tile) * n + lane];
  walk_tile<CLAMP, true, 1>(b, prof, ring, tring, cap, r0, r1, diag0, s,
                            true);
}

// K3's row form: every band of the query, in turn.  The bands are laid
// from the query's last row up, so every band is whole: the first one
// starts above row 0 with virtual rows, which score as PAD against a zero
// row above and so stay at H = 0 and hand row 0 exactly what the row
// above the query would (H = 0; an F of at most -Q, which never beats
// the H >= 0 it meets).
template <typename M, bool CLAMP>
__global__ void __launch_bounds__(32)
carry_rows_kernel(const int32_t* __restrict__ qcodes,
                  const int32_t* __restrict__ qlens,
                  const M* __restrict__ m, const int8_t* __restrict__ db,
                  const int8_t* __restrict__ start, int32_t* out,
                  int32_t* hst, int32_t* est, int32_t* s_io, int32_t* bh,
                  int32_t* bf, int carry_in, int qlen_pad, int nblocks,
                  int nseqs, int Q, int R, int clamp) {
  M* prof;
  int2 *tring, *cap;
  uint8_t* ring;
  carve<1>(prof, tring, cap, ring);
  const int lane = blockIdx.x, q = blockIdx.y;
  const long long n = nseqs;
  const int L = nblocks * KSEG;
  const int qlen = min(qlens[q], qlen_pad);
  int32_t* dump = out + (long long)q * nblocks * n + lane;
  int s = carry_in ? s_io[q * n + lane] : 0;
  if (qlen == 0) {
    if (threadIdx.x == 0)
      s_io[q * n + lane] = no_rows(start + lane, dump, n, nblocks, s);
    return;
  }
  const int32_t* qc = qcodes + (long long)q * qlen_pad;
  const long long plane = (long long)q * L * n + lane;
  const long long srow = (long long)q * qlen_pad * n + lane;
  Band<M> b{qc, m, 0, 0, db + lane, start + lane, n, L, nullptr, nullptr,
            nullptr, nullptr, hst + srow, est + srow, dump,
            !carry_in || start[lane] != 0, Q, R, clamp};
  constexpr int BAND = 32 * Rows<M>::RS;
  int diag0 = 0, sfin = 0;
  for (int r1 = qlen - (qlen - 1) / BAND * BAND; r1 <= qlen; r1 += BAND) {
    b.r0 = r1 - BAND;
    b.r1 = r1;
    const bool last = r1 == qlen;
    b.bot_h = last ? nullptr : bh + plane;
    b.bot_f = last ? nullptr : bf + plane;
    int below;
    sfin = max(sfin, walk_band<M, CLAMP, false, true, 1>(
                         b, prof, ring, tring, cap, diag0, s, below));
    diag0 = __shfl_sync(FULL, below, 31);
    s = 0;
    b.top_h = bh + plane;
    b.top_f = bf + plane;
  }
  sfin = __reduce_max_sync(FULL, sfin);
  if (threadIdx.x == 0) s_io[q * n + lane] = sfin;
}

// K2: every band of the query, laid from its last row up as K3's row form
// lays them (whole bands, virtual rows above row 0), TILE_WARPS lanes of
// one query a block sharing the band's profile of 32 * RS rows; rows
// fresh at column 0 and at start bits; no state.  bh/bf: the planes
// between bands, [nq, L, nseqs] (null when no query has more than one
// band).  The dump is zeroed by the caller.
template <int RS, bool CLAMP>
__global__ void __launch_bounds__(32 * TILE_WARPS)
stream_rows_kernel(const int32_t* __restrict__ qcodes,
                   const int32_t* __restrict__ qlens,
                   const int8_t* __restrict__ m8,
                   const int8_t* __restrict__ db,
                   const int8_t* __restrict__ start, int32_t* out,
                   int32_t* bh, int32_t* bf, int qlen_pad, int nblocks,
                   int nseqs, int Q, int R, int clamp) {
  int8_t* prof;
  int2 *tring, *cap;
  uint8_t* ring;
  carve<TILE_WARPS, int8_t, RS>(prof, tring, cap, ring);
  const int lane = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
  const int q = blockIdx.y;
  const long long n = nseqs;
  const int L = nblocks * KSEG;
  const int qlen = min(qlens[q], qlen_pad);
  // no rows (the whole block: one query): the dump stays 0
  if (qlen == 0) return;
  const int32_t* qc = qcodes + (long long)q * qlen_pad;
  const long long plane = (long long)q * L * n + lane;
  Band<int8_t> b{qc, m8, 0, 0, db + lane, start + lane, n, L, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr,
                 out + (long long)q * nblocks * n + lane, true, Q, R,
                 clamp};
  constexpr int BAND = 32 * RS;
  for (int r1 = qlen - (qlen - 1) / BAND * BAND; r1 <= qlen; r1 += BAND) {
    b.r0 = r1 - BAND;
    b.r1 = r1;
    const bool last = r1 == qlen;
    b.bot_h = last ? nullptr : bh + plane;
    b.bot_f = last ? nullptr : bf + plane;
    block_profile<TILE_WARPS, int8_t, RS>(qc, m8, b.r0, b.r1, prof);
    if (lane < nseqs) {
      int below;
      walk_band<int8_t, CLAMP, false, false, TILE_WARPS, RS, true>(
          b, prof, ring, tring, cap, 0, 0, below);
    }
    b.top_h = bh + plane;
    b.top_f = bf + plane;
  }
}

// K3's flow form: K2's blocks and bands with the state carried, as K3's
// row form carries it.  TILE_WARPS lanes of one query a block share the
// band's profile of 32 * RS rows; the bands are laid from the query's end
// (whole, virtual rows above row 0); each band's rows are read from the
// state at column 0 and written back at the last column, and thread 0 of
// the first band starts from the carried S.  bh/bf: the planes between
// bands, [nq, L, nseqs] (null when no query has more than one band).  The
// dump is handed down the pipeline as K2's (timed 4-8% faster than every
// thread's atomicMax at the proteome's flow shapes, PERF.md) and zeroed
// by the caller (a pair without rows max-merges into it).  At least 3
// blocks an SM: left free, ptxas gave the 256-row band 128 registers (2
// blocks an SM, K2 takes 64); capped at 85 it takes 69-80 without spills
// and the flow chunk and its drains ran 9-12% faster (4 blocks, 64
// registers, spilled at 512-row bands; PERF.md).
template <int RS, bool CLAMP>
__global__ void __launch_bounds__(32 * TILE_WARPS, 3)
flow_rows_kernel(const int32_t* __restrict__ qcodes,
                 const int32_t* __restrict__ qlens,
                 const int8_t* __restrict__ m8, const int8_t* __restrict__ db,
                 const int8_t* __restrict__ start, int32_t* out,
                 int32_t* hst, int32_t* est, int32_t* s_io, int32_t* bh,
                 int32_t* bf, int carry_in, int qlen_pad, int nblocks,
                 int nseqs, int Q, int R, int clamp) {
  int8_t* prof;
  int2 *tring, *cap;
  uint8_t* ring;
  carve<TILE_WARPS, int8_t, RS>(prof, tring, cap, ring);
  const int lane = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
  const int q = blockIdx.y;
  // a warp past the chunk's lanes only joins the block's barriers
  const bool live = lane < nseqs;
  const long long n = nseqs;
  const int L = nblocks * KSEG;
  const int qlen = min(qlens[q], qlen_pad);
  int32_t* dump = out + (long long)q * nblocks * n + lane;
  int s = carry_in && live ? s_io[q * n + lane] : 0;
  // no rows (the whole block: one query): S still goes through the blocks
  if (qlen == 0) {
    if (live && (threadIdx.x & 31) == 0)
      s_io[q * n + lane] = no_rows(start + lane, dump, n, nblocks, s);
    return;
  }
  const int32_t* qc = qcodes + (long long)q * qlen_pad;
  const long long plane = (long long)q * L * n + lane;
  const long long srow = (long long)q * qlen_pad * n + lane;
  Band<int8_t> b{qc, m8, 0, 0, db + lane, start + lane, n, L, nullptr,
                 nullptr, nullptr, nullptr, hst + srow, est + srow, dump,
                 !carry_in || (live && start[lane] != 0), Q, R, clamp};
  constexpr int BAND = 32 * RS;
  int diag0 = 0, sfin = 0;
  for (int r1 = qlen - (qlen - 1) / BAND * BAND; r1 <= qlen; r1 += BAND) {
    b.r0 = r1 - BAND;
    b.r1 = r1;
    const bool last = r1 == qlen;
    b.bot_h = last ? nullptr : bh + plane;
    b.bot_f = last ? nullptr : bf + plane;
    block_profile<TILE_WARPS, int8_t, RS>(qc, m8, b.r0, b.r1, prof);
    if (live) {
      int below;
      sfin = max(sfin,
                 walk_band<int8_t, CLAMP, false, true, TILE_WARPS, RS, true>(
                     b, prof, ring, tring, cap, diag0, s, below));
      diag0 = __shfl_sync(FULL, below, 31);
    }
    s = 0;
    b.top_h = bh + plane;
    b.top_f = bf + plane;
  }
  if (live) {
    sfin = __reduce_max_sync(FULL, sfin);
    if ((threadIdx.x & 31) == 0) s_io[q * n + lane] = sfin;
  }
}

template <int RS, bool CLAMP>
int launch_flow(dim3 grid, cudaStream_t st, const int32_t* qcodes,
                const int32_t* qlens, const int8_t* m8, const int8_t* db,
                const int8_t* start, int32_t* out, int32_t* hst,
                int32_t* est, int32_t* s_io, int32_t* bh, int32_t* bf,
                int carry_in, int qlen_pad, int nblocks, int nseqs, int Q,
                int R, int clamp) {
  const size_t smem = smem_bytes<int8_t, RS>(TILE_WARPS);
  const auto kernel = flow_rows_kernel<RS, CLAMP>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * TILE_WARPS, smem, st>>>(
      qcodes, qlens, m8, db, start, out, hst, est, s_io, bh, bf, carry_in,
      qlen_pad, nblocks, nseqs, Q, R, clamp);
  return (int)cudaGetLastError();
}

template <int RS, bool CLAMP>
int launch_stream(dim3 grid, cudaStream_t st, const int32_t* qcodes,
                  const int32_t* qlens, const int8_t* m8, const int8_t* db,
                  const int8_t* start, int32_t* out, int32_t* bh,
                  int32_t* bf, int qlen_pad, int nblocks, int nseqs, int Q,
                  int R, int clamp) {
  const size_t smem = smem_bytes<int8_t, RS>(TILE_WARPS);
  const auto kernel = stream_rows_kernel<RS, CLAMP>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * TILE_WARPS, smem, st>>>(qcodes, qlens, m8, db, start,
                                              out, bh, bf, qlen_pad, nblocks,
                                              nseqs, Q, R, clamp);
  return (int)cudaGetLastError();
}

template <typename M, bool CLAMP>
int launch_rows(dim3 grid, cudaStream_t st, const int32_t* qcodes,
                const int32_t* qlens, const M* m, const int8_t* db,
                const int8_t* start, int32_t* out, int32_t* hst,
                int32_t* est, int32_t* s_io, int32_t* bh, int32_t* bf,
                int carry_in, int qlen_pad, int nblocks, int nseqs, int Q,
                int R, int clamp) {
  const size_t smem = smem_bytes<M>(1);
  const cudaError_t err = allow_smem(carry_rows_kernel<M, CLAMP>, smem);
  if (err != cudaSuccess) return (int)err;
  carry_rows_kernel<M, CLAMP><<<grid, 32, smem, st>>>(
      qcodes, qlens, m, db, start, out, hst, est, s_io, bh, bf, carry_in,
      qlen_pad, nblocks, nseqs, Q, R, clamp);
  return (int)cudaGetLastError();
}

template <bool CLAMP>
int launch_tile(dim3 grid, cudaStream_t st, const int32_t* qcodes,
                const int32_t* qlens, const int8_t* m8, const int8_t* db,
                const int8_t* start, int32_t* out, int32_t* bh, int32_t* bf,
                int tile, int tile_rows, int qlen_pad, int nblocks,
                int nseqs, int Q, int R, int clamp) {
  const size_t smem = smem_bytes<int8_t>(TILE_WARPS);
  const cudaError_t err = allow_smem(tile_kernel<CLAMP>, smem);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<CLAMP><<<grid, 32 * TILE_WARPS, smem, st>>>(
      qcodes, qlens, m8, db, start, out, bh, bf, tile, tile_rows, qlen_pad,
      nblocks, nseqs, Q, R, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: out/bh/bf updated in place (bh/bf [nq, L, nseqs], out [nq, nblocks,
// nseqs] max-merged).  Needs Q >= R.
extern "C" int swipe_stream_tile(const int32_t* qcodes, const int32_t* qlens,
                                 const int8_t* m8, const int8_t* db,
                                 const int8_t* start, int32_t* out,
                                 int32_t* bh, int32_t* bf, int tile,
                                 int tile_rows, int nq, int qlen_pad,
                                 int nblocks, int nseqs, int Q, int R,
                                 int use_clamp, int clamp, void* stream) {
  if (Q < R) return (int)cudaErrorInvalidValue;
  if (nq <= 0 || nseqs <= 0 || nblocks <= 0 || tile_rows <= 0)
    return (int)cudaGetLastError();
  const dim3 grid((nseqs + TILE_WARPS - 1) / TILE_WARPS, nq);
  const cudaStream_t st = (cudaStream_t)stream;
  if (use_clamp)
    return launch_tile<true>(grid, st, qcodes, qlens, m8, db, start, out, bh,
                             bf, tile, tile_rows, qlen_pad, nblocks, nseqs,
                             Q, R, clamp);
  return launch_tile<false>(grid, st, qcodes, qlens, m8, db, start, out, bh,
                            bf, tile, tile_rows, qlen_pad, nblocks, nseqs, Q,
                            R, clamp);
}

// K6: out/bh/bf updated in place (bh/bf [nq, L, nseqs], out [nq, nblocks,
// nseqs] max-merged); hst/est the series' [nq, qlen_pad, nseqs] state,
// updated in place; s_in [nq, nseqs] and bh0c [nq, qlen_pad / tile_rows
// + 1, nseqs] read.  Needs Q >= R.
extern "C" int swipe_stream_tile_carry(
    const int32_t* qcodes, const int32_t* qlens, const int8_t* m8,
    const int8_t* db, const int8_t* start, int32_t* out, int32_t* bh,
    int32_t* bf, int32_t* hst, int32_t* est, const int32_t* s_in,
    const int32_t* bh0c, int tile, int tile_rows, int nq, int qlen_pad,
    int nblocks, int nseqs, int Q, int R, int use_clamp, int clamp,
    void* stream) {
  if (Q < R) return (int)cudaErrorInvalidValue;
  if (nq > 0 && nseqs > 0 && nblocks > 0 && tile_rows > 0) {
    const dim3 grid(nseqs, nq);
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = smem_bytes<int8_t>(1);
    if (use_clamp) {
      const cudaError_t err = allow_smem(tile_carry_kernel<true>, smem);
      if (err != cudaSuccess) return (int)err;
      tile_carry_kernel<true><<<grid, 32, smem, st>>>(
          qcodes, qlens, m8, db, start, out, bh, bf, hst, est, s_in, bh0c,
          tile, tile_rows, qlen_pad, nblocks, nseqs, Q, R, clamp);
    } else {
      const cudaError_t err = allow_smem(tile_carry_kernel<false>, smem);
      if (err != cudaSuccess) return (int)err;
      tile_carry_kernel<false><<<grid, 32, smem, st>>>(
          qcodes, qlens, m8, db, start, out, bh, bf, hst, est, s_in, bh0c,
          tile, tile_rows, qlen_pad, nblocks, nseqs, Q, R, clamp);
    }
  }
  return (int)cudaGetLastError();
}

// K3's row form: out [nq, nblocks, nseqs] zeroed by the caller; hst/est
// [nq, qlen_pad, nseqs] and s_io [nq, nseqs] the carried state, updated in
// place (with carry_in 0 not read); bh/bf [nq, L, nseqs] a scratch for the
// planes between bands (null when no query has more than one band).  m
// is the int8 matrix, or with wide set the int32 one (no clamp).  Needs
// Q >= R.
extern "C" int swipe_carry_rows(
    const int32_t* qcodes, const int32_t* qlens, const void* m,
    const int8_t* db, const int8_t* start, int32_t* out, int32_t* hst,
    int32_t* est, int32_t* s_io, int32_t* bh, int32_t* bf, int carry_in,
    int wide, int nq, int qlen_pad, int nblocks, int nseqs, int Q, int R,
    int use_clamp, int clamp, void* stream) {
  if (Q < R || (wide && use_clamp)) return (int)cudaErrorInvalidValue;
  const int band = 32 * (wide ? Rows<int32_t>::RS : Rows<int8_t>::RS);
  if (qlen_pad > band && bh == nullptr) return (int)cudaErrorInvalidValue;
  if (nq <= 0 || nseqs <= 0 || nblocks <= 0) return (int)cudaGetLastError();
  const dim3 grid(nseqs, nq);
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch_rows<int32_t, false>(
        grid, st, qcodes, qlens, (const int32_t*)m, db, start, out, hst, est,
        s_io, bh, bf, carry_in, qlen_pad, nblocks, nseqs, Q, R, clamp);
  if (use_clamp)
    return launch_rows<int8_t, true>(
        grid, st, qcodes, qlens, (const int8_t*)m, db, start, out, hst, est,
        s_io, bh, bf, carry_in, qlen_pad, nblocks, nseqs, Q, R, clamp);
  return launch_rows<int8_t, false>(
      grid, st, qcodes, qlens, (const int8_t*)m, db, start, out, hst, est,
      s_io, bh, bf, carry_in, qlen_pad, nblocks, nseqs, Q, R, clamp);
}

// K2: out [nq, nblocks, nseqs] zeroed by the caller; rs the rows a
// thread (4, 8 or 16: bands of 128, 256 or 512 rows); bh/bf [nq, L,
// nseqs] a scratch for the planes between bands (null when qlen_pad fits
// one band).  Needs Q >= R.
extern "C" int swipe_stream_rows(const int32_t* qcodes, const int32_t* qlens,
                                 const int8_t* m8, const int8_t* db,
                                 const int8_t* start, int32_t* out,
                                 int32_t* bh, int32_t* bf, int nq,
                                 int qlen_pad, int nblocks, int nseqs, int Q,
                                 int R, int rs, int use_clamp, int clamp,
                                 void* stream) {
  if (Q < R || (rs != 4 && rs != 8 && rs != 16))
    return (int)cudaErrorInvalidValue;
  if (qlen_pad > 32 * rs && bh == nullptr) return (int)cudaErrorInvalidValue;
  if (nq <= 0 || nseqs <= 0 || nblocks <= 0) return (int)cudaGetLastError();
  const dim3 grid((nseqs + TILE_WARPS - 1) / TILE_WARPS, nq);
  const cudaStream_t st = (cudaStream_t)stream;
#define STREAM_RS(RS)                                                     \
  if (rs == RS)                                                           \
    return use_clamp                                                      \
               ? launch_stream<RS, true>(grid, st, qcodes, qlens, m8, db, \
                                         start, out, bh, bf, qlen_pad,    \
                                         nblocks, nseqs, Q, R, clamp)     \
               : launch_stream<RS, false>(grid, st, qcodes, qlens, m8,    \
                                          db, start, out, bh, bf,         \
                                          qlen_pad, nblocks, nseqs, Q, R, \
                                          clamp);
  STREAM_RS(4)
  STREAM_RS(8)
  STREAM_RS(16)
#undef STREAM_RS
  return (int)cudaErrorInvalidValue;
}

// K3's flow form: out [nq, nblocks, nseqs] zeroed by the caller; hst/est
// [nq, qlen_pad, nseqs] and s_io [nq, nseqs] the carried state, updated in
// place (with carry_in 0 not read); rs the rows a thread (4, 8 or 16:
// bands of 128, 256 or 512 rows); bh/bf [nq, L, nseqs] a scratch for the
// planes between bands (null when qlen_pad fits one band).  The int8
// matrix only.  Needs Q >= R.
extern "C" int swipe_carry_flow(
    const int32_t* qcodes, const int32_t* qlens, const int8_t* m8,
    const int8_t* db, const int8_t* start, int32_t* out, int32_t* hst,
    int32_t* est, int32_t* s_io, int32_t* bh, int32_t* bf, int carry_in,
    int nq, int qlen_pad, int nblocks, int nseqs, int Q, int R, int rs,
    int use_clamp, int clamp, void* stream) {
  if (Q < R || (rs != 4 && rs != 8 && rs != 16))
    return (int)cudaErrorInvalidValue;
  if (qlen_pad > 32 * rs && bh == nullptr) return (int)cudaErrorInvalidValue;
  if (nq <= 0 || nseqs <= 0 || nblocks <= 0) return (int)cudaGetLastError();
  const dim3 grid((nseqs + TILE_WARPS - 1) / TILE_WARPS, nq);
  const cudaStream_t st = (cudaStream_t)stream;
#define FLOW_LAUNCH(RS, CLAMP)                                              \
  launch_flow<RS, CLAMP>(grid, st, qcodes, qlens, m8, db, start, out, hst,  \
                         est, s_io, bh, bf, carry_in, qlen_pad, nblocks,    \
                         nseqs, Q, R, clamp)
#define FLOW_RS(RS)                                                         \
  if (rs == RS)                                                             \
    return use_clamp ? FLOW_LAUNCH(RS, true) : FLOW_LAUNCH(RS, false);
  FLOW_RS(4)
  FLOW_RS(8)
  FLOW_RS(16)
#undef FLOW_RS
#undef FLOW_LAUNCH
  return (int)cudaErrorInvalidValue;
}
