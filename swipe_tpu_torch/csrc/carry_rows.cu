// Carry-series scoring with a query's rows spread over a warp: the tile
// carry pass (K6) and the row form of the carry kernel (K3).
//
// Replaces the TPU kernels swipe_tpu/ops/sw_stream.py
// _stream_tile_carry_pass (:1419, _stream_tile_carry_kernel, driven by
// sw_scores_stream_carry_long) and sw_scores_stream_carry (:733) in its
// launches without block profiles: the giant carry series
// (pack_stream_carry), whose state is the chromosomes' compact lane count
// rounded to a warp, so a launch holds a few hundred (query, lane) pairs,
// most of them PAD.  The flow series' launches, which read block
// profiles, keep the lane form (stream.cu); ops/sw_stream.py carry_form
// picks the form.
//
// Why a warp per pair.  One thread per pair (stream.cu, the old K6) walks
// a chromosome lane's whole chain: two to sixteen real pairs left 130 of
// the 132 SMs idle and every cell paid its dependent chain and a global
// round trip of the row state.  Here one warp takes one (query, lane) and
// sweeps the chunk as a systolic pipeline over the query's rows:
//   * a band is 32 * RS consecutive query rows; thread t owns a strip of
//     RS rows, their H and pre-advanced E in registers for the whole walk
//     (read once at the chunk's first column, written once at its last);
//   * at step s thread t computes column s - t: F runs down its strip,
//     and it hands its bottom row's H and F to thread t + 1 with
//     __shfl_up_sync; H that arrived one step earlier is the diagonal
//     into its top row;
//   * row -1 of a band comes from two planes [L] of the pair (the row
//     above's H and its F advanced into the band), staged through shared
//     memory with the db symbols; thread 31 writes the band's bottom row
//     back to the planes.  Threads whose strip lies past the query's last
//     row only relay, so the planes hold the last real row;
//   * K6 walks the bands of one 512-row tile (the planes are the pass's
//     bh/bf, updated in place); K3's row form walks every band of the
//     query in turn, band k + 1 reading band k's planes from a scratch.
//     The diagonal into band k + 1's top row at column 0 is the carried H
//     of band k's last row, which band k overwrites: thread 31 keeps the
//     value it read and hands it on.
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
// db symbols, start bits and the planes are staged 32 columns at a time,
// one window ahead of the pipeline, through a 64-column ring.
// The dump out[q, b, lane] is the maximum of every thread's S at the end
// of block b; threads reach it at different steps, so each thread whose
// strip has rows stores it with atomicMax into the dump (K6's dump is
// max-merged already; the row form's wrapper zeroes its dump).
// Start bits (lane refill at KSEG): at a block whose start bit is set, a
// thread zeroes its rows' H, sets E to -inf, takes the diagonal from the
// left as 0 and restarts S; what arrives from above is not reset (the
// thread above applied the reset at the same column).
//
// Bound: the DP's critical path.  A giant launch holds few pairs, so
// neither the bytes nor the ALU rate bind; each band takes L + 31 steps
// of RS cells, and the card runs one to four warps an SM.
#include "sw_common.cuh"

using namespace swipe;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WIN = 32;            // columns staged at a time
constexpr int RING = 2 * WIN;      // staged columns
constexpr int RESET = 32;          // ring code bit: a start bit at this column

// rows a thread, by matrix element type (chosen by timing 8, 16 and 32;
// ops/sw_stream.py ROW_BANDS mirrors the band heights, 32 * RS)
template <typename M> struct Rows;
template <> struct Rows<int8_t> { static constexpr int RS = 16; };
template <> struct Rows<int32_t> { static constexpr int RS = 8; };

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

// The strip's RS cells of one column, every row computed: rows outside
// the query score as PAD (past its end; virtual rows above its start, see
// carry_rows_kernel), so they never raise S above a real cell and their
// state is neither read nor written.  In three passes over the strip:
// every row's H without F (the rows independent), then F down the strip
// (the only chain: one instruction a row), then H, E and S off it.
// (hout, fout) come in as
// the row above's and go out as the bottom real row's: row RS - 1, or
// with PARTIAL row nr - 1 (none: a relay passes them on), picked from a
// shared-memory copy of every row's (H, F) -- the same pick made with a
// predicated select in the unrolled loop gave wrong results at RS = 16
// on the card unless ptxas ran at -O0 (not understood).  Predicating each
// row on being the query's instead of computing it was slower.
template <typename M, bool CLAMP, bool PARTIAL>
__device__ __forceinline__ void strip_cells(
    const M* __restrict__ pr, int2* cap, int (&H)[Rows<M>::RS],
    int (&E)[Rows<M>::RS], int nr, int d, int& hout, int& fout, int& S,
    int Q, int R, int clamp) {
  constexpr int RS = Rows<M>::RS;
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

// Walk one band over the chunk (all 32 threads).  diag0: H of row r0 - 1
// at column -1; s_in: the running max thread 0 starts from.  Returns the
// thread's S at the last column; `below` gets thread 31's carried H of
// row r1 - 1 as read (the next band's diag0).  PARTIAL: the band has
// fewer than 32 * RS rows (the query's last band, or a short tile).
template <typename M, bool CLAMP, bool PARTIAL>
__device__ int walk_band(const Band<M>& b, M* prof, uint8_t* ring,
                         int2* tring, int2* cap, int diag0, int s_in,
                         int& below) {
  constexpr int RS = Rows<M>::RS;
  const int t = threadIdx.x;
  const long long n = b.n;
  const int row0 = b.r0 + t * RS;
  // the strip's rows of the query: [lo, nr)
  const int lo = max(0, min(RS, -row0));
  const int nr = max(0, min(RS, b.r1 - row0));

  // the band's profile: prof[(sym * RS + i) * 32 + t], the PAD row's
  // scores outside the query
  __syncwarp();
  for (int i = 0; i < RS; ++i) {
    const bool real = i >= lo && i < nr;
    const M* mrow =
        b.m + (real ? b.qc[row0 + i] & (NSYM - 1) : PAD_SYMBOL) * NSYM;
    for (int sym = 0; sym < NSYM; ++sym)
      prof[(sym * RS + i) * 32 + t] = mrow[sym];
  }
  int H[RS], E[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    H[i] = 0;
    E[i] = NEG_INF;
    if (!b.fresh0 && i >= lo && i < nr) {
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
      strip_cells<M, CLAMP, PARTIAL>(pr, cap + t, H, E, nr, d, hout, fout,
                                     S, b.Q, b.R, b.clamp);
      // thread 0 also holds s_in, on the query's virtual rows too
      if ((j & (KSEG - 1)) == KSEG - 1 && (lo < nr || t == 0))
        atomicMax(b.dump + (j / KSEG) * n, S);
      if (t == 31 && b.bot_h != nullptr) {
        b.bot_h[j * n] = hout;
        b.bot_f[j * n] = fout;
      }
    }
    hprev = hin;
    hin = __shfl_up_sync(FULL, hout, 1);
    fin = __shfl_up_sync(FULL, fout, 1);
  }
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    if (i >= lo && i < nr) {
      b.hst[(long long)(row0 + i) * n] = H[i];
      b.est[(long long)(row0 + i) * n] = E[i];
    }
  }
  __syncwarp();      // the planes and state, for the next band
  return S;
}

// shared memory of a block: the staged planes (int2 [RING]), the rows'
// (H, F) of a partial band (int2 [RS][32]), the staged symbols (uint8
// [RING]) and the profile (M [NSYM][RS][32])
template <typename M>
constexpr size_t smem_bytes() {
  return sizeof(int2) * (RING + Rows<M>::RS * 32) + RING +
         sizeof(M) * NSYM * Rows<M>::RS * 32;
}

template <typename M>
__device__ void carve(M*& prof, int2*& tring, int2*& cap, uint8_t*& ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  tring = reinterpret_cast<int2*>(smem);
  cap = tring + RING;
  ring = reinterpret_cast<uint8_t*>(cap + Rows<M>::RS * 32);
  prof = reinterpret_cast<M*>(ring + RING);
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
  carve(prof, tring, cap, ring);
  const int lane = blockIdx.x, q = blockIdx.y;
  const long long n = nseqs;
  const int L = nblocks * KSEG;
  const int r0 = tile * tile_rows;
  const int r1 = min(min(qlens[q], qlen_pad), r0 + tile_rows);
  int32_t* dump = out + (long long)q * nblocks * n + lane;
  int s = tile == 0 ? s_in[q * n + lane] : 0;
  if (r1 <= r0) {          // no rows: the planes pass through
    if (tile == 0 && threadIdx.x == 0) no_rows(start + lane, dump, n,
                                               nblocks, s);
    return;
  }
  const long long plane = (long long)q * L * n + lane;
  const long long srow = (long long)q * qlen_pad * n + lane;
  Band<int8_t> b{qcodes + (long long)q * qlen_pad, m8, 0, 0, db + lane,
                 start + lane, n, L, bh + plane, bf + plane, bh + plane,
                 bf + plane, hst + srow, est + srow, dump,
                 start[lane] != 0, Q, R, clamp};
  int diag0 = bh0c[((long long)q * (qlen_pad / tile_rows + 1) + tile) * n
                   + lane];
  constexpr int BAND = 32 * Rows<int8_t>::RS;
  for (int r = r0; r < r1; r += BAND) {
    b.r0 = r;
    b.r1 = min(r + BAND, r1);
    int below;
    if (b.r1 - b.r0 == BAND)
      walk_band<int8_t, CLAMP, false>(b, prof, ring, tring, cap, diag0, s,
                                      below);
    else
      walk_band<int8_t, CLAMP, true>(b, prof, ring, tring, cap, diag0, s,
                                     below);
    diag0 = __shfl_sync(FULL, below, 31);
    s = 0;
  }
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
  carve(prof, tring, cap, ring);
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
  const long long plane = (long long)q * L * n + lane;
  const long long srow = (long long)q * qlen_pad * n + lane;
  Band<M> b{qcodes + (long long)q * qlen_pad, m, 0, 0, db + lane,
            start + lane, n, L, nullptr, nullptr, nullptr, nullptr,
            hst + srow, est + srow, dump, !carry_in || start[lane] != 0,
            Q, R, clamp};
  constexpr int BAND = 32 * Rows<M>::RS;
  int diag0 = 0, sfin = 0;
  for (int r1 = qlen - (qlen - 1) / BAND * BAND; r1 <= qlen; r1 += BAND) {
    b.r0 = r1 - BAND;
    b.r1 = r1;
    const bool last = r1 == qlen;
    b.bot_h = last ? nullptr : bh + plane;
    b.bot_f = last ? nullptr : bf + plane;
    int below;
    sfin = max(sfin, walk_band<M, CLAMP, false>(b, prof, ring, tring, cap,
                                                diag0, s, below));
    diag0 = __shfl_sync(FULL, below, 31);
    s = 0;
    b.top_h = bh + plane;
    b.top_f = bf + plane;
  }
  sfin = __reduce_max_sync(FULL, sfin);
  if (threadIdx.x == 0) s_io[q * n + lane] = sfin;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)
             : cudaSuccess;
}

template <typename M, bool CLAMP>
int launch_rows(dim3 grid, cudaStream_t st, const int32_t* qcodes,
                const int32_t* qlens, const M* m, const int8_t* db,
                const int8_t* start, int32_t* out, int32_t* hst,
                int32_t* est, int32_t* s_io, int32_t* bh, int32_t* bf,
                int carry_in, int qlen_pad, int nblocks, int nseqs, int Q,
                int R, int clamp) {
  const size_t smem = smem_bytes<M>();
  const cudaError_t err = allow_smem(carry_rows_kernel<M, CLAMP>, smem);
  if (err != cudaSuccess) return (int)err;
  carry_rows_kernel<M, CLAMP><<<grid, 32, smem, st>>>(
      qcodes, qlens, m, db, start, out, hst, est, s_io, bh, bf, carry_in,
      qlen_pad, nblocks, nseqs, Q, R, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

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
    const size_t smem = smem_bytes<int8_t>();
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
