// Alignment-endpoint hints (K4), the search16s analog, with a query's rows
// spread over a warp.
//
// Replaces the TPU kernel swipe_tpu/ops/sw_stream.py sw_hint_stream
// (:990, _hint_kernel).  The stream recurrence over one query and one
// subject per lane (no refill), plus endpoint tracking with the
// reference's tie rules:
//   * per column, the max H over the query rows and the SMALLEST row
//     attaining it (strictly greater updates, rows < qlen only);
//   * columns fold in ascending order into (S, bestq, bestpos), improving
//     only on a strict increase and only at columns >= the lane's first
//     tracked column (starts[q, lane]);
//   * bestq stays -1 when a lane never scores above 0.
//
// Why a warp per (bin, lane).  One thread a lane (the old K4) walked a
// subject's whole qlen x length chain alone: the titin's lane set a
// launch's time and a few giant pieces left most SMs idle.  Here one warp
// takes one (bin, lane) and sweeps the subject over the query's rows on
// the band walker of rows.cuh (K3's row form's layout: bands laid from
// the query's last row up, all whole, the first topped with virtual rows
// that stay at H = 0):
//   * column max down the pipeline: at column j each thread folds its
//     strip into (max, smallest row) -- a tree for the max, then the first
//     row holding it -- and takes it over the (max, row) that thread t - 1
//     handed on for column j only if strictly greater (rows above are
//     smaller), and hands the result on with two more shuffles beside H
//     and F.  Thread 31 of the query's last band then holds the column's
//     max and its smallest row, at columns in ascending order, and folds
//     them into (S, bestq, bestpos).  No row past the query's end exists
//     (the last band ends at its last row), and the virtual rows' H = 0
//     never beats the max of 0 a column starts from, so no row outside
//     the query enters a max;
//   * a query over one band (any length; the wide matrix bands of 256
//     rows): band k's
//     thread 31 writes (H, F, column max, row) per column to a plane
//     [L] of the pair, which band k + 1's thread 0 reads as its row above,
//     staged with the db symbols; only the last band folds;
//   * per-lane early stop: columns past a subject's end hold PAD, where a
//     column's max never rises (while above 0 it falls by min(R, -PAD) a
//     column), so once a lane is past its last residue and its first
//     tracked column no column can raise S: the warp walks only the
//     blocks up to the later of the two, found with a ballot over 32
//     columns at a time from the lane's end.  That needs a strictly
//     negative PAD score: -128 in build_matrix8, and build_matrix_wide
//     guarantees it for the wide instantiation (the matrix element type
//     a template parameter).  Short lanes finish early; the longest
//     subject's warp sets a launch's time.
//
// Bound: the DP's critical path.  An align phase's launch holds few bins
// of few subjects, and its longest subject's warp takes its columns + 31
// steps a band; the roofline of the real cells is far below it.
#include "rows.cuh"

using namespace swipe;

namespace {

// One band of a (bin, lane): rows [r0, r0 + 32 * RS) of the query.
struct HintBand {
  int r0;
  const int8_t* db;           // column 0 of the lane; column stride n
  long long n;
  int L;                      // the lane's columns walked
  const int4* top;            // row r0 - 1 per column (H, F into the band,
                              // column max of the rows above, its row), or
                              // null: the row above the query
  int4* bot;                  // the band's bottom row, the same, or null
  int Q, R;
};

struct Best {
  int S, bq, bp;
};

// shared memory of a block (one warp): the profile (M [NSYM][RS][32]),
// the staged row above (int4 [RING]) and the staged symbols (uint8
// [RING])
template <typename M>
constexpr size_t hint_smem_bytes() {
  return profile_bytes<M>() + sizeof(int4) * RING + RING;
}

// Walk one band over the lane's columns (all 32 threads).  LAST: the
// query's last band, whose thread 31 folds each column into `best`; any
// other writes its bottom row to the planes.
template <typename M, bool LAST>
__device__ void walk_hint_band(const HintBand& b, const M* prof,
                               uint8_t* ring, int4* tring, int first,
                               Best& best) {
  constexpr int RS = Rows<M>::RS;
  const int t = threadIdx.x;
  const long long n = b.n;
  const int row0 = b.r0 + t * RS;
  int H[RS], E[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    H[i] = 0;
    E[i] = NEG_INF;
  }

  // one window of staged columns, held in registers until it is stored
  int code = 0;
  int4 top = make_int4(0, NEG_INF, 0, 0);
  auto fetch = [&](int c0) {
    const int c = c0 + t;
    if (c < b.L) {
      code = b.db[c * n] & (NSYM - 1);
      if (b.top != nullptr) top = b.top[c * n];
    }
  };
  fetch(0);

  // from the row above: H, F, the column max and its row this column; H
  // the column before (0 at column -1: no carried state)
  int hin = 0, fin = NEG_INF, cin = 0, rin = 0, hprev = 0;
  int hout = 0, fout = NEG_INF, cout = 0, rout = 0;
  const int steps = b.L + 31;
  for (int s = 0; s < steps; ++s) {
    if ((s & (WIN - 1)) == 0) {
      __syncwarp();
      ring[(s + t) & (RING - 1)] = (uint8_t)code;
      tring[(s + t) & (RING - 1)] = top;
      __syncwarp();
      fetch(s + WIN);
    }
    const int j = s - t;
    if (t == 0 && s < b.L) {
      const int4 v = tring[s & (RING - 1)];
      hin = v.x;
      fin = v.y;
      cin = v.z;
      rin = v.w;
    }
    if (j >= 0 && j < b.L) {
      const M* pr = prof + ring[j & (RING - 1)] * RS * 32 + t;
      hout = hin;
      fout = fin;
      int smax = 0;                 // the strip's max (H >= 0)
      strip_cells<M, false, false>(pr, nullptr, H, E, RS, hprev, hout, fout,
                                   smax, b.Q, b.R, 0);
      int r = 0;                    // the first row of the strip holding it
#pragma unroll
      for (int i = RS - 1; i >= 0; --i) r = H[i] == smax ? i : r;
      if (smax > cin) {
        cout = smax;
        rout = row0 + r;
      } else {
        cout = cin;
        rout = rin;
      }
      if (t == 31) {
        if (LAST) {
          if (cout > best.S && j >= first) {
            best.S = cout;
            best.bq = rout;
            best.bp = j;
          }
        } else {
          b.bot[j * n] = make_int4(hout, fout, cout, rout);
        }
      }
    }
    hprev = hin;
    hin = __shfl_up_sync(FULL, hout, 1);
    fin = __shfl_up_sync(FULL, fout, 1);
    cin = __shfl_up_sync(FULL, cout, 1);
    rin = __shfl_up_sync(FULL, rout, 1);
  }
  __syncwarp();      // the planes, for the next band
}

template <typename M>
__global__ void __launch_bounds__(32)
hint_kernel(const int32_t* __restrict__ qcodes,
            const int32_t* __restrict__ qlens, const M* __restrict__ m,
            const int8_t* __restrict__ db, const int32_t* __restrict__ starts,
            int32_t* __restrict__ s_out, int32_t* __restrict__ bq_out,
            int32_t* __restrict__ bp_out, int4* planes, int qlen_pad,
            int nblocks, int nseqs, int Q, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  M* prof = reinterpret_cast<M*>(smem);
  int4* tring = reinterpret_cast<int4*>(smem + profile_bytes<M>());
  uint8_t* ring = reinterpret_cast<uint8_t*>(tring + RING);
  const int lane = blockIdx.x, q = blockIdx.y, t = threadIdx.x;
  const long long n = nseqs;
  const int L = nblocks * KSEG;
  const int qlen = min(qlens[q], qlen_pad);
  const int8_t* dbq = db + (long long)q * L * n + lane;
  const int first = starts[q * n + lane];

  // the lane's last residue: a ballot over 32 columns at a time, from the
  // end
  int last = -1;
  for (int c1 = L; c1 > 0 && last < 0; c1 -= WIN) {
    const int c = c1 - WIN + t;
    const unsigned real = __ballot_sync(
        FULL, c >= 0 && (dbq[c * n] & (NSYM - 1)) != PAD_SYMBOL);
    if (real != 0) last = c1 - WIN + 31 - __clz(real);
  }

  Best best{0, -1, 0};
  if (qlen > 0) {
    const int32_t* qc = qcodes + (long long)q * qlen_pad;
    int4* plane = planes == nullptr ? nullptr
                                    : planes + (long long)q * L * n + lane;
    HintBand b{0, dbq, n, min(max(last, first) / KSEG + 1, nblocks) * KSEG,
               nullptr, nullptr, Q, R};
    constexpr int BAND = 32 * Rows<M>::RS;
    for (int r1 = qlen - (qlen - 1) / BAND * BAND; r1 <= qlen; r1 += BAND) {
      b.r0 = r1 - BAND;
      const int row0 = b.r0 + t * Rows<M>::RS;
      strip_profile(qc, m, row0, max(0, min(Rows<M>::RS, -row0)),
                    Rows<M>::RS, t, prof);
      if (r1 == qlen) {
        walk_hint_band<M, true>(b, prof, ring, tring, first, best);
      } else {
        b.bot = plane;
        walk_hint_band<M, false>(b, prof, ring, tring, first, best);
        b.top = plane;
      }
    }
  }
  if (t == 31) {
    s_out[q * n + lane] = best.S;
    bq_out[q * n + lane] = best.bq;
    bp_out[q * n + lane] = best.bp;
  }
}

template <typename M>
int launch(const int32_t* qcodes, const int32_t* qlens, const M* m,
           const int8_t* db, const int32_t* starts, int32_t* s_out,
           int32_t* bq_out, int32_t* bp_out, int32_t* planes, int nq,
           int qlen_pad, int nblocks, int nseqs, int Q, int R,
           void* stream) {
  if (qlen_pad > 32 * Rows<M>::RS && planes == nullptr && nblocks > 0)
    return (int)cudaErrorInvalidValue;
  // no columns still launches: every lane's result is (0, -1, 0)
  if (nq <= 0 || nseqs <= 0) return (int)cudaGetLastError();
  const size_t smem = hint_smem_bytes<M>();
  const cudaError_t err = allow_smem(hint_kernel<M>, smem);
  if (err != cudaSuccess) return (int)err;
  hint_kernel<M><<<dim3(nseqs, nq), 32, smem, (cudaStream_t)stream>>>(
      qcodes, qlens, m, db, starts, s_out, bq_out, bp_out, (int4*)planes,
      qlen_pad, nblocks, nseqs, Q, R);
  return (int)cudaGetLastError();
}

}  // namespace

// m is the int8 matrix (build_matrix8), or with wide set the int32 one
// (build_matrix_wide).  planes: a scratch [nq, L, nseqs, 4] int32 for the
// rows between a query's bands, null when no query has more than one band
// (512 rows int8, 256 wide).  Needs Q >= R.
extern "C" int swipe_hint(const int32_t* qcodes, const int32_t* qlens,
                          const void* m, int wide, const int8_t* db,
                          const int32_t* starts, int32_t* s_out,
                          int32_t* bq_out, int32_t* bp_out, int32_t* planes,
                          int nq, int qlen_pad, int nblocks, int nseqs, int Q,
                          int R, void* stream) {
  if (Q < R) return (int)cudaErrorInvalidValue;
  if (wide)
    return launch(qcodes, qlens, (const int32_t*)m, db, starts, s_out,
                  bq_out, bp_out, planes, nq, qlen_pad, nblocks, nseqs, Q, R,
                  stream);
  return launch(qcodes, qlens, (const int8_t*)m, db, starts, s_out, bq_out,
                bp_out, planes, nq, qlen_pad, nblocks, nseqs, Q, R, stream);
}
