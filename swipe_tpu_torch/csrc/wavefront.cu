// Anti-diagonal wavefront scoring of one giant db segment (K7).
//
// Replaces the TPU kernel swipe_tpu/ops/sw_wavefront.py sw_wavefront
// (_wavefront_kernel).  NQ queries against ONE db sequence, streamed
// through segments with the cross-segment state carried between launches:
// per query row the H and E of the segment's last column, and the
// query's running max S.  Used for the few chromosome-scale units whose
// positive-score span is too large to cut them into overlapped pieces.
//
// The TPU kernel parallelises inside the pair with 8 x 128 column strips,
// a lazy-E prefix max along each strip and an edge ring between strips.
// Here the parallel axis is the query row instead:
//   * one thread block per query, one thread per query row (QLEN <= 1024;
//     rows past qlen_pad, up to a whole warp, only relay values);
//   * the block sweeps anti-diagonals: at step t, thread i computes column
//     t - i of the segment;
//   * E runs along the row, so it stays in the thread's registers with
//     the row's H of the previous column;
//   * H and F come down from row i - 1, computed one step earlier: inside
//     a warp by __shfl_up_sync, across warps through a shared-memory
//     double buffer written by each warp's last lane, behind one
//     __syncthreads per step; the H that arrived one step earlier is the
//     diagonal;
//   * the row's scores for the 32 db symbols sit in shared memory as
//     [32][rows] int32, so a warp's lookups (one row each, any symbols)
//     hit 32 different banks;
//   * the segment's symbols are staged through a shared-memory ring of
//     four 1024-column tiles, one tile ahead of the wavefront;
//   * S is reduced over the block at the end.
// The recurrence is the exact E/F/H of stream.cu with E kept as the
// cell's own value (not pre-advanced), which is what the TPU kernel's
// edge ring holds: E(i, j) = max(E(i, j-1) - R, H(i, j-1) - Q),
// F(i, j) = max(F(i-1, j) - R, H(i-1, j) - Q),
// H(i, j) = max(H(i-1, j-1) + score, E, F, 0).
//
// Bound: latency.  A step does one cell per row, about ten dependent
// instructions, then waits at the block barrier; L + QLEN - 1 steps per
// segment, NQ blocks on the card's 132 SMs.  The barrier per step is what
// a warp-strip pipeline would remove (later work).
#include "sw_common.cuh"

using namespace swipe;

namespace {

constexpr int TILE = 1024;          // db columns staged per tile
constexpr int RING = 4 * TILE;      // staged columns (bytes), power of two
constexpr int MAX_ROWS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(MAX_ROWS)
wavefront_kernel(const int8_t* __restrict__ mq, const int8_t* __restrict__ db,
                 int32_t* h, int32_t* e, int32_t* s, int qlen_pad, int L,
                 int Q, int R) {
  extern __shared__ int smem[];
  const int rows = blockDim.x;                  // qlen_pad rounded to a warp
  const int nwarps = rows / 32;
  int* prof = smem;                             // [NSYM][rows]
  int2* xfer = reinterpret_cast<int2*>(prof + NSYM * rows);   // [2][nwarps]
  int* red = reinterpret_cast<int*>(xfer + 2 * nwarps);       // [nwarps]
  int8_t* ring = reinterpret_cast<int8_t*>(red + nwarps);     // [RING]

  const int q = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const bool live = i < qlen_pad;
  const int8_t* mqq = mq + (long long)q * qlen_pad * NSYM;
  for (int k = i; k < NSYM * rows; k += rows) {
    const int sym = k / rows, r = k - sym * rows;
    prof[k] = r < qlen_pad ? mqq[r * NSYM + sym] : 0;
  }
  for (int k = i; k < TILE && k < L; k += rows) ring[k] = db[k];

  int32_t* hq = h + (long long)q * qlen_pad;
  int32_t* eq = e + (long long)q * qlen_pad;
  // the row's H/E at column -1 (the previous segment's last column)
  int hleft = live ? hq[i] : 0;
  int eleft = live ? eq[i] : NEG_INF;
  int fout = NEG_INF;
  // from row i - 1: H and F of the column this row computes next, and H
  // of the one before (the diagonal); row -1 is H = 0, F = -inf
  int hup = i > 0 && i <= qlen_pad ? hq[i - 1] : 0;
  int fup = NEG_INF;
  int diag = 0;
  int S = 0;
  __syncthreads();

  const int steps = L + qlen_pad - 1;
  for (int t = 0; t < steps; ++t) {
    if ((t & (TILE - 1)) == 0) {
      // stage the tile after the current one: it is first read TILE
      // steps (and as many barriers) from now, and its ring slot last
      // held columns no row still needs
      const int c0 = t + TILE;
      for (int k = i; k < TILE && c0 + k < L; k += rows)
        ring[(c0 + k) & (RING - 1)] = db[c0 + k];
    }
    const int j = t - i;
    if (live && j >= 0 && j < L) {
      const int p = prof[(ring[j & (RING - 1)] & (NSYM - 1)) * rows + i];
      const int ecur = max(eleft - R, hleft - Q);
      const int f = max(fup - R, hup - Q);
      const int hh = max(max(diag + p, 0), max(ecur, f));
      S = max(S, hh);
      hleft = hh;
      eleft = ecur;
      fout = f;
    }
    // hand H and F down one row; a row not yet started hands down its
    // column -1 H, which the next row needs as its first diagonal
    int hn = __shfl_up_sync(FULL, hleft, 1);
    int fn = __shfl_up_sync(FULL, fout, 1);
    if (lane == 31) xfer[(t & 1) * nwarps + warp] = make_int2(hleft, fout);
    __syncthreads();
    if (lane == 0) {
      if (warp > 0) {
        const int2 v = xfer[(t & 1) * nwarps + warp - 1];
        hn = v.x;
        fn = v.y;
      } else {
        hn = 0;
        fn = NEG_INF;
      }
    }
    diag = hup;
    hup = hn;
    fup = fn;
  }

  if (live) {
    hq[i] = hleft;
    eq[i] = eleft;
  }
  S = __reduce_max_sync(FULL, S);
  if (lane == 0) red[warp] = S;
  __syncthreads();
  if (i == 0) {
    int m = s[q];
    for (int w = 0; w < nwarps; ++w) m = max(m, red[w]);
    s[q] = m;
  }
}

}  // namespace

// mq [nq, qlen_pad, 32] int8 per-row scores, db [L] int8 symbols; h/e
// [nq, qlen_pad] and s [nq] int32, the carried state, updated in place.
extern "C" int swipe_wavefront(const int8_t* mq, const int8_t* db, int32_t* h,
                               int32_t* e, int32_t* s, int nq, int qlen_pad,
                               int L, int Q, int R, void* stream) {
  if (nq > 0 && L > 0 && qlen_pad > 0) {
    if (qlen_pad > MAX_ROWS) return (int)cudaErrorInvalidValue;
    const int rows = (qlen_pad + 31) / 32 * 32;
    const size_t smem = sizeof(int) * NSYM * rows +
                        sizeof(int2) * 2 * (rows / 32) +
                        sizeof(int) * (rows / 32) + RING;
    const cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    wavefront_kernel<<<nq, rows, smem, (cudaStream_t)stream>>>(
        mq, db, h, e, s, qlen_pad, L, Q, R);
  }
  return (int)cudaGetLastError();
}
