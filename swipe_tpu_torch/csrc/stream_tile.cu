// Query-tile passes of stream scoring (K5) and their carry form (K6), for
// queries over one tile of rows.
//
// Replaces the TPU kernels swipe_tpu/ops/sw_stream.py _stream_tile_pass
// (_stream_tile_kernel, driven by sw_scores_stream_long) and
// _stream_tile_carry_pass (_stream_tile_carry_kernel, driven by
// sw_scores_stream_carry_long).  A query of QLEN rows is scored in
// QLEN / T passes over the chunk; pass t walks rows [t*T, t*T + T) (fewer
// where the query ends) and carries the DP boundary to the next pass in
// two planes [NQ, L, NSEQS]: the H of its bottom row at every column and
// that row's F advanced into the next tile's top row.  The per-block dump
// out[q, b, lane] is max-merged over the passes.
//
// Design: stream.cu's.  One thread owns one (query, lane) and walks the
// db blocks in order; the 16 columns' previous-row H/F sit in registers
// and the tile's H/E at the block's last column in a global scratch, one
// row ahead of the row being computed.  What the tile adds:
//   * row -1 of a block is the planes' 16 columns (hrow = bh, frow = bf),
//     not H = 0 and F = -inf.  They are not masked on a start bit: the
//     previous pass applied this block's reset already;
//   * the diagonal into the top row at a block's first column is the
//     previous block's last bh, kept in a register and masked to 0 on a
//     start bit (that column belongs to the previous sequence).  At block
//     0 it is 0, or bh0c[q, t] for a carry series;
//   * S restarts at 0 in every pass (K6: tile 0 reads the carried S) and
//     on start bits; each block stores max(out, S) -- per block, no
//     reset: an earlier pass's dump of a refill block already belongs to
//     the new sequence;
//   * the bottom row's H and F go back into the planes per column.
// Scores come from the matrix in shared memory, not from block profiles:
// with one warp an SM the lookup beat K1's profiles by 1.5-1.7x at every
// long shape measured (PERF.md), so the long route builds none.
// Every plane element, dump element and scratch row is read and then
// written by the one thread that owns its lane, so the planes and the
// dump are updated in place (one set, not two ping-pong buffers).  A pass
// in which the query has no rows left walks no rows: the planes pass
// through and the dump keeps its value.
//
// K6 (CARRY): the scratch is the series' [NQ, QLEN, NSEQS] H/E state;
// the tile reads its rows at block 0 (reset where the start bit is set)
// and leaves them updated in place.  The tile's bottom-row H at the
// chunk's last column is the plane's last column, which the wrapper
// stacks into bh0c for the next chunk.
//
// Kept apart from stream.cu on purpose: K2's compiled code is sensitive
// to any change (a run-time branch there doubled its time), so the tile
// kernels are their own instantiations of the shared sw_cell.
//
// Thread blocks of one warp.  A long-query slot group is at most 4
// queries x 1024 lanes, 128 warps: in blocks of 128 threads they would
// sit on 32 of the 132 SMs; one warp a block spreads them over 128 SMs,
// each with its own L1 for the warp's 128 KB of row state.
//
// Bound: operations (the real cells), as K2; with one warp an SM, each
// thread's dependent chain through E and F sets the time.
#include "sw_common.cuh"

using namespace swipe;

constexpr int TILE_THREADS = 32;

template <bool CLAMP, bool CARRY>
__global__ void __launch_bounds__(TILE_THREADS)
tile_kernel(const int32_t* __restrict__ qcodes,
            const int32_t* __restrict__ qlens,
            const int8_t* __restrict__ m8, const int8_t* __restrict__ db,
            const int8_t* __restrict__ start, int32_t* __restrict__ out,
            int32_t* __restrict__ bh, int32_t* __restrict__ bf,
            int32_t* __restrict__ hst, int32_t* __restrict__ est,
            const int32_t* __restrict__ s_in,
            const int32_t* __restrict__ bh0c, int tile, int tile_rows,
            int qlen_pad, int nblocks, int nseqs, int Q, int R, int clamp) {
  __shared__ int m8s[NSYM * NSYM];
  load_matrix(m8s, m8);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nseqs) return;
  const int q = blockIdx.y;
  const long long n = nseqs;
  const int r0 = tile * tile_rows;
  const int rows = max(0, min(min(qlens[q], qlen_pad) - r0, tile_rows));
  const int32_t* qc = qcodes + (long long)q * qlen_pad + r0;
  // K5: a [NQ, T, NSEQS] scratch; K6: the tile's rows of the state
  const long long srow =
      CARRY ? (long long)q * qlen_pad + r0 : (long long)q * tile_rows;
  int32_t* H = hst + srow * n + lane;
  int32_t* E = est + srow * n + lane;
  int32_t* dump = out + (long long)q * nblocks * n + lane;
  int32_t* BH = bh + (long long)q * nblocks * KSEG * n + lane;
  int32_t* BF = bf + (long long)q * nblocks * KSEG * n + lane;
  const int ntiles = qlen_pad / tile_rows;

  int S = CARRY && tile == 0 ? s_in[q * n + lane] : 0;
  // bottom-row H of the tile above at the previous block's last column
  int bh_prev = CARRY ? bh0c[((long long)q * (ntiles + 1) + tile) * n + lane]
                      : 0;
  for (int b = 0; b < nblocks; ++b) {
    const bool reset = start[b * n + lane] != 0;
    // K5: block 0 starts from the fresh state, like a set start bit
    const bool fresh = (!CARRY && b == 0) || reset;
    if (reset) S = 0;
    const long long c0 = (long long)b * KSEG * n;
    const int8_t* col = db + c0 + lane;
    int dsym[KSEG], hrow[KSEG], frow[KSEG];
#pragma unroll
    for (int j = 0; j < KSEG; ++j) {
      dsym[j] = col[j * n] & (NSYM - 1);
      hrow[j] = BH[c0 + j * n];     // row -1 of the tile: the planes
      frow[j] = BF[c0 + j * n];
    }
    int d0 = reset ? 0 : bh_prev;   // the diagonal into the top row
    bh_prev = hrow[KSEG - 1];
    int hnext = 0, enext = NEG_INF;
    if (!fresh && rows > 0) {
      hnext = H[0];
      enext = E[0];
    }
    for (int i = 0; i < rows; ++i) {
      const long long at = i * n;
      const int hold = hnext;
      int e = enext;
      if (!fresh && i + 1 < rows) {   // the next row's state, ahead
        hnext = H[at + n];
        enext = E[at + n];
      }
      const int qs = qc[i] & (NSYM - 1);
      const int* mrow = m8s + qs * NSYM;
      int diag = d0;
      int h = 0;
#pragma unroll
      for (int j = 0; j < KSEG; ++j) {
        h = sw_cell<CLAMP>(diag + mrow[dsym[j]], e, frow[j], Q, R, clamp);
        S = max(S, h);
        diag = hrow[j];
        hrow[j] = h;
      }
      d0 = hold;
      H[at] = h;
      E[at] = e;
    }
    dump[b * n] = max(dump[b * n], S);
#pragma unroll
    for (int j = 0; j < KSEG; ++j) {
      BH[c0 + j * n] = hrow[j];     // the bottom row, for the next tile
      BF[c0 + j * n] = frow[j];
    }
  }
}

#define TILE_PARAMS                                                        \
  const int32_t *qcodes, const int32_t *qlens, const int8_t *m8,           \
      const int8_t *db, const int8_t *start, int32_t *out, int32_t *bh,    \
      int32_t *bf, int32_t *hst, int32_t *est,                             \
      const int32_t *s_in, const int32_t *bh0c, int tile, int tile_rows,   \
      int qlen_pad, int nblocks, int nseqs, int Q, int R, int clamp
#define TILE_ARGS                                                          \
  qcodes, qlens, m8, db, start, out, bh, bf, hst, est, s_in, bh0c,         \
      tile, tile_rows, qlen_pad, nblocks, nseqs, Q, R, clamp

template <bool CARRY>
static void launch_clamp(dim3 grid, cudaStream_t s, bool use_clamp,
                         TILE_PARAMS) {
  if (use_clamp)
    tile_kernel<true, CARRY><<<grid, TILE_THREADS, 0, s>>>(TILE_ARGS);
  else
    tile_kernel<false, CARRY><<<grid, TILE_THREADS, 0, s>>>(TILE_ARGS);
}

static int launch(int nq, int use_clamp, bool carry, void* stream,
                  TILE_PARAMS) {
  if (nq > 0 && nseqs > 0 && nblocks > 0 && tile_rows > 0) {
    const dim3 grid((nseqs + TILE_THREADS - 1) / TILE_THREADS, nq);
    const cudaStream_t s = (cudaStream_t)stream;
    if (carry) launch_clamp<true>(grid, s, use_clamp, TILE_ARGS);
    else launch_clamp<false>(grid, s, use_clamp, TILE_ARGS);
  }
  return (int)cudaGetLastError();
}

// K5: out/bh/bf updated in place; hst/est a [nq, tile_rows, nseqs] scratch
extern "C" int swipe_stream_tile(const int32_t* qcodes, const int32_t* qlens,
                                 const int8_t* m8, const int8_t* db,
                                 const int8_t* start, int32_t* out,
                                 int32_t* bh, int32_t* bf,
                                 int32_t* hst, int32_t* est, int tile,
                                 int tile_rows, int nq, int qlen_pad,
                                 int nblocks, int nseqs, int Q, int R,
                                 int use_clamp, int clamp, void* stream) {
  const int32_t* s_in = nullptr;
  const int32_t* bh0c = nullptr;
  return launch(nq, use_clamp, false, stream, TILE_ARGS);
}

// K6: hst/est the series' [nq, qlen_pad, nseqs] state, updated in place;
// s_in [nq, nseqs] and bh0c [nq, qlen_pad / tile_rows + 1, nseqs] read
extern "C" int swipe_stream_tile_carry(
    const int32_t* qcodes, const int32_t* qlens, const int8_t* m8,
    const int8_t* db, const int8_t* start, int32_t* out, int32_t* bh,
    int32_t* bf, int32_t* hst, int32_t* est, const int32_t* s_in,
    const int32_t* bh0c, int tile, int tile_rows, int nq, int qlen_pad,
    int nblocks, int nseqs, int Q, int R, int use_clamp, int clamp,
    void* stream) {
  return launch(nq, use_clamp, true, stream, TILE_ARGS);
}
