// Query-tile passes of stream scoring (K5), for queries over one tile of
// rows on the plain pack.
//
// Replaces the TPU kernel swipe_tpu/ops/sw_stream.py _stream_tile_pass
// (_stream_tile_kernel, driven by sw_scores_stream_long).  A query of QLEN
// rows is scored in QLEN / T passes over the chunk; pass t walks rows
// [t*T, t*T + T) (fewer where the query ends) and carries the DP boundary
// to the next pass in two planes [NQ, L, NSEQS]: the H of its bottom row
// at every column and that row's F advanced into the next tile's top row.
// The per-block dump out[q, b, lane] is max-merged over the passes.  The
// carry form of the tile pass (K6), whose launches hold a chromosome
// lane's few pairs, is carry_rows.cu's.
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
//     0 it is 0;
//   * S restarts at 0 in every pass and on start bits; each block stores
//     max(out, S) -- per block, no reset: an earlier pass's dump of a
//     refill block already belongs to the new sequence;
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
// Kept apart from stream.cu on purpose: K2's compiled code is sensitive
// to any change (a run-time branch there doubled its time), so the tile
// kernel is its own instantiation of the shared sw_cell.
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

template <bool CLAMP>
__global__ void __launch_bounds__(TILE_THREADS)
tile_kernel(const int32_t* __restrict__ qcodes,
            const int32_t* __restrict__ qlens,
            const int8_t* __restrict__ m8, const int8_t* __restrict__ db,
            const int8_t* __restrict__ start, int32_t* __restrict__ out,
            int32_t* __restrict__ bh, int32_t* __restrict__ bf,
            int32_t* __restrict__ hst, int32_t* __restrict__ est, int tile,
            int tile_rows, int qlen_pad, int nblocks, int nseqs, int Q,
            int R, int clamp) {
  __shared__ int m8s[NSYM * NSYM];
  load_matrix(m8s, m8);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nseqs) return;
  const int q = blockIdx.y;
  const long long n = nseqs;
  const int r0 = tile * tile_rows;
  const int rows = max(0, min(min(qlens[q], qlen_pad) - r0, tile_rows));
  const int32_t* qc = qcodes + (long long)q * qlen_pad + r0;
  // a [NQ, T, NSEQS] scratch
  const long long srow = (long long)q * tile_rows;
  int32_t* H = hst + srow * n + lane;
  int32_t* E = est + srow * n + lane;
  int32_t* dump = out + (long long)q * nblocks * n + lane;
  int32_t* BH = bh + (long long)q * nblocks * KSEG * n + lane;
  int32_t* BF = bf + (long long)q * nblocks * KSEG * n + lane;

  int S = 0;
  // bottom-row H of the tile above at the previous block's last column
  int bh_prev = 0;
  for (int b = 0; b < nblocks; ++b) {
    const bool reset = start[b * n + lane] != 0;
    // block 0 starts from the fresh state, like a set start bit
    const bool fresh = b == 0 || reset;
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

// out/bh/bf updated in place; hst/est a [nq, tile_rows, nseqs] scratch
extern "C" int swipe_stream_tile(const int32_t* qcodes, const int32_t* qlens,
                                 const int8_t* m8, const int8_t* db,
                                 const int8_t* start, int32_t* out,
                                 int32_t* bh, int32_t* bf,
                                 int32_t* hst, int32_t* est, int tile,
                                 int tile_rows, int nq, int qlen_pad,
                                 int nblocks, int nseqs, int Q, int R,
                                 int use_clamp, int clamp, void* stream) {
  if (nq > 0 && nseqs > 0 && nblocks > 0 && tile_rows > 0) {
    const dim3 grid((nseqs + TILE_THREADS - 1) / TILE_THREADS, nq);
    const cudaStream_t s = (cudaStream_t)stream;
    if (use_clamp)
      tile_kernel<true><<<grid, TILE_THREADS, 0, s>>>(
          qcodes, qlens, m8, db, start, out, bh, bf, hst, est, tile,
          tile_rows, qlen_pad, nblocks, nseqs, Q, R, clamp);
    else
      tile_kernel<false><<<grid, TILE_THREADS, 0, s>>>(
          qcodes, qlens, m8, db, start, out, bh, bf, hst, est, tile,
          tile_rows, qlen_pad, nblocks, nseqs, Q, R, clamp);
  }
  return (int)cudaGetLastError();
}
