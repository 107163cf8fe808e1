// Segment-packed Smith-Waterman: the untiled kernel (K9) and the
// query-tiled kernel (K8).
//
// Replace the TPU kernels swipe_tpu/ops/sw_pallas.py sw_scores_segmented
// (_sw_kernel; its lax twin sw_scores_lax takes an int32 profile, which
// K9's wide instantiation covers) and swipe_tpu/ops/sw_tiled.py
// sw_scores_tiled (_tiled_kernel).  Exact affine-gap Smith-Waterman of
// NQ queries against a segment-packed chunk (batching.pack_database):
// the chunk's [L, NSEQS] columns are cut into blocks of SEG_BLK = 32, a
// block->segment map names each block's segment, and lane i of segment k
// holds one sequence.  A lane's state resets at a segment's first block,
// and at its last block the lane's best score is written to
// out[q, seg, lane].  Segments that seg_ids never names stay as the
// wrapper zeroed them.  The score of row i against db symbol d comes
// from the query's transposed profile qpt[q, i, d] (ops.sw_segmented
// build_qpt), whose rows past the query and whose PAD column hold a
// strongly negative pad: walking all QLEN rows is exact, as a pad row
// can never raise S.
//
// Design.  As stream.cu, one thread owns one (query, lane) and walks the
// blocks in order (the TPU's sequential grid axis); neighbouring threads
// take neighbouring lanes, so the db, scratch and output accesses are
// coalesced.  Every thread of a warp reads the same profile row, so a
// profile read is one 32-entry row from L1.  Blocks are one warp, so a
// chunk's NSEQS / 32 x NQ warps spread over every SM.
//
// K9 walks each block row by row: the block's 32 columns' H and F of the
// previous row sit in registers, and each row's H and E at the block's
// last column live in a global scratch [NQ, QLEN, NSEQS], read and
// written once per (row, block).  The profile is int8 or int32 (a
// template parameter), the latter for score matrices outside int8.
//
// K8 keeps the TPU kernel's loop order: the thread holds a tile of
// TILE_ROWS query rows (their H and E) in registers and walks the
// block's 32 columns, row by row within a column, so the scratch is read
// and written once per (tile, block) instead of once per (row, block).
// Between tiles it passes the tile's bottom row per column: its H (the
// next tile's diagonal one column on) and its F advanced into the next
// tile's top row (the F carry of sw_tiled.py, here in the stored
// pre-advanced form), kept with the column's symbol in shared memory,
// one slot per thread.  The TPU's 64-row tile is only the contract's
// QLEN check; the tile here is sized by registers.
//
// Bound: operations, as for stream.cu: a cell is ten two-operand int32
// add/max (six with the DPX add-max) against one profile read from L1;
// each thread's cells are one dependent chain, and a chunk of 512 lanes
// gives NQ x 16 warps, too few to hide it (tuning is later work).
#include "sw_common.cuh"

using namespace swipe;

constexpr int SEG_BLK = 32;       // db columns per block (segment grain)
constexpr int SEG_THREADS = 32;   // one warp per thread block
constexpr int TILE_ROWS = 16;     // K8's query rows held in registers

__device__ __forceinline__ bool seg_start(const int32_t* seg_ids, int b) {
  return b == 0 || seg_ids[b - 1] != seg_ids[b];
}

__device__ __forceinline__ bool seg_end(const int32_t* seg_ids, int b,
                                        int nblocks) {
  return b == nblocks - 1 || seg_ids[b + 1] != seg_ids[b];
}

template <typename P>
__global__ void __launch_bounds__(SEG_THREADS)
segment_kernel(const P* __restrict__ qpt, const int8_t* __restrict__ db,
               const int32_t* __restrict__ seg_ids,
               int32_t* __restrict__ out, int32_t* __restrict__ hst,
               int32_t* __restrict__ est, int qlen, int nblocks, int nseqs,
               int nsegs, int Q, int R) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nseqs) return;
  const int q = blockIdx.y;
  const long long n = nseqs;
  const P* qp = qpt + (long long)q * qlen * NSYM;
  int32_t* H = hst + (long long)q * qlen * n + lane;
  int32_t* E = est + (long long)q * qlen * n + lane;
  int32_t* o = out + (long long)q * nsegs * n + lane;

  int S = 0;
  for (int b = 0; b < nblocks; ++b) {
    const bool fresh = seg_start(seg_ids, b);
    if (fresh) S = 0;
    const int8_t* col = db + (long long)b * SEG_BLK * n + lane;
    int dsym[SEG_BLK], hrow[SEG_BLK], frow[SEG_BLK];
#pragma unroll
    for (int j = 0; j < SEG_BLK; ++j) {
      dsym[j] = col[j * n] & (NSYM - 1);
      hrow[j] = 0;          // row -1 of the block: H = 0, F = -inf
      frow[j] = NEG_INF;
    }
    int d0 = 0;             // H of the previous row at the previous column
    for (int i = 0; i < qlen; ++i) {
      const long long at = i * n;
      const int hold = fresh ? 0 : H[at];
      int e = fresh ? NEG_INF : E[at];
      const P* prow = qp + i * NSYM;
      int diag = d0;
      int h = 0;
#pragma unroll
      for (int j = 0; j < SEG_BLK; ++j) {
        h = sw_cell<false>(diag + (int)prow[dsym[j]], e, frow[j], Q, R, 0);
        S = max(S, h);
        diag = hrow[j];
        hrow[j] = h;
      }
      d0 = hold;
      H[at] = h;
      E[at] = e;
    }
    if (seg_end(seg_ids, b, nblocks)) o[seg_ids[b] * n] = S;
  }
}

__global__ void __launch_bounds__(SEG_THREADS)
tiled_kernel(const int8_t* __restrict__ qpt, const int8_t* __restrict__ db,
             const int32_t* __restrict__ seg_ids, int32_t* __restrict__ out,
             int32_t* __restrict__ hst, int32_t* __restrict__ est, int qlen,
             int nblocks, int nseqs, int nsegs, int Q, int R) {
  // per column of the block and per thread: the db symbol, and the
  // bottom row of the tile above (its H, and its F advanced into this
  // tile's top row).  Each thread reads and writes only its own slots,
  // so no barrier is needed.
  __shared__ int sym_s[SEG_BLK][SEG_THREADS];
  __shared__ int bh_s[SEG_BLK][SEG_THREADS];
  __shared__ int bf_s[SEG_BLK][SEG_THREADS];
  const int tx = threadIdx.x;
  const int lane = blockIdx.x * blockDim.x + tx;
  if (lane >= nseqs) return;
  const int q = blockIdx.y;
  const long long n = nseqs;
  const int8_t* qp = qpt + (long long)q * qlen * NSYM;
  int32_t* H = hst + (long long)q * qlen * n + lane;
  int32_t* E = est + (long long)q * qlen * n + lane;
  int32_t* o = out + (long long)q * nsegs * n + lane;
  const int ntiles = qlen / TILE_ROWS;    // the wrapper checks qlen % 64

  int S = 0;
  for (int b = 0; b < nblocks; ++b) {
    const bool fresh = seg_start(seg_ids, b);
    if (fresh) S = 0;
    const int8_t* col = db + (long long)b * SEG_BLK * n + lane;
    for (int j = 0; j < SEG_BLK; ++j) {
      sym_s[j][tx] = col[j * n] & (NSYM - 1);
      bh_s[j][tx] = 0;      // the row above the query: H = 0, F = -inf
      bf_s[j][tx] = NEG_INF;
    }
    // H of the tile above's bottom row at the previous block's last
    // column: the diagonal into this tile's top row at column 0
    int corner = 0;
    for (int t = 0; t < ntiles; ++t) {
      const long long r0 = (long long)t * TILE_ROWS;
      int h[TILE_ROWS], e[TILE_ROWS];
#pragma unroll
      for (int r = 0; r < TILE_ROWS; ++r) {
        h[r] = fresh ? 0 : H[(r0 + r) * n];
        e[r] = fresh ? NEG_INF : E[(r0 + r) * n];
      }
      const int next_corner = h[TILE_ROWS - 1];
      const int8_t* tp = qp + r0 * NSYM;
      int diag_top = corner;
      // the column loop stays rolled: unrolled over 32 columns and the
      // tile's rows, ptxas took minutes on the one source
#pragma unroll 1
      for (int j = 0; j < SEG_BLK; ++j) {
        const int8_t* pc = tp + sym_s[j][tx];
        const int above = bh_s[j][tx];   // the next column's top diagonal
        int f = bf_s[j][tx];
        int diag = diag_top;
#pragma unroll
        for (int r = 0; r < TILE_ROWS; ++r) {
          const int hn = sw_cell<false>(diag + (int)pc[r * NSYM], e[r], f,
                                        Q, R, 0);
          S = max(S, hn);
          diag = h[r];
          h[r] = hn;
        }
        bh_s[j][tx] = h[TILE_ROWS - 1];
        bf_s[j][tx] = f;
        diag_top = above;
      }
#pragma unroll
      for (int r = 0; r < TILE_ROWS; ++r) {
        H[(r0 + r) * n] = h[r];
        E[(r0 + r) * n] = e[r];
      }
      corner = next_corner;
    }
    if (seg_end(seg_ids, b, nblocks)) o[seg_ids[b] * n] = S;
  }
}

// out [NQ, nsegs, NSEQS] must be zeroed by the caller (segments no block
// names stay 0); hst/est are [NQ, QLEN, NSEQS] scratch.  wide: the
// profile is int32, else int8.
extern "C" int swipe_segment(const void* qpt, int wide, const int8_t* db,
                             const int32_t* seg_ids, int32_t* out,
                             int32_t* hst, int32_t* est, int nq, int qlen,
                             int nblocks, int nseqs, int nsegs, int Q, int R,
                             void* stream) {
  if (nq > 0 && nseqs > 0 && nblocks > 0) {
    const dim3 grid((nseqs + SEG_THREADS - 1) / SEG_THREADS, nq);
    const cudaStream_t s = (cudaStream_t)stream;
    if (wide)
      segment_kernel<int32_t><<<grid, SEG_THREADS, 0, s>>>(
          (const int32_t*)qpt, db, seg_ids, out, hst, est, qlen, nblocks,
          nseqs, nsegs, Q, R);
    else
      segment_kernel<int8_t><<<grid, SEG_THREADS, 0, s>>>(
          (const int8_t*)qpt, db, seg_ids, out, hst, est, qlen, nblocks,
          nseqs, nsegs, Q, R);
  }
  return (int)cudaGetLastError();
}

// As swipe_segment, int8 profile only; qlen a multiple of TILE_ROWS.
extern "C" int swipe_segment_tiled(const int8_t* qpt, const int8_t* db,
                                   const int32_t* seg_ids, int32_t* out,
                                   int32_t* hst, int32_t* est, int nq,
                                   int qlen, int nblocks, int nseqs,
                                   int nsegs, int Q, int R, void* stream) {
  if (qlen % TILE_ROWS) return (int)cudaErrorInvalidValue;
  if (nq > 0 && nseqs > 0 && nblocks > 0) {
    const dim3 grid((nseqs + SEG_THREADS - 1) / SEG_THREADS, nq);
    tiled_kernel<<<grid, SEG_THREADS, 0, (cudaStream_t)stream>>>(
        qpt, db, seg_ids, out, hst, est, qlen, nblocks, nseqs, nsegs, Q, R);
  }
  return (int)cudaGetLastError();
}
