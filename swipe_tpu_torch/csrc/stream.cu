// Grouped stream scoring of a lane-packed chunk (K2).
//
// Replaces the TPU kernel swipe_tpu/ops/sw_stream.py sw_scores_stream
// (_stream_kernel_grouped with the row recurrence _make_row_body_multi).
// Exact affine-gap Smith-Waterman of NQ queries against every lane of a
// chunk; a lane's state resets where the start mask says a new sequence
// begins, and each lane's running max is dumped after every block of 16
// columns: out[q, b, lane].
//
// Design.  One thread owns one (query, lane) and walks the db blocks in
// order -- the TPU's sequential grid axis becomes a loop in the thread.
// Threads of a warp take neighbouring lanes, so every global access
// (db symbols, start mask, profiles, row state, dump) is coalesced.
// Inside a block the thread walks the query rows; the 16 columns' H and
// F of the previous row stay in registers.  The H/E of the block's last
// column for every row live in a global scratch [NQ, QLEN, NSEQS] (the
// lane-flat layout of the JAX lax twin), read and written once per
// (row, block): 16 bytes per 16 cells.  The cell is
//   H = max(diag + p, E, F, 0), clamp, S = max(S, H)
// with E and F stored pre-advanced into the next cell, as in the TPU
// kernel.  p comes from the precomputed block profile (dprofile.cu) when
// given, else from the matrix in shared memory indexed by the query
// symbol and the column's db symbol.
//
// Bound: operations.  As written a cell takes ten two-operand int32
// add/max against one profile read (4 bytes, from L2) and one byte of row
// state; with the DPX add-max instructions it would take six, and no SM
// issues more than 128 thread instructions a clock, which sets the least
// time (chip_smoke.py).  The simple design is far from it: a cell's
// add/max form one dependent chain per thread, and NQ x NSEQS / 128
// thread blocks leave few warps per SM to cover it (tuning, DPX and
// 16-bit lanes are later work).
//
// Running exactly qlen rows is enough: the TPU kernel's round-up to 4
// rows only added PAD rows, which decay and never raise S.
#include "sw_common.cuh"

using namespace swipe;

template <bool DPROF, bool CLAMP>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const int32_t* __restrict__ qcodes,
              const int32_t* __restrict__ qlens,
              const int8_t* __restrict__ m8, const int8_t* __restrict__ db,
              const int8_t* __restrict__ start,
              const int32_t* __restrict__ dprof, int32_t* __restrict__ out,
              int32_t* __restrict__ hst, int32_t* __restrict__ est,
              int qlen_pad, int nblocks, int nseqs, int Q, int R,
              int clamp) {
  __shared__ int m8s[NSYM * NSYM];
  load_matrix(m8s, m8);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nseqs) return;
  const int q = blockIdx.y;
  const int qlen = min(qlens[q], qlen_pad);
  const int32_t* qc = qcodes + (long long)q * qlen_pad;
  const long long n = nseqs;
  int32_t* H = hst + (long long)q * qlen_pad * n + lane;
  int32_t* E = est + (long long)q * qlen_pad * n + lane;
  int32_t* dump = out + (long long)q * nblocks * n + lane;

  int S = 0;
  for (int b = 0; b < nblocks; ++b) {
    // block 0 starts from the fresh state, like a set start bit
    const bool fresh = b == 0 || start[b * n + lane] != 0;
    if (fresh) S = 0;
    const int8_t* col = db + (long long)b * KSEG * n + lane;
    int dsym[KSEG], hrow[KSEG], frow[KSEG];
#pragma unroll
    for (int j = 0; j < KSEG; ++j) {
      dsym[j] = col[j * n] & (NSYM - 1);
      hrow[j] = 0;          // row -1 of the block: H = 0, F = -inf
      frow[j] = NEG_INF;
    }
    const int32_t* prof =
        DPROF ? dprof + (long long)b * NSYM * KSEG * n + lane : nullptr;
    int d0 = 0;             // H of the previous row at the previous column
    for (int i = 0; i < qlen; ++i) {
      const long long at = i * n;
      const int hold = fresh ? 0 : H[at];
      int e = fresh ? NEG_INF : E[at];
      const int qs = qc[i] & (NSYM - 1);
      const int* mrow = m8s + qs * NSYM;
      const int32_t* prow = DPROF ? prof + (long long)qs * KSEG * n : nullptr;
      int diag = d0;
      int h = 0;
#pragma unroll
      for (int j = 0; j < KSEG; ++j) {
        const int p = DPROF ? prow[j * n] : mrow[dsym[j]];
        h = sw_cell<CLAMP>(diag + p, e, frow[j], Q, R, clamp);
        S = max(S, h);
        diag = hrow[j];
        hrow[j] = h;
      }
      d0 = hold;
      H[at] = h;
      E[at] = e;
    }
    dump[b * n] = S;
  }
}

template <bool DPROF, bool CLAMP>
static void launch(dim3 grid, cudaStream_t stream, const int32_t* qcodes,
                   const int32_t* qlens, const int8_t* m8, const int8_t* db,
                   const int8_t* start, const int32_t* dprof, int32_t* out,
                   int32_t* hst, int32_t* est, int qlen_pad, int nblocks,
                   int nseqs, int Q, int R, int clamp) {
  stream_kernel<DPROF, CLAMP><<<grid, THREADS, 0, stream>>>(
      qcodes, qlens, m8, db, start, dprof, out, hst, est, qlen_pad, nblocks,
      nseqs, Q, R, clamp);
}

extern "C" int swipe_stream(const int32_t* qcodes, const int32_t* qlens,
                            const int8_t* m8, const int8_t* db,
                            const int8_t* start, const int32_t* dprof,
                            int32_t* out, int32_t* hst, int32_t* est, int nq,
                            int qlen_pad, int nblocks, int nseqs, int Q,
                            int R, int use_clamp, int clamp, void* stream) {
  if (nq > 0 && nseqs > 0 && nblocks > 0) {
    const dim3 grid((nseqs + THREADS - 1) / THREADS, nq);
    const cudaStream_t s = (cudaStream_t)stream;
    if (dprof != nullptr) {
      if (use_clamp)
        launch<true, true>(grid, s, qcodes, qlens, m8, db, start, dprof, out,
                           hst, est, qlen_pad, nblocks, nseqs, Q, R, clamp);
      else
        launch<true, false>(grid, s, qcodes, qlens, m8, db, start, dprof,
                            out, hst, est, qlen_pad, nblocks, nseqs, Q, R,
                            clamp);
    } else {
      if (use_clamp)
        launch<false, true>(grid, s, qcodes, qlens, m8, db, start, dprof,
                            out, hst, est, qlen_pad, nblocks, nseqs, Q, R,
                            clamp);
      else
        launch<false, false>(grid, s, qcodes, qlens, m8, db, start, dprof,
                             out, hst, est, qlen_pad, nblocks, nseqs, Q, R,
                             clamp);
    }
  }
  return (int)cudaGetLastError();
}
