// Alignment-endpoint hints (K4), the search16s analog.
//
// Replaces the TPU kernel swipe_tpu/ops/sw_stream.py sw_hint_stream
// (_hint_kernel).  The stream recurrence of stream.cu over one query and
// one subject per lane (no refill), plus endpoint tracking with the
// reference's tie rules:
//   * per column, the max H over the query rows and the SMALLEST row
//     attaining it (strictly greater updates, rows < qlen only);
//   * columns fold in ascending order into (S, bestq, bestpos), improving
//     only on a strict increase and only at columns >= the lane's first
//     tracked column (starts[q, lane]);
//   * bestq stays -1 when a lane never scores above 0.
// Columns past a subject's end hold PAD.  There a column's max never
// rises (while above 0 it falls by min(R, -PAD) a column), so once a
// lane is past its last residue and its first tracked column no column
// can raise S: the lane stops at the block that holds the later of the
// two.  That needs only a strictly negative PAD score: -128 in
// build_matrix8, and build_matrix_wide guarantees it for the wide
// instantiation (matrices outside int8, the matrix element type a
// template parameter), which the per-bin route runs for such bins.
//
// Design: as stream.cu -- one thread per (query bin, lane), the db
// blocks walked in order, the 16 columns' previous-row H/F and their
// column max and argmax row in registers, the last column's H/E per row
// in a global scratch [NQ, QLEN, NSEQS].  An align phase has few bins of
// few subjects, so few warps run and nothing hides the latency of the
// scratch: each row's H/E is loaded one row ahead, behind the current
// row's 16 cells.
//
// Bound: latency.  A lane's qlen x length cells are one dependent chain
// in one thread, so the longest subject sets the time; the roofline of
// the real cells is far below it.  Spreading a subject's rows over a
// warp is the lever.
#include "sw_common.cuh"

using namespace swipe;

template <typename M>
__global__ void __launch_bounds__(THREADS)
hint_kernel(const int32_t* __restrict__ qcodes,
            const int32_t* __restrict__ qlens, const M* __restrict__ m8,
            const int8_t* __restrict__ db, const int32_t* __restrict__ starts,
            int32_t* __restrict__ s_out, int32_t* __restrict__ bq_out,
            int32_t* __restrict__ bp_out, int32_t* __restrict__ hst,
            int32_t* __restrict__ est, int qlen_pad, int nblocks, int nseqs,
            int Q, int R) {
  __shared__ int m8s[NSYM * NSYM];
  load_matrix(m8s, m8);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nseqs) return;
  const int q = blockIdx.y;
  const int qlen = min(qlens[q], qlen_pad);
  const int32_t* qc = qcodes + (long long)q * qlen_pad;
  const long long n = nseqs;
  const int8_t* dbq = db + (long long)q * nblocks * KSEG * n + lane;
  int32_t* H = hst + (long long)q * qlen_pad * n + lane;
  int32_t* E = est + (long long)q * qlen_pad * n + lane;
  const int first = starts[q * n + lane];

  int last = nblocks * KSEG - 1;     // the lane's last residue
  while (last >= 0 && (dbq[last * n] & (NSYM - 1)) == PAD_SYMBOL) --last;
  const int lane_blocks = min(max(last, first) / KSEG + 1, nblocks);

  int S = 0, bestq = -1, bestpos = 0;
  for (int b = 0; b < lane_blocks; ++b) {
    const bool fresh = b == 0;
    const int8_t* col = dbq + (long long)b * KSEG * n;
    int dsym[KSEG], hrow[KSEG], frow[KSEG], cm[KSEG], ra[KSEG];
#pragma unroll
    for (int j = 0; j < KSEG; ++j) {
      dsym[j] = col[j * n] & (NSYM - 1);
      hrow[j] = 0;
      frow[j] = NEG_INF;
      cm[j] = 0;
      ra[j] = 0;
    }
    int hnext = 0, enext = NEG_INF;
    if (!fresh && qlen > 0) {
      hnext = H[0];
      enext = E[0];
    }
    int d0 = 0;
    for (int i = 0; i < qlen; ++i) {
      const long long at = i * n;
      const int hold = hnext;
      int e = enext;
      if (!fresh && i + 1 < qlen) {
        hnext = H[at + n];
        enext = E[at + n];
      }
      const int* mrow = m8s + (qc[i] & (NSYM - 1)) * NSYM;
      int diag = d0;
      int h = 0;
#pragma unroll
      for (int j = 0; j < KSEG; ++j) {
        h = sw_cell<false>(diag + mrow[dsym[j]], e, frow[j], Q, R, 0);
        if (h > cm[j]) {
          cm[j] = h;
          ra[j] = i;
        }
        diag = hrow[j];
        hrow[j] = h;
      }
      d0 = hold;
      H[at] = h;
      E[at] = e;
    }
#pragma unroll
    for (int j = 0; j < KSEG; ++j) {
      const int c = b * KSEG + j;
      if (cm[j] > S && c >= first) {
        S = cm[j];
        bestpos = c;
        bestq = ra[j];
      }
    }
  }
  s_out[q * n + lane] = S;
  bq_out[q * n + lane] = bestq;
  bp_out[q * n + lane] = bestpos;
}

template <typename M>
static int launch(const int32_t* qcodes, const int32_t* qlens, const M* m,
                  const int8_t* db, const int32_t* starts, int32_t* s_out,
                  int32_t* bq_out, int32_t* bp_out, int32_t* hst,
                  int32_t* est, int nq, int qlen_pad, int nblocks, int nseqs,
                  int Q, int R, void* stream) {
  if (nq > 0 && nseqs > 0) {
    const dim3 grid((nseqs + THREADS - 1) / THREADS, nq);
    hint_kernel<M><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        qcodes, qlens, m, db, starts, s_out, bq_out, bp_out, hst, est,
        qlen_pad, nblocks, nseqs, Q, R);
  }
  return (int)cudaGetLastError();
}

// m is the int8 matrix (build_matrix8), or with wide set the int32 one
// (build_matrix_wide).
extern "C" int swipe_hint(const int32_t* qcodes, const int32_t* qlens,
                          const void* m, int wide, const int8_t* db,
                          const int32_t* starts, int32_t* s_out,
                          int32_t* bq_out, int32_t* bp_out, int32_t* hst,
                          int32_t* est, int nq, int qlen_pad, int nblocks,
                          int nseqs, int Q, int R, void* stream) {
  if (wide)
    return launch(qcodes, qlens, (const int32_t*)m, db, starts, s_out,
                  bq_out, bp_out, hst, est, nq, qlen_pad, nblocks, nseqs, Q,
                  R, stream);
  return launch(qcodes, qlens, (const int8_t*)m, db, starts, s_out, bq_out,
                bp_out, hst, est, nq, qlen_pad, nblocks, nseqs, Q, R, stream);
}
