// The lane form of K3, the carry kernel: stream scoring of one chunk of a
// flow series, a thread a (query, lane).
//
// Replaces the TPU kernel swipe_tpu/ops/sw_stream.py sw_scores_stream_carry
// (_stream_kernel) in its launches with block profiles: the flow series.
// Exact affine-gap Smith-Waterman of NQ queries against every lane of a
// chunk, with each lane's H/E/S carried in from the chunk before and out
// to the next; a lane's state resets where the start mask says a new
// sequence begins, and each lane's running max is dumped after every
// block of 16 columns: out[q, b, lane].  Launches without profiles (the
// giant carry series) take K3's row form in carry_rows.cu
// (ops/sw_stream.py carry_form); K2, the plain-pack kernel, runs on the
// band walker in carry_rows.cu too.
//
// Design.  One thread owns one (query, lane) and walks the db blocks in
// order -- the TPU's sequential grid axis becomes a loop in the thread.
// Threads of a warp take neighbouring lanes, so every global access
// (db symbols, start mask, profiles, row state, dump) is coalesced.
// Inside a block the thread walks the query rows; the 16 columns' H and
// F of the previous row stay in registers.  The H/E of the block's last
// column for every row live in the carried state [NQ, QLEN, NSEQS] (the
// lane-flat layout of the JAX lax twin), read and written once per
// (row, block): 16 bytes per 16 cells.  The cell is
//   H = max(diag + p, E, F, 0), clamp, S = max(S, H)
// with E and F stored pre-advanced into the next cell, as in the TPU
// kernel.  p comes from the precomputed block profile (dprofile.cu) when
// given, else from the matrix in shared memory indexed by the query
// symbol and the column's db symbol.
//
// The carried state is updated in place (for a series' last chunk the
// caller passes a copy).  With CARRY the first block reads the carried
// H/E and S from s_io, and a lane starts fresh there only where its start
// bit is set; S goes back to s_io.
//
// Bound: operations.  As written a cell takes ten two-operand int32
// add/max against one profile read (4 bytes, from L2) and one byte of row
// state; with the DPX add-max instructions it would take six, and no SM
// issues more than 128 thread instructions a clock, which sets the least
// time (chip_smoke.py).  The design is far from it: a cell's add/max
// form one dependent chain per thread, and NQ x NSEQS / 128 thread
// blocks leave few warps per SM to cover it.
//
// Matrices outside int8 (build_matrix_wide: int32 scores, a strictly
// negative PAD row and column) take a wide instantiation, the matrix
// element type a template parameter: matrix lookup only, no profiles and
// no clamp.  The row state has no cap, so it takes any query length.
//
// Running exactly qlen rows is enough: the TPU kernel's round-up to 4
// rows only added PAD rows, which decay and never raise S.  Rows at and
// past qlen are neither read nor written.
#include "sw_common.cuh"

using namespace swipe;

template <typename M, bool DPROF, bool CLAMP, bool CARRY>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const int32_t* __restrict__ qcodes,
              const int32_t* __restrict__ qlens,
              const M* __restrict__ m8, const int8_t* __restrict__ db,
              const int8_t* __restrict__ start,
              const int32_t* __restrict__ dprof, int32_t* __restrict__ out,
              int32_t* __restrict__ hst, int32_t* __restrict__ est,
              int32_t* __restrict__ s_io, int qlen_pad, int nblocks,
              int nseqs, int Q, int R, int clamp) {
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

  int S = CARRY ? s_io[q * n + lane] : 0;
  for (int b = 0; b < nblocks; ++b) {
    // from a fresh state block 0 starts like a set start bit; carried,
    // only the start bit resets and block 0 reads the carried state
    const bool fresh = (!CARRY && b == 0) || start[b * n + lane] != 0;
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
  s_io[q * n + lane] = S;
}

#define STREAM_PARAMS                                                      \
  const int32_t *qcodes, const int32_t *qlens, const M *m8,                \
      const int8_t *db, const int8_t *start, const int32_t *dprof,         \
      int32_t *out, int32_t *hst, int32_t *est, int32_t *s_io,             \
      int qlen_pad, int nblocks, int nseqs, int Q, int R, int clamp
#define STREAM_ARGS                                                        \
  qcodes, qlens, m8, db, start, dprof, out, hst, est, s_io, qlen_pad,      \
      nblocks, nseqs, Q, R, clamp

// mode 1: from a fresh state; 2: reading the carried state
template <typename M, bool DPROF, bool CLAMP>
static void launch_mode(dim3 grid, cudaStream_t s, int mode,
                        STREAM_PARAMS) {
  if (mode == 2)
    stream_kernel<M, DPROF, CLAMP, true>
        <<<grid, THREADS, 0, s>>>(STREAM_ARGS);
  else
    stream_kernel<M, DPROF, CLAMP, false>
        <<<grid, THREADS, 0, s>>>(STREAM_ARGS);
}

// The int8 matrix takes profiles and a clamp in any combination; the
// wide one neither (matrix lookup only, and no route clamps it).
template <typename M>
static int launch(int nq, int use_clamp, int mode, void* stream,
                  STREAM_PARAMS) {
  if (sizeof(M) == 4 && (dprof != nullptr || use_clamp))
    return (int)cudaErrorInvalidValue;
  if (nq > 0 && nseqs > 0 && nblocks > 0) {
    const dim3 grid((nseqs + THREADS - 1) / THREADS, nq);
    const cudaStream_t s = (cudaStream_t)stream;
    if constexpr (sizeof(M) == 4) {
      launch_mode<M, false, false>(grid, s, mode, STREAM_ARGS);
    } else if (dprof != nullptr) {
      if (use_clamp) launch_mode<M, true, true>(grid, s, mode, STREAM_ARGS);
      else launch_mode<M, true, false>(grid, s, mode, STREAM_ARGS);
    } else {
      if (use_clamp) launch_mode<M, false, true>(grid, s, mode, STREAM_ARGS);
      else launch_mode<M, false, false>(grid, s, mode, STREAM_ARGS);
    }
  }
  return (int)cudaGetLastError();
}

// hst/est/s_io hold the carried state and are updated in place; with
// carry_in 0 every lane starts fresh at block 0 and H/E/S are not read.
// m is the int8 matrix (build_matrix8), or with wide set the int32 one
// (build_matrix_wide: the carry series of the segment route for matrices
// outside int8), which takes no profiles and no clamp.
extern "C" int swipe_stream_carry(
    const int32_t* qcodes, const int32_t* qlens, const void* m,
    const int8_t* db, const int8_t* start, const int32_t* dprof,
    int32_t* out, int32_t* hst, int32_t* est, int32_t* s_io, int carry_in,
    int wide, int nq, int qlen_pad, int nblocks, int nseqs, int Q, int R,
    int use_clamp, int clamp, void* stream) {
  const int mode = carry_in ? 2 : 1;
  if (wide) {
    const int32_t* m8 = (const int32_t*)m;
    return launch(nq, use_clamp, mode, stream, STREAM_ARGS);
  }
  const int8_t* m8 = (const int8_t*)m;
  return launch(nq, use_clamp, mode, stream, STREAM_ARGS);
}
