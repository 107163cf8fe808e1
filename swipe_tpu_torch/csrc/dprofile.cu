// Block score profiles of a lane-packed chunk (K1).
//
// Replaces the TPU kernel swipe_tpu/ops/sw_stream.py
// build_dprofile_series / _build_dprofile, which built the profile as a
// one-hot int8 matmul on the MXU.  Here it is a plain table lookup:
//
//   out[b, sym, j, lane] = int32(m8[sym, db[b * 16 + j, lane]])
//
// out is [nblocks, 32, 16, NSEQS] int32, the JAX array's memory order.
// Bound by bytes: each db byte becomes 32 int32 profile entries, so the
// kernel writes 128 bytes per byte it reads.  The design keeps every
// write a full 16-byte store: a thread reads 4 neighbouring lanes as one
// char4 and writes one int4 per symbol, so a warp stores 512 contiguous
// bytes at a time; the matrix sits in shared memory (conflict-free, see
// sw_common.cuh).
#include "sw_common.cuh"

using namespace swipe;

__global__ void __launch_bounds__(256)
dprofile_kernel(const int8_t* __restrict__ m8, const int8_t* __restrict__ db,
                int32_t* __restrict__ out, long long ncols, int nseqs) {
  __shared__ int m8s[NSYM * NSYM];
  load_matrix(m8s, m8);
  const int nq4 = nseqs / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ncols * nq4) return;
  const long long row = t / nq4;  // db column b * 16 + j
  const int l4 = (int)(t % nq4);
  const char4 d = reinterpret_cast<const char4*>(db + row * nseqs)[l4];
  const int d0 = d.x & (NSYM - 1), d1 = d.y & (NSYM - 1);
  const int d2 = d.z & (NSYM - 1), d3 = d.w & (NSYM - 1);
  const long long b = row / KSEG;
  const int j = (int)(row % KSEG);
  int4* o = reinterpret_cast<int4*>(
      out + ((b * NSYM) * KSEG + j) * (long long)nseqs) + l4;
  const long long sym_stride = (long long)KSEG * nseqs / 4;  // in int4
#pragma unroll 8
  for (int sym = 0; sym < NSYM; ++sym) {
    const int* r = m8s + sym * NSYM;
    o[sym * sym_stride] = make_int4(r[d0], r[d1], r[d2], r[d3]);
  }
}

extern "C" int swipe_dprofile(const int8_t* m8, const int8_t* db,
                              int32_t* out, long long ncols, int nseqs,
                              void* stream) {
  const long long n = ncols * (nseqs / 4);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    dprofile_kernel<<<(unsigned)blocks, threads, 0,
                      (cudaStream_t)stream>>>(m8, db, out, ncols, nseqs);
  }
  return (int)cudaGetLastError();
}
