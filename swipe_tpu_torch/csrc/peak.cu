// The card's integer peak probe (K10).
//
// Replaces the TPU kernel tools/mfu_stream.py measure_vpu_peak: chained
// int32 max/add with no memory traffic, the op mix of the DP recurrence,
//   x = max(x + a, y);  y = max(y - a, x)
// from y = x + a, a = 1, writing x + y.  Each element of x is one chain;
// a thread runs CHAINS independent chains, PEAK_STEPS steps unrolled per
// loop iteration, so only the chains' arithmetic is timed (the caller
// takes the slope between two iteration counts).  The step `a` is a
// kernel argument: with a literal 1 the compiler could prove
// y - 1 < max(x + 1, y) and drop the second max.
//
// Two forms, each for 1 and 8 chains a thread:
//   * plain: max and add written out.  nvcc may emit IADD3 + IMNMX (two
//     instructions a line) or fuse them into one VIADDMNMX; the caller
//     reads which from the SASS (cuobjdump) and so measures the issue
//     rate of what it finds;
//   * dpx: __viaddmax_s32(x, a, y), the DPX add-max, one instruction a
//     line by construction: the rate of the fused instruction.
// With 8 chains a thread and every SM full of warps the probe is bound by
// issue (the rate the kernels' operation bounds divide by); with one
// chain a thread and one warp an SM it is bound by the chain's latency.
#include <cstdint>
#include <cuda_runtime.h>

// steps of every chain per loop iteration; ops/peak.py's PEAK_STEPS
constexpr int PEAK_STEPS = 64;

template <int CHAINS, bool DPX>
__device__ __forceinline__ void peak_body(const int32_t* __restrict__ x_in,
                                          int32_t* __restrict__ out,
                                          int iters, int a) {
  const int nthreads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int x[CHAINS], y[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    x[c] = x_in[c * nthreads + tid];
    y[c] = x[c] + a;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < PEAK_STEPS; ++k) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        if (DPX) {
          x[c] = __viaddmax_s32(x[c], a, y[c]);
          y[c] = __viaddmax_s32(y[c], -a, x[c]);
        } else {
          x[c] = max(x[c] + a, y[c]);
          y[c] = max(y[c] - a, x[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) out[c * nthreads + tid] = x[c] + y[c];
}

// unmangled names, so the SASS of each form can be found by name
#define PEAK_KERNEL(name, chains, dpx)                                    \
  extern "C" __global__ void name(const int32_t* x, int32_t* out,         \
                                  int iters, int a) {                     \
    peak_body<chains, dpx>(x, out, iters, a);                             \
  }
PEAK_KERNEL(peak_plain_1, 1, false)
PEAK_KERNEL(peak_plain_8, 8, false)
PEAK_KERNEL(peak_dpx_1, 1, true)
PEAK_KERNEL(peak_dpx_8, 8, true)

// x, out: [chains, threads] int32, threads a multiple of block.
extern "C" int swipe_peak(const int32_t* x, int32_t* out, int chains,
                          int dpx, int threads, int block, int iters, int a,
                          void* stream) {
  if (block <= 0 || threads % block || (chains != 1 && chains != 8))
    return (int)cudaErrorInvalidValue;
  if (threads > 0) {
    const dim3 grid(threads / block);
    const cudaStream_t s = (cudaStream_t)stream;
    if (chains == 1 && !dpx)
      peak_plain_1<<<grid, block, 0, s>>>(x, out, iters, a);
    else if (chains == 1)
      peak_dpx_1<<<grid, block, 0, s>>>(x, out, iters, a);
    else if (!dpx)
      peak_plain_8<<<grid, block, 0, s>>>(x, out, iters, a);
    else
      peak_dpx_8<<<grid, block, 0, s>>>(x, out, iters, a);
  }
  return (int)cudaGetLastError();
}
