// Wavefront scoring of chains of giant db columns (K7): each chain's
// columns cut into slabs that run at once across the card.
//
// Replaces the TPU kernel swipe_tpu/ops/sw_wavefront.py sw_wavefront
// (_wavefront_kernel).  A launch walks CHAINS: a chain is one query
// against one run of consecutive db columns, whose own running max it
// folds into its own slot of S.  Two kinds of launch:
//   * the TPU kernel's one segment (carry): a chain a query over the same
//     columns, starting from the caller's H and E of column -1 and
//     leaving those of its last column in their place, the state carried
//     segment to segment;
//   * a query group against every giant at once (no carry): a chain a
//     (query, giant, piece), each piece from a fresh state (H 0, E -inf)
//     and S[query, giant] the max over the giant's pieces.  The pieces
//     (ops/sw_wavefront.py plan_pieces) overlap by V, the db span of any
//     positive-score local alignment (pipeline._overlap_bound): every
//     such alignment lies whole in the piece that owns its last column,
//     and a fresh state never raises an H above the whole walk's (the
//     recurrence is monotone in H and E and the fresh state is the
//     least), so the max over pieces is the giant's score, EXACT.  The
//     pieces give one query's walk the card's width: a chain keeps about
//     (rows + 31) / 39 warps busy (below), a few dozen of the card's
//     hundreds of resident blocks.
//
// The TPU kernel walks a segment in 1024-column strips one after another,
// the query's rows its time axis.  Here the strips become slabs that run
// at the same time, pipelined across the SMs:
//   * the band walker of rows.cuh transposed: thread t of a warp owns COLS
//     consecutive db columns, their H of the row above and F in registers
//     for the whole slab, and at step s computes row s - t of them;
//   * E runs along the row through the thread's columns, one instruction
//     a column: it is taken from the cell before its max with E (hn =
//     max(diag + p, F, 0)), exact because Q >= R, as rows.cuh takes F.  E
//     and F are kept as E + Q and F + Q, so that H = max(E + Q - Q, hn)
//     and the next E + Q = max(E + Q - R, hn) are one DPX instruction
//     each;
//   * the thread hands its last column's H and E + Q for that row to
//     thread t + 1 with __shfl_up_sync; the H that arrived one step
//     earlier is the diagonal into its first column;
//   * the query profile sits in shared memory as int16 [sym][row]: the 32
//     threads of a warp are on 32 consecutive rows, so their lookups hit
//     at most two rows a bank, one word when the symbols agree.  A
//     lookup's address is a base common to the warp's step plus the
//     column's offset, held in a register for the whole slab;
//   * every thread computes every step, without a branch around the
//     cells: the profile holds PAD rows above and below the query's, rows
//     above it are virtual rows (H 0, as row -1 is) and rows below it PAD
//     rows, which never raise S; neither is stored.
// A warp (a block) covers a slab of 32 * COLS columns.  Its left edge (H
// and E + Q of every row at the column before the slab) comes from the
// slab to its left through global memory: that slab's thread 31 writes
// each row's 16 bytes {H, tag, E + Q, tag} with one store, and this slab
// loads them GROUP rows at a time, one group ahead, into shared memory,
// polling a row again until both its tags are the slab's (the 8-byte
// halves are single copies: the handoff of NCCL's LL protocol, so no
// fence is needed).  A chain's first slab stages column -1 (the carried
// state, or H 0 and E -inf); a carrying chain's last slab writes the new
// one.  Each warp folds its S into its chain's slot with atomicMax.
//
// Edges: a ring of two per chain.  Slab j writes ring slot j & 1 with
// tag j + 1 and slab j + 1 polls it for that tag; slab j + 2 writes the
// same slot again only after it has computed the row, so after slab j +
// 1 has read it (its row r needs slab j + 1's row r, which needs the
// row r slab j + 1 staged).  The wrapper zeroes the ring (tag 0, never
// awaited) on the launch's stream: 2 * 16 bytes a row and chain, 3 MB
// for 96 chains of 1,024 rows, whatever the columns walked.
//
// Tickets, and why none waits on a larger one: blocks take (chain, slab)
// tickets from a counter in the order they start, slab-major across the
// chains, so that every chain advances together.  The chains come sorted
// by slabs, most first, so slab j's tickets are those of the chains
// 0 .. n_j - 1 with more than j slabs, a prefix: ticket first[j] + c is
// chain c's slab j (first[j], the tickets before slab j, from the
// wrapper).  Slab j of chain c waits only on slab j - 1 of chain c,
// ticket first[j - 1] + c, which is smaller.  Every smaller ticket is
// done or held by a running block, since the grid is no larger than the
// blocks the card holds at once: the walk cannot deadlock.
//
// Bound: the throughput term at tblastn's call (16 queries of 512 rows
// against six 1.55-M-column frames), the critical path at one
// 262,144-column segment.  A step carries the wavefront COLS columns
// along a row and a slab starts about 2 * GROUP + 31 steps after the one
// to its left, so a chain of R rows keeps about (R + 31) / 39 warps busy;
// a warp issues the step's instructions one after another, and each
// thread's E runs through its COLS columns one dependent instruction
// after another, so a warp's step takes several times its issue time.
#include "sw_common.cuh"

using namespace swipe;

namespace {

constexpr int MAX_ROWS = 1024;
constexpr unsigned FULL = 0xffffffffu;
// columns a thread and rows a group of the left edge: 32 and 4 timed
// fastest against fewer columns, larger groups, blocks of 2 and 4 warps
// handing their edges on through shared memory, and E's chain along a
// row split in two (PERF.md);
// ops/sw_wavefront.py SLAB_COLS mirrors the slab, 32 * COLS
constexpr int COLS = 32;
constexpr int GROUP = 4;

// the profile's row stride: rows rounded to 64, so stride / 2 words is a
// multiple of 32 and a lookup's bank is its row's
__host__ __device__ constexpr int row_stride(int qlen_pad) {
  return (qlen_pad + 63) / 64 * 64;
}

// the profile holds PAD_ROWS PAD rows above and below the query's, so
// that every step's lookups, of every thread, stay in it
constexpr int PAD_ROWS = 32;

__host__ __device__ constexpr int prof_stride(int qlen_pad) {
  return row_stride(qlen_pad + 2 * PAD_ROWS);
}

// shared memory: the profile (int16 [NSYM][prof_stride]), the staged left
// edge (int4 [stride]) and the block's ticket
__host__ __device__ constexpr size_t wave_smem(int qlen_pad) {
  return sizeof(int16_t) * NSYM * prof_stride(qlen_pad) +
         sizeof(int4) * row_stride(qlen_pad) + sizeof(int);
}

// A row of an edge, {H, tag, E + Q, tag}, as one 16-byte store and load.
__device__ __forceinline__ void put_row(int4* p, int h, int e, int tag) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(h), "r"(tag), "r"(e), "r"(tag)
               : "memory");
}

__device__ __forceinline__ int4 get_row(const int4* p) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ bool whole(int4 v, int tag) {
  return v.y == tag && v.w == tag;
}

// The ticket's slab: the largest j with first[j] <= k, first rising from
// first[0] = 0 over nslab + 1 entries; a warp-wide search, 32 entries a
// round (3 rounds up to 32,768 slabs).
__device__ __forceinline__ int ticket_slab(const long long* first,
                                           int nslab, int k) {
  int lo = 0, n = nslab;
  while (n > 1) {
    const int step = (n + 31) / 32;
    const int i = lo + (int)threadIdx.x * step;
    const unsigned le =
        __ballot_sync(FULL, i < lo + n && __ldg(first + i) <= k);
    const int w = 31 - __clz(le);
    lo += w * step;
    n = min(step, n - w * step);
  }
  return lo;
}

// The query's profile, int16 [sym][stride] from int8 mq [qlen_pad][32],
// row r at r + pad; rows outside the query score as PAD: a thread takes
// rows 2p - pad and 2p + 1 - pad (64 bytes) and writes word p of every
// symbol, so a warp's stores hit 32 consecutive words.
__device__ __forceinline__ void load_profile(const int8_t* mqq, int qlen_pad,
                                             int stride, int pad,
                                             int16_t* prof) {
  constexpr int PADV = (int)0x80808080;
  uint32_t* words = reinterpret_cast<uint32_t*>(prof);
  for (int p = threadIdx.x; p < stride / 2; p += blockDim.x) {
    const int ra0 = 2 * p - pad, rb0 = ra0 + 1;
    int4 a[2] = {make_int4(PADV, PADV, PADV, PADV),
                 make_int4(PADV, PADV, PADV, PADV)};
    int4 b[2] = {a[0], a[1]};
    const int4* src = reinterpret_cast<const int4*>(mqq);
    if (ra0 >= 0 && ra0 < qlen_pad) {
      a[0] = src[2 * ra0];
      a[1] = src[2 * ra0 + 1];
    }
    if (rb0 >= 0 && rb0 < qlen_pad) {
      b[0] = src[2 * rb0];
      b[1] = src[2 * rb0 + 1];
    }
    const int* ra = reinterpret_cast<const int*>(a);
    const int* rb = reinterpret_cast<const int*>(b);
#pragma unroll
    for (int sym = 0; sym < NSYM; ++sym) {
      const int sh = 8 * (sym & 3);
      const int lo = (int)(int8_t)(ra[sym >> 2] >> sh);
      const int hi = (int)(int8_t)(rb[sym >> 2] >> sh);
      words[sym * (stride / 2) + p] =
          (uint32_t)(lo & 0xffff) | ((uint32_t)hi << 16);
    }
  }
}

// A chain: its first column in db, its query, its slot in s and its
// slabs (the wrapper's int64 [nchains, 4]).
struct Chain {
  long long off, q, slot, nslabs;
};

__global__ void __launch_bounds__(32)
wavefront_kernel(const int8_t* __restrict__ mq,
                 const int8_t* __restrict__ db,
                 const Chain* __restrict__ chains,
                 const long long* __restrict__ first, int nslab,
                 int32_t* h,
                 int32_t* e, int32_t* s, int4* edge, int* ticket_counter,
                 int qlen_pad, int Q, int R, int carry) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = row_stride(qlen_pad);
  const int pstride = prof_stride(qlen_pad);
  int16_t* prof = reinterpret_cast<int16_t*>(smem);
  int4* stage = reinterpret_cast<int4*>(prof + NSYM * pstride);
  int* ticket = reinterpret_cast<int*>(stage + stride);
  const int t = threadIdx.x;
  const int tickets = (int)__ldg(first + nslab);

  for (;;) {
    __syncwarp();          // the previous ticket's walk is over
    if (t == 0) *ticket = atomicAdd(ticket_counter, 1);
    __syncwarp();
    const int k = *ticket;
    if (k >= tickets) return;
    const int slab = ticket_slab(first, nslab, k);
    const int c = k - (int)__ldg(first + slab);
    const Chain ch = chains[c];
    const int q = (int)ch.q;
    load_profile(mq + (long long)q * qlen_pad * NSYM, qlen_pad, pstride,
                 PAD_ROWS, prof);
    const bool head = slab == 0;
    const bool last = slab == ch.nslabs - 1;  // a carry writes the state
    int32_t* hq = h + (long long)q * qlen_pad;
    int32_t* eq = e + (long long)q * qlen_pad;
    // the ring: the left edge in slot (slab - 1) & 1 with tag slab, the
    // right edge into slot slab & 1 with tag slab + 1
    const int4* left = edge + ((long long)c * 2 + ((slab + 1) & 1)) * stride;
    int4* right = edge + ((long long)c * 2 + (slab & 1)) * stride;

    // the thread's columns: the byte offsets of their symbols' profile
    // rows, less the thread's row lag, so that row st - t of column i is
    // at (profile + st) + off[i], a uniform base plus a register; kept
    // opaque, so the compiler holds them instead of rebuilding them from
    // the symbols every step
    int off[COLS];
    {
      const int* col = reinterpret_cast<const int*>(
          db + ch.off + ((long long)slab * 32 + t) * COLS);
#pragma unroll
      for (int i = 0; i < COLS / 4; ++i) {
        const int v = col[i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          off[4 * i + j] =
              2 * (((v >> (8 * j)) & (NSYM - 1)) * pstride + PAD_ROWS - t);
      }
#pragma unroll
      for (int i = 0; i < COLS; ++i) asm volatile("" : "+r"(off[i]));
    }

    // the left edge, staged GROUP rows at a time, loaded one group ahead:
    // column -1 for the chain's first slab (the carried H and the cell's
    // own E, or H 0 and E -inf; made E + Q of the next column when
    // stored), else the slab to the left's edge.  Thread t < GROUP holds
    // row r0 + t until it is stored.
    int4 fv = make_int4(0, 0, NEG_INF, 0);
    auto fetch = [&](int r0) {
      const int r = r0 + t;
      if (t >= GROUP || r >= qlen_pad) return;
      fv = !head   ? get_row(left + r)
           : carry ? make_int4(hq[r], 0, eq[r], 0)
                   : make_int4(0, 0, NEG_INF, 0);
    };
    fetch(0);
    __syncwarp();          // the profile

    int Hc[COLS], Fp[COLS];      // H of the row above, F + Q into this row
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      Hc[i] = 0;
      Fp[i] = NEG_INF;
    }
    int S = 0;
    int hl = 0, el = NEG_INF;    // left H and E + Q of the row this step
    int hprev = 0;               // left H of the row above: the diagonal
    int hout = 0, eout = NEG_INF;
    const int steps = qlen_pad + 31;
    for (int st = 0; st < steps; ++st) {
      if (st % GROUP == 0) {
        // store group st / GROUP (loaded one group ago, polled again
        // until whole), load the next
        if (t < GROUP && st + t < qlen_pad) {
          while (!whole(fv, slab)) {
            __nanosleep(20);
            fv = get_row(left + st + t);
          }
          if (head) fv.z = __viaddmax_s32(fv.z, Q - R, fv.x);
          stage[st + t] = fv;
        }
        __syncwarp();
        fetch(st + GROUP);
      }
      const int r = st - t;
      if (t == 0 && r < qlen_pad) {
        const int4 v = stage[r];
        hl = v.x;
        el = v.z;
      }
      // the cells of row r, a virtual or PAD row outside the query
      const char* pr = reinterpret_cast<const char*>(prof + st);
      int hn[COLS];
#pragma unroll
      for (int i = 0; i < COLS; ++i)
        hn[i] = *reinterpret_cast<const int16_t*>(pr + off[i]);
      int d = hprev;
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        hn[i] = __viaddmax_s32_relu(Fp[i], -Q, d + hn[i]);
        d = Hc[i];
      }
      int E = el, eown = el;
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        eown = E;
        const int hh = __viaddmax_s32(E, -Q, hn[i]);
        E = __viaddmax_s32(E, -R, hn[i]);
        Hc[i] = hh;
        Fp[i] = __viaddmax_s32(Fp[i], -R, hh);
      }
#pragma unroll
      for (int i = 0; i + 1 < COLS; i += 2)
        S = __vimax3_s32(S, Hc[i], Hc[i + 1]);
      hout = Hc[COLS - 1];
      eout = E;
      if (t == 31 && r >= 0 && r < qlen_pad) {
        if (!last) {
          put_row(right + r, hout, eout, slab + 1);
        } else if (carry) {
          hq[r] = hout;
          eq[r] = eown - Q;
        }
      }
      hprev = hl;
      hl = __shfl_up_sync(FULL, hout, 1);
      el = __shfl_up_sync(FULL, eout, 1);
    }
    S = __reduce_max_sync(FULL, S);
    if (t == 0) atomicMax(s + ch.slot, S);
  }
}

}  // namespace

// The blocks of wavefront_kernel the card holds at once at qlen_pad rows
// (its SMs times the blocks an SM holds), written to *out.
static cudaError_t resident_blocks(int qlen_pad, int* out) {
  const size_t smem = wave_smem(qlen_pad);
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, wavefront_kernel, 32, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return cudaSuccess;
}

extern "C" int swipe_wavefront_resident(int qlen_pad, int* out) {
  if (qlen_pad <= 0 || qlen_pad > MAX_ROWS) return (int)cudaErrorInvalidValue;
  return (int)resident_blocks(qlen_pad, out);
}

// mq [nq, qlen_pad, 32] int8 per-row scores, db int8 symbols; chains
// int64 [nchains, 4] (first column in db, query, slot in s, slabs of
// 32 * COLS columns), sorted by slabs, most first, and first int64
// [nslab + 1] the tickets before each slab (first[nslab] = tickets, all
// of them);
// s the chains' slots, int32, folded into with atomicMax.  carry: h/e
// [nq, qlen_pad] int32 are column -1's state, replaced by the last
// column's (one chain a query); else every chain starts fresh and h/e
// are not read.  edge the ring (int4 [nchains, 2, row_stride(qlen_pad)])
// and ticket the ticket counter (int32 [1]), both zeroed before each
// launch.  Needs Q >= R.
extern "C" int swipe_wavefront(const int8_t* mq, const int8_t* db,
                               const long long* chains,
                               const long long* first,
                               int nchains, int nslab, int32_t* h,
                               int32_t* e, int32_t* s, int4* edge,
                               int* ticket, int tickets, int qlen_pad, int Q,
                               int R, int carry, void* stream) {
  if (nchains <= 0 || nslab <= 0 || tickets <= 0 || qlen_pad <= 0)
    return (int)cudaGetLastError();
  if (qlen_pad > MAX_ROWS || Q < R) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = resident_blocks(qlen_pad, &resident);
  if (err != cudaSuccess) return (int)err;
  wavefront_kernel<<<min(tickets, resident), 32, wave_smem(qlen_pad),
                     (cudaStream_t)stream>>>(
      mq, db, reinterpret_cast<const Chain*>(chains), first, nslab, h, e, s,
      edge, ticket, qlen_pad, Q, R, carry);
  return (int)cudaGetLastError();
}
