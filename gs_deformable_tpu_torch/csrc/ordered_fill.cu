// Ordered fill: prefix fill and placement of rows at sorted unique positions.
//
// Replaces the TPU kernel gs_deformable_tpu/ops/pallas/ordered_fill.py:_kernel
// in both of its modes (ordered_prefix_fill, ordered_place_i32):
//
//   prefix: out[c, k] = sum over j with pos[j] <= k of delta[j, c]   (C, K)
//   place:  out = zeros(K); out[pos[j]] = vals[j]                     (K,)
//
// pos is int32, ascending and unique; entries < 0 or >= K drop.  Values are
// int32 and the arithmetic is integer, so the result is exact: the TPU
// kernel's Dekker-split bf16 matmuls existed only because its matrix unit
// rounds fp32, and have no counterpart here.
//
// What bounds it on the H100.  The bytes are few: the prefix fill reads
// n*(C+1)*4 and writes C*K*4 (12 MB at the 1080p front fill, 3.6 us at
// 3.35 TB/s), the place reads n*8 and writes K*4.  What holds a call is
// latency: the launch, chains of dependent loads (finding a block's rows,
// the carry from the blocks before) and the barriers between them.  So each
// call is ONE launch of one pass, and every chain is kept short:
//
// - Each CUDA block owns BLOCK = 4096 consecutive output positions (256
//   threads x 16).  pos is sorted, so the rows landing there are one range.
//   One round of 512 probes of pos, evenly spaced over the rows and the same
//   for every block (so they hit in L2 after the first block), brackets both
//   ends of that range to within ceil(n / 512) rows: one dependent load,
//   where a binary search from one thread took 17.  The block then reads the
//   bracketed rows, 4 to 16 a thread in flight at once, and keeps those whose
//   position falls in its range.  It zeroes its window in shared memory
//   while the probes are on the way.
// - The rows go into the window and are summed per channel.  The prefix
//   fill scans the window 16 positions a thread in registers plus one warp
//   shuffle scan; the window rows carry 4 padding words after every 32, so
//   both the scan's 16-position reads and the write-out's 4-position reads
//   are 16-byte and free of bank conflicts.  Every output element is written
//   once, with 16-byte stores; where a row of the (C, K) output does not
//   start 16-byte aligned (K not a multiple of 4), its first positions up to
//   the first aligned one go out as scalars, as do the last few of a row.
// - The prefix fill takes the carry of the blocks before it by decoupled
//   look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
//   Decoupled Look-back", 2016).  A block publishes its aggregate (C sums)
//   as soon as its rows are read and its inclusive prefix once its carry is
//   known.  Warp 0 reads back over 160 predecessors a round (5 a lane, all
//   loads in flight together), summing aggregates up to the nearest
//   inclusive prefix, so at the render path's 144 blocks one round covers
//   every predecessor; it waits (with a short sleep between reads) only
//   while an aggregate it needs is missing.  The place needs no carry.
//
// What is left (a per-phase clock trace of the two kernels at the 1080p
// shapes): the launch, the probe and row loads from cold memory, the wait
// for the slowest predecessor's aggregate, and the C*K*4-byte write-out,
// which runs at about the memory's rate.
//
// Forward progress.  Prefix blocks take their logical index from an atomic
// ticket, not from blockIdx, so a block only ever waits for blocks that took
// a smaller ticket, that is, blocks already running on an SM.  The block
// with ticket 0 waits for nobody, and by induction every block finishes,
// whatever order the hardware schedules blocks in.
//
// State between launches.  The status words live in one small buffer: one
// ticket counter, then MAX_C aggregate and MAX_C inclusive words per block.
// Each status word is 64 bits, the launch's epoch in the high half and the
// int32 value in the low half, written and read whole (relaxed, GPU scope),
// so a word is valid for a launch exactly when it carries that launch's
// epoch.  The block that takes the launch's last ticket resets the counter
// to 0: every other ticket of the launch is taken by then.  Where the
// buffer comes from decides which epochs it can hold, and the wrapper keeps
// every call a pure function of (pos, delta, K) in both of its cases:
//
// - A call issued from the host takes the buffer the wrapper keeps per
//   device and stream and a new epoch (never 0, the value of a freshly
//   zeroed buffer), so no launch needs the words cleared: the launch before
//   it on the stream has ended, and its words carry an older epoch.  Before
//   the epoch would wrap, the wrapper replaces the buffer by a zeroed one.
// - A call captured into a CUDA graph takes a buffer of its own, zeroed by
//   torch.zeros inside the capture, and epoch 1.  A graph replays the epoch
//   it was captured with, and it replays the memset node too, so every
//   replay starts from words that carry no epoch at all.  Two captured calls
//   never share a buffer, so graphs replayed on two streams at once cannot
//   read each other's words, and an eager call between two replays on the
//   same stream uses the other buffer.  The price is one memset of
//   ordered_fill_state_words(K) * 8 bytes per captured call (22 KB at the
//   1080p render's 144 blocks).
//
// Of the two designs that keep a replay pure, this one leaves the kernel as
// it was.  The other, an epoch word kept on the card and advanced by the
// launch's last block, would change the eager kernel and its time, needs a
// fence between each block's epoch read and its ticket, and still shares
// one buffer between graphs captured on one stream.
//
// A launch refused at the call never touches the buffer; the next one
// finds the counter at 0.  A launch that faults on the card leaves the
// CUDA context unusable, and with it every later launch, so no state
// survives a fault to be read.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 16;
constexpr int BLOCK = THREADS * PER_THREAD;  // output positions per CUDA block
constexpr int POS_PER_WARP = 32 * PER_THREAD;
constexpr int ROW = BLOCK + BLOCK / 8;       // a window row with its padding words
constexpr int MAX_C = 8;
constexpr int PROBES_PER_THREAD = 2;
constexpr int PROBE_ROWS = THREADS * PROBES_PER_THREAD;  // first-round probes of pos
constexpr int LOOK_BACK_ROWS = 5;  // predecessors a look-back lane reads per round
// The ticket sits alone, 4 KB before the status words that every look-back
// polls, so its atomics do not queue behind those loads.
constexpr int STATUS_OFFSET = 512;  // in 64-bit words
constexpr unsigned FULL = 0xffffffffu;

// Window slot of block position r: 4 padding words after every 32.
__device__ __forceinline__ int slot(int r) { return r + ((r >> 5) << 2); }

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// One round of PROBE_ROWS probes of pos, spaced evenly over [0, n): the
// same rows for every block, so after the first block they hit in L2, and
// independent of the block's position range, so a prefix block issues them
// while its ticket is on the way.
__device__ __forceinline__ void load_probes(const int32_t* __restrict__ pos, int n, int stride,
                                            int32_t (&probe)[PROBES_PER_THREAD]) {
#pragma unroll
  for (int k = 0; k < PROBES_PER_THREAD; ++k) {
    const int q = (threadIdx.x + THREADS * k) * stride;
    probe[k] = q < n ? __ldg(pos + q) : INT_MAX;
  }
}

// Rows [lo, hi) that hold every row with key_lo <= pos < key_hi.  c probes
// below a key put the first row at or above it in ((c - 1) * stride,
// c * stride], so the range is at most 2 * stride rows longer than the rows
// wanted, and the caller filters by position.  Ends with a block barrier.
__device__ __forceinline__ int2 bracket(const int32_t (&probe)[PROBES_PER_THREAD], int n,
                                        int stride, int key_lo, int key_hi, int* s_count) {
  int below = 0;  // probes below key_lo in the low half, below key_hi in the high half
#pragma unroll
  for (int k = 0; k < PROBES_PER_THREAD; ++k)
    below += (probe[k] < key_lo) + ((probe[k] < key_hi) << 16);
  below = (int)__reduce_add_sync(FULL, (unsigned)below);
  if ((threadIdx.x & 31) == 0) s_count[threadIdx.x >> 5] = below;
  __syncthreads();
  below = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) below += s_count[w];
  const int c_lo = below & 0xffff, c_hi = below >> 16;
  return make_int2(c_lo == 0 ? 0 : (c_lo - 1) * stride + 1, min(c_hi * stride, n));
}

// One 16-byte store to global memory (p 16-byte aligned).  Written out, as
// the compiler splits some int4 stores through a cast pointer into four.
__device__ __forceinline__ void store16(int32_t* p, int4 v) {
  asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}

// Row j of the (n, C) deltas, with one 16- or 8-byte load where C allows.
template <int C>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ delta, int j,
                                         int32_t (&v)[C]) {
  if constexpr (C == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(delta) + j);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (C == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(delta) + j);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(delta + (size_t)j * C + c);
  }
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned epoch,
                                             int32_t v) {
  const unsigned long long w = ((unsigned long long)epoch << 32) | (uint32_t)v;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// Words [0, C) of one block's status, two to a 16-byte load (each 8-byte
// word is still read whole).
template <int C>
__device__ __forceinline__ void load_status(const unsigned long long* p,
                                            unsigned long long (&w)[C]) {
#pragma unroll
  for (int c = 0; c + 1 < C; c += 2)
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(w[c]), "=l"(w[c + 1]) : "l"(p + c) : "memory");
  if constexpr (C & 1)
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w[C - 1]) : "l"(p + C - 1) : "memory");
}

// Warp 0 of block b > 0: the per-channel sum of every block before b.  Lane
// c < C returns channel c's sum.  Each round reads back over 32 * R
// predecessors at once: lane l the aggregates of those at distances
// R*l .. R*l + R - 1 and the inclusive prefix of the first of them.  The
// round's sum runs up to the nearest inclusive prefix read, or over all 32 * R
// aggregates if there is none; it waits while an aggregate it needs is
// missing.
template <int C>
__device__ int32_t look_back(const unsigned long long* __restrict__ agg,
                             const unsigned long long* __restrict__ incl, int b,
                             unsigned epoch) {
  constexpr int R = C <= 4 ? LOOK_BACK_ROWS : 2;  // 160 predecessors a round for C <= 4
  const int lane = threadIdx.x & 31;
  int32_t carry = 0;
  for (int end = b;; end -= 32 * R) {
    const int q = end - 1 - R * lane;  // this lane's nearest predecessor
    unsigned long long wa[R][C], wi[C];
    int last;  // lane holding the nearest inclusive prefix (32 if none)
    for (int spin = 0;; ++spin) {
      if (spin > 0) __nanosleep(100);  // let the predecessors' stores through
#pragma unroll
      for (int c = 0; c < C; ++c) {
        wi[c] = 0;
#pragma unroll
        for (int i = 0; i < R; ++i) wa[i][c] = 0;
      }
      if (q >= 0) load_status<C>(incl + (size_t)q * MAX_C, wi);
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (q - i >= 0) load_status<C>(agg + (size_t)(q - i) * MAX_C, wa[i]);
      bool prefix = true, missing = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        prefix &= q < 0 || (unsigned)(wi[c] >> 32) == epoch;
#pragma unroll
        for (int i = 0; i < R; ++i) missing |= q - i >= 0 && (unsigned)(wa[i][c] >> 32) != epoch;
      }
      const unsigned with_prefix = __ballot_sync(FULL, prefix);
      last = with_prefix ? __ffs(with_prefix) - 1 : 32;
      if (!__any_sync(FULL, lane < last && missing)) break;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int32_t s = 0;
      if (lane < last) {
#pragma unroll
        for (int i = 0; i < R; ++i) s += (int32_t)(uint32_t)wa[i][c];
      } else if (lane == last) {
        s = (int32_t)(uint32_t)wi[c];
      }
      s = warp_sum(s);
      if (lane == c) carry += s;
    }
    if (last < 32) return carry;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
    prefix_fill(const int32_t* __restrict__ pos, const int32_t* __restrict__ delta, int n,
                int K, int nb, unsigned* __restrict__ ticket,
                unsigned long long* __restrict__ agg, unsigned long long* __restrict__ incl,
                unsigned epoch, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t win[];  // C rows of ROW words
  __shared__ int s_b, s_count[WARPS];
  __shared__ int32_t s_part[WARPS][C];   // per-warp sums of the placed rows
  __shared__ int32_t s_wtot[C][WARPS];   // per-warp totals of the in-block scan
  __shared__ int32_t s_before[C];        // sum of every block before this one
  __shared__ int32_t s_carry[C][WARPS];  // what each warp's positions add
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int stride = (n + PROBE_ROWS - 1) / PROBE_ROWS;
  if (tid == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == (unsigned)nb - 1u) atomicExch(ticket, 0u);  // the launch's last ticket
    s_b = (int)t;
  }
  int32_t probe[PROBES_PER_THREAD];
  load_probes(pos, n, stride, probe);
  for (int i = tid; i < C * ROW / 4; i += THREADS)
    reinterpret_cast<int4*>(win)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int b = s_b;
  const int base = b * BLOCK;
  const int end = base + min(BLOCK, K - base);  // this block's positions inside [0, K)
  const int2 rows = bracket(probe, n, stride, base, end, s_count);

  int32_t acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0;
  constexpr int RPT = C <= 4 ? 8 : 4;  // rows a thread has in flight
  for (int j0 = rows.x + tid; j0 < rows.y; j0 += RPT * THREADS) {
    int p[RPT];
    int32_t v[RPT][C];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int j = j0 + k * THREADS;
      p[k] = j < rows.y ? __ldg(pos + j) : -1;
      load_row<C>(delta, j < rows.y ? j : rows.x, v[k]);
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (p[k] >= base && p[k] < end) {
        const int r = slot(p[k] - base);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          win[c * ROW + r] = v[k][c];
          acc[c] += v[k][c];
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t v = warp_sum(acc[c]);
    if (lane == 0) s_part[warp][c] = v;
  }
  __syncthreads();

  // Publish the aggregate as early as possible; the look-back comes after
  // this warp's share of the scan.
  int32_t total = 0;  // lane c < C of warp 0: channel c's sum over this block
  if (warp == 0 && lane < C) {
    for (int w = 0; w < WARPS; ++w) total += s_part[w][lane];
    store_status(agg + (size_t)b * MAX_C + lane, epoch, total);
    if (b == 0) store_status(incl + lane, epoch, total);
  }

  // In-block inclusive scan: 16 positions a thread, then the thread totals
  // across the warp; the carry of earlier warps and blocks comes at write-out.
#pragma unroll
  for (int c = 0; c < C; ++c) {
    int4* p4 = reinterpret_cast<int4*>(win + c * ROW + slot(tid * PER_THREAD));
    int32_t v[PER_THREAD];
#pragma unroll
    for (int q = 0; q < PER_THREAD / 4; ++q) {
      const int4 x = p4[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int e = 1; e < PER_THREAD; ++e) v[e] += v[e - 1];
    const int32_t own = v[PER_THREAD - 1];
    int32_t x = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    const int32_t ex = x - own;
#pragma unroll
    for (int q = 0; q < PER_THREAD / 4; ++q)
      p4[q] = make_int4(v[4 * q] + ex, v[4 * q + 1] + ex, v[4 * q + 2] + ex, v[4 * q + 3] + ex);
    if (lane == 31) s_wtot[c][warp] = x;
  }
  if (warp == 0) {
    const int32_t before = b == 0 ? 0 : look_back<C>(agg, incl, b, epoch);
    if (lane < C) {
      if (b > 0) store_status(incl + (size_t)b * MAX_C + lane, epoch, before + total);
      s_before[lane] = before;
    }
  }
  __syncthreads();
  if (tid < C * WARPS) {
    const int c = tid / WARPS, w = tid % WARPS;
    int32_t carry = s_before[c];
    for (int u = 0; u < w; ++u) carry += s_wtot[c][u];
    s_carry[c][w] = carry;
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t* row = win + c * ROW;
    const int32_t* carry = s_carry[c];
    int32_t* orow = out + (size_t)c * K + base;
    // positions before the row's first 16-byte aligned one (base % 4 == 0)
    const int h = (int)((4u - (unsigned)(((size_t)c * K) & 3u)) & 3u);
    const int lim = end - base;
    const int head = min(h, lim);
    if (tid < head) orow[tid] = row[slot(tid)] + carry[tid / POS_PER_WARP];
    const int nvec = (lim - head) >> 2;
    for (int m = tid; m < nvec; m += THREADS) {
      const int r = head + 4 * m;
      int4 v;
      if (h == 0) {
        v = *reinterpret_cast<const int4*>(row + slot(r));
      } else {
        const int4 a = *reinterpret_cast<const int4*>(row + slot(r - h));
        const int4 e = *reinterpret_cast<const int4*>(row + slot(r - h + 4));
        v = h == 1 ? make_int4(a.y, a.z, a.w, e.x)
                   : h == 2 ? make_int4(a.z, a.w, e.x, e.y) : make_int4(a.w, e.x, e.y, e.z);
      }
      v.x += carry[r / POS_PER_WARP];
      v.y += carry[(r + 1) / POS_PER_WARP];
      v.z += carry[(r + 2) / POS_PER_WARP];
      v.w += carry[(r + 3) / POS_PER_WARP];
      store16(orow + r, v);
    }
    const int r = head + 4 * nvec + tid;
    if (r < lim) orow[r] = row[slot(r)] + carry[r / POS_PER_WARP];
  }
}

__global__ void __launch_bounds__(THREADS)
    place(const int32_t* __restrict__ pos, const int32_t* __restrict__ vals, int n, int K,
          int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t win[BLOCK];
  __shared__ int s_count[WARPS];
  const int tid = threadIdx.x;
  const int stride = (n + PROBE_ROWS - 1) / PROBE_ROWS;
  const int base = blockIdx.x * BLOCK;
  const int lim = min(BLOCK, K - base);
  int32_t probe[PROBES_PER_THREAD];
  load_probes(pos, n, stride, probe);
  for (int i = tid; i < BLOCK / 4; i += THREADS)
    reinterpret_cast<int4*>(win)[i] = make_int4(0, 0, 0, 0);
  const int2 rows = bracket(probe, n, stride, base, base + lim, s_count);
  // Rows past the range reread its last row and store the same value again,
  // so every load is unconditional and all of them are in flight at once.
  constexpr int RPT = 16;  // rows a thread has in flight
  for (int j0 = rows.x + tid; j0 < rows.y; j0 += RPT * THREADS) {
    int p[RPT];
    int32_t v[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int j = min(j0 + k * THREADS, rows.y - 1);
      p[k] = __ldg(pos + j);
      v[k] = __ldg(vals + j);
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (p[k] >= base && p[k] < base + lim) win[p[k] - base] = v[k];
  }
  __syncthreads();
  const int nvec = lim >> 2;  // out and base are 16-byte aligned
  for (int m = tid; m < nvec; m += THREADS)
    store16(out + base + 4 * m, reinterpret_cast<const int4*>(win)[m]);
  const int r = 4 * nvec + tid;
  if (r < lim) out[base + r] = win[r];
}

template <int C>
int launch_prefix(const int32_t* pos, const int32_t* delta, int n, int K, int nb,
                  unsigned long long* state, unsigned epoch, int32_t* out, cudaStream_t s) {
  const int smem = C * ROW * (int)sizeof(int32_t);
  if (smem > 48 * 1024) {  // above 48 KB only once the kernel is allowed it
    static bool allowed[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(prefix_fill<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) allowed[dev] = true;
    }
  }
  unsigned long long* status = state + STATUS_OFFSET;
  prefix_fill<C><<<nb, THREADS, smem, s>>>(pos, delta, n, K, nb, (unsigned*)state, status,
                                           status + (size_t)MAX_C * nb, epoch, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 64-bit words of ordered_prefix_fill's state buffer for K output positions
// (zeroed when the buffer is allocated, and by every replay of a captured
// call): the ticket, then MAX_C aggregate and MAX_C inclusive status words
// per block.
int ordered_fill_state_words(int K) {
  return STATUS_OFFSET + 2 * MAX_C * ((K + BLOCK - 1) / BLOCK);
}

int ordered_prefix_fill(const void* pos, const void* delta, int n, int C, int K, void* state,
                        unsigned epoch, void* out, void* stream) {
  if (C < 1 || C > MAX_C || K < 1 || n < 0 || epoch == 0 || ((uintptr_t)out & 15u) ||
      ((uintptr_t)delta & 15u))
    return (int)cudaErrorInvalidValue;
  const int nb = (K + BLOCK - 1) / BLOCK;
  const int32_t* p = (const int32_t*)pos;
  const int32_t* d = (const int32_t*)delta;
  unsigned long long* st = (unsigned long long*)state;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch_prefix<1>(p, d, n, K, nb, st, epoch, o, s);
    case 2: return launch_prefix<2>(p, d, n, K, nb, st, epoch, o, s);
    case 3: return launch_prefix<3>(p, d, n, K, nb, st, epoch, o, s);
    case 4: return launch_prefix<4>(p, d, n, K, nb, st, epoch, o, s);
    case 5: return launch_prefix<5>(p, d, n, K, nb, st, epoch, o, s);
    case 6: return launch_prefix<6>(p, d, n, K, nb, st, epoch, o, s);
    case 7: return launch_prefix<7>(p, d, n, K, nb, st, epoch, o, s);
    default: return launch_prefix<8>(p, d, n, K, nb, st, epoch, o, s);
  }
}

int ordered_place_i32(const void* pos, const void* vals, int n, int K, void* out,
                      void* stream) {
  if (K < 1 || n < 0 || ((uintptr_t)out & 15u)) return (int)cudaErrorInvalidValue;
  place<<<(K + BLOCK - 1) / BLOCK, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pos, (const int32_t*)vals, n, K, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
