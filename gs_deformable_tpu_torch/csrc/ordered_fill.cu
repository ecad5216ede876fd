// Ordered fill: prefix fill and placement of rows at sorted unique positions.
//
// Replaces the TPU kernel gs_deformable_tpu/ops/pallas/ordered_fill.py:_kernel
// in both of its modes (ordered_prefix_fill, ordered_place_i32):
//
//   prefix: out[c, k] = sum over j with pos[j] <= k of delta[j, c]   (C, K)
//   place:  out = zeros(K); out[pos[j]] = vals[j]                     (K,)
//
// pos is int32, ascending and unique; entries >= K (or < 0) drop.  Values are
// int32 and the arithmetic is integer, so the result is exact: the TPU
// kernel's Dekker-split bf16 matmuls existed only because its matrix unit
// rounds fp32, and have no counterpart here.
//
// What bounds it on the H100: bytes.  Prefix mode reads n*(C+1)*4 bytes and
// writes C*K*4 (about 12 MB at the 1080p render shapes, ~3.6 us at
// 3.35 TB/s); place mode reads n*8 and writes K*4.  Both do a few integer
// operations per byte.
//
// This first design:
// - prefix: output is cut into blocks of BLOCK positions.  Because pos is
//   sorted, the rows landing in block b are one contiguous range [s_b, s_{b+1})
//   found by a binary search.  Pass 1 sums each block's rows per channel
//   (one CUDA block per output block).  Pass 2 takes the carry of block b as
//   the sum of the block totals before it (the totals are a few KB and sit
//   in L2), places the block's rows into a zeroed shared-memory window,
//   scans it with warp shuffles and writes the C output rows coalesced.
// - place: cudaMemsetAsync zeroes the output, then one thread per input row
//   stores its value.
// Every output element is written once and every input row read twice at
// most.  Making it fast (a single pass with decoupled look-back, TMA loads of
// the window) is a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 1024;          // output positions per CUDA block
constexpr int THREADS = 256;         // 4 positions per thread
constexpr int PER_THREAD = BLOCK / THREADS;
constexpr int MAX_C = 8;

// First index j in [0, n) with pos[j] >= key (n if none).
__device__ int lower_bound(const int32_t* pos, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)pos[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass 1: starts[b] = first row landing at or after block b, and the
// per-channel sum of the rows landing in block b.
__global__ void block_totals(const int32_t* __restrict__ pos,
                             const int32_t* __restrict__ delta, int n, int C,
                             int K, int nb, int32_t* __restrict__ starts,
                             int32_t* __restrict__ totals) {
  __shared__ int s_range[2];
  __shared__ int32_t s_warp[THREADS / 32][MAX_C];
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    long long lo_key = (long long)b * BLOCK;
    long long hi_key = lo_key + BLOCK < K ? lo_key + BLOCK : K;
    s_range[0] = lower_bound(pos, n, lo_key);
    s_range[1] = lower_bound(pos, n, hi_key);
    starts[b] = s_range[0];
    if (b == nb - 1) starts[nb] = s_range[1];
  }
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  int32_t acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0;
  for (int j = lo + threadIdx.x; j < hi; j += THREADS) {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < C) acc[c] += delta[(size_t)j * C + c];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    int32_t v = acc[c];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_warp[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    int32_t v = 0;
    for (int w = 0; w < THREADS / 32; ++w) v += s_warp[w][threadIdx.x];
    totals[(size_t)b * C + threadIdx.x] = v;
  }
}

// Pass 2: carry + in-block inclusive scan of the placed rows.
__global__ void place_scan(const int32_t* __restrict__ pos,
                           const int32_t* __restrict__ delta, int C, int K,
                           const int32_t* __restrict__ starts,
                           const int32_t* __restrict__ totals,
                           int32_t* __restrict__ out) {
  __shared__ int32_t s_val[MAX_C][BLOCK];
  __shared__ int32_t s_carry[MAX_C];
  __shared__ int32_t s_warp[THREADS / 32][MAX_C];
  const int b = blockIdx.x;
  const long long base = (long long)b * BLOCK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < C * BLOCK; i += THREADS) s_val[i / BLOCK][i % BLOCK] = 0;
  // carry[c] = sum of the totals of blocks 0..b-1
  {
    int32_t acc[MAX_C];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) acc[c] = 0;
    for (int q = threadIdx.x; q < b; q += THREADS) {
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) acc[c] += totals[(size_t)q * C + c];
    }
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      int32_t v = acc[c];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_warp[warp][c] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < C) {
    int32_t v = 0;
    for (int w = 0; w < THREADS / 32; ++w) v += s_warp[w][threadIdx.x];
    s_carry[threadIdx.x] = v;
  }
  const int lo = starts[b], hi = starts[b + 1];
  for (int j = lo + threadIdx.x; j < hi; j += THREADS) {
    const int r = (int)((long long)pos[j] - base);
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < C) s_val[c][r] = delta[(size_t)j * C + c];
  }
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    int32_t v[PER_THREAD];
    int32_t run = 0;
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      run += s_val[c][threadIdx.x * PER_THREAD + e];
      v[e] = run;
    }
    // inclusive scan of the thread totals across the warp
    int32_t x = run;
    for (int off = 1; off < 32; off <<= 1) {
      int32_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    __syncthreads();  // s_warp reuse
    if (lane == 31) s_warp[warp][0] = x;
    __syncthreads();
    int32_t warp_prefix = s_carry[c];
    for (int w = 0; w < warp; ++w) warp_prefix += s_warp[w][0];
    const int32_t excl = warp_prefix + x - run;
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const long long k = base + threadIdx.x * PER_THREAD + e;
      if (k < K) s_val[c][threadIdx.x * PER_THREAD + e] = excl + v[e];
    }
  }
  __syncthreads();
  // coalesced stores: consecutive threads write consecutive positions
  for (int c = 0; c < C; ++c) {
    for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
      const long long k = base + i;
      if (k < K) out[(size_t)c * K + k] = s_val[c][i];
    }
  }
}

__global__ void place_rows(const int32_t* __restrict__ pos,
                           const int32_t* __restrict__ vals, int n, int K,
                           int32_t* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) {
    const int32_t p = pos[j];
    if (p >= 0 && p < K) out[p] = vals[j];
  }
}

}  // namespace

extern "C" {

// Scratch sizes for ordered_prefix_fill: starts (nb + 1) and totals (nb * C)
// int32, with nb = ceil(K / 1024).
int ordered_fill_block() { return BLOCK; }

int ordered_prefix_fill(const void* pos, const void* delta, int n, int C, int K,
                        void* starts, void* totals, void* out, void* stream) {
  if (C < 1 || C > MAX_C || K < 1 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (K + BLOCK - 1) / BLOCK;
  block_totals<<<nb, THREADS, 0, s>>>((const int32_t*)pos, (const int32_t*)delta,
                                      n, C, K, nb, (int32_t*)starts,
                                      (int32_t*)totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  place_scan<<<nb, THREADS, 0, s>>>((const int32_t*)pos, (const int32_t*)delta,
                                    C, K, (const int32_t*)starts,
                                    (const int32_t*)totals, (int32_t*)out);
  return (int)cudaGetLastError();
}

int ordered_place_i32(const void* pos, const void* vals, int n, int K, void* out,
                      void* stream) {
  if (K < 1 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)K * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    place_rows<<<(n + 255) / 256, 256, 0, s>>>((const int32_t*)pos,
                                               (const int32_t*)vals, n, K,
                                               (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
