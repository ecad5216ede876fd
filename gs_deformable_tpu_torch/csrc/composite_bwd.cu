// Tile composite backward: per-instance gradient rows of the front-to-back
// alpha blend.
//
// Replaces the TPU kernel gs_deformable_tpu/ops/pallas/stream_composite.py:
// _stream_backward_kernel (the backward half of composite_mode "mixed" and
// "stream"), and serves the "batch" schedule's composite.py:
// _backward_kernel too: the JAX package holds all three bit-equal.  It also
// serves packed_composite.py:_packed_backward_kernel ("packed", held to
// "batch" at the reference's packed bars, test_rasterize.py:191-241): the
// caller passes chunk = sub_chunk, since the packed layout aligns tiles to
// sub_chunk rows.  The TPU kernel's segmented scan and carried open-tile
// state handled 128-row DMA chunks that span tiles; each block here walks
// only its own tile's [start, start + count).
//
// Inputs: splats (16, Kp) fp32, field-major rows [x, y, conic_a, conic_b,
// conic_c, opacity, r, g, b, 0...]; tile t owns instances
// [tile_chunk_start[t] * chunk, + tile_count[t]) in depth order; the
// forward's out (T, 8, 256) [r, g, b, final_T, n_contrib, ...]; the
// upstream gradient grad_out (T, 8, 256), of which rows 0-3 (g_r, g_g, g_b,
// g_T) are read.  Output: (16, Kp) rows [dx, dy, dconic_a, dconic_b,
// dconic_c, dopacity, dr, dg, db, 0...]; each tile writes only its own rows
// and the caller zero-fills the rest (padding slots carry gaussian 0).
//
// Semantics (composite.py:196-258 _instance_grads, backward.cu:401-560):
// gtotal = sum_c g_c C_c + g_T final_T per pixel; walking front to back
// with T_i the transmittance before instance i and pcc_i the inclusive
// prefix of alpha_j T_j sum_c g_c col_jc,
//   dalpha_i = (sum_c g_c col_ic) T_i - (gtotal - pcc_i) / (1 - alpha_i),
//   dcol_ic = alpha_i T_i g_c,
// and with gg = op dalpha exp(power) (no term for the alpha_max clamp):
//   d_op = exp(power) dalpha, d_x = -gg (a dx + b dy), d_y = -gg (c dy + b dx),
//   d_a = -gg dx^2 / 2, d_b = -gg dx dy, d_c = -gg dy^2 / 2,
// each summed over the pixels the instance contributes to.
//
// Each pixel recomputes T front to back with the forward's float operations
// in the same order (the expressions of composite_fwd.cu, copied, and
// -fmad=false), so its contributing set is the forward's and the forward's
// n_contrib bounds its walk: instance i contributes iff i < n_contrib and it
// is not skipped.  The reference's back-to-front division of T by
// (1 - alpha) drifts from the forward's T and could disagree at the eps edge.
//
// What bounds it on the H100.  The least time is small: at the bench
// scene's 800x800 train frame the bytes (the 9 used fields of each
// instance, the (16, Kp) rows written, 9 meta rows per pixel) and the
// operations (~16 fp32 operations and an exp per walked pair, ~37 more per
// contributing pair, 9 adds per contributing pair to sum the rows) both give
// about 0.018 ms.  The first design took 27x that, from instruction issue
// outside the arithmetic: per (instance, warp) it ran nine 5-level
// __shfl_down_sync trees (45 shuffles, at one warp-shuffle per clock per SM
// the slowest instruction here), lane 0 of every warp stored 9 partials for
// every instance, zeros included, every warp walked to the block's longest
// pixel, and the staging loads did not overlap the walk.  What is left is
// issue on the kept pairs and, at 800x800, the tail: the longest tile walks
// ~9x the mean tile's pairs, and one warp's walk through it is a serial
// chain (T and its prefix) that other warps cannot share.
//
// The design: one 256-thread block per 16x16 tile, one thread per pixel;
// warp w holds the tile's 4 x 8 pixel block at row 4 (w / 2), column
// 8 (w % 2) (composite_common.cuh:pixel_of_thread).  Instances stream
// through shared memory in batches of 32, double-buffered with 4-byte
// cp.async (any start row, any Kp: no aligned head or tail to handle), the
// next batch copied while this one is walked.
// - Warp cull: when a batch lands, each warp culls it for its own block
//   (composite_common.cuh:warp_keeps, conservative) into a ballot and a
//   list, and walks only the instances it keeps: no exp, no partial for a
//   culled one.  A culled pair would have failed the forward's skip tests,
//   so the walk meets the same contributing set.
// - Per-warp walk bound: a warp walks only up to its own largest n_contrib
//   (__reduce_max_sync), the block up to the largest of its warps'.
// - The next kept instance's loads, power, exp and alpha are issued ahead,
//   beside this one's gradient (they do not depend on T).
// - Three instances per reduction: each lane writes the 9 values of a kept
//   instance into a column of its warp's 27 x 33 transpose buffer in shared
//   memory; after three instances lane l < 27 adds row l (field l % 9 of
//   instance l / 9) over the 32 pixels in a fixed order.  Nine stores and
//   ~21 loads and adds per instance and no shuffles; a reduce-scatter
//   butterfly over 32 register slots, tried first, spent 31 shuffles and
//   62 selects per three instances and held 32 registers across the walk.
// - Partials only where needed: a warp parks its 9 sums for each instance it
//   keeps; after each batch the 9 rows of every instance are summed in warp
//   order over the warps whose ballot bit is set, and written once.  No
//   atomics: the rows are the same bits every launch.
// No tensor cores: the row sums are fp32 sums over pixels held to rtol
// 5e-4, which TF32's 10-bit mantissa cannot meet.  A 64-instance batch
// with two instances per reduction, and a launch bound that forces 4 blocks
// per SM, were timed on the card and not adopted (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::FULL;
using composite::NPIX;
using composite::ROWS;
using composite::STRIDE;
using composite::TILE;
using composite::WARPS;

constexpr int BATCH = 32;  // instances staged at a time
constexpr int G = BATCH / 32;
constexpr int NGRAD = 9;
constexpr int R = 3;                        // instances per reduction round (flush_rows)
constexpr int RROWS = R * NGRAD;            // rows of a warp's transpose buffer
constexpr int RSTRIDE = 33;                 // one row: 32 lanes, padded
constexpr int PSTRIDE = WARPS * NGRAD + 1;  // one instance's partials, padded

// One (instance, pixel) pair up to the forward's skip tests: pass is true
// when power <= 0 and alpha >= alpha_min.
struct Pair {
  int j;
  bool pass;
  float dx, dy, g, alpha, a, b, c, op, cr, cg, cb;

  __device__ __forceinline__ static Pair at(const float* batch, int j, float px, float py,
                                            float alpha_max, float alpha_min) {
    const float* s = &batch[j * STRIDE];
    const float4 v0 = *reinterpret_cast<const float4*>(s);
    const float4 v1 = *reinterpret_cast<const float4*>(s + 4);
    Pair q;
    q.j = j;
    q.a = v0.z;
    q.b = v0.w;
    q.c = v1.x;
    q.op = v1.y;
    const float power = composite::splat_power(v0.x, v0.y, q.a, q.b, q.c, px, py, q.dx, q.dy);
    q.g = expf(power);
    q.alpha = fminf(alpha_max, q.op * q.g);  // the forward's alpha expression
    q.pass = !(power > 0.0f) && !(q.alpha < alpha_min);
    q.cr = v1.z;
    q.cg = v1.w;
    q.cb = s[8];
    return q;
  }
};

// Sum the nbuf instances buffered in a warp's transpose buffer over its 32
// pixels: lane l < 9 nbuf adds row l (field l % 9 of buffered instance
// l / 9, batch index idx0, idx1 or idx2) in a fixed order and parks it in
// the instance's partials.
__device__ __forceinline__ void flush_rows(const float* red, float* part, int lane, int warp,
                                           int nbuf, int idx0, int idx1, int idx2) {
  __syncwarp();
  if (lane < nbuf * NGRAD) {
    const float* row = red + lane * RSTRIDE;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      s0 += row[i];
      s1 += row[i + 1];
      s2 += row[i + 2];
      s3 += row[i + 3];
    }
    const int r = lane / NGRAD;
    const int j = r == 0 ? idx0 : (r == 1 ? idx1 : idx2);
    part[j * PSTRIDE + warp * NGRAD + lane - r * NGRAD] = (s0 + s1) + (s2 + s3);
  }
  __syncwarp();
}

// No minimum of resident blocks: left to itself the compiler allocates
// fewer registers than with a minimum of 1.
__global__ void __launch_bounds__(NPIX)
composite_backward_kernel(const float* __restrict__ splats, long long Kp,
                          const int32_t* __restrict__ tile_chunk_start,
                          const int32_t* __restrict__ tile_count,
                          const float* __restrict__ fwd_out,
                          const float* __restrict__ grad_out, int grid_x, int chunk,
                          float alpha_max, float alpha_min, float* __restrict__ dsplats) {
  __shared__ __align__(16) float s_buf[2][BATCH * STRIDE];
  __shared__ float s_part[BATCH * PSTRIDE];
  __shared__ float s_red[WARPS][RROWS * RSTRIDE];
  __shared__ unsigned s_bal[WARPS][G];
  __shared__ uint16_t s_list[WARPS][BATCH];
  __shared__ int s_wn[WARPS];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int pix = composite::pixel_of_thread(p);
  float px, py, rx0, ry0;
  composite::pixel_coords(t, pix, grid_x, px, py);
  composite::warp_origin(warp, (float)((t % grid_x) * TILE), (float)((t / grid_x) * TILE), rx0,
                         ry0);
  const long long start = (long long)tile_chunk_start[t] * chunk;
  const int count = tile_count[t];
  unsigned* bal = s_bal[warp];
  uint16_t* list = s_list[warp];
  float* red = s_red[warp];

  const float* fo = fwd_out + (size_t)t * ROWS * NPIX;
  const float* go = grad_out + (size_t)t * ROWS * NPIX;
  const float g_r = go[0 * NPIX + pix], g_g = go[1 * NPIX + pix], g_b = go[2 * NPIX + pix];
  const float g_t = go[3 * NPIX + pix];
  const float gtotal = g_r * fo[0 * NPIX + pix] + g_g * fo[1 * NPIX + pix] +
                       g_b * fo[2 * NPIX + pix] + g_t * fo[3 * NPIX + pix];
  const int n_contrib = (int)fo[4 * NPIX + pix];
  const int wn = (int)__reduce_max_sync(FULL, (unsigned)n_contrib);  // this warp's walk
  if (lane == 0) s_wn[warp] = wn;

  if (p < min(count, BATCH)) composite::stage_async(&s_buf[0][p * STRIDE], splats, Kp, start + p);
  composite::cp_async_commit();
  __syncthreads();
  int walk = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) walk = max(walk, s_wn[w]);
  walk = min(walk, count);  // rows past every pixel's n_contrib stay the caller's zeros

  float T = 1.0f;
  float pcc = 0.0f;
  int nbuf = 0, idx0 = 0, idx1 = 0, idx2 = 0;

  for (int base = 0, k = 0; base < walk; base += BATCH, ++k) {
    const float* cur = s_buf[k & 1];
    const int m = min(BATCH, walk - base);
    composite::cp_async_wait_all();
    // Batch k has landed; batch k - 1's walk and row sums are done, so its
    // buffer takes batch k + 1, and its ballots and partials are spent.
    __syncthreads();
    if (p < BATCH && base + BATCH + p < walk) {
      composite::stage_async(&s_buf[(k + 1) & 1][p * STRIDE], splats, Kp,
                             start + base + BATCH + p);
    }
    composite::cp_async_commit();

    // This warp's cull of the batch up to its walk bound, then its kept
    // instances in order.  The next instance's loads, power, exp and alpha
    // do not depend on T, so they are issued ahead, beside this one's
    // gradient.  Every kept instance is buffered for the reduction, zeros
    // where no lane contributes (0.3% of them at the bench frame).
    const int n = composite::warp_list<G>(list, bal, cur, min(m, wn - base), lane, rx0, ry0,
                                          alpha_min);
    Pair nxt;
    if (n > 0) nxt = Pair::at(cur, list[0], px, py, alpha_max, alpha_min);
    for (int i = 0; i < n; ++i) {
      const Pair now = nxt;
      if (i + 1 < n) nxt = Pair::at(cur, list[i + 1], px, py, alpha_max, alpha_min);
      float tv[NGRAD];
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) tv[q] = 0.0f;
      if (now.pass && base + now.j < n_contrib) {  // contributes
        const float alpha = now.alpha, dx = now.dx, dy = now.dy;
        const float test_T = T * (1.0f - alpha);
        const float w = alpha * T;
        const float gcol = g_r * now.cr + g_g * now.cg + g_b * now.cb;
        pcc = pcc + w * gcol;
        const float dalpha = gcol * T - (gtotal - pcc) * (1.0f / (1.0f - alpha));
        const float gg = now.op * dalpha * now.g;
        tv[0] = gg * (-(now.a * dx + now.b * dy));
        tv[1] = gg * (-(now.c * dy + now.b * dx));
        tv[2] = gg * (-0.5f * dx * dx);
        tv[3] = gg * (-dx * dy);
        tv[4] = gg * (-0.5f * dy * dy);
        tv[5] = now.g * dalpha;
        tv[6] = w * g_r;
        tv[7] = w * g_g;
        tv[8] = w * g_b;
        T = test_T;
      }
      // Column `lane` of rows [9 nbuf, 9 nbuf + 9) (nbuf is warp-uniform).
      float* col = red + nbuf * NGRAD * RSTRIDE + lane;
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) col[q * RSTRIDE] = tv[q];
      if (nbuf == 0) idx0 = now.j;
      else if (nbuf == 1) idx1 = now.j;
      else idx2 = now.j;
      if (++nbuf == R) {
        flush_rows(red, s_part, lane, warp, nbuf, idx0, idx1, idx2);
        nbuf = 0;
      }
    }
    if (nbuf > 0) {  // the batch's last buffered instances
      flush_rows(red, s_part, lane, warp, nbuf, idx0, idx1, idx2);
      nbuf = 0;
    }
    __syncthreads();

    // Row q of instance j: the partials of the warps that kept it, in warp
    // order.
    for (int e = p; e < NGRAD * m; e += NPIX) {
      const int q = e / m;
      const int j = e - q * m;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if ((s_bal[w][j >> 5] >> (j & 31)) & 1u) sum += s_part[j * PSTRIDE + w * NGRAD + q];
      }
      dsplats[q * Kp + start + base + j] = sum;
    }
  }
  composite::cp_async_wait_all();
}

}  // namespace

extern "C" {

int composite_backward(const void* splats, long long Kp, const void* tile_chunk_start,
                       const void* tile_count, int num_tiles,
                       const void* fwd_out, const void* grad_out, int grid_x, int chunk,
                       float alpha_max, float alpha_min, void* dsplats, void* stream) {
  if (num_tiles < 1 || grid_x < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  composite_backward_kernel<<<num_tiles, NPIX, 0, (cudaStream_t)stream>>>(
      (const float*)splats, Kp, (const int32_t*)tile_chunk_start,
      (const int32_t*)tile_count, (const float*)fwd_out,
      (const float*)grad_out, grid_x, chunk, alpha_max, alpha_min, (float*)dsplats);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at once.
int composite_backward_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, composite_backward_kernel,
                                                            NPIX, 0);
}

}  // extern "C"
