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
// What bounds it on the H100: at the bench scene's 800x800 train frame the
// bytes and the operations give about the same least time.  Operations: per
// walked pair (before the pixel's n_contrib) ~16 fp32 operations and one exp
// (the forward's test), per contributing pair ~37 more and 9 adds that sum
// the row over the tile's pixels.  Bytes: the 9 used fields of each
// instance read, the (16, Kp) rows written, and 9 of the 16 meta rows per
// pixel read (forward rows 0-4, upstream rows 0-3).
//
// This first design is simple and deterministic: one 256-thread block per
// 16x16 tile, one thread per pixel; instances stream in batches of 128
// through shared memory; per instance, each warp that has a contributing
// pixel sums its 9 values by __shfl_down_sync and parks the partials in
// shared memory (a warp with none parks zeros without shuffling); after
// each batch the 8 warp partials of every instance are summed in a fixed
// order and written once.  No atomics, so the rows are the same from run to
// run.  The block leaves once every pixel is past its n_contrib
// (__syncthreads_count).  Making it fast (several instances per reduction
// round, TMA rings, several tiles per block for long tiles) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::NPIX;
using composite::ROWS;

constexpr int BATCH = 128;
constexpr int WARPS = NPIX / 32;
constexpr int NGRAD = 9;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(NPIX)
composite_backward_kernel(const float* __restrict__ splats, long long Kp,
                          const int32_t* __restrict__ tile_chunk_start,
                          const int32_t* __restrict__ tile_count,
                          const float* __restrict__ fwd_out,
                          const float* __restrict__ grad_out, int grid_x, int chunk,
                          float alpha_max, float alpha_min, float* __restrict__ dsplats) {
  __shared__ float s_xy[BATCH][2];
  __shared__ float s_con_op[BATCH][4];
  __shared__ float s_rgb[BATCH][3];
  __shared__ float s_part[NGRAD][WARPS][BATCH];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  float px, py;
  composite::pixel_coords(t, p, grid_x, px, py);
  const long long start = (long long)tile_chunk_start[t] * chunk;
  const int count = tile_count[t];

  const float* fo = fwd_out + (size_t)t * ROWS * NPIX;
  const float* go = grad_out + (size_t)t * ROWS * NPIX;
  const float g_r = go[0 * NPIX + p], g_g = go[1 * NPIX + p], g_b = go[2 * NPIX + p];
  const float g_t = go[3 * NPIX + p];
  const float gtotal = g_r * fo[0 * NPIX + p] + g_g * fo[1 * NPIX + p] +
                       g_b * fo[2 * NPIX + p] + g_t * fo[3 * NPIX + p];
  const int n_contrib = (int)fo[4 * NPIX + p];

  float T = 1.0f;
  float pcc = 0.0f;

  for (int base = 0; base < count; base += BATCH) {
    if (__syncthreads_count(base < n_contrib) == 0) break;
    const int m = min(BATCH, count - base);
    if (p < m) composite::load_splat(s_xy[p], s_con_op[p], s_rgb[p], splats, Kp, start + base + p);
    __syncthreads();

    for (int j = 0; j < m; ++j) {
      float v[NGRAD];
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) v[q] = 0.0f;
      bool contrib = false;
      float dx, dy, g = 0.0f, alpha = 0.0f;
      if (base + j < n_contrib) {
        const float power = composite::splat_power(s_xy[j], s_con_op[j], px, py, dx, dy);
        if (!(power > 0.0f)) {
          g = expf(power);
          alpha = fminf(alpha_max, s_con_op[j][3] * g);  // the forward's alpha expression
          contrib = !(alpha < alpha_min);
        }
      }
      if (contrib) {
        const float a = s_con_op[j][0], b = s_con_op[j][1], c = s_con_op[j][2];
        const float test_T = T * (1.0f - alpha);
        const float w = alpha * T;
        const float gcol = g_r * s_rgb[j][0] + g_g * s_rgb[j][1] + g_b * s_rgb[j][2];
        pcc = pcc + w * gcol;
        const float dalpha = gcol * T - (gtotal - pcc) * (1.0f / (1.0f - alpha));
        const float gg = s_con_op[j][3] * dalpha * g;
        v[0] = gg * (-(a * dx + b * dy));
        v[1] = gg * (-(c * dy + b * dx));
        v[2] = gg * (-0.5f * dx * dx);
        v[3] = gg * (-dx * dy);
        v[4] = gg * (-0.5f * dy * dy);
        v[5] = g * dalpha;
        v[6] = w * g_r;
        v[7] = w * g_g;
        v[8] = w * g_b;
        T = test_T;
      }
      if (__any_sync(FULL, contrib)) {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) v[q] = warp_sum(v[q]);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) s_part[q][warp][j] = v[q];
      }
    }
    __syncthreads();

    // Fixed-order sum of the 8 warp partials; row q of instance j.
    for (int e = p; e < NGRAD * m; e += NPIX) {
      const int q = e / m;
      const int j = e - q * m;
      float s = s_part[q][0][j];
#pragma unroll
      for (int w8 = 1; w8 < WARPS; ++w8) s += s_part[q][w8][j];
      dsplats[q * Kp + start + base + j] = s;
    }
  }
}

}  // namespace

extern "C" {

int composite_backward(const void* splats, long long Kp, const void* tile_chunk_start,
                       const void* tile_count, int num_tiles, const void* fwd_out,
                       const void* grad_out, int grid_x, int chunk, float alpha_max,
                       float alpha_min, void* dsplats, void* stream) {
  if (num_tiles < 1 || grid_x < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  composite_backward_kernel<<<num_tiles, NPIX, 0, (cudaStream_t)stream>>>(
      (const float*)splats, Kp, (const int32_t*)tile_chunk_start,
      (const int32_t*)tile_count, (const float*)fwd_out, (const float*)grad_out, grid_x,
      chunk, alpha_max, alpha_min, (float*)dsplats);
  return (int)cudaGetLastError();
}

}  // extern "C"
