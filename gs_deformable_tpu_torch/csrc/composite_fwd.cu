// Tile composite forward: front-to-back alpha blending of depth-sorted splats.
//
// Replaces the TPU kernel gs_deformable_tpu/ops/pallas/composite.py:
// _forward_kernel (the forward half of composite_mode "mixed" and "batch"),
// and serves stream_composite.py:_stream_forward_kernel ("stream") and
// packed_composite.py:_packed_forward_kernel ("packed") too: all compute
// the same function.  The packed kernel differs only in layout: tiles are
// aligned to sub_chunk rows, so the caller passes chunk = sub_chunk.  Its
// segmented log-space scan, owner/inbase tables, tile-meta DMA ring and
// flush double buffer existed because a TPU DMA chunk (128 rows) could
// span several tiles; this kernel reads exactly [start, start + count) of
// its own tile and never depended on alignment.
//
// Inputs: splats (16, Kp) fp32, field-major rows
// [x, y, conic_a, conic_b, conic_c, opacity, r, g, b, 0...]; tile t owns
// instances [tile_chunk_start[t] * chunk, + tile_count[t]) in depth order.
// Output: (T, 8, 256) fp32 rows [r, g, b, final_T, n_contrib, 0, 0, 0].
//
// Semantics (composite.py:70-193 and 336-441, the CUDA renderCUDA forward):
// pixel centres are integer-valued floats; power = -0.5(a dx^2 + c dy^2)
// - b dx dy; an instance is skipped if power > 0 or
// alpha = min(alpha_max, op * exp(power)) < alpha_min; a pixel stops before
// the instance whose T * (1 - alpha) < eps, which does not contribute;
// final_T is T after the last contributing instance and n_contrib that
// instance's 1-based index in the tile.  An empty tile gives rgb 0, T 1, n 0.
// The loop is sequential per pixel, which is exact: the TPU kernel's
// Hillis-Steele prefix product and its matrix-unit colour dot were
// workarounds for a machine without per-pixel threads.
//
// What bounds it on the H100: operations.  Each (instance, pixel) pair costs
// ~15 fp32 operations and one exp; the bytes are small (each instance's 9
// fields are read once per tile it lies in, 36 B; the output is 8 KB per
// tile).  With early termination the work depends on the data, and the
// measured count of evaluated pairs gives the bound.
//
// This first design is renderCUDA's own: one 256-thread block per 16x16 tile
// and one thread per pixel; instances stream in batches of 256 through
// shared memory (one instance per thread per batch, coalesced field-major
// loads); the whole block leaves as soon as every pixel is done
// (__syncthreads_count).  Making it fast (TMA rings of instance batches,
// several tiles per block to balance long tiles, packed fp16 math) is a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::NPIX;
using composite::ROWS;

__global__ void __launch_bounds__(NPIX)
composite_forward_kernel(const float* __restrict__ splats, long long Kp,
                  const int32_t* __restrict__ tile_chunk_start,
                  const int32_t* __restrict__ tile_count, int grid_x, int chunk,
                  float alpha_max, float alpha_min, float eps,
                  float* __restrict__ out) {
  __shared__ float s_xy[NPIX][2];
  __shared__ float s_con_op[NPIX][4];
  __shared__ float s_rgb[NPIX][3];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  float px, py;
  composite::pixel_coords(t, p, grid_x, px, py);
  const long long start = (long long)tile_chunk_start[t] * chunk;
  const int count = tile_count[t];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int n_contrib = 0;
  bool done = false;

  for (int base = 0; base < count; base += NPIX) {
    if (__syncthreads_count(done) == NPIX) break;
    const int i = base + p;
    if (i < count) composite::load_splat(s_xy[p], s_con_op[p], s_rgb[p], splats, Kp, start + i);
    __syncthreads();
    const int m = min(NPIX, count - base);
    for (int j = 0; j < m && !done; ++j) {
      float dx, dy;
      const float power = composite::splat_power(s_xy[j], s_con_op[j], px, py, dx, dy);
      if (power > 0.0f) continue;
      const float alpha = fminf(alpha_max, s_con_op[j][3] * expf(power));
      if (alpha < alpha_min) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < eps) {
        done = true;
        continue;
      }
      const float w = alpha * T;
      cr = cr + s_rgb[j][0] * w;
      cg = cg + s_rgb[j][1] * w;
      cb = cb + s_rgb[j][2] * w;
      T = test_T;
      n_contrib = base + j + 1;
    }
  }

  float* o = out + (size_t)t * ROWS * NPIX;
  o[0 * NPIX + p] = cr;
  o[1 * NPIX + p] = cg;
  o[2 * NPIX + p] = cb;
  o[3 * NPIX + p] = T;
  o[4 * NPIX + p] = (float)n_contrib;
  o[5 * NPIX + p] = 0.0f;
  o[6 * NPIX + p] = 0.0f;
  o[7 * NPIX + p] = 0.0f;
}

}  // namespace

extern "C" {

int composite_forward(const void* splats, long long Kp, const void* tile_chunk_start,
                      const void* tile_count, int num_tiles, int grid_x, int chunk,
                      float alpha_max, float alpha_min, float eps, void* out,
                      void* stream) {
  if (num_tiles < 1 || grid_x < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  composite_forward_kernel<<<num_tiles, NPIX, 0, (cudaStream_t)stream>>>(
      (const float*)splats, Kp, (const int32_t*)tile_chunk_start,
      (const int32_t*)tile_count, grid_x, chunk, alpha_max, alpha_min, eps,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
