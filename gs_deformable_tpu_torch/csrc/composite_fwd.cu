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
// What bounds it on the H100: instruction issue.  The least time from the
// work is small (~16 fp32 operations and an exp per tested pair, 36 B per
// instance read, 8 KB per tile written), but a pair issues several times
// as many instructions (shared loads, the exp's range reduction, branches),
// and at the bench scene's 1080p frame 74% of the (instance, pixel) tests of
// the first design ended in a skip: a splat a few pixels wide reaches a few
// of a tile's 8 warps, and every warp paid the power and the exp of every
// instance.
//
// The design: one 256-thread block per 16x16 tile, one thread per pixel;
// warp w holds the tile's 4 x 8 pixel block at row 4 (w / 2), column
// 8 (w % 2) (composite_common.cuh:pixel_of_thread; a compact block meets
// ~20% fewer splats than a 2 x 16 strip).  Instances stream through shared
// memory in batches of 256, double-buffered: the 9 field runs of the next
// batch are copied with 4-byte cp.async (any start row, any Kp, so no
// aligned head or tail to handle) while this batch is walked.  When a batch
// lands, each warp culls it for its own block (composite_common.cuh:
// warp_keeps, conservative, 32 instances per ballot) and walks only the
// instances it keeps, in order.  A culled pair would have failed the skip
// tests anyway, so the output is bitwise that of the plain version
// (ops/kernels/composite.py).  A warp leaves the batch once all its pixels
// are done (__all_sync after each 32 instances), the block once all 256 are
// (__syncthreads_count).  Per pixel, the order and the float operations are
// unchanged, built with -fmad=false.  A 128-instance batch and launch
// bounds that force more blocks per SM were timed on the card and not
// adopted (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::FULL;
using composite::NPIX;
using composite::ROWS;
using composite::STRIDE;
using composite::TILE;

constexpr int BATCH = 256;  // instances staged at a time, one per thread
constexpr int G = BATCH / 32;

// No minimum of resident blocks: left to itself the compiler allocates
// fewer registers than with a minimum of 1.
__global__ void __launch_bounds__(NPIX)
composite_forward_kernel(const float* __restrict__ splats, long long Kp,
                         const int32_t* __restrict__ tile_chunk_start,
                         const int32_t* __restrict__ tile_count, int grid_x, int chunk,
                         float alpha_max, float alpha_min, float eps,
                         float* __restrict__ out) {
  __shared__ __align__(16) float s_buf[2][BATCH * STRIDE];
  __shared__ unsigned s_bal[composite::WARPS][G];

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

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int n_contrib = 0;
  bool done = false;

  if (p < min(count, BATCH)) composite::stage_async(&s_buf[0][p * STRIDE], splats, Kp, start + p);
  composite::cp_async_commit();
  for (int base = 0, k = 0; base < count; base += BATCH, ++k) {
    const float* cur = s_buf[k & 1];
    const int m = min(BATCH, count - base);
    composite::cp_async_wait_all();
    // Batch k has landed; every warp has left batch k - 1, whose buffer
    // takes batch k + 1.
    if (__syncthreads_count(done) == NPIX) break;
    if (p < BATCH && base + BATCH + p < count) {
      composite::stage_async(&s_buf[(k + 1) & 1][p * STRIDE], splats, Kp,
                             start + base + BATCH + p);
    }
    composite::cp_async_commit();
    if (__all_sync(FULL, done)) continue;

    // This warp's cull of the batch, then its kept instances in order.
    composite::warp_list<G>(nullptr, bal, cur, m, lane, rx0, ry0, alpha_min);
    for (int g = 0; g < G; ++g) {
      unsigned bits = bal[g];
      while (bits) {
        const int j = g * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        if (!done) {
          const float* s = &cur[j * STRIDE];
          const float4 v0 = *reinterpret_cast<const float4*>(s);
          const float4 v1 = *reinterpret_cast<const float4*>(s + 4);
          float dx, dy;
          const float power =
              composite::splat_power(v0.x, v0.y, v0.z, v0.w, v1.x, px, py, dx, dy);
          if (!(power > 0.0f)) {
            const float alpha = fminf(alpha_max, v1.y * expf(power));
            if (!(alpha < alpha_min)) {
              const float test_T = T * (1.0f - alpha);
              if (test_T < eps) {
                done = true;
              } else {
                const float w = alpha * T;
                cr = cr + v1.z * w;
                cg = cg + v1.w * w;
                cb = cb + s[8] * w;
                T = test_T;
                n_contrib = base + j + 1;
              }
            }
          }
        }
      }
      if (__all_sync(FULL, done)) break;  // every pixel of the warp is done
    }
  }
  composite::cp_async_wait_all();

  float* o = out + (size_t)t * ROWS * NPIX;
  o[0 * NPIX + pix] = cr;
  o[1 * NPIX + pix] = cg;
  o[2 * NPIX + pix] = cb;
  o[3 * NPIX + pix] = T;
  o[4 * NPIX + pix] = (float)n_contrib;
  o[5 * NPIX + pix] = 0.0f;
  o[6 * NPIX + pix] = 0.0f;
  o[7 * NPIX + pix] = 0.0f;
}

}  // namespace

extern "C" {

int composite_forward(const void* splats, long long Kp, const void* tile_chunk_start,
                      const void* tile_count, int num_tiles, int grid_x, int chunk,
                      float alpha_max, float alpha_min, float eps, void* out, void* stream) {
  if (num_tiles < 1 || grid_x < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  composite_forward_kernel<<<num_tiles, NPIX, 0, (cudaStream_t)stream>>>(
      (const float*)splats, Kp, (const int32_t*)tile_chunk_start,
      (const int32_t*)tile_count, grid_x, chunk, alpha_max, alpha_min, eps, (float*)out);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at once.
int composite_forward_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, composite_forward_kernel,
                                                            NPIX, 0);
}

}  // extern "C"
