// Pixel centres, instance staging, the splat's power and the warp cull,
// shared by the tile-composite forward (composite_fwd.cu) and backward
// (composite_bwd.cu).
//
// The exp, the alpha clamp and the skip tests are not shared: each kernel
// writes them out inline (see splat_power).  The backward's contributing set
// equals the forward's only while those two copies stay the same expression
// and both build with -fmad=false; the card tests and chip_smoke.py hold
// n_contrib exact and the backward's rows to their plain version's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace composite {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int ROWS = 8;
constexpr int WARPS = NPIX / 32;
constexpr int FIELDS = 9;         // x, y, conic a, b, c, opacity, r, g, b
constexpr int STRIDE = 12;        // staged floats per instance (16-byte rows)
constexpr unsigned FULL = 0xffffffffu;

// Warp cull (warp_keeps below).
constexpr float CULL_SLACK = 0.02f;  // in q, as ops/projection.py:tile_ellipse_mask
constexpr float CULL_REL = 1e-5f;    // of the q terms' magnitude: float rounding

// Thread p of a tile's block: warp w = p / 32 holds the 4 x 8 pixel block
// of rows 4 (w / 2) .. + 3 and columns 8 (w % 2) .. + 7, lane l its pixel
// (l / 8, l % 8) there.  Returns the pixel's row-major index in the tile.
// (A compact block meets fewer splats than a 2 x 16 strip: at the bench
// scene's 800x800 frame the warp cull keeps 20% fewer (instance, warp) pairs.)
constexpr int WARP_ROWS = 4;
constexpr int WARP_COLS = 8;
__device__ __forceinline__ int pixel_of_thread(int p) {
  const int w = p >> 5, l = p & 31;
  return ((w >> 1) * WARP_ROWS + (l >> 3)) * TILE + (w & 1) * WARP_COLS + (l & 7);
}

// Pixel centres are integer-valued floats; pix is the pixel's index in the tile.
__device__ __forceinline__ void pixel_coords(int t, int pix, int grid_x, float& px, float& py) {
  px = (float)((t % grid_x) * TILE + pix % TILE);
  py = (float)((t / grid_x) * TILE + pix / TILE);
}

// power = -0.5(a dx^2 + c dy^2) - b dx dy of one (instance, pixel) pair.
// Each kernel then skips the pair if power > 0, else takes
// alpha = min(alpha_max, op * exp(power)) and skips it if alpha < alpha_min,
// written out in the kernel: the same expressions, inline.  (With the exp
// and the alpha test inside this helper the forward ran measurably slower
// on an H100, with bitwise-equal output.)
__device__ __forceinline__ float splat_power(float x, float y, float a, float b, float c,
                                             float px, float py, float& dx, float& dy) {
  dx = x - px;
  dy = y - py;
  return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
}

// --- asynchronous staging ---------------------------------------------------
// 4-byte cp.async: any start row and any Kp, so the field runs of a tile
// (which begin at (f * Kp + start) * 4 bytes, 4-byte aligned only) need no
// aligned head or tail.  The staged bytes are few (36 per instance); what
// matters is that the copy of the next batch overlaps the walk of this one.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying instance k of the field-major (16, Kp) splats into s[STRIDE].
__device__ __forceinline__ void stage_async(float* s, const float* __restrict__ splats,
                                            long long Kp, long long k) {
#pragma unroll
  for (int f = 0; f < FIELDS; ++f) cp_async4(s + f, splats + f * Kp + k);
}

// --- warp cull -----------------------------------------------------------------
// q = a dx^2 + 2 b dx dy + c dy^2 (= -2 power) at (dx, dy).
__device__ __forceinline__ float quad(float a, float b, float c, float dx, float dy) {
  return a * dx * dx + 2.0f * b * dx * dy + c * dy * dy;
}

// Whether the staged instance s may contribute to a pixel of the warp whose
// 4 x 8 pixel block starts at pixel (rx0, ry0); mirrored, for all 8 warps of
// a tile at once, by ops/kernels/composite.py:warp_mask.  A pair contributes
// only if op * exp(power) >= alpha_min, i.e. q <= 2 ln(op / alpha_min); the
// warp keeps the instance when the least q over its block (exact for a
// positive-definite conic: 0 with the centre inside, else the least of the
// four edges' clamped vertices) is within that bound plus CULL_SLACK plus
// CULL_REL of the q terms' magnitude.  Conservative: a, c or ac - b^2 not
// positive, or a NaN or infinity anywhere, keeps it.  The one exact
// exclusion is 0 < alpha_min and op < alpha_min, where alpha <= op <
// alpha_min.  __logf's error (a few 1e-6 here) is far inside CULL_SLACK, and
// the reciprocals are correctly rounded, so the vertices sit within an ulp.
__device__ __forceinline__ bool warp_keeps(const float* s, float rx0, float ry0,
                                           float alpha_min) {
  const float x = s[0], y = s[1], a = s[2], b = s[3], c = s[4], op = s[5];
  if (!isfinite(x + y + a + b + c + op)) return true;  // (fminf drops NaNs)
  if (alpha_min > 0.0f && op < alpha_min) return false;
  if (!(a > 0.0f) || !(c > 0.0f) || !(a * c - b * b > 0.0f)) return true;
  const float ax = x - (rx0 + (float)(WARP_COLS - 1)), bx = x - rx0;  // dx over the columns
  const float ay = y - (ry0 + (float)(WARP_ROWS - 1)), by = y - ry0;  // dy over the rows
  if (ax <= 0.0f && bx >= 0.0f && ay <= 0.0f && by >= 0.0f) return true;
  const float thr = 2.0f * __logf(op / alpha_min) + CULL_SLACK;
  const float kx = -b * __frcp_rn(c), ky = -b * __frcp_rn(a);  // dy = kx dx, dx = ky dy
  const float e0 = quad(a, b, c, ax, fminf(fmaxf(kx * ax, ay), by));
  const float e1 = quad(a, b, c, bx, fminf(fmaxf(kx * bx, ay), by));
  const float e2 = quad(a, b, c, fminf(fmaxf(ky * ay, ax), bx), ay);
  const float e3 = quad(a, b, c, fminf(fmaxf(ky * by, ax), bx), by);
  const float qmin = fminf(fminf(e0, e1), fminf(e2, e3));
  const float margin = CULL_REL * ((a + fabsf(b)) * fmaxf(ax * ax, bx * bx) +
                                   (c + fabsf(b)) * fmaxf(ay * ay, by * by));
  return !(qmin > thr + margin);
}

// The first pixel of warp w's block in the tile whose first pixel is (px0, py0).
__device__ __forceinline__ void warp_origin(int w, float px0, float py0, float& rx0,
                                            float& ry0) {
  rx0 = px0 + (float)((w & 1) * WARP_COLS);
  ry0 = py0 + (float)((w >> 1) * WARP_ROWS);
}

// This warp's list of the instances [0, n) of a staged batch that it keeps,
// ascending, unless `list` is null; returns its length.  With `bal` also the
// ballots: bal[g] bit i is instance 32 g + i.  Lane i tests instances i, 32 + i, ...  Warp-
// collective; G = batch size / 32.
template <int G>
__device__ __forceinline__ int warp_list(uint16_t* list, unsigned* bal, const float* batch,
                                         int n, int lane, float rx0, float ry0,
                                         float alpha_min) {
  int len = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = g * 32 + lane;
    const bool keep = j < n && warp_keeps(batch + j * STRIDE, rx0, ry0, alpha_min);
    const unsigned v = __ballot_sync(FULL, keep);
    if (list != nullptr && keep) list[len + __popc(v & ((1u << lane) - 1u))] = (uint16_t)j;
    if (bal != nullptr && lane == 0) bal[g] = v;
    len += __popc(v);
  }
  __syncwarp();
  return len;
}

}  // namespace composite
