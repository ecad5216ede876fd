// Pixel centres, the staged splat and its power, shared by the tile-composite
// forward (composite_fwd.cu) and backward (composite_bwd.cu).
//
// The exp, the alpha clamp and the skip tests are not shared: each kernel
// writes them out inline (see splat_power).  The backward's contributing set
// equals the forward's only while those two copies stay the same expression
// and both build with -fmad=false; the card tests and chip_smoke.py hold
// n_contrib exact and the backward's rows to their plain version's.

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int ROWS = 8;

// Pixel centres are integer-valued floats.
__device__ __forceinline__ void pixel_coords(int t, int p, int grid_x, float& px, float& py) {
  px = (float)((t % grid_x) * TILE + p % TILE);
  py = (float)((t / grid_x) * TILE + p / TILE);
}

// The kernels stage each instance in shared memory as xy[2], con_op[4]
// (conic a, b, c; opacity) and rgb[3], in three arrays indexed by instance.

// power = -0.5(a dx^2 + c dy^2) - b dx dy of one (instance, pixel) pair.
// Each kernel then skips the pair if power > 0, else takes
// alpha = min(alpha_max, op * exp(power)) and skips it if alpha < alpha_min,
// written out in the kernel: the same expressions, inline.  (With the exp
// and the alpha test inside this helper the forward ran measurably slower
// on an H100, with bitwise-equal output.)
__device__ __forceinline__ float splat_power(const float* xy, const float* con_op, float px,
                                             float py, float& dx, float& dy) {
  dx = xy[0] - px;
  dy = xy[1] - py;
  const float a = con_op[0], b = con_op[1], c = con_op[2];
  return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
}

// Stage instance k of the field-major (16, Kp) splats.
__device__ __forceinline__ void load_splat(float* xy, float* con_op, float* rgb,
                                           const float* __restrict__ splats, long long Kp,
                                           long long k) {
  xy[0] = splats[0 * Kp + k];
  xy[1] = splats[1 * Kp + k];
  con_op[0] = splats[2 * Kp + k];
  con_op[1] = splats[3 * Kp + k];
  con_op[2] = splats[4 * Kp + k];
  con_op[3] = splats[5 * Kp + k];
  rgb[0] = splats[6 * Kp + k];
  rgb[1] = splats[7 * Kp + k];
  rgb[2] = splats[8 * Kp + k];
}

}  // namespace composite
