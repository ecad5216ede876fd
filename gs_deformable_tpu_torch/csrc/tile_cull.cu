// The exact per-tile ellipse cull: which tiles of a gaussian's rect its
// ellipse reaches (ops/projection.py, tile_ellipse_mask_plain).
//
// For row r with 0 < tiles_touched[r] <= max_bits and conic (a, b, c) with
// a > 0 and c > 0 ("usable"): slot i < tiles_touched of the rect [x0, y0,
// x1, y1) is the tile (x0 + i mod w, y0 + i div w), w = max(x1 - x0, 1);
// the slot is kept where the least of q(d) = a dx^2 + 2b dx dy + c dy^2
// over the tile's pixel box, measured from the centre, is at most
// qthr = 2 ln(max(255 op, 1)) + slack.  Out:
//
//   mask_code[r] = (1 << 16) | (bit i set for each kept slot)   (usable)
//                  0                                             (otherwise)
//   new_tiles[r] = the number of kept slots (usable), else tiles_touched[r]
//
// Replaces no TPU kernel: XLA fuses the JAX package's 16-pass loop into one
// pass.  In PyTorch the same loop is ~1,370 elementwise launches a call.
//
// Bitwise the plain loop on CUDA tensors.  The outputs are integers and
// binning is held bitwise, so every float is computed as torch's kernels
// compute it, one rounding an operation (-fmad=false keeps nvcc from
// contracting), in the loop's order:
//   qthr = 2 * logf(max(255 * op, 1)) + slack     (logf: torch's log)
//   q(dx, dy) = ((a * dx) * dx + ((2 * b) * dx) * dy) + (c * dy) * dy
//   the clamped coordinate ((-b) * d) / c or ((-b) * d) / a, IEEE division
//   px0 = float((x0 + i mod w) * tile_x), int32 arithmetic that wraps
// and with torch's NaN rules: minimum returns its first NaN operand, clamp
// its value's, then its bounds' (fminf and fmaxf alone would drop a NaN).
// A pixel box that holds the centre gives 0.  Rows that are not usable and
// slots past tiles_touched are skipped: the loop throws their work away.
//
// One thread a row; a launch on the caller's stream, no host wait, no
// memset and no state between launches, so a CUDA graph can capture it.
// Only with a counts pointer (tracing on) does a call first zero
// counts[0..1] (one memset), then add the rows with tiles_touched > 0 and
// the usable rows into them (one atomic a block each).
//
// What bounds it on the H100: bytes.  A row reads 44 B (centre, conic,
// opacity, rect, tiles) and writes 8 B: 13.6 MB at 262,144 rows, ~4 us at
// 3.35 TB/s.  The arithmetic (16 slots x ~70 operations at most, four of
// them divisions) is a few us more on the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BITS = 16;

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// int32 sum and product as torch's int32 tensors make them: modulo 2^32.
__device__ __forceinline__ int wrap_add(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}

__device__ __forceinline__ int wrap_mul(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) * static_cast<unsigned>(y));
}

__device__ __forceinline__ float q_at(float a, float b2, float c, float dx, float dy) {
  return (a * dx * dx + b2 * dx * dy) + c * dy * dy;
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
tile_cull_kernel(const float* __restrict__ mean, long long ld_mean,
                 const float* __restrict__ conic, long long ld_conic,
                 const float* __restrict__ opac, long long ld_opac,
                 const int* __restrict__ rect, long long ld_rect,
                 const int* __restrict__ tiles_in, long long ld_tiles, long long n,
                 int tile_x, int tile_y, int max_bits, float slack,
                 int* __restrict__ mask_out, int* __restrict__ tiles_out,
                 unsigned long long* __restrict__ counts) {
  const long long r = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  bool touched = false, usable = false;
  if (r < n) {
    const int tt = tiles_in[r * ld_tiles];
    const float* cr = conic + r * ld_conic;
    const float a = cr[0], b = cr[1], c = cr[2];
    touched = tt > 0;
    usable = touched && tt <= max_bits && a > 0.f && c > 0.f;
    int code = 0, kept = tt;
    if (usable) {
      const float gx = mean[r * ld_mean], gy = mean[r * ld_mean + 1];
      const float o = 255.f * opac[r * ld_opac];
      const float qthr = 2.f * logf(o != o ? o : fmaxf(o, 1.f)) + slack;
      const int* rr = rect + r * ld_rect;
      const int x0 = rr[0], y0 = rr[1];
      const int dw = static_cast<int>(static_cast<unsigned>(rr[2]) - static_cast<unsigned>(x0));
      const int w = dw < 1 ? 1 : dw;
      const float b2 = 2.f * b, nb = -b;
      const float ex = static_cast<float>(tile_x - 1), ey = static_cast<float>(tile_y - 1);
      int mask = 0;
      kept = 0;
      for (int i = 0; i < tt; ++i) {
        const int iy = i / w, ix = i - iy * w;
        const float px0 = static_cast<float>(wrap_mul(wrap_add(x0, ix), tile_x));
        const float py0 = static_cast<float>(wrap_mul(wrap_add(y0, iy), tile_y));
        const float ax = gx - (px0 + ex), bx = gx - px0;
        const float ay = gy - (py0 + ey), by = gy - py0;
        float qmin = 0.f;
        if (!(ax <= 0.f && bx >= 0.f && ay <= 0.f && by >= 0.f)) {
          const float qa = q_at(a, b2, c, ax, nan_clamp(nb * ax / c, ay, by));
          const float qb = q_at(a, b2, c, bx, nan_clamp(nb * bx / c, ay, by));
          const float qc = q_at(a, b2, c, nan_clamp(nb * ay / a, ax, bx), ay);
          const float qd = q_at(a, b2, c, nan_clamp(nb * by / a, ax, bx), by);
          qmin = nan_min(nan_min(qa, qb), nan_min(qc, qd));
        }
        if (qmin <= qthr) {
          mask |= 1 << i;
          ++kept;
        }
      }
      code = mask | (1 << 16);
    }
    mask_out[r] = code;
    tiles_out[r] = kept;
  }
  if (COUNT) {
    const int rows = __syncthreads_count(touched);
    const int masked = __syncthreads_count(usable);
    if (threadIdx.x == 0) {
      atomicAdd(counts, static_cast<unsigned long long>(rows));
      atomicAdd(counts + 1, static_cast<unsigned long long>(masked));
    }
  }
}

}  // namespace

extern "C" {

// Row strides in elements: means (n, 2), conics (n, 3) and rect (n, 4) with
// unit column strides, opacities and tiles_touched one element a row.
// mask_code and new_tiles are (n,) int32, contiguous.  counts: null, or two
// int64 (8-byte aligned) that the launch zeroes and then counts into.
int tile_cull(const void* means, long long ld_means, const void* conics, long long ld_conics,
              const void* opac, long long ld_opac, const void* rect, long long ld_rect,
              const void* tiles, long long ld_tiles, long long n, int tile_x, int tile_y,
              int max_bits, float slack, void* mask_code, void* new_tiles, void* counts,
              void* stream) {
  if (n < 0 || tile_x < 1 || tile_y < 1 || max_bits > MAX_BITS ||
      (reinterpret_cast<uintptr_t>(counts) & 7u))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts != nullptr) {
    const cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
  }
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + THREADS - 1) / THREADS;
  auto kernel = counts != nullptr ? tile_cull_kernel<true> : tile_cull_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const float*>(means), ld_means, static_cast<const float*>(conics), ld_conics,
      static_cast<const float*>(opac), ld_opac, static_cast<const int*>(rect), ld_rect,
      static_cast<const int*>(tiles), ld_tiles, n, tile_x, tile_y, max_bits, slack,
      static_cast<int*>(mask_code), static_cast<int*>(new_tiles),
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

}  // extern "C"
