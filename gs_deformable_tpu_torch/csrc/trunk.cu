// The deformation trunk's epilogues in the bf16 tiers (models/deform.py,
// _Bf16Trunk): what a layer does to the fp32 output of its bf16 x bf16
// matrix product, forward and backward.
//
//   trunk_bias_relu:  out[r, c] = bf16_rn(relu(y[r, c] + b[c]))
//   trunk_relu_mask:  v = a[r, c] > 0 ? g[r, c] : 0;  out[r, c] = bf16_rn(v),
//                     and the column sums of out (or of v), the bias's cotangent
//
// y and g are fp32, b fp32, a and out bf16; C columns of n rows, each
// operand with its own row stride, so a layer's output can land inside a
// wider buffer (the skip layer's operand holds the skip input in front).
//
// Replaces no TPU kernel: the JAX package leaves the bias, ReLU and casts to
// XLA, which fuses them into its dot.  Here the product is cuBLAS's
// (torch.mm with out_dtype=float32), and these kernels do in one pass what
// took three or four elementwise kernels and an fp32 round trip each.
//
// Forward: the next layer rounds this layer's activation to bf16 anyway, and
// round(relu(v)) == relu(round(v)), so storing the bf16 is exact.  The bias
// is added in fp32 to the fp32 product, before any rounding.
// Backward: in the "bfloat16" tier the cotangent of a stored activation is
// the bf16 rounding of the fp32 product g (the cast's transpose), masked by
// the ReLU, whose mask comes from the stored output; in "bfloat16_bwd" the
// masked fp32 cotangent is rounded before the next products.  Both are the
// formula above.
//
// The bias's cotangent is the column sum of the layer's masked cotangent:
// trunk_relu_mask adds it up while the values are in registers, instead of
// a second pass over n x C.  Block b owns rows [b * rows_per_block, ...):
// each thread sums its column group over its rows in order, the block adds
// its row lanes in order and writes one row of partial sums, and the caller
// adds the blocks' rows (grid x C floats).  The order is fixed by n and the
// grid, so the sums are the same from run to run.
//
// What bounds it on the H100: bytes.  A row of 256 columns reads 1 KB of
// fp32 (plus 512 B of bf16 for the mask) and writes 512 B; at 1,048,576
// rows that is 1.6 GB (2.1 GB backward), 0.47 ms (0.63 ms) at 3.35 TB/s.
// One thread takes 8 columns of a row: two 16-byte fp32 loads (streaming,
// read once), the 8 bf16 of the mask as one 16-byte load, one 16-byte
// store; consecutive threads take consecutive column groups, so a warp
// reads and writes whole rows.  The forward is a grid-stride loop
// over n * C / 8 groups; the backward gives each block a range of rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN stays NaN

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// g where the bf16 in the low (half 0) or high (half 1) 16 bits of bits is
// > 0, else 0: a bf16 is the top half of the fp32 of the same value.
__device__ __forceinline__ float masked(float g, uint32_t bits, int half) {
  return __uint_as_float(half ? bits & 0xFFFF0000u : bits << 16) > 0.f ? g : 0.f;
}

__global__ void __launch_bounds__(THREADS)
bias_relu_kernel(const float* __restrict__ y, long long ldy, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, long long ldo, long long n, int c8) {
  const long long total = n * c8;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long r = i / c8;
    const int c = static_cast<int>(i - r * c8) * 8;
    const float4* yp = reinterpret_cast<const float4*>(y + r * ldy + c);
    const float4* bp = reinterpret_cast<const float4*>(bias + c);
    const float4 y0 = __ldcs(yp), y1 = __ldcs(yp + 1);
    const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
    uint4 o;
    o.x = pack(relu(y0.x + b0.x), relu(y0.y + b0.y));
    o.y = pack(relu(y0.z + b0.z), relu(y0.w + b0.w));
    o.z = pack(relu(y1.x + b1.x), relu(y1.y + b1.y));
    o.w = pack(relu(y1.z + b1.z), relu(y1.w + b1.w));
    *reinterpret_cast<uint4*>(out + r * ldo + c) = o;
  }
}

// blockDim.x = c8 * lanes threads: column group threadIdx.x % c8 of rows
// r0 + lane, r0 + lane + lanes, ...; partial[blockIdx.x * C + c] gets the
// block's column sums, of the bf16 outputs (ROUNDED) or of the fp32 values.
template <bool ROUNDED>
__global__ void __launch_bounds__(THREADS)
relu_mask_kernel(const float* __restrict__ g, long long ldg, const __nv_bfloat16* __restrict__ a,
                 long long lda, __nv_bfloat16* __restrict__ out, long long ldo, long long n,
                 int c8, long long rows_per_block, float* __restrict__ partial) {
  extern __shared__ float red[];  // blockDim.x x 8
  const int lanes = blockDim.x / c8;
  const int cg = threadIdx.x % c8, lane = threadIdx.x / c8;
  const int c = cg * 8;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (long long r = r0 + lane; r < r1; r += lanes) {
    const float4* gp = reinterpret_cast<const float4*>(g + r * ldg + c);
    const float4 g0 = __ldcs(gp), g1 = __ldcs(gp + 1);
    const uint4 m = __ldcs(reinterpret_cast<const uint4*>(a + r * lda + c));
    const float v[8] = {masked(g0.x, m.x, 0), masked(g0.y, m.x, 1), masked(g0.z, m.y, 0),
                        masked(g0.w, m.y, 1), masked(g1.x, m.z, 0), masked(g1.y, m.z, 1),
                        masked(g1.z, m.w, 0), masked(g1.w, m.w, 1)};
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = pack(v[2 * k], v[2 * k + 1]);
      if (ROUNDED) {
        sum[2 * k] += __uint_as_float(o[k] << 16);
        sum[2 * k + 1] += __uint_as_float(o[k] & 0xFFFF0000u);
      } else {
        sum[2 * k] += v[2 * k];
        sum[2 * k + 1] += v[2 * k + 1];
      }
    }
    *reinterpret_cast<uint4*>(out + r * ldo + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) red[threadIdx.x * 8 + k] = sum[k];
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float t = 0.f;
      for (int l = 0; l < lanes; ++l) t += red[(l * c8 + cg) * 8 + k];
      partial[blockIdx.x * (long long)c8 * 8 + c + k] = t;
    }
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int grid_for(long long groups) {
  const long long want = (groups + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sm_count()) * BLOCKS_PER_SM;
  return static_cast<int>(want < cap ? want : cap);
}

// The backward's blocks: 8 of 256 threads per SM (2,048 threads, the SM's
// most), each over an equal range of rows; fewer where rows are few.
void mask_grid(long long n, int c8, int* threads, int* blocks, long long* rows_per_block) {
  const int lanes = c8 >= THREADS ? 1 : THREADS / c8;
  *threads = c8 * lanes;
  if (n == 0) {  // one block writes zero sums
    *blocks = 1;
    *rows_per_block = 0;
    return;
  }
  long long want = (n + lanes - 1) / lanes;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  if (want > cap) want = cap;
  *rows_per_block = (n + want - 1) / want;
  *blocks = static_cast<int>((n + *rows_per_block - 1) / *rows_per_block);
}

}  // namespace

extern "C" {

// Row strides in elements of each operand's own type.  Every pointer and
// row start must be 16-byte aligned and C a multiple of 8; anything else is
// refused with cudaErrorInvalidValue before a launch.
int trunk_bias_relu(const void* y, long long ldy, const void* bias, void* out, long long ldo,
                    long long n, int C, void* stream) {
  if (n < 0 || C < 8 || C % 8 || ldy % 4 || ldo % 8 || !aligned(y) || !aligned(bias) ||
      !aligned(out))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int c8 = C / 8;
  bias_relu_kernel<<<grid_for(n * c8), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), ldy, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), ldo, n, c8);
  return cudaGetLastError();
}

// Blocks of trunk_relu_mask for n rows of C columns: the rows of the
// partial sums it writes (each C floats).
int trunk_relu_mask_blocks(long long n, int C) {
  int threads, blocks;
  long long rows;
  mask_grid(n, C / 8, &threads, &blocks, &rows);
  return blocks;
}

int trunk_relu_mask(const void* g, long long ldg, const void* a, long long lda, void* out,
                    long long ldo, long long n, int C, int rounded, void* partial, void* stream) {
  if (n < 0 || C < 8 || C % 8 || C > 8 * THREADS || ldg % 4 || lda % 8 || ldo % 8 ||
      !aligned(g) || !aligned(a) || !aligned(out) || !aligned(partial))
    return cudaErrorInvalidValue;
  int threads, blocks;
  long long rows;
  mask_grid(n, C / 8, &threads, &blocks, &rows);
  const size_t smem = static_cast<size_t>(threads) * 8 * sizeof(float);
  auto kernel = rounded ? relu_mask_kernel<true> : relu_mask_kernel<false>;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), ldg, static_cast<const __nv_bfloat16*>(a), lda,
      static_cast<__nv_bfloat16*>(out), ldo, n, C / 8, rows, static_cast<float*>(partial));
  return cudaGetLastError();
}

}  // extern "C"
