// Screen space, one thread a gaussian, one launch each way: cov3D, the EWA
// projection, the radius and tile rect, and the SH colour (the plain chain
// ops/kernels/screen_space.py forward_plain: transforms.build_cov3d,
// projection.preprocess and compute_cov2d, sh.eval_sh_color).
//
// Forward, row r (row-vector camera: p_view = [m, 1] @ V, p_clip = [m, 1] @ P):
//   depth = view z; ndc = p_clip.xy / (p_clip.w + 1e-7); pix = ndc2pix(ndc)
//   Sigma = L L^T, L = R(q) diag(scale_mod * s); cov2d = J W Sigma W^T J^T
//   + 0.3 on the diagonal; conic = cov2d^-1 (0 where det = 0)
//   radius = ceil(nsigma * sqrt(max eig)); rect = the tile bounds of the
//   radius (intersected with the 3-sigma rect under the opacity-aware
//   nsigma); tiles = rect's area; mask = z > 0.2, det != 0, tiles > 0, alive
//   colour = max(SH_deg(sh, (m - campos) / |m - campos|) + 0.5, 0)
//   with a tap: ndc_tap = ndc + tap, pix_tap = ndc2pix(ndc_tap)
// Backward, row r: recomputes those values from the inputs (nothing but the
// inputs is saved) and takes the chain rule of the same expressions to the
// cotangents that arrived (ndc, pix, depth, conic, colour and the tapped
// pair; a null one is absent), as autograd does the plain chain's:
// gradients of means, scales, rotations, the SH coefficients and the tap.
// torch's rules hold where autograd applies them: clamp passes its
// gradient on [lo, hi] inclusive, where to the chosen branch only, the
// norm's backward is 0 at a zero norm.  A branch whose cotangents are all
// absent is not walked, as autograd walks no node that gets none, so a row
// whose cotangents are zero gets zero gradients as autograd gives it
// (dead rows at 1e6 stay finite throughout).  Pattern: the 3DGS
// reference's computeCov3D / computeCov2DCUDA / computeColorFromSH
// backward, on this port's formulas.
//
// Replaces no TPU kernel: XLA fuses the JAX package's elementwise chain.  In
// PyTorch the chain is ~415 elementwise launches a frame and its autograd
// backward ~677 more a step.
//
// Integers feed binning, which is bitwise, so the forward equals the plain
// chain run on the same CUDA tensors: every float op rounds once, as
// torch's elementwise kernels do (-fmad=false keeps nvcc from contracting),
// in the plain chain's order, with its constants rounded from the Python
// doubles, its IEEE divisions and square roots, logf, and torch's NaN rules
// (clamp and maximum return a NaN operand; NaN casts to int 0).  The three
// products torch hands to cuBLAS -- [m] @ V[:3, 2], [m] @ V[:3, :3] and
// [m] @ P[:3, :] -- and the norm of the SH direction are summed here in the
// order those kernels sum on an H100 (see dot3_blas, dot3_gemv, norm3),
// found by comparing candidate orders on the card; past 699,050 rows the
// near test's gemv sums in another order, and a depth there may be an ulp
// off the plain chain's.
//
// What bounds it on the H100: bytes.  At SH degree 3 with 16 coefficients,
// the forward reads 245 B a row (means, scales, rotation, opacity, alive,
// 48 SH floats, the tap) and writes 85 B (ndc, pixel centre, depth, conic,
// colour, radius, rect, tiles, mask, the tapped pair): 0.10 ms at 1,048,576
// rows and 3.35 TB/s.  The backward reads the inputs but the opacity,
// alive and tap and the train step's three cotangents (264 B) and writes
// 240 B of gradients: 0.16 ms.  One thread a row keeps every intermediate
// in registers (the SH degree is a template argument, so the coefficients
// stay there too) and makes one pass over the rows each way, where the
// plain chain made ~415 and ~677.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// Constants as torch makes them: the Python double rounded to float.
#define F32(x) static_cast<float>(x)

__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float nan_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float nan_clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch's float -> int32 cast (a truncating cvt: NaN to 0, saturating).
__device__ __forceinline__ int to_i32(float v) { return static_cast<int>(v); }

// sum_k m_k b_k as cuBLAS sums a (P, 3) @ (3, c) product on the H100.
__device__ __forceinline__ float dot3_blas(float m0, float m1, float m2, float b0, float b1,
                                           float b2) {
  return __fmaf_rn(m2, b2, __fmaf_rn(m1, b1, m0 * b0));
}

// The (P, 3) @ (3,) product (cuBLAS gemv) of the near test, in the order
// cuBLAS's gemv sums it on the H100 up to 699,050 rows.  Past that cuBLAS
// picks another gemv kernel, which pairs m0 b0 with m2 b2, so a depth there
// may differ from the plain chain's by an ulp.
__device__ __forceinline__ float dot3_gemv(float m0, float m1, float m2, float b0, float b1,
                                           float b2) {
  return __fmaf_rn(m1, b1, m0 * b0) + m2 * b2;
}

// torch.linalg.vector_norm over a row of 3 on the card: (x^2 + z^2) + y^2.
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}

__device__ __forceinline__ float ndc2pix(float v, float size) {
  return ((v + 1.f) * size - 1.f) * 0.5f;
}

struct Cam {
  float v[16], p[16], c[3];
};

__device__ __forceinline__ void load_cam(Cam& cam, const float* view, const float* proj,
                                         const float* campos) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    cam.v[i] = view[i];
    cam.p[i] = proj[i];
  }
  cam.c[0] = campos[0];
  cam.c[1] = campos[1];
  cam.c[2] = campos[2];
}

// V[k][j] of a row-major 4x4.
#define V_(k, j) cam.v[(k) * 4 + (j)]
#define P_(k, j) cam.p[(k) * 4 + (j)]

struct Params {
  int width, height, tile_x, tile_y, grid_x, grid_y;
  float scale_mod, focal_x, focal_y, lim_x, lim_y;
};

// R(q) as transforms._rot_entries writes it, q = (r, x, y, z).
__device__ __forceinline__ void rot_entries(const float q[4], float R[3][3]) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = 1.f - 2.f * (y * y + z * z);
  R[0][1] = 2.f * (x * y - r * z);
  R[0][2] = 2.f * (x * z + r * y);
  R[1][0] = 2.f * (x * y + r * z);
  R[1][1] = 1.f - 2.f * (x * x + z * z);
  R[1][2] = 2.f * (y * z - r * x);
  R[2][0] = 2.f * (x * z - r * y);
  R[2][1] = 2.f * (y * z + r * x);
  R[2][2] = 1.f - 2.f * (x * x + y * y);
}

// The EWA values of one row: the view point, the Jacobian entries, the
// covariance in camera space (s = W Sigma W^T) and cov2d.
struct Ewa {
  float t0, t1, tz, txr, tyr, tx, ty, inv_z, inv_z2, a00, a02, a11, a12;
  float sg[3][3], tmp[3][3], s00, s01, s02, s11, s12, s22;
  float c00, c01, c11;
};

__device__ __forceinline__ void ewa(const Cam& cam, const Params& pr, const float m[3],
                                    const float cov[6], Ewa& e) {
  e.t0 = dot3_blas(m[0], m[1], m[2], V_(0, 0), V_(1, 0), V_(2, 0)) + V_(3, 0);
  e.t1 = dot3_blas(m[0], m[1], m[2], V_(0, 1), V_(1, 1), V_(2, 1)) + V_(3, 1);
  e.tz = dot3_blas(m[0], m[1], m[2], V_(0, 2), V_(1, 2), V_(2, 2)) + V_(3, 2);
  e.txr = e.t0 / e.tz;
  e.tyr = e.t1 / e.tz;
  e.tx = nan_clamp(e.txr, -pr.lim_x, pr.lim_x) * e.tz;
  e.ty = nan_clamp(e.tyr, -pr.lim_y, pr.lim_y) * e.tz;
  e.inv_z = 1.f / e.tz;
  e.inv_z2 = e.inv_z * e.inv_z;
  e.a00 = pr.focal_x * e.inv_z;
  e.a02 = (-pr.focal_x * e.tx) * e.inv_z2;
  e.a11 = pr.focal_y * e.inv_z;
  e.a12 = (-pr.focal_y * e.ty) * e.inv_z2;
  const float xx = cov[0], xy = cov[1], xz = cov[2], yy = cov[3], yz = cov[4], zz = cov[5];
  e.sg[0][0] = xx; e.sg[0][1] = xy; e.sg[0][2] = xz;
  e.sg[1][0] = xy; e.sg[1][1] = yy; e.sg[1][2] = yz;
  e.sg[2][0] = xz; e.sg[2][1] = yz; e.sg[2][2] = zz;
  // Python's sum() starts at 0: 0 + p0 is a rounding of its own (-0 -> +0).
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      e.tmp[i][k] = ((V_(0, i) * e.sg[0][k] + 0.f) + V_(1, i) * e.sg[1][k]) +
                    V_(2, i) * e.sg[2][k];
#define SCAM(i, l) \
  (((e.tmp[i][0] * V_(0, l) + 0.f) + e.tmp[i][1] * V_(1, l)) + e.tmp[i][2] * V_(2, l))
  e.s00 = SCAM(0, 0); e.s01 = SCAM(0, 1); e.s02 = SCAM(0, 2);
  e.s11 = SCAM(1, 1); e.s12 = SCAM(1, 2); e.s22 = SCAM(2, 2);
#undef SCAM
  const float lp = F32(0.3);
  e.c00 = (e.a00 * (e.a00 * e.s00 + e.a02 * e.s02) + e.a02 * (e.a00 * e.s02 + e.a02 * e.s22)) + lp;
  e.c01 = e.a11 * (e.a00 * e.s01 + e.a02 * e.s12) + e.a12 * (e.a00 * e.s02 + e.a02 * e.s22);
  e.c11 = (e.a11 * (e.a11 * e.s11 + e.a12 * e.s12) + e.a12 * (e.a11 * e.s12 + e.a12 * e.s22)) + lp;
}

// Sigma = L L^T packed [xx, xy, xz, yy, yz, zz], L = R diag(scale_mod * s).
__device__ __forceinline__ void cov3d(const float s[3], const float R[3][3], float smod,
                                      float L[3][3], float cov[6]) {
  const float sc[3] = {smod * s[0], smod * s[1], smod * s[2]};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int j = 0; j < 3; ++j) L[a][j] = R[a][j] * sc[j];
#define SIG(a, b) ((L[a][0] * L[b][0] + L[a][1] * L[b][1]) + L[a][2] * L[b][2])
  cov[0] = SIG(0, 0); cov[1] = SIG(0, 1); cov[2] = SIG(0, 2);
  cov[3] = SIG(1, 1); cov[4] = SIG(1, 2); cov[5] = SIG(2, 2);
#undef SIG
}

// The SH constants of ops/sh.py, rounded as torch rounds a Python float.
#define C0 F32(0.28209479177387814)
#define C1 F32(0.4886025119029199)
#define C2_0 F32(1.0925484305920792)
#define C2_1 F32(-1.0925484305920792)
#define C2_2 F32(0.31539156525252005)
#define C2_3 F32(-1.0925484305920792)
#define C2_4 F32(0.5462742152960396)
#define C3_0 F32(-0.5900435899266435)
#define C3_1 F32(2.890611442640554)
#define C3_2 F32(-0.4570457994644658)
#define C3_3 F32(0.3731763325901154)
#define C3_4 F32(-0.4570457994644658)
#define C3_5 F32(1.445305721320277)
#define C3_6 F32(-0.5900435899266435)
#define C4_0 F32(2.5033429417967046)
#define C4_1 F32(-1.7701307697799304)
#define C4_2 F32(0.9461746957575601)
#define C4_3 F32(-0.6690465435572892)
#define C4_4 F32(0.10578554691520431)
#define C4_5 F32(-0.6690465435572892)
#define C4_6 F32(0.47308734787878004)
#define C4_7 F32(-1.7701307697799304)
#define C4_8 F32(0.6258357354491761)

// The coefficient of each SH term (sh.eval_sh's grouping: the term is
// basis[k] * sh[k], its first one subtracted where eval_sh subtracts).
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float b[25]) {
  b[0] = C0;
  if (DEG > 0) {
    b[1] = C1 * y;
    b[2] = C1 * z;
    b[3] = C1 * x;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    b[4] = C2_0 * xy;
    b[5] = C2_1 * yz;
    b[6] = C2_2 * ((2.f * zz - xx) - yy);
    b[7] = C2_3 * xz;
    b[8] = C2_4 * (xx - yy);
    if (DEG > 2) {
      b[9] = (C3_0 * y) * (3.f * xx - yy);
      b[10] = (C3_1 * xy) * z;
      b[11] = (C3_2 * y) * ((4.f * zz - xx) - yy);
      b[12] = (C3_3 * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
      b[13] = (C3_4 * x) * ((4.f * zz - xx) - yy);
      b[14] = (C3_5 * z) * (xx - yy);
      b[15] = (C3_6 * x) * (xx - 3.f * yy);
    }
    if (DEG > 3) {
      b[16] = (C4_0 * xy) * (xx - yy);
      b[17] = (C4_1 * yz) * (3.f * xx - yy);
      b[18] = (C4_2 * xy) * (7.f * zz - 1.f);
      b[19] = (C4_3 * yz) * (7.f * zz - 3.f);
      b[20] = C4_4 * (zz * (35.f * zz - 30.f) + 3.f);
      b[21] = (C4_5 * xz) * (7.f * zz - 3.f);
      b[22] = (C4_6 * (xx - yy)) * (7.f * zz - 1.f);
      b[23] = (C4_7 * xz) * (xx - 3.f * yy);
      b[24] = C4_8 * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy));
    }
  }
}

// eval_sh's sum for one channel, term by term in its order.
template <int DEG>
__device__ __forceinline__ float sh_sum(const float b[25], const float* sh) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  float v = b[0] * sh[0];
  if (DEG > 0) v = ((v - b[1] * sh[1]) + b[2] * sh[2]) - b[3] * sh[3];
#pragma unroll
  for (int k = 4; k < K; ++k) v = v + b[k] * sh[k];
  return v;
}

struct Dirs {
  float d[3], n, nc, u[3];  // m - campos, its norm, clamped, the unit direction
};

__device__ __forceinline__ void sh_dirs(const Cam& cam, const float m[3], Dirs& dr) {
#pragma unroll
  for (int k = 0; k < 3; ++k) dr.d[k] = m[k] - cam.c[k];
  dr.n = norm3(dr.d[0], dr.d[1], dr.d[2]);
  dr.nc = nan_clamp_min(dr.n, F32(1e-12));
#pragma unroll
  for (int k = 0; k < 3; ++k) dr.u[k] = dr.d[k] / dr.nc;
}

template <typename T>
__device__ __forceinline__ const T* row(const void* base, long long r, long long ld) {
  return static_cast<const T*>(base) + r * ld;
}

// A row of SH coefficients, (n_coef, 3) contiguous.
template <int DEG>
__device__ __forceinline__ void load_sh(const float* sh, float out[3][25]) {
  constexpr int K = (DEG + 1) * (DEG + 1);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c][k] = sh[3 * k + c];
}

struct FwdArgs {
  const void *means, *scales, *rots, *shs, *opac, *alive, *tap;
  long long ld_means, ld_scales, ld_rots, ld_opac, ld_alive, ld_tap;
  const float *view, *proj, *campos;
  long long n;
  int n_coef;
  Params pr;
  float *ndc, *pix, *depth, *conic, *color, *ndc_tap, *pix_tap;
  int *radii, *rect, *tiles;
  uint8_t* mask;
};

template <int DEG>
__global__ void __launch_bounds__(THREADS) forward_kernel(const FwdArgs a) {
  const long long r = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (r >= a.n) return;
  Cam cam;
  load_cam(cam, a.view, a.proj, a.campos);
  const Params& pr = a.pr;
  const float* mp = row<float>(a.means, r, a.ld_means);
  const float m[3] = {mp[0], mp[1], mp[2]};

  // near test and projection
  const float vz =
      dot3_gemv(m[0], m[1], m[2], V_(0, 2), V_(1, 2), V_(2, 2)) + V_(3, 2);
  const bool in_front = vz > F32(0.2);
  float ph[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ph[j] = dot3_blas(m[0], m[1], m[2], P_(0, j), P_(1, j), P_(2, j)) + P_(3, j);
  const float p_w = 1.f / (ph[3] + F32(1e-7));
  const float ndc_x = ph[0] * p_w, ndc_y = ph[1] * p_w;
  const float wf = static_cast<float>(pr.width), hf = static_cast<float>(pr.height);
  const float pix_x = ndc2pix(ndc_x, wf), pix_y = ndc2pix(ndc_y, hf);

  // cov3D and its EWA projection
  const float* sp = row<float>(a.scales, r, a.ld_scales);
  const float* qp = row<float>(a.rots, r, a.ld_rots);
  const float s[3] = {sp[0], sp[1], sp[2]};
  const float q[4] = {qp[0], qp[1], qp[2], qp[3]};
  float R[3][3], L[3][3], cov[6];
  rot_entries(q, R);
  cov3d(s, R, pr.scale_mod, L, cov);
  Ewa e;
  ewa(cam, pr, m, cov, e);
  const float det = e.c00 * e.c11 - e.c01 * e.c01;
  const bool det_ok = det != 0.f;
  const float det_inv = det_ok ? 1.f / det : 0.f;

  // radius and tile rect
  const float mid = 0.5f * (e.c00 + e.c11);
  const float disc = nan_clamp_min(mid * mid - det, F32(0.1));
  const float lam1 = mid + sqrtf(disc), lam2 = mid - sqrtf(disc);
  const float sqrt_lam = sqrtf(nan_max(lam1, lam2));
  float nsigma = 3.f;
  if (a.opac != nullptr) {
    const float o = *row<float>(a.opac, r, a.ld_opac);
    nsigma = sqrtf(nan_clamp_min(2.f * logf(255.f * o) + F32(0.02), 0.f));
    nsigma = nan_clamp_max(nsigma, 3.f);
  }
  const float radius_f = ceilf(nsigma * sqrt_lam);
  // x / tile on the card is x * (1 / tile): torch's division by a scalar
  const float itx = 1.f / static_cast<float>(pr.tile_x), ity = 1.f / static_cast<float>(pr.tile_y);
  const float tx_f = static_cast<float>(pr.tile_x), ty_f = static_cast<float>(pr.tile_y);
  const float gxf = static_cast<float>(pr.grid_x), gyf = static_cast<float>(pr.grid_y);
  const int x0 = to_i32(nan_clamp(floorf((pix_x - radius_f) * itx), 0.f, gxf));
  const int y0 = to_i32(nan_clamp(floorf((pix_y - radius_f) * ity), 0.f, gyf));
  float x1f, y1f;
  if (a.opac != nullptr) {
    const float r3 = ceilf(3.f * sqrt_lam);
    x1f = nan_min(floorf((pix_x + radius_f) * itx) + 1.f,
                  floorf((((pix_x + r3) + tx_f) - 1.f) * itx));
    y1f = nan_min(floorf((pix_y + radius_f) * ity) + 1.f,
                  floorf((((pix_y + r3) + ty_f) - 1.f) * ity));
  } else {
    x1f = floorf((((pix_x + radius_f) + tx_f) - 1.f) * itx);
    y1f = floorf((((pix_y + radius_f) + ty_f) - 1.f) * ity);
  }
  const int x1 = to_i32(nan_clamp(x1f, 0.f, gxf));
  const int y1 = to_i32(nan_clamp(y1f, 0.f, gyf));
  const int ntiles = (x1 - x0) * (y1 - y0);
  bool mask = in_front && det_ok && ntiles > 0;
  if (a.alive != nullptr) mask = mask && *row<uint8_t>(a.alive, r, a.ld_alive) != 0;

  // SH colour
  float col[3];
  {
    Dirs dr = {};
    if (DEG > 0) sh_dirs(cam, m, dr);
    float b[25], sh[3][25];
    sh_basis<DEG>(dr.u[0], dr.u[1], dr.u[2], b);
    load_sh<DEG>(static_cast<const float*>(a.shs) + r * 3 * a.n_coef, sh);
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = nan_clamp_min(sh_sum<DEG>(b, sh[c]) + 0.5f, 0.f);
  }

  a.ndc[2 * r] = ndc_x;
  a.ndc[2 * r + 1] = ndc_y;
  a.pix[2 * r] = pix_x;
  a.pix[2 * r + 1] = pix_y;
  a.depth[r] = vz;
  a.conic[3 * r] = e.c11 * det_inv;
  a.conic[3 * r + 1] = -e.c01 * det_inv;
  a.conic[3 * r + 2] = e.c00 * det_inv;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.color[3 * r + c] = col[c];
  a.radii[r] = mask ? to_i32(radius_f) : 0;
  a.rect[4 * r] = x0;
  a.rect[4 * r + 1] = y0;
  a.rect[4 * r + 2] = x1;
  a.rect[4 * r + 3] = y1;
  a.tiles[r] = mask ? ntiles : 0;
  a.mask[r] = mask;
  if (a.tap != nullptr) {
    const float* tp = row<float>(a.tap, r, a.ld_tap);
    const float tx = ndc_x + tp[0], ty = ndc_y + tp[1];
    a.ndc_tap[2 * r] = tx;
    a.ndc_tap[2 * r + 1] = ty;
    a.pix_tap[2 * r] = ndc2pix(tx, wf);
    a.pix_tap[2 * r + 1] = ndc2pix(ty, hf);
  }
}

struct BwdArgs {
  const void *means, *scales, *rots, *shs;
  long long ld_means, ld_scales, ld_rots;
  const float *view, *proj, *campos;
  long long n;
  int n_coef;
  Params pr;
  // cotangents, null where none arrived
  const void *g_ndc, *g_pix, *g_depth, *g_conic, *g_color, *g_ndc_tap, *g_pix_tap;
  long long ld_g_ndc, ld_g_pix, ld_g_depth, ld_g_conic, ld_g_color, ld_g_ndc_tap, ld_g_pix_tap;
  // gradients, contiguous, null where not wanted
  float *d_means, *d_scales, *d_rots, *d_shs, *d_tap;
};

// Row r's gradients.  tile_row: row r's SH coefficients in shared memory
// (loaded where a colour cotangent arrived), where its SH gradient goes too.
template <int DEG>
__device__ __forceinline__ void backward_row(const BwdArgs& a, long long r, float* tile_row) {
  Cam cam;
  load_cam(cam, a.view, a.proj, a.campos);
  const Params& pr = a.pr;
  const float* mp = row<float>(a.means, r, a.ld_means);
  const float m[3] = {mp[0], mp[1], mp[2]};
  float gm[3] = {0.f, 0.f, 0.f};
  const float wf = static_cast<float>(pr.width), hf = static_cast<float>(pr.height);

  // ndc = p_clip.xy * p_w: the pixel cotangents through ndc2pix's (v * 0.5) * S
  float tx = 0.f, ty = 0.f;
  if (a.g_ndc || a.g_pix || a.g_ndc_tap || a.g_pix_tap) {
    float gx = 0.f, gy = 0.f;
    if (a.g_ndc_tap) {
      const float* g = row<float>(a.g_ndc_tap, r, a.ld_g_ndc_tap);
      tx += g[0];
      ty += g[1];
    }
    if (a.g_pix_tap) {
      const float* g = row<float>(a.g_pix_tap, r, a.ld_g_pix_tap);
      tx += (g[0] * 0.5f) * wf;
      ty += (g[1] * 0.5f) * hf;
    }
    gx = tx;
    gy = ty;
    if (a.g_ndc) {
      const float* g = row<float>(a.g_ndc, r, a.ld_g_ndc);
      gx += g[0];
      gy += g[1];
    }
    if (a.g_pix) {
      const float* g = row<float>(a.g_pix, r, a.ld_g_pix);
      gx += (g[0] * 0.5f) * wf;
      gy += (g[1] * 0.5f) * hf;
    }
    float ph[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ph[j] = dot3_blas(m[0], m[1], m[2], P_(0, j), P_(1, j), P_(2, j)) + P_(3, j);
    const float p_w = 1.f / (ph[3] + F32(1e-7));
    const float g0 = gx * p_w, g1 = gy * p_w;
    const float g_pw = gx * ph[0] + gy * ph[1];
    const float g3 = -g_pw * (p_w * p_w);
#pragma unroll
    for (int k = 0; k < 3; ++k) gm[k] += P_(k, 0) * g0 + P_(k, 1) * g1 + P_(k, 3) * g3;
  }
  if (a.g_depth) {
    const float g = *row<float>(a.g_depth, r, a.ld_g_depth);
#pragma unroll
    for (int k = 0; k < 3; ++k) gm[k] += V_(k, 2) * g;
  }

  // conic = cov2d^-1 <- J W Sigma W^T J^T <- Sigma(s, q) and the view point
  float gs[3] = {0.f, 0.f, 0.f}, gq[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.g_conic) {
    const float* gc = row<float>(a.g_conic, r, a.ld_g_conic);
    const float gA = gc[0], gB = gc[1], gC = gc[2];
    const float* sp = row<float>(a.scales, r, a.ld_scales);
    const float* qp = row<float>(a.rots, r, a.ld_rots);
    const float s[3] = {sp[0], sp[1], sp[2]};
    const float q[4] = {qp[0], qp[1], qp[2], qp[3]};
    float R[3][3], L[3][3], cov[6];
    rot_entries(q, R);
    cov3d(s, R, pr.scale_mod, L, cov);
    Ewa e;
    ewa(cam, pr, m, cov, e);
    const float det = e.c00 * e.c11 - e.c01 * e.c01;
    const bool det_ok = det != 0.f;
    const float det_inv = det_ok ? 1.f / det : 0.f;
    // conic = (c11, -c01, c00) * det_inv
    float g_c00 = gC * det_inv, g_c11 = gA * det_inv, g_c01 = -(gB * det_inv);
    const float g_dinv = gA * e.c11 + gB * (-e.c01) + gC * e.c00;
    // det_inv = where(ok, 1 / where(ok, det, 1), 0)
    const float g_det = det_ok ? -g_dinv * (det_inv * det_inv) : 0.f;
    g_c00 += g_det * e.c11;
    g_c11 += g_det * e.c00;
    g_c01 += -(2.f * g_det * e.c01);
    // c = a J-row products of s
    const float u0 = e.a00 * e.s00 + e.a02 * e.s02, u1 = e.a00 * e.s02 + e.a02 * e.s22;
    const float v0 = e.a00 * e.s01 + e.a02 * e.s12, v1 = u1;
    const float w0 = e.a11 * e.s11 + e.a12 * e.s12, w1 = e.a11 * e.s12 + e.a12 * e.s22;
    float g_a00 = g_c00 * u0, g_a02 = g_c00 * u1, g_a11 = g_c01 * v0 + g_c11 * w0,
          g_a12 = g_c01 * v1 + g_c11 * w1;
    const float g_u0 = g_c00 * e.a00, g_u1 = g_c00 * e.a02;
    const float g_v0 = g_c01 * e.a11, g_v1 = g_c01 * e.a12;
    const float g_w0 = g_c11 * e.a11, g_w1 = g_c11 * e.a12;
    g_a00 += g_u0 * e.s00 + g_u1 * e.s02 + g_v0 * e.s01 + g_v1 * e.s02;
    g_a02 += g_u0 * e.s02 + g_u1 * e.s22 + g_v0 * e.s12 + g_v1 * e.s22;
    g_a11 += g_w0 * e.s11 + g_w1 * e.s12;
    g_a12 += g_w0 * e.s12 + g_w1 * e.s22;
    float gS[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};  // s_il cotangents
    gS[0][0] = g_u0 * e.a00;
    gS[0][2] = g_u0 * e.a02 + g_u1 * e.a00 + g_v1 * e.a00;
    gS[2][2] = g_u1 * e.a02 + g_v1 * e.a02 + g_w1 * e.a12;
    gS[0][1] = g_v0 * e.a00;
    gS[1][2] = g_v0 * e.a02 + g_w0 * e.a12 + g_w1 * e.a11;
    gS[1][1] = g_w0 * e.a11;
    // s_il = sum_k tmp[i][k] V[k][l]; tmp[i][k] = sum_j V[j][i] sg[j][k]
    float g_tmp[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < 3; ++l) acc += gS[i][l] * V_(k, l);
        g_tmp[i][k] = acc;
      }
    float g_sg[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) acc += g_tmp[i][k] * V_(j, i);
        g_sg[j][k] = acc;
      }
    // packed Sigma: each off-diagonal entry appears twice in sg; the
    // diagonal entries of Sigma = L L^T take both factors' cotangents
    float gM[3][3];
    gM[0][0] = 2.f * g_sg[0][0];
    gM[1][1] = 2.f * g_sg[1][1];
    gM[2][2] = 2.f * g_sg[2][2];
    gM[0][1] = gM[1][0] = g_sg[0][1] + g_sg[1][0];
    gM[0][2] = gM[2][0] = g_sg[0][2] + g_sg[2][0];
    gM[1][2] = gM[2][1] = g_sg[1][2] + g_sg[2][1];
    float gR[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float g_scj = 0.f;
      const float scj = pr.scale_mod * s[j];
#pragma unroll
      for (int aa = 0; aa < 3; ++aa) {
        const float gL = gM[aa][0] * L[0][j] + gM[aa][1] * L[1][j] + gM[aa][2] * L[2][j];
        gR[aa][j] = gL * scj;
        g_scj += gL * R[aa][j];
      }
      gs[j] = g_scj * pr.scale_mod;
    }
    const float qr = q[0], qx = q[1], qy = q[2], qz = q[3];
    gq[0] = 2.f * (-qz * gR[0][1] + qy * gR[0][2] + qz * gR[1][0] - qx * gR[1][2] -
                   qy * gR[2][0] + qx * gR[2][1]);
    gq[1] = 2.f * (qy * gR[0][1] + qz * gR[0][2] + qy * gR[1][0] - 2.f * qx * gR[1][1] -
                   qr * gR[1][2] + qz * gR[2][0] + qr * gR[2][1] - 2.f * qx * gR[2][2]);
    gq[2] = 2.f * (-2.f * qy * gR[0][0] + qx * gR[0][1] + qr * gR[0][2] + qx * gR[1][0] +
                   qz * gR[1][2] - qr * gR[2][0] + qz * gR[2][1] - 2.f * qy * gR[2][2]);
    gq[3] = 2.f * (-2.f * qz * gR[0][0] - qr * gR[0][1] + qx * gR[0][2] + qr * gR[1][0] -
                   2.f * qz * gR[1][1] + qy * gR[1][2] + qx * gR[2][0] + qy * gR[2][1]);
    // a00 = fx / z, a02 = (-fx tx) / z^2, a11, a12 likewise
    float g_invz = g_a00 * pr.focal_x + g_a11 * pr.focal_y;
    const float g_invz2 = g_a02 * (-pr.focal_x * e.tx) + g_a12 * (-pr.focal_y * e.ty);
    const float g_tx = (g_a02 * e.inv_z2) * -pr.focal_x;
    const float g_ty = (g_a12 * e.inv_z2) * -pr.focal_y;
    g_invz += 2.f * g_invz2 * e.inv_z;
    float g_tz = -g_invz * (e.inv_z * e.inv_z);
    // tx = clamp(t0 / tz, +-lim) * tz
    g_tz += g_tx * nan_clamp(e.txr, -pr.lim_x, pr.lim_x);
    g_tz += g_ty * nan_clamp(e.tyr, -pr.lim_y, pr.lim_y);
    const float g_txr = (e.txr >= -pr.lim_x && e.txr <= pr.lim_x) ? g_tx * e.tz : 0.f;
    const float g_tyr = (e.tyr >= -pr.lim_y && e.tyr <= pr.lim_y) ? g_ty * e.tz : 0.f;
    const float g_t0 = g_txr / e.tz, g_t1 = g_tyr / e.tz;
    g_tz += -g_txr * e.t0 / (e.tz * e.tz) - g_tyr * e.t1 / (e.tz * e.tz);
#pragma unroll
    for (int k = 0; k < 3; ++k) gm[k] += V_(k, 0) * g_t0 + V_(k, 1) * g_t1 + V_(k, 2) * g_tz;
  }

  // colour = max(SH(sh, u) + 0.5, 0), u = d / max(|d|, 1e-12), d = m - campos
  if (a.g_color) {
    const float* gc = row<float>(a.g_color, r, a.ld_g_color);
    Dirs dr;
    sh_dirs(cam, m, dr);
    const float x = dr.u[0], y = dr.u[1], z = dr.u[2];
    float b[25], sh[3][25];
    sh_basis<DEG>(x, y, z, b);
    load_sh<DEG>(tile_row, sh);
    float gv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) gv[c] = sh_sum<DEG>(b, sh[c]) + 0.5f >= 0.f ? gc[c] : 0.f;
    constexpr int K = (DEG + 1) * (DEG + 1);
    if (a.d_shs) {
      float* out = tile_row;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float bk = (k >= 1 && k <= 3 && k != 2) ? -b[k] : b[k];
#pragma unroll
        for (int c = 0; c < 3; ++c) out[3 * k + c] = gv[c] * bk;
      }
      for (int k = K; k < a.n_coef; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) out[3 * k + c] = 0.f;
    }
    if (DEG > 0) {
      // d(SH)/d(x, y, z), per channel, weighted by the channel's cotangent
      float gu[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* h = sh[c];
        float dx = -C1 * h[3], dy = -C1 * h[1], dz = C1 * h[2];
        if (DEG > 1) {
          const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
          dx += C2_0 * y * h[4] + C2_2 * (-2.f * x) * h[6] + C2_3 * z * h[7] +
                C2_4 * (2.f * x) * h[8];
          dy += C2_0 * x * h[4] + C2_1 * z * h[5] + C2_2 * (-2.f * y) * h[6] +
                C2_4 * (-2.f * y) * h[8];
          dz += C2_1 * y * h[5] + C2_2 * (4.f * z) * h[6] + C2_3 * x * h[7];
          if (DEG > 2) {
            dx += C3_0 * (6.f * xy) * h[9] + C3_1 * yz * h[10] + C3_2 * (-2.f * xy) * h[11] +
                  C3_3 * (-6.f * xz) * h[12] + C3_4 * (4.f * zz - 3.f * xx - yy) * h[13] +
                  C3_5 * (2.f * xz) * h[14] + C3_6 * (3.f * xx - 3.f * yy) * h[15];
            dy += C3_0 * (3.f * xx - 3.f * yy) * h[9] + C3_1 * xz * h[10] +
                  C3_2 * (4.f * zz - xx - 3.f * yy) * h[11] + C3_3 * (-6.f * yz) * h[12] +
                  C3_4 * (-2.f * xy) * h[13] + C3_5 * (-2.f * yz) * h[14] +
                  C3_6 * (-6.f * xy) * h[15];
            dz += C3_1 * xy * h[10] + C3_2 * (8.f * yz) * h[11] +
                  C3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * h[12] + C3_4 * (8.f * xz) * h[13] +
                  C3_5 * (xx - yy) * h[14];
          }
          if (DEG > 3) {
            const float q7 = 7.f * zz - 1.f, s7 = 7.f * zz - 3.f;
            dx += C4_0 * y * (3.f * xx - yy) * h[16] + C4_1 * (6.f * xy) * z * h[17] +
                  C4_2 * y * q7 * h[18] + C4_5 * z * s7 * h[21] +
                  C4_6 * (2.f * x) * q7 * h[22] + C4_7 * z * (3.f * xx - 3.f * yy) * h[23] +
                  C4_8 * (4.f * x) * (xx - 3.f * yy) * h[24];
            dy += C4_0 * x * (xx - 3.f * yy) * h[16] + C4_1 * z * (3.f * xx - 3.f * yy) * h[17] +
                  C4_2 * x * q7 * h[18] + C4_3 * z * s7 * h[19] +
                  C4_6 * (-2.f * y) * q7 * h[22] + C4_7 * (-6.f * xy) * z * h[23] +
                  C4_8 * (4.f * y) * (yy - 3.f * xx) * h[24];
            dz += C4_1 * y * (3.f * xx - yy) * h[17] + C4_2 * (14.f * xy) * z * h[18] +
                  C4_3 * y * (21.f * zz - 3.f) * h[19] + C4_4 * z * (140.f * zz - 60.f) * h[20] +
                  C4_5 * x * (21.f * zz - 3.f) * h[21] + C4_6 * (xx - yy) * (14.f * z) * h[22] +
                  C4_7 * x * (xx - 3.f * yy) * h[23];
          }
        }
        gu[0] += gv[c] * dx;
        gu[1] += gv[c] * dy;
        gu[2] += gv[c] * dz;
      }
      // u = d / nc: d's share, nc's share through clamp (n >= 1e-12) and the norm
      float g_nc = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) g_nc += -gu[k] * dr.d[k] / (dr.nc * dr.nc);
      const float g_n = dr.n >= F32(1e-12) ? g_nc : 0.f;
      const float g_over_n = dr.n == 0.f ? 0.f : g_n / dr.n;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gm[k] += gu[k] / dr.nc + (dr.n == 0.f ? 0.f : dr.d[k] * g_over_n);
    }
  }

  if (a.d_means) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.d_means[3 * r + k] = gm[k];
  }
  if (a.d_scales) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.d_scales[3 * r + k] = gs[k];
  }
  if (a.d_rots) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.d_rots[4 * r + k] = gq[k];
  }
  if (a.d_tap) {
    a.d_tap[2 * r] = tx;
    a.d_tap[2 * r + 1] = ty;
  }
}

// One thread a row.  The SH rows (48 floats at degree 3) are the bulk of a
// row's bytes; one thread's 4-byte loads and stores land 192 B apart, so
// the block moves its rows' coefficients in (where a colour cotangent
// arrived: nothing else reads them) and their gradients out (zeros without
// a colour cotangent) through shared memory, coalesced (rows padded to an
// odd width: no bank conflicts).
template <int DEG>
__global__ void __launch_bounds__(THREADS) backward_kernel(const BwdArgs a) {
  extern __shared__ float tile[];
  const long long r0 = blockIdx.x * static_cast<long long>(THREADS);
  const long long r = r0 + threadIdx.x;
  const int width = 3 * a.n_coef, ld = width + 1;
  const int rows = static_cast<int>(a.n - r0 < THREADS ? a.n - r0 : THREADS);
  if (a.g_color) {
    const float* src = static_cast<const float*>(a.shs) + r0 * width;
    for (int i = threadIdx.x; i < rows * width; i += THREADS)
      tile[(i / width) * ld + i % width] = src[i];
    __syncthreads();
  }
  if (r < a.n) backward_row<DEG>(a, r, tile + threadIdx.x * ld);
  if (a.d_shs) {
    __syncthreads();
    float* dst = a.d_shs + r0 * width;
    for (int i = threadIdx.x; i < rows * width; i += THREADS)
      dst[i] = a.g_color ? tile[(i / width) * ld + i % width] : 0.f;
  }
}

#undef V_
#undef P_

Params params(int width, int height, int tile_x, int tile_y, float scale_mod, float focal_x,
              float focal_y, float lim_x, float lim_y) {
  Params p;
  p.width = width;
  p.height = height;
  p.tile_x = tile_x;
  p.tile_y = tile_y;
  p.grid_x = (width + tile_x - 1) / tile_x;
  p.grid_y = (height + tile_y - 1) / tile_y;
  p.scale_mod = scale_mod;
  p.focal_x = focal_x;
  p.focal_y = focal_y;
  p.lim_x = lim_x;
  p.lim_y = lim_y;
  return p;
}

template <typename Args>
cudaError_t launch(void (*const kernels[5])(Args), int deg, const Args& a, size_t smem,
                   void* stream) {
  if (a.n == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[deg], cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (a.n + THREADS - 1) / THREADS;
  kernels[deg]<<<static_cast<unsigned>(blocks), THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row strides in elements, unit column strides: means and scales (n, 3),
// rotations (n, 4), opacities and alive one element a row (alive as bytes,
// nonzero = alive), tap (n, 2); shs (n, n_coef, 3) contiguous.
// opac (the opacity-aware radius), alive and tap may be null.  view and
// proj are row-major (4, 4), campos (3,), all on the device.  Outputs are
// contiguous: ndc and pix (n, 2), depth (n,), conic and color (n, 3),
// radii and tiles (n,) int32, rect (n, 4) int32, mask (n,) bytes; ndc_tap
// and pix_tap (n, 2) when tap is given.  focal_x = width / (2 tan_fovx)
// and lim_x = 1.3 tan_fovx, rounded from the doubles.
int screen_space_forward(const void* means, long long ld_means, const void* scales,
                         long long ld_scales, const void* rots, long long ld_rots,
                         const void* shs, int n_coef, const void* opac, long long ld_opac,
                         const void* alive, long long ld_alive, const void* tap,
                         long long ld_tap, const void* view, const void* proj,
                         const void* campos, long long n, int width, int height, int tile_x,
                         int tile_y, int deg, float scale_mod, float focal_x,
                         float focal_y, float lim_x, float lim_y, void* ndc, void* pix, void* depth,
                         void* conic, void* color, void* radii, void* rect, void* tiles,
                         void* mask, void* ndc_tap, void* pix_tap, void* stream) {
  if (n < 0 || deg < 0 || deg > 4 || n_coef < (deg + 1) * (deg + 1) || tile_x < 1 ||
      tile_y < 1 || width < 1 || height < 1 || (tap != nullptr && (!ndc_tap || !pix_tap)))
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.means = means; a.scales = scales; a.rots = rots; a.shs = shs;
  a.opac = opac; a.alive = alive; a.tap = tap;
  a.ld_means = ld_means; a.ld_scales = ld_scales; a.ld_rots = ld_rots;
  a.n_coef = n_coef;
  a.ld_opac = ld_opac; a.ld_alive = ld_alive; a.ld_tap = ld_tap;
  a.view = static_cast<const float*>(view);
  a.proj = static_cast<const float*>(proj);
  a.campos = static_cast<const float*>(campos);
  a.n = n;
  a.pr = params(width, height, tile_x, tile_y, scale_mod, focal_x, focal_y, lim_x, lim_y);
  a.ndc = static_cast<float*>(ndc); a.pix = static_cast<float*>(pix);
  a.depth = static_cast<float*>(depth); a.conic = static_cast<float*>(conic);
  a.color = static_cast<float*>(color);
  a.ndc_tap = static_cast<float*>(ndc_tap); a.pix_tap = static_cast<float*>(pix_tap);
  a.radii = static_cast<int*>(radii); a.rect = static_cast<int*>(rect);
  a.tiles = static_cast<int*>(tiles); a.mask = static_cast<uint8_t*>(mask);
  void (*const kernels[5])(FwdArgs) = {forward_kernel<0>, forward_kernel<1>, forward_kernel<2>,
                                       forward_kernel<3>, forward_kernel<4>};
  return launch(kernels, deg, a, 0, stream);
}

// The forward's inputs (but the opacities, alive and tap: the gradients do
// not read them), the cotangents (each null or with its row stride, unit
// column strides: ndc, pix, ndc_tap and pix_tap (n, 2), depth (n,), conic
// and color (n, 3)) and the gradients, each null or contiguous: means and
// scales (n, 3), rotations (n, 4), shs (n, n_coef, 3), tap (n, 2).  Each
// gradient given is written whole, zeros where no cotangent reaches it.
int screen_space_backward(const void* means, long long ld_means, const void* scales,
                          long long ld_scales, const void* rots, long long ld_rots,
                          const void* shs, int n_coef, const void* view, const void* proj,
                          const void* campos, long long n, int width, int height, int deg,
                          float scale_mod, float focal_x, float focal_y, float lim_x,
                          float lim_y, const void* g_ndc, long long ld_g_ndc,
                          const void* g_pix, long long ld_g_pix, const void* g_depth,
                          long long ld_g_depth, const void* g_conic, long long ld_g_conic,
                          const void* g_color, long long ld_g_color, const void* g_ndc_tap,
                          long long ld_g_ndc_tap, const void* g_pix_tap,
                          long long ld_g_pix_tap, void* d_means, void* d_scales,
                          void* d_rots, void* d_shs, void* d_tap, void* stream) {
  if (n < 0 || deg < 0 || deg > 4 || n_coef < (deg + 1) * (deg + 1) || width < 1 || height < 1)
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.means = means; a.scales = scales; a.rots = rots; a.shs = shs;
  a.ld_means = ld_means; a.ld_scales = ld_scales; a.ld_rots = ld_rots;
  a.view = static_cast<const float*>(view);
  a.proj = static_cast<const float*>(proj);
  a.campos = static_cast<const float*>(campos);
  a.n = n;
  a.n_coef = n_coef;
  a.pr = params(width, height, 1, 1, scale_mod, focal_x, focal_y, lim_x, lim_y);
  a.g_ndc = g_ndc; a.g_pix = g_pix; a.g_depth = g_depth; a.g_conic = g_conic;
  a.g_color = g_color; a.g_ndc_tap = g_ndc_tap; a.g_pix_tap = g_pix_tap;
  a.ld_g_ndc = ld_g_ndc; a.ld_g_pix = ld_g_pix; a.ld_g_depth = ld_g_depth;
  a.ld_g_conic = ld_g_conic; a.ld_g_color = ld_g_color; a.ld_g_ndc_tap = ld_g_ndc_tap;
  a.ld_g_pix_tap = ld_g_pix_tap;
  a.d_means = static_cast<float*>(d_means); a.d_scales = static_cast<float*>(d_scales);
  a.d_rots = static_cast<float*>(d_rots); a.d_shs = static_cast<float*>(d_shs);
  a.d_tap = static_cast<float*>(d_tap);
  const size_t smem = g_color != nullptr ? sizeof(float) * THREADS * (3 * n_coef + 1) : 0;
  void (*const kernels[5])(BwdArgs) = {backward_kernel<0>, backward_kernel<1>,
                                       backward_kernel<2>, backward_kernel<3>,
                                       backward_kernel<4>};
  return launch(kernels, deg, a, smem, stream);
}

}  // extern "C"
