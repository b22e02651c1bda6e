// Shared by the pair-compositor kernels (composite_pairs_fwd.cu,
// composite_pairs_fwd_v2.cu, composite_pairs_bwd.cu, composite_pairs_bwd_v2.cu):
// the compositing thresholds, the per-pixel arithmetic of one pair, and the
// backward's fixed-order reductions over a tile's pixels. Everything here is
// inlined into each kernel, so the kernels of one function differ only in
// their schedule. The build's library digest covers this header.
//
// The arithmetic is written operation for operation as the plain PyTorch
// versions in ops/composite_pairs.py do it (the sources are built with
// --fmad=false and `expf`), so a kernel's per-pixel values equal the plain
// version's bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cpk {

constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kStopNever = 0x3FFFFFFF;
constexpr int kRows = 9;       // used rows of the pair table
constexpr int kSums = 9;       // backward per-pair sums: six moments of d_p, Σ w·g_c
constexpr int kGroup = 32;     // pairs per backward second-level reduction round
constexpr int kMaxWarps = 32;  // 1024 threads
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Round to the nearest bfloat16 and back: the contraction operands of the
// backward's `amp` mode (the TPU kernel's bf16 MXU inputs). A product of two
// such values is exact in float32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The block-wide max of one int per thread; every thread gets it. `scratch`
// holds kMaxWarps ints of shared memory.
__device__ __forceinline__ int block_max(int v, int* scratch, int lane, int warp, int nwarps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int m = scratch[0];
  for (int w = 1; w < nwarps; ++w) m = max(m, scratch[w]);
  return m;
}

// ---------------------------------------------------------------- forward

// One pair at one pixel of the forward walk. `col` points at the pair's
// row 0 in shared memory, its rows `stride` floats apart. A pair that is
// culled (power > 0 or alpha < 1/255) changes nothing. Returns false, and
// changes nothing, when the pair would take T below 1e-4: the pixel stops
// before it.
__device__ __forceinline__ bool fwd_pair(const float* col, int stride, float px, float py,
                                         float& T, float& cr, float& cg, float& cb) {
  const float dx = px - col[0];
  const float dy = py - col[stride];
  const float power = -0.5f * (col[2 * stride] * dx * dx + col[4 * stride] * dy * dy)
                      - col[3 * stride] * dx * dy;
  const float v = col[8 * stride] * expf(power);
  const float alpha = v > kAlphaMax ? kAlphaMax : v;
  if (!(power <= 0.0f) || !(alpha >= kAlphaCutoff)) return true;
  const float test_t = T * (1.0f - alpha);
  if (!(test_t >= kTEps)) return false;
  const float w = alpha * T;
  cr = cr + w * col[5 * stride];
  cg = cg + w * col[6 * stride];
  cb = cb + w * col[7 * stride];
  T = test_t;
  return true;
}

// --------------------------------------------------------------- backward

// A pixel's constants for the backward replay, in tile-local coordinates.
struct BwdPixel {
  float x, y;          // tile-local pixel coordinates
  float g0, g1, g2;    // cotangent of acc, float32 (for gc)
  float big_g;         // G = g_t·t_final + Σ_c g_c·acc_c
  int stop;            // the forward's window-local stop id
  // The contraction's right operand: the moment basis {x, y, x², xy, y²}
  // and the three g_c, rounded to bf16 under `amp`, float32 otherwise.
  float bx, by, bxx, bxy, byy, bg0, bg1, bg2;
};

template <bool kAmp>
__device__ __forceinline__ BwdPixel bwd_pixel(int tid, int tw, long long o, int p,
                                              const float* acc_t, const float* t_final,
                                              const int* stop_in, const float* g_acc_t,
                                              const float* g_t) {
  BwdPixel px;
  px.x = (float)(tid % tw);
  px.y = (float)(tid / tw);
  px.g0 = g_acc_t[3 * o];
  px.g1 = g_acc_t[3 * o + 1];
  px.g2 = g_acc_t[3 * o + 2];
  px.big_g = g_t[o] * t_final[o] + px.g0 * acc_t[tid] + px.g1 * acc_t[p + tid]
             + px.g2 * acc_t[2 * p + tid];
  px.stop = stop_in[o];
  const float xx = px.x * px.x, xy = px.x * px.y, yy = px.y * px.y;
  if (kAmp) {
    // x and y are small integers, exact in bf16; x² and xy above 256 are not.
    px.bx = bf16_round(px.x);
    px.by = bf16_round(px.y);
    px.bxx = bf16_round(xx);
    px.bxy = bf16_round(xy);
    px.byy = bf16_round(yy);
    px.bg0 = bf16_round(px.g0);
    px.bg1 = bf16_round(px.g1);
    px.bg2 = bf16_round(px.g2);
  } else {
    px.bx = px.x;
    px.by = px.y;
    px.bxx = xx;
    px.bxy = xy;
    px.byy = yy;
    px.bg0 = px.g0;
    px.bg1 = px.g1;
    px.bg2 = px.g2;
  }
  return px;
}

// One pair at one pixel of the backward replay: advances T and the prefix
// q = Σ w·gc and fills the pixel's nine summands `s` (zeros when the pair
// does not contribute). `gate` is the schedule's own test of the slot (sid <
// stop, and for a walk over whole chunks the slot's liveness). Returns
// whether the pair contributes.
//   kAmp:   d_p and w are rounded to bf16 before the products with the
//           (already rounded) basis and g_c; products and sums stay float32.
//   kGcVpu: gc as the TPU v4 kernel forms it, (r·g0 + g·g1) + b·g2, three
//           broadcast products (composite_pairs.py:760-764); otherwise the
//           sum of the TPU v3 kernel's k = 3 contraction in the plain
//           version's order, r·g0 + g·g1 + b·g2. With one thread per pixel
//           both are the same three products and two adds.
template <bool kAmp, bool kGcVpu>
__device__ __forceinline__ bool bwd_pair(const float* col, int stride, float x0, float y0,
                                         const BwdPixel& px, bool gate, float& T, float& qsum,
                                         float (&s)[kSums]) {
  const float mxl = col[0] - x0;
  const float myl = col[stride] - y0;
  const float ca = col[2 * stride];
  const float cb = col[3 * stride];
  const float cc = col[4 * stride];
  const float op = col[8 * stride];
  const float dx = px.x - mxl;
  const float dy = px.y - myl;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  const float v = op * expf(power);
  const float alpha = v > kAlphaMax ? kAlphaMax : v;
  const bool contrib = power <= 0.0f && alpha >= kAlphaCutoff && gate;
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = 0.0f;
  if (contrib) {
    const float r = col[5 * stride], g = col[6 * stride], b = col[7 * stride];
    const float gc = kGcVpu ? (r * px.g0 + g * px.g1) + b * px.g2
                            : r * px.g0 + g * px.g1 + b * px.g2;
    const float t_before = T;
    T = T * (1.0f - alpha);
    const float w = alpha * t_before;
    qsum = qsum + w * gc;
    const float gs = px.big_g - qsum;
    const float d_alpha = t_before * gc - (1.0f / (1.0f - alpha)) * gs;
    const float d_p = alpha < kAlphaMax ? d_alpha * alpha : 0.0f;
    if (kAmp) {
      const float dpb = bf16_round(d_p);
      const float wb = bf16_round(w);
      s[0] = dpb;
      s[1] = dpb * px.bx;
      s[2] = dpb * px.by;
      s[3] = dpb * px.bxx;
      s[4] = dpb * px.bxy;
      s[5] = dpb * px.byy;
      s[6] = wb * px.bg0;
      s[7] = wb * px.bg1;
      s[8] = wb * px.bg2;
    } else {
      s[0] = d_p;
      s[1] = d_p * px.bx;
      s[2] = d_p * px.by;
      s[3] = d_p * px.bxx;
      s[4] = d_p * px.bxy;
      s[5] = d_p * px.byy;
      s[6] = w * px.bg0;
      s[7] = w * px.bg1;
      s[8] = w * px.bg2;
    }
  }
  return contrib;
}

// Level 1 of a pair's reduction: the warp's sums of `s` (a butterfly of
// shuffles, skipped when no pixel of the warp contributes), stored by lane 0
// at red[k * red_stride + warp].
__device__ __forceinline__ void warp_partials(float (&s)[kSums], bool contrib, float* red,
                                              int red_stride, int lane, int warp) {
  if (__any_sync(kFull, contrib)) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = warp_sum(s[k]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) red[k * red_stride + warp] = s[k];
  }
}

// A pair's nine gradient rows from its nine sums `s` over the tile's pixels,
// written to dst (rows `ld` floats apart), as at composite_pairs.py:802-819.
__device__ __forceinline__ void pair_grad_rows(const float (&s)[kSums], const float* col,
                                               int stride, float x0, float y0, float* dst,
                                               long long ld) {
  const float mxl = col[0] - x0;
  const float myl = col[stride] - y0;
  const float ca = col[2 * stride];
  const float cb = col[3 * stride];
  const float cc = col[4 * stride];
  const float op = col[8 * stride];
  const float m1 = s[0], mx = s[1], my = s[2];
  const float mxx = s[3], mxy = s[4], myy = s[5];
  const float s1 = mx - mxl * m1;
  const float s2 = my - myl * m1;
  const float sxx = mxx - 2.0f * mxl * mx + mxl * mxl * m1;
  const float sxy = mxy - mxl * my - myl * mx + mxl * myl * m1;
  const float syy = myy - 2.0f * myl * my + myl * myl * m1;
  dst[0] = ca * s1 + cb * s2;
  dst[ld] = cc * s2 + cb * s1;
  dst[2 * ld] = -0.5f * sxx;
  dst[3 * ld] = -sxy;
  dst[4 * ld] = -0.5f * syy;
  dst[5 * ld] = s[6];
  dst[6 * ld] = s[7];
  dst[7 * ld] = s[8];
  dst[8 * ld] = m1 / fmaxf(op, 1e-12f);
}

// Level 2, for one warp: sums the nwarps partials of one pair (stored as
// warp_partials left them) in a fixed order; lane 0 then writes the pair's
// nine gradient rows.
__device__ __forceinline__ void write_pair_grad(const float* red, int red_stride, int lane,
                                                int nwarps, const float* col, int stride,
                                                float x0, float y0, float* dst, long long ld) {
  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = warp_sum(lane < nwarps ? red[k * red_stride + lane] : 0.0f);
  if (lane == 0) pair_grad_rows(s, col, stride, x0, y0, dst, ld);
}

}  // namespace cpk
