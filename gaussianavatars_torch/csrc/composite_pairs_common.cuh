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

// One pair's nine used rows, read once from shared memory (rows `stride`
// floats apart from `col`) and then evaluated at each of a thread's pixels.
struct FwdPair {
  float mx, my, ca, cb, cc, r, g, b, op;
};

__device__ __forceinline__ FwdPair load_pair(const float* col, int stride) {
  return FwdPair{col[0],          col[stride],     col[2 * stride],
                 col[3 * stride], col[4 * stride], col[5 * stride],
                 col[6 * stride], col[7 * stride], col[8 * stride]};
}

// The alpha of pair q at a pixel dx, dy from its mean, with ccdy2 =
// c·dy·dy (shared by the pixels of one row), or 0 where the pair is culled
// (power > 0 or alpha < 1/255).
__device__ __forceinline__ float fwd_alpha(const FwdPair& q, float dx, float dy, float ccdy2) {
  const float power = -0.5f * (q.ca * dx * dx + ccdy2) - q.cb * dx * dy;
  const float v = q.op * expf(power);
  const float alpha = v > kAlphaMax ? kAlphaMax : v;
  return power <= 0.0f && alpha >= kAlphaCutoff ? alpha : 0.0f;
}

// Blends pair q, of alpha `alpha` (fwd_alpha), into a pixel that has not
// stopped (`live`): T and the colour advance unless the pair is culled or
// would take T below 1e-4. Returns whether the pixel stops before the pair
// (then nothing changes). Written with selects, not branches.
__device__ __forceinline__ bool fwd_blend(float alpha, const FwdPair& q, bool live, float& T,
                                          float& cr, float& cg, float& cb) {
  const float test_t = T * (1.0f - alpha);
  const float w = alpha * T;
  const float nr = cr + w * q.r;
  const float ng = cg + w * q.g;
  const float nb = cb + w * q.b;
  const bool use = live && alpha >= kAlphaCutoff;
  const bool keep = use && test_t >= kTEps;
  cr = keep ? nr : cr;
  cg = keep ? ng : cg;
  cb = keep ? nb : cb;
  T = keep ? test_t : T;
  return use && !(test_t >= kTEps);
}

// One pair at one pixel of the forward walk. A pair that is culled changes
// nothing. Returns false, and changes nothing, when the pair would take T
// below 1e-4: the pixel stops before it.
__device__ __forceinline__ bool fwd_pair(const FwdPair& q, float px, float py, float& T,
                                         float& cr, float& cg, float& cb) {
  const float dx = px - q.mx;
  const float dy = py - q.my;
  return !fwd_blend(fwd_alpha(q, dx, dy, q.cc * dy * dy), q, true, T, cr, cg, cb);
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

// ------------------------------------------- the backward's walk schedule
//
// Shared by the backward kernels of every implementation
// (composite_pairs_bwd.cu, composite_pairs_bwd_v2.cu), which differ only in
// how they stage their segment. A block of ceil(P / 128) warps takes one
// tile, kPix pixels a thread (a warp owns kPix rows of 32 consecutive
// pixels). Per pair:
//   level 1  a thread sums the pair's nine values over its pixels in
//            registers; the warp's sums of fields 0..7 go through a
//            transposing butterfly (7 shuffles leave each lane one field
//            summed over 8 lanes, 2 more finish it), field 8 through a plain
//            one: 14 shuffles a pair and warp, skipped when no pixel of the
//            warp contributes; lane l & 3 == 0 stores field l >> 2 into the
//            partials `red`;
//   level 2  once per kGroup pairs, after one barrier, thread j of warp 0
//            adds pair j's partials in warp order and writes its nine rows.
// The partials are double-buffered ([2][kSums][kBwdWarps][kGroup]), so the
// other warps go on with the next group. Every sum has a fixed order that
// never depends on timing: no atomics.

constexpr int kPix = 4;                          // backward pixels a thread
constexpr int kBwdWarps = kMaxWarps / kPix;      // warps of a 1024-pixel tile
constexpr int kField = kBwdWarps * kGroup;       // floats between fields of `red`

// One level of a transposing butterfly over 2·kHalf values: the lanes whose
// bit `4·kHalf` is set keep the upper half and hand the partner the lower,
// the others the reverse, so kHalf shuffles leave each lane kHalf values,
// each summed over the lane and its partner.
template <int kHalf>
__device__ __forceinline__ void transpose_level(float* v, int lane) {
  const bool upper = lane & (4 * kHalf);
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    const float keep = upper ? v[m + kHalf] : v[m];
    const float send = upper ? v[m] : v[m + kHalf];
    v[m] = keep + __shfl_xor_sync(kFull, send, 4 * kHalf);
  }
}

// This thread's sums s (over its pixels) of one pair to the warp's. Fields
// 0..7: a transposing butterfly (offsets 16, 8, 4: 7 shuffles), after which
// lane l holds field l >> 2 summed over the 8 lanes that share l & 3;
// offsets 2 and 1 finish the sum. Field 8: a plain butterfly. Lanes with
// l & 3 == 0 store field l >> 2 at red[field · kField], lane 0 field 8.
__device__ __forceinline__ void warp_fields(const float (&s)[kSums], float* red, int lane) {
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = s[k];
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  v[0] = v[0] + __shfl_xor_sync(kFull, v[0], 2);
  v[0] = v[0] + __shfl_xor_sync(kFull, v[0], 1);
  const float f8 = warp_sum(s[8]);
  if ((lane & 3) == 0) red[(lane >> 2) * kField] = v[0];
  if (lane == 0) red[8 * kField] = f8;
}

// This thread's kPix pixels of the tile: pixel i is row i of the warp's
// kPix rows of 32 pixels. Pixels past the tile take part in nothing (stop
// 0: no slot passes). Returns the largest stop id of the thread's pixels.
template <bool kAmp>
__device__ __forceinline__ int bwd_pixels(BwdPixel (&px)[kPix], int tile, int p, int tw,
                                          int warp, int lane, const float* acc,
                                          const float* t_final, const int* stop_in,
                                          const float* g_acc_t, const float* g_t) {
  int my_stop = 0;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int pix = (warp * kPix + i) * 32 + lane;
    if (pix < p) {
      px[i] = bwd_pixel<kAmp>(pix, tw, (long long)tile * p + pix, p,
                              acc + (long long)tile * 3 * p, t_final, stop_in, g_acc_t, g_t);
    } else {
      px[i] = BwdPixel{};
      px[i].stop = 0;
    }
    my_stop = max(my_stop, px[i].stop);
  }
  return my_stop;
}

// Level 1 for kn consecutive staged pairs: columns c0.. of `pairs` (rows
// kStride floats apart), window-local ids sid0... `rb` is this warp's slice
// of one buffer of the partials, &red[buf][0][warp][0]. The pair loop is
// unrolled twice, so one pair's reduction overlaps the next pair's
// arithmetic.
template <bool kAmp, bool kGcVpu, int kStride>
__device__ __forceinline__ void walk_group(const float* pairs, int c0, int kn, int sid0,
                                           float x0, float y0, const BwdPixel (&px)[kPix],
                                           float (&T)[kPix], float (&qsum)[kPix], float* rb,
                                           int lane) {
#pragma unroll 2
  for (int j = 0; j < kn; ++j) {
    const int sid = sid0 + j;
    float s[kSums];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      float si[kSums];
      any |= bwd_pair<kAmp, kGcVpu>(pairs + c0 + j, kStride, x0, y0, px[i], sid < px[i].stop,
                                    T[i], qsum[i], si);
#pragma unroll
      for (int k = 0; k < kSums; ++k) s[k] = i == 0 ? si[k] : s[k] + si[k];
    }
    if (__any_sync(kFull, any)) {
      warp_fields(s, rb + j, lane);
    } else if (lane < kSums) {
      rb[lane * kField + j] = 0.0f;
    }
  }
}

// Level 2 for pair j of a group (called by thread j of warp 0 after the
// barrier that ends level 1): adds the pair's partials of one buffer of
// `red` (&red[buf][0][0][0]) in warp order and writes its nine rows to dst.
// `col` is the pair's staged column (rows kStride floats apart).
template <int kStride>
__device__ __forceinline__ void group_rows(const float* red, int j, int nwarps,
                                           const float* col, float x0, float y0, float* dst,
                                           long long ld) {
  const float* r = red + j;
  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float a = r[k * kField];
    for (int w = 1; w < nwarps; ++w) a = a + r[k * kField + w * kGroup];
    s[k] = a;
  }
  pair_grad_rows(s, col, kStride, x0, y0, dst, ld);
}

// The zeros of rows 0..8 that a block writes after its walk: its segment's
// slots [from, count) (columns start + slot), and its share of the columns
// past the last segment, [total, ld). The segments tile [0, total) in tile
// order (ops/sort_binning.segment_bounds), so every column is written by
// exactly one block. Written after the walk, they drain while other
// blocks' walks compute.
__device__ __forceinline__ void write_zeros(float* dgrad, long long ld, int start, int from,
                                            int count, const int* starts, const int* counts) {
  const int total = starts[gridDim.x - 1] + counts[gridDim.x - 1];
  for (int i = from + (int)threadIdx.x; i < count; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) dgrad[k * ld + start + i] = 0.0f;
  }
  for (long long c = total + (long long)blockIdx.x * blockDim.x + threadIdx.x; c < ld;
       c += (long long)gridDim.x * blockDim.x) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) dgrad[k * ld + c] = 0.0f;
  }
}

}  // namespace cpk
