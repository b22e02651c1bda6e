// Backward pair compositor for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel_pairs_v3`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:620), launched there by
// `bwd_call_pairs`. Same function: the gradient of the forward compositor
// (composite_pairs_fwd.cu) with respect to each pair's nine used rows of the
// param-major table dataT [16, ld] (mx, my, conic a/b/c, r, g, b, opacity),
// from the cotangents g_acc (pixel-major [NT, P, 3]) and g_t [NT, P].
//
// Each tile replays its transmittance front to back from T = 1, with the
// forward's saved acc, t_final and window-local stop ids. Per pixel:
//   G     = g_t·t_final + Σ_c g_c·acc_c             (constant over the walk)
//   a slot contributes when power <= 0, alpha >= 1/255 and sid < stop,
//   where sid = slot + starts % 128 (the TPU kernel's window-local id);
//   w     = alpha·T_before,  gc = Σ_c rgb_c·g_c,  q = Σ_{s'<=s} w·gc,
//   d_alpha = T_before·gc − (G − q)/(1 − alpha),
//   d_p   = d_alpha·alpha where alpha < 0.99 (the clamp passes no gradient).
// Per pair, over the tile's pixels in tile-local coordinates (x, y):
//   the moments of d_p against {1, x, y, x², xy, y²} and Σ w·g_c.
// From them: d mean2d, d conic (−½sxx, −sxy, −½syy), d rgb and
// d opacity = M1 / max(op, 1e-12), as at composite_pairs.py:802-819.
// The walk covers slots [0, needed) with needed = min(count,
// max(stop) − starts % 128 + 1): past the last pixel's stop nothing
// contributes. The wrapper zero-fills dgrad, so slots no tile walks and
// rows 9..15 stay exact zeros.
//
// What bounds it on the card: arithmetic and block-wide reductions, not
// memory. A pair costs 36 bytes read and 36 written once, but it is
// evaluated at every one of the tile's P pixels (an expf, a division and
// about 48 flops each, nine of them the reduction's adds), and each pixel's
// replay is a sequential chain through T and q. The design:
//   * one block per tile and one thread per pixel (P = th·tw <= 1024, a
//     multiple of 32), as in the forward kernel; each pair belongs to one
//     tile, so its sums are written once, with no atomics;
//   * the segment is staged kChunk pairs at a time in shared memory (one
//     pair's nine rows per thread, coalesced), read by every thread as a
//     broadcast;
//   * a pair's nine sums are reduced in two fixed-order levels: a butterfly
//     of warp shuffles, then one warp per pair over the warps' partials.
//     The order never depends on timing, so the result is deterministic.
//     The second level runs once per kGroup pairs, which keeps it to two
//     barriers per 32 pairs;
//   * a warp in which no pixel contributes to a pair skips its shuffles.
// Built with --fmad=false and `expf` (not `__expf`), so each pixel's values
// are operation for operation those of the plain PyTorch version
// (`bwd_call_pairs_reference`); the sums over pixels differ from it only in
// their order of addition. Several pairs per shuffle round and cp.async
// staging are not done here.
#include <cuda_runtime.h>

namespace {

constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr int kRows = 9;       // used rows of the pair table
constexpr int kChunk = 256;    // pairs staged in shared memory at a time
constexpr int kGroup = 32;     // pairs per second-level reduction round
constexpr int kSums = 9;       // per-pair sums: six moments of d_p, Σ w·g_c
constexpr int kMaxWarps = 32;  // 1024 threads
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void composite_pairs_bwd_kernel(
    const float* __restrict__ dataT, long long ld,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ acc, const float* __restrict__ t_final,
    const int* __restrict__ stop_in, const float* __restrict__ g_acc_t,
    const float* __restrict__ g_t, int th, int tw, int ntx,
    float* __restrict__ dgrad) {
  __shared__ float pairs[kRows][kChunk];
  __shared__ float red[kGroup][kSums][kMaxWarps];
  __shared__ int stop_max[kMaxWarps];

  const int p = th * tw;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = p >> 5;
  const int start = starts[tile];
  const int count = counts[tile];
  const int head = start & 127;  // TPU window offset of this segment

  // Tile origin and tile-local pixel coordinates, as the TPU kernel's
  // `_pixel_coords(th, tw, 0, 0)` with the means shifted by the origin.
  const float x0 = (float)((tile % ntx) * tw);
  const float y0 = (float)((tile / ntx) * th);
  const float x = (float)(tid % tw);
  const float y = (float)(tid / tw);
  const float xx = x * x;
  const float xy = x * y;
  const float yy = y * y;

  const long long o = (long long)tile * p + tid;
  const float* acc_t = acc + (long long)tile * 3 * p;
  const float g0 = g_acc_t[3 * o];
  const float g1 = g_acc_t[3 * o + 1];
  const float g2 = g_acc_t[3 * o + 2];
  const float big_g = g_t[o] * t_final[o] + g0 * acc_t[tid] + g1 * acc_t[p + tid]
                      + g2 * acc_t[2 * p + tid];
  const int stop = stop_in[o];

  // needed = min(count, max(stop) - head + 1), the same for every thread.
  int m = stop;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) stop_max[warp] = m;
  __syncthreads();
  int smax = stop_max[0];
  for (int w = 1; w < nwarps; ++w) smax = max(smax, stop_max[w]);
  const int needed = min(count, smax - head + 1);

  float T = 1.0f;
  float qsum = 0.0f;
  for (int base = 0; base < needed; base += kChunk) {
    const int n = min(kChunk, needed - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < n; i += p) {
      const float* src = dataT + (long long)start + base + i;
#pragma unroll
      for (int k = 0; k < kRows; ++k) pairs[k][i] = src[k * ld];
    }
    __syncthreads();

    for (int g = 0; g < n; g += kGroup) {
      const int kn = min(kGroup, n - g);
      // Level 1: each pixel's values for kn pairs, summed over each warp.
      for (int j = 0; j < kn; ++j) {
        const int c = g + j;
        const float mxl = pairs[0][c] - x0;
        const float myl = pairs[1][c] - y0;
        const float ca = pairs[2][c];
        const float cb = pairs[3][c];
        const float cc = pairs[4][c];
        const float op = pairs[8][c];
        const float dx = x - mxl;
        const float dy = y - myl;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        const float v = op * expf(power);
        const float alpha = v > kAlphaMax ? kAlphaMax : v;
        const int sid = base + c + head;
        const bool contrib = power <= 0.0f && alpha >= kAlphaCutoff && sid < stop;
        float s[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) s[k] = 0.0f;
        if (contrib) {
          const float gc = pairs[5][c] * g0 + pairs[6][c] * g1 + pairs[7][c] * g2;
          const float t_before = T;
          T = T * (1.0f - alpha);
          const float w = alpha * t_before;
          qsum = qsum + w * gc;
          const float gs = big_g - qsum;
          const float d_alpha = t_before * gc - (1.0f / (1.0f - alpha)) * gs;
          const float d_p = alpha < kAlphaMax ? d_alpha * alpha : 0.0f;
          s[0] = d_p;
          s[1] = d_p * x;
          s[2] = d_p * y;
          s[3] = d_p * xx;
          s[4] = d_p * xy;
          s[5] = d_p * yy;
          s[6] = w * g0;
          s[7] = w * g1;
          s[8] = w * g2;
        }
        if (__any_sync(kFull, contrib)) {
#pragma unroll
          for (int k = 0; k < kSums; ++k) s[k] = warp_sum(s[k]);
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < kSums; ++k) red[j][k][warp] = s[k];
        }
      }
      __syncthreads();

      // Level 2: one warp per pair sums the warps' partials, lane 0 writes.
      for (int j = warp; j < kn; j += nwarps) {
        float s[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) s[k] = warp_sum(lane < nwarps ? red[j][k][lane] : 0.0f);
        if (lane == 0) {
          const int c = g + j;
          const float mxl = pairs[0][c] - x0;
          const float myl = pairs[1][c] - y0;
          const float ca = pairs[2][c];
          const float cb = pairs[3][c];
          const float cc = pairs[4][c];
          const float op = pairs[8][c];
          const float m1 = s[0], mx = s[1], my = s[2];
          const float mxx = s[3], mxy = s[4], myy = s[5];
          const float s1 = mx - mxl * m1;
          const float s2 = my - myl * m1;
          const float sxx = mxx - 2.0f * mxl * mx + mxl * mxl * m1;
          const float sxy = mxy - mxl * my - myl * mx + mxl * myl * m1;
          const float syy = myy - 2.0f * myl * my + myl * myl * m1;
          float* dst = dgrad + (long long)start + base + c;
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
      }
      __syncthreads();  // `red` is free for the next group
    }
  }
}

}  // namespace

// Launches one block of th·tw threads per tile on `stream` and returns
// cudaGetLastError() (0 on success). The caller checks shapes, types,
// contiguity and th·tw <= 1024 with th·tw % 32 == 0, and zero-fills dgrad
// (same shape and row stride `ld` as dataT).
extern "C" int composite_pairs_bwd(
    const float* dataT, long long ld, const int* starts, const int* counts,
    const float* acc, const float* t_final, const int* stop,
    const float* g_acc_t, const float* g_t,
    int nt, int th, int tw, int ntx, float* dgrad, void* stream) {
  if (nt > 0) {
    composite_pairs_bwd_kernel<<<nt, th * tw, 0, (cudaStream_t)stream>>>(
        dataT, ld, starts, counts, acc, t_final, stop, g_acc_t, g_t, th, tw, ntx, dgrad);
  }
  return (int)cudaGetLastError();
}
