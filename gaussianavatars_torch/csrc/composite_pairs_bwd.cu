// Backward pair compositor for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_bwd_kernel_pairs_v3` and `_bwd_kernel_pairs_v4`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:620, :880; v4 is v3 with
// `gc_vpu=True`), launched there by `bwd_call_pairs`, each with and without
// its `amp` mode. Same function: the gradient of the forward compositor
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
// contributes (the TPU kernel's `g_hi` trim, at slot rather than group
// granularity). The wrapper zero-fills dgrad, so slots no tile walks and
// rows 9..15 stay exact zeros.
//
// Four instantiations, one C entry point each:
//   composite_pairs_bwd         v3, float32 contraction
//   composite_pairs_bwd_amp     v3, `amp`: the contraction operands d_p, w
//                               (left) and the basis and g_c (right) rounded
//                               to bf16, as the TPU kernel's bf16 MXU inputs
//                               (:684-685, :793-798); products and sums float32
//   composite_pairs_bwd_v4      v4 (gc as three broadcast products)
//   composite_pairs_bwd_v4_amp  v4 with `amp`
// On the TPU, v4 moves the k = 3 contraction gc off the matrix unit. A thread
// per pixel has no matrix unit to hand it to: v3 and v4 both compute gc as
// three products and two adds in the same order, so they compile to the same
// instructions and give the same bits.
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
// (`bwd_call_pairs_reference`, with the same `amp` rounding); the sums over
// pixels differ from it only in their order of addition. Tensor-core
// contractions, several pairs per shuffle round and cp.async staging are
// not done here.
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kChunk = 256;  // pairs staged in shared memory at a time

// 1024 threads a block: at most 64 registers a thread.
template <bool kAmp, bool kGcVpu>
__global__ void __launch_bounds__(kMaxWarps * 32) composite_pairs_bwd_kernel(
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

  // Tile origin; pixel coordinates are tile-local, as the TPU kernel's
  // `_pixel_coords(th, tw, 0, 0)` with the means shifted by the origin.
  const float x0 = (float)((tile % ntx) * tw);
  const float y0 = (float)((tile / ntx) * th);
  const long long o = (long long)tile * p + tid;
  const BwdPixel px = bwd_pixel<kAmp>(tid, tw, o, p, acc + (long long)tile * 3 * p, t_final,
                                      stop_in, g_acc_t, g_t);

  // needed = min(count, max(stop) - head + 1), the same for every thread.
  const int needed = min(count, block_max(px.stop, stop_max, lane, warp, nwarps) - head + 1);

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
        float s[kSums];
        const bool contrib = bwd_pair<kAmp, kGcVpu>(&pairs[0][c], kChunk, x0, y0, px,
                                                    base + c + head < px.stop, T, qsum, s);
        warp_partials(s, contrib, &red[j][0][0], kMaxWarps, lane, warp);
      }
      __syncthreads();

      // Level 2: one warp per pair sums the warps' partials, lane 0 writes.
      for (int j = warp; j < kn; j += nwarps) {
        const int c = g + j;
        write_pair_grad(&red[j][0][0], kMaxWarps, lane, nwarps, &pairs[0][c], kChunk, x0, y0,
                        dgrad + (long long)start + base + c, ld);
      }
      __syncthreads();  // `red` is free for the next group
    }
  }
}

template <bool kAmp, bool kGcVpu>
int launch(const float* dataT, long long ld, const int* starts, const int* counts,
           const float* acc, const float* t_final, const int* stop, const float* g_acc_t,
           const float* g_t, int nt, int th, int tw, int ntx, float* dgrad, void* stream) {
  if (nt > 0) {
    composite_pairs_bwd_kernel<kAmp, kGcVpu><<<nt, th * tw, 0, (cudaStream_t)stream>>>(
        dataT, ld, starts, counts, acc, t_final, stop, g_acc_t, g_t, th, tw, ntx, dgrad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches one block of th·tw threads per tile on `stream`
// and returns cudaGetLastError() (0 on success). The caller checks shapes,
// types, contiguity and th·tw <= 1024 with th·tw % 32 == 0, and zero-fills
// dgrad (same shape and row stride `ld` as dataT).
#define CPK_BWD_ENTRY(name, amp, gc_vpu)                                                   \
  extern "C" int name(const float* dataT, long long ld, const int* starts,                \
                      const int* counts, const float* acc, const float* t_final,          \
                      const int* stop, const float* g_acc_t, const float* g_t, int nt,    \
                      int th, int tw, int ntx, float* dgrad, void* stream) {              \
    return launch<amp, gc_vpu>(dataT, ld, starts, counts, acc, t_final, stop, g_acc_t,    \
                               g_t, nt, th, tw, ntx, dgrad, stream);                      \
  }

CPK_BWD_ENTRY(composite_pairs_bwd, false, false)
CPK_BWD_ENTRY(composite_pairs_bwd_amp, true, false)
CPK_BWD_ENTRY(composite_pairs_bwd_v4, false, true)
CPK_BWD_ENTRY(composite_pairs_bwd_v4_amp, true, true)
