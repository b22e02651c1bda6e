// Backward pair compositor for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_bwd_kernel_pairs_v3` and `_bwd_kernel_pairs_v4`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:620, :880; v4 is v3 with
// `gc_vpu=True`), launched there by `bwd_call_pairs`, each with and without
// its `amp` mode. Same function: the gradient of the forward compositor
// (composite_pairs_fwd.cu) with respect to each pair's nine used rows of the
// param-major table dataT [9 or 16, ld] (mx, my, conic a/b/c, r, g, b,
// opacity), from the cotangents g_acc (pixel-major [NT, P, 3]) and g_t
// [NT, P].
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
// granularity). The kernel writes rows 0..8 of every column of dgrad [9 or
// 16, ld] once: the walked slots' gradients, and zeros for the rest of its
// segment and for its share of the columns past the last segment. That
// takes segments that tile [0, total) in tile order, as
// ops/sort_binning.segment_bounds makes them (total = starts[NT-1] +
// counts[NT-1]); the wrapper zero-fills only rows 9..15 of a 16-row table.
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
// has no matrix unit to hand it to: v3 and v4 both compute gc as three
// products and two adds in the same order, so they compile to the same
// instructions and give the same bits.
//
// What bounds it on the card. A pair costs 36 bytes read and 36 written, but
// it is evaluated at every one of the tile's P pixels (an expf, a division
// and about 40 flops), and each pixel's replay is a sequential chain through
// T and q: operations, not bytes, for the kernel's own work; the wrapper's
// output (nine rows of every slot of the expansion, ~60 MB at the benchmark
// frame) makes the wrapper's bound bytes. The work that is not the
// per-pixel arithmetic is the reduction of each pair's nine values over the
// P pixels: with one thread a pixel and a butterfly per sum, ~1,500 warp
// shuffles per pair and tile, more issue slots than the arithmetic. This
// schedule puts pixels inside a thread (its pieces are in
// composite_pairs_common.cuh, shared with the v2 kernel,
// composite_pairs_bwd_v2.cu):
//   * one block per tile, kPix pixels per thread (a warp owns kPix rows of
//     32 consecutive pixels), so a pair's nine values are first summed over
//     a thread's pixels in registers, and the pair's nine columns are read
//     from shared memory once per thread rather than once per pixel;
//   * a warp's partials of fields 0..7 are reduced by a transposing
//     butterfly (7 shuffles leave each lane one field summed over 8 lanes,
//     2 more finish it), field 8 by a plain one: 14 shuffles per pair and
//     warp instead of 45; skipped when no pixel of the warp contributes;
//   * lane l of the warp stores field l / 4's warp sum to shared memory;
//     once per kGroup pairs, after one barrier, thread j of warp 0 adds pair
//     j's nwarps partials of each field in warp order and writes its nine
//     rows (consecutive pairs' rows are consecutive words). The partials are
//     double-buffered, so the other warps go on with the next group;
//   * the pair loop is unrolled twice, so one pair's reduction overlaps the
//     next pair's arithmetic;
//   * the segment is staged kChunk pairs at a time in shared memory;
//   * the kernel writes the output's zeros itself, after its walk, so they
//     drain while other blocks compute, instead of a separate fill before
//     the launch.
// On an H100 (NVIDIA H100 80GB HBM3, 700 W) the benchmark frame's float32
// backward takes ~0.08 ms, wrapper included (chip_smoke.py phase 3). Two
// pixels a thread, eight, and three blocks an SM were slower or spilled;
// the tensor-core contraction (d_p and w through shared memory into
// `mma.sync`) was 1.7x slower in float32 (3xTF32) and 5-17 % faster in
// bf16 under `amp`, which does not pay for a second schedule (PERF.md).
// Every sum has a fixed order (a thread's pixels in order, the butterfly,
// the warps in order) that never depends on timing: no atomics, and each
// pair is written once, by the block of its tile. Built with --fmad=false
// and `expf` (not `__expf`), so each pixel's values are operation for
// operation those of the plain PyTorch version (`bwd_call_pairs_reference`,
// with the same `amp` rounding); the sums over pixels differ from it only
// in their order of addition.
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kChunk = 256;  // pairs staged at a time

template <bool kAmp, bool kGcVpu>
__global__ void __launch_bounds__(kBwdWarps * 32, 2) composite_pairs_bwd_kernel(
    const float* __restrict__ dataT, long long ld,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ acc, const float* __restrict__ t_final,
    const int* __restrict__ stop_in, const float* __restrict__ g_acc_t,
    const float* __restrict__ g_t, int th, int tw, int ntx,
    float* __restrict__ dgrad) {
  __shared__ float pairs[kRows][kChunk];
  // Each warp's sums, [buffer][field][warp][pair of the group].
  __shared__ float red[2][kSums][kBwdWarps][kGroup];
  __shared__ int stop_max[kBwdWarps];

  const int p = th * tw;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int start = starts[tile];
  const int count = counts[tile];
  const int head = start & 127;  // TPU window offset of this segment

  // Tile origin; pixel coordinates are tile-local, as the TPU kernel's
  // `_pixel_coords(th, tw, 0, 0)` with the means shifted by the origin.
  const float x0 = (float)((tile % ntx) * tw);
  const float y0 = (float)((tile / ntx) * th);
  BwdPixel px[kPix];
  const int my_stop = bwd_pixels<kAmp>(px, tile, p, tw, warp, lane, acc, t_final, stop_in,
                                       g_acc_t, g_t);

  // needed = min(count, max(stop) - head + 1), the same for every thread.
  const int needed =
      max(0, min(count, block_max(my_stop, stop_max, lane, warp, nwarps) - head + 1));

  float T[kPix], qsum[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    T[i] = 1.0f;
    qsum[i] = 0.0f;
  }
  int round = 0;
  for (int base = 0; base < needed; base += kChunk) {
    const int n = min(kChunk, needed - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < n; i += blockDim.x) {
      const float* src = dataT + (long long)start + base + i;
#pragma unroll
      for (int k = 0; k < kRows; ++k) pairs[k][i] = src[k * ld];
    }
    __syncthreads();

    for (int g = 0; g < n; g += kGroup, ++round) {
      const int kn = min(kGroup, n - g);
      walk_group<kAmp, kGcVpu, kChunk>(&pairs[0][0], g, kn, base + g + head, x0, y0, px, T,
                                       qsum, &red[round & 1][0][warp][0], lane);
      __syncthreads();
      if (tid < kn) {
        group_rows<kChunk>(&red[round & 1][0][0][0], tid, nwarps, &pairs[0][g + tid], x0, y0,
                           dgrad + (long long)start + base + g + tid, ld);
      }
    }
  }
  write_zeros(dgrad, ld, start, needed, count, starts, counts);
}

template <bool kAmp, bool kGcVpu>
int launch(const float* dataT, long long ld, const int* starts, const int* counts,
           const float* acc, const float* t_final, const int* stop, const float* g_acc_t,
           const float* g_t, int nt, int th, int tw, int ntx, float* dgrad, void* stream) {
  const int warps = (th * tw + 32 * kPix - 1) / (32 * kPix);
  if (nt > 0) {
    composite_pairs_bwd_kernel<kAmp, kGcVpu><<<nt, warps * 32, 0, (cudaStream_t)stream>>>(
        dataT, ld, starts, counts, acc, t_final, stop, g_acc_t, g_t, th, tw, ntx, dgrad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches one block of ceil(th·tw / 128) warps per tile on
// `stream` and returns cudaGetLastError() (0 on success). The caller checks
// shapes, types, contiguity and th·tw <= 1024 with th·tw % 32 == 0; dgrad
// has dataT's shape and row stride `ld` (its column count), and the kernel
// writes rows 0..8 of all of it.
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
