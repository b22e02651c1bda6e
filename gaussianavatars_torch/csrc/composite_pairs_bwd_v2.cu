// Backward pair compositor on the TPU v2 schedule's window, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel_pairs_v2`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:407), with and without
// its `amp` mode (:475, :556), which runs when the JAX module's switch
// `_BWD_IMPL` is flipped to it (only scripts/kernel_ab.py does). It computes
// the function of composite_pairs_bwd.cu (the v3 kernel's port: the
// gradient of the forward compositor with respect to each pair's nine used
// rows) with the same per-pixel replay (`bwd_pixel`, `bwd_pair`) and the
// same walk schedule (`walk_group`, `group_rows`, `write_zeros`, all in
// composite_pairs_common.cuh): 4 pixels a thread, a pair's nine values
// summed over a thread's pixels in registers, the transposing butterfly
// across the warp, warp 0 adding the warps' partials in order once per 32
// pairs, no atomics.
//
// What is v2's is the window:
//   * the walk goes over the segment's 128-aligned window in 512-pair chunks
//     (TPU `_CHUNK`) aligned to the window base start & ~127, each staged
//     synchronously into shared memory before it is walked;
//   * the chunks run up to needed = min(head + count, max(stop) + 1) in
//     window slots (:478-479).
// What is not carried over is the TPU's walk of every 64-pair group of each
// chunk (:588), a vector-unit schedule: a slot outside the segment, or past
// every pixel's stop, contributes exact zeros, so the kernel walks only the
// live slots [max(head, base), min(needed, base + 512)) of each chunk, with
// a block-uniform bound. Nor is the TPU's whole-chunk out-DMA and its
// read-modify-write of the 128-lane block that adjacent tiles share
// (:589-602): the window's head slots belong to the previous tile's
// segment, and only the block of the owning segment writes a column. The
// kernel writes rows 0..8 of every column of dgrad once: the walked slots'
// gradients, then zeros for the rest of its segment and for its share of
// the columns past the last segment, so the wrapper fills only rows 9..15
// of a 16-row table.
//
// Two instantiations, one C entry point each: composite_pairs_bwd_v2
// (float32 contraction) and composite_pairs_bwd_v2_amp (the contraction
// operands d_p, w, the basis and g_c rounded to bf16, products and sums in
// float32, as the TPU kernel's bf16 MXU inputs).
//
// What bounds it on the card: what bounds composite_pairs_bwd.cu, the
// per-pixel replay (an expf and a division a pair and pixel, a dependent
// chain through T and q) and the wrapper's output (nine rows of every slot,
// ~60 MB at the benchmark frame). The 512-pair chunk takes 18 KB of shared
// memory, the double-buffered partials another 18 KB: 36.9 KB of static
// shared memory a block, so two blocks of 8 warps share an SM, as in
// composite_pairs_bwd.cu. On an H100 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py, PERF.md) a launch at the benchmark frame takes ~0.08 ms,
// as composite_pairs_bwd.cu's, where one thread a pixel walking every slot
// of its chunk took ~0.90. Built with --fmad=false and `expf`, so each
// pixel's values equal the plain PyTorch version's; the sums differ from
// it only in their order of addition.
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kChunk = 512;  // TPU `_CHUNK`

template <bool kAmp>
__global__ void __launch_bounds__(kBwdWarps * 32, 2) composite_pairs_bwd_v2_kernel(
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
  const int head = start & 127;          // window slots before the segment
  const int start_dn = start - head;     // 128-aligned window base
  const int count_eff = head + count;    // window slots up to the segment's end

  const float x0 = (float)((tile % ntx) * tw);
  const float y0 = (float)((tile / ntx) * th);
  BwdPixel px[kPix];
  const int my_stop = bwd_pixels<kAmp>(px, tile, p, tw, warp, lane, acc, t_final, stop_in,
                                       g_acc_t, g_t);

  // needed = min(count_eff, max(stop) + 1) in window slots, block-uniform.
  const int needed = min(count_eff, block_max(my_stop, stop_max, lane, warp, nwarps) + 1);

  float T[kPix], qsum[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    T[i] = 1.0f;
    qsum[i] = 0.0f;
  }
  int round = 0;
  for (int base = 0; base < needed; base += kChunk) {
    // The chunk's live slots, chunk-local: [lo, hi).
    const int lo = max(head, base) - base;
    const int hi = min(needed, base + kChunk) - base;
    if (lo >= hi) continue;
    __syncthreads();  // the previous chunk is no longer read
    for (int i = lo + tid; i < hi; i += blockDim.x) {
      const float* src = dataT + (long long)start_dn + base + i;
#pragma unroll
      for (int k = 0; k < kRows; ++k) pairs[k][i] = src[k * ld];
    }
    __syncthreads();

    for (int g = lo; g < hi; g += kGroup, ++round) {
      const int kn = min(kGroup, hi - g);
      walk_group<kAmp, false, kChunk>(&pairs[0][0], g, kn, base + g, x0, y0, px, T, qsum,
                                      &red[round & 1][0][warp][0], lane);
      __syncthreads();
      if (tid < kn) {
        group_rows<kChunk>(&red[round & 1][0][0][0], tid, nwarps, &pairs[0][g + tid], x0, y0,
                           dgrad + (long long)start_dn + base + g + tid, ld);
      }
    }
  }
  write_zeros(dgrad, ld, start, max(0, needed - head), count, starts, counts);
}

template <bool kAmp>
int launch(const float* dataT, long long ld, const int* starts, const int* counts,
           const float* acc, const float* t_final, const int* stop, const float* g_acc_t,
           const float* g_t, int nt, int th, int tw, int ntx, float* dgrad, void* stream) {
  const int warps = (th * tw + 32 * kPix - 1) / (32 * kPix);
  if (nt > 0) {
    composite_pairs_bwd_v2_kernel<kAmp><<<nt, warps * 32, 0, (cudaStream_t)stream>>>(
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
extern "C" int composite_pairs_bwd_v2(
    const float* dataT, long long ld, const int* starts, const int* counts,
    const float* acc, const float* t_final, const int* stop, const float* g_acc_t,
    const float* g_t, int nt, int th, int tw, int ntx, float* dgrad, void* stream) {
  return launch<false>(dataT, ld, starts, counts, acc, t_final, stop, g_acc_t, g_t, nt, th, tw,
                       ntx, dgrad, stream);
}

extern "C" int composite_pairs_bwd_v2_amp(
    const float* dataT, long long ld, const int* starts, const int* counts,
    const float* acc, const float* t_final, const int* stop, const float* g_acc_t,
    const float* g_t, int nt, int th, int tw, int ntx, float* dgrad, void* stream) {
  return launch<true>(dataT, ld, starts, counts, acc, t_final, stop, g_acc_t, g_t, nt, th, tw,
                      ntx, dgrad, stream);
}
