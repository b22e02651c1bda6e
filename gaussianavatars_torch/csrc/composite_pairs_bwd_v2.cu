// Backward pair compositor on the TPU v2 schedule, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel_pairs_v2`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:407), with and without
// its `amp` mode (:475, :556), which runs when the JAX module's switch
// `_BWD_IMPL` is flipped to it (only scripts/kernel_ab.py does). It computes
// the function of composite_pairs_bwd.cu (the v3 kernel's port: the
// gradient of the forward compositor with respect to each pair's nine used
// rows) with the same per-pixel replay and the same fixed-order, atomic-free
// per-pair sums (composite_pairs_common.cuh). Only the schedule differs, and
// it is v2's, translated to one block per tile and one thread per pixel:
//   * the walk goes over the segment's 128-aligned window in 512-pair chunks
//     (TPU `_CHUNK`) aligned to the window, each staged synchronously into
//     shared memory before it is walked;
//   * the chunks run up to needed = min(head + count, max(stop) + 1) in
//     window slots (:478-479), and every 64-pair group of each such chunk is
//     walked (:588): there is no `g_hi` trim of the groups past `needed`
//     (v3, :829-837). Slots outside the segment, and slots past a pixel's
//     stop, are masked per slot;
//   * the sums are reduced, as in the v3 port, 32 pairs per round.
// Two parts of the TPU kernel are not carried over: the out-DMA of the whole
// chunk and the read-modify-write of the 128-lane block that adjacent tiles
// share (:589-602). They exist because a TPU DMA is 128-lane aligned and its
// grid runs tiles in order. Here blocks run concurrently, and a whole-chunk
// write would race with the next tile's block: each block writes only the
// slots of its own segment that it walks, and the wrapper's zero fill gives
// every other slot (and rows 9..15) exact zeros.
//
// Two instantiations, one C entry point each: composite_pairs_bwd_v2
// (float32 contraction) and composite_pairs_bwd_v2_amp (the contraction
// operands d_p, w, the basis and g_c rounded to bf16, products and sums in
// float32, as the TPU kernel's bf16 MXU inputs).
//
// What bounds it on the card: arithmetic and block-wide reductions, as for
// composite_pairs_bwd.cu. Against that kernel the v2 schedule walks the
// masked slots up to each chunk's end (their warps skip the shuffles, but
// every such slot still costs a second-level round) and stages 512 pairs at
// once, which needs 55 KB of shared memory a block: dynamic shared memory,
// opted in above the 48 KB default. Built with --fmad=false and `expf`, so
// each pixel's values equal the plain PyTorch version's; the sums differ
// from it only in their order of addition.
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kChunk = 512;  // TPU `_CHUNK`
// Dynamic shared memory at the largest block: the staged chunk [kRows][kChunk]
// and the partial sums [kGroup][kSums][kMaxWarps].
constexpr int kSmemBytes = (kRows * kChunk + kGroup * kSums * kMaxWarps) * (int)sizeof(float);

// 1024 threads a block: at most 64 registers a thread.
template <bool kAmp>
__global__ void __launch_bounds__(kMaxWarps * 32) composite_pairs_bwd_v2_kernel(
    const float* __restrict__ dataT, long long ld,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ acc, const float* __restrict__ t_final,
    const int* __restrict__ stop_in, const float* __restrict__ g_acc_t,
    const float* __restrict__ g_t, int th, int tw, int ntx,
    float* __restrict__ dgrad) {
  extern __shared__ float smem[];
  float* pairs = smem;                    // [kRows][kChunk]
  float* red = smem + kRows * kChunk;     // [kGroup][kSums][kMaxWarps]
  __shared__ int stop_max[kMaxWarps];

  const int p = th * tw;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = p >> 5;
  const int start = starts[tile];
  const int head = start & 127;               // window slots before the segment
  const int start_dn = start - head;          // 128-aligned window base
  const int count_eff = head + counts[tile];  // window slots up to the segment's end

  const float x0 = (float)((tile % ntx) * tw);
  const float y0 = (float)((tile / ntx) * th);
  const long long o = (long long)tile * p + tid;
  const BwdPixel px = bwd_pixel<kAmp>(tid, tw, o, p, acc + (long long)tile * 3 * p, t_final,
                                      stop_in, g_acc_t, g_t);

  // needed = min(count_eff, max(stop) + 1) in window slots.
  const int needed = min(count_eff, block_max(px.stop, stop_max, lane, warp, nwarps) + 1);
  const int n_chunks = (needed + kChunk - 1) / kChunk;

  float T = 1.0f;
  float qsum = 0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    const int base = k * kChunk;
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < kChunk; i += p) {
      // Masked slots are staged as zeros (opacity 0: they never contribute).
      const int sid = base + i;
      const bool live = sid >= head && sid < count_eff;
      const float* src = dataT + (long long)start_dn + sid;
#pragma unroll
      for (int r = 0; r < kRows; ++r) pairs[r * kChunk + i] = live ? src[r * ld] : 0.0f;
    }
    __syncthreads();

    for (int g = 0; g < kChunk; g += kGroup) {
      // Level 1: each pixel's values for kGroup pairs, summed over each warp.
      for (int j = 0; j < kGroup; ++j) {
        const int sid = base + g + j;
        const bool live = sid >= head && sid < count_eff;
        float s[kSums];
        const bool contrib = bwd_pair<kAmp, false>(pairs + g + j, kChunk, x0, y0, px,
                                                   live && sid < px.stop, T, qsum, s);
        warp_partials(s, contrib, red + j * kSums * kMaxWarps, kMaxWarps, lane, warp);
      }
      __syncthreads();

      // Level 2: one warp per pair sums the warps' partials; lane 0 writes
      // the pairs of this tile's segment.
      for (int j = warp; j < kGroup; j += nwarps) {
        const int sid = base + g + j;
        if (sid >= head && sid < count_eff) {
          write_pair_grad(red + j * kSums * kMaxWarps, kMaxWarps, lane, nwarps,
                          pairs + g + j, kChunk, x0, y0, dgrad + (long long)start_dn + sid, ld);
        }
      }
      __syncthreads();  // `red` is free for the next round
    }
  }
}

template <bool kAmp>
int launch(const float* dataT, long long ld, const int* starts, const int* counts,
           const float* acc, const float* t_final, const int* stop, const float* g_acc_t,
           const float* g_t, int nt, int th, int tw, int ntx, float* dgrad, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      composite_pairs_bwd_v2_kernel<kAmp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  if (nt > 0) {
    composite_pairs_bwd_v2_kernel<kAmp><<<nt, th * tw, kSmemBytes, (cudaStream_t)stream>>>(
        dataT, ld, starts, counts, acc, t_final, stop, g_acc_t, g_t, th, tw, ntx, dgrad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches one block of th·tw threads per tile on `stream`
// and returns the CUDA error (0 on success). The caller checks shapes,
// types, contiguity and th·tw <= 1024 with th·tw % 32 == 0, and zero-fills
// dgrad (same shape and row stride `ld` as dataT).
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
