// Forward pair compositor on the TPU v2 schedule's window, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel_pairs_v2`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:90), which runs when the
// JAX module's implementation switch `_FWD_IMPL` is flipped to it (only
// scripts/kernel_ab.py does). It computes the function of
// composite_pairs_fwd.cu (the v3 kernel's port) with the same walk
// (`fwd_walk`, composite_pairs_common.cuh: 4 pixels of one row a thread,
// the 4 alphas first and blends by selects, blocks of 2 warps, 4 a 32×32
// tile, each leaving when its own pixels have stopped, 16-byte stores) and
// the same outputs: acc [NT, 3, P], t_final [NT, P] and window-local stop
// ids [NT, P].
//
// What is v2's is the window:
//   * the walk goes over the segment's 128-aligned window [starts & ~127,
//     starts + count) in 512-pair chunks (TPU `_CHUNK`) aligned to the
//     window, each staged synchronously into shared memory before it is
//     walked (v2 waits for each chunk's DMA; v3 prefetches the next);
//   * the block tests its exit after every 64-pair group (TPU `_SUB`,
//     :195, :200), not once a chunk.
// What is not carried over is the TPU's visit of every slot of a chunk,
// the window's head slots (the previous tile's) and the slots past the
// segment masked one by one (:154), a vector-unit schedule: a chunk stages
// and walks only its slots inside the segment. Stop ids are window slots,
// so they need no renaming.
//
// What bounds it on the card: what bounds composite_pairs_fwd.cu, the
// issue of ~40 instructions a pixel and pair (an expf among them) and, on
// long walks, each pixel's dependent chain through T. The 512-pair chunk
// takes 18 KB of shared memory a block (row 1's 256-pair chunk 9 KB), so an
// SM holds 12 of these 2-warp blocks where it holds 16 of row 1's. One
// block of th·tw threads a tile, one thread a pixel walking every slot of
// each chunk, took 0.051 ms at the benchmark frame on an H100 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py, PERF.md). Built with --fmad=false and
// `expf`, so its outputs equal the plain PyTorch version
// (`fwd_call_pairs_reference`) bit for bit.
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kChunk = 512;  // TPU `_CHUNK`
constexpr int kSub = 64;     // TPU `_SUB`

__global__ void __launch_bounds__(kFwdBlockWarps * 32, 32 / kFwdBlockWarps)
composite_pairs_fwd_v2_kernel(const float* __restrict__ dataT, long long ld,
                              const int* __restrict__ starts, const int* __restrict__ counts,
                              int th, int tw, int ntx, float* __restrict__ acc,
                              float* __restrict__ t_final, int* __restrict__ stop_out) {
  __shared__ float chunk[kRows][kChunk];
  fwd_walk<kChunk, kSub, true>(dataT, ld, starts, counts, th, tw, ntx, acc, t_final, stop_out,
                               chunk);
}

}  // namespace

// Launches ceil(W / kFwdBlockWarps) blocks of min(W, kFwdBlockWarps) warps
// per tile, W = ceil(th·tw / 128), on `stream` (`fwd_launch`) and returns
// cudaGetLastError() (0 on success). The caller checks shapes, types,
// th·tw <= 1024 and tw % 4 == 0, and allocates the outputs (16-byte
// aligned, as PyTorch allocates them).
extern "C" int composite_pairs_fwd_v2(
    const float* dataT, long long ld, const int* starts, const int* counts,
    int nt, int th, int tw, int ntx,
    float* acc, float* t_final, int* stop, void* stream) {
  return fwd_launch(composite_pairs_fwd_v2_kernel, dataT, ld, starts, counts, nt, th, tw, ntx,
                    acc, t_final, stop, stream);
}
