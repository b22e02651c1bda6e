// Forward pair compositor for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel_pairs_v3`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:236), launched there by
// `fwd_call_pairs`. Same function: each image tile walks its segment
// [starts[i], starts[i] + counts[i]) of the (tile, depth)-sorted param-major
// pair table dataT [9 or 16, ld] (rows mx, my, conic a/b/c, r, g, b,
// opacity; rows 9..15 unused) front to back. Per pixel:
//   power = -0.5 (a dx² + c dy²) - b dx dy,  alpha = min(0.99, op·e^power);
//   a slot is skipped if power > 0 or alpha < 1/255; the walk stops before
//   the slot that would take T below 1e-4.
// Outputs: premultiplied colour acc [NT, 3, P], final transmittance
// t_final [NT, P], and the per-pixel stop id [NT, P] in the TPU kernel's
// window-local ids (segment index + starts[i] % 128; STOP_NEVER when the
// pixel never stopped), so all three compare element for element with it.
//
// What bounds it on the card, as measured on an H100 (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py, PERF.md). A pair costs 36 bytes of device
// memory once per tile but is evaluated at every one of the tile's P
// pixels, and each pixel's walk is a sequential chain through T. At the
// benchmark frame (468 tiles of 32×32, every pixel stopped within 34 pairs,
// ~19 on average) a launch with every count 0 takes ~0.004 ms (the launch
// and the 9.6 MB of outputs); the walk takes the rest, in the issue of the
// per-pixel instructions (~40 without fused multiply-adds, an expf among
// them) and, where walks are long (the fitted avatar's up to 159 pairs,
// the parity table's 1,547), in each pixel's dependent chain. One thread a
// pixel in one block a tile took 0.037 ms at the frame; this schedule
// ~0.020. The design, `fwd_walk` of composite_pairs_common.cuh (shared
// with the v2 schedule, composite_pairs_fwd_v2.cu, which cuts the segment
// into window-aligned chunks instead):
//   * kFwdPix = 4 pixels a thread, consecutive pixels of one row (tiles
//     are tw % 4 == 0 wide), so a pair's nine rows are read from shared
//     memory once a thread (`load_pair`), dy and c·dy² are formed once a
//     pair, and the outputs are stored as 16-byte vectors;
//   * a pair's alpha is formed at the thread's 4 pixels first
//     (`fwd_alpha`, 4 independent chains through expf), then blended with
//     selects, not branches (`fwd_blend`);
//   * a tile's 128-pixel warps are spread over blocks of kFwdBlockWarps =
//     2 warps, 4 blocks a 32×32 tile, each staging the segment kChunk pairs
//     at a time from its first pair and leaving as soon as its own pixels
//     have stopped (__syncthreads_count, once a chunk): a long walk runs on
//     4 SMs, not 1, and the benchmark frame's 1,872 blocks are all resident
//     at once (16 an SM at <= 64 registers, 2,112 slots on 132 SMs);
//   * segment starts are read as they are: the GPU needs no 128-lane
//     alignment, the window-local offset only renames the stop ids.
// Tried and not kept (PERF.md): one 8-warp block a tile (0.024 ms at
// the frame, no faster than one thread a pixel on the fitted avatar),
// 1-warp blocks, warps that walk alone with no shared staging, a 64-pair
// chunk, and a per-pair band of rows outside which alpha < 1/255 (the
// frame's front pairs cover whole tiles: slower everywhere).
// Built with --fmad=false and `expf` (not `__expf`) so that the arithmetic
// is operation for operation that of the plain PyTorch version
// (`fwd_call_pairs_reference`).
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kChunk = 256;  // pairs staged at a time

__global__ void __launch_bounds__(kFwdBlockWarps * 32, 32 / kFwdBlockWarps)
composite_pairs_fwd_kernel(const float* __restrict__ dataT, long long ld,
                           const int* __restrict__ starts, const int* __restrict__ counts,
                           int th, int tw, int ntx, float* __restrict__ acc,
                           float* __restrict__ t_final, int* __restrict__ stop_out) {
  __shared__ float chunk[kRows][kChunk];
  // Chunks from the segment's first slot; the exit is tested once a chunk.
  fwd_walk<kChunk, kChunk, false>(dataT, ld, starts, counts, th, tw, ntx, acc, t_final,
                                  stop_out, chunk);
}

}  // namespace

// Launches ceil(W / kFwdBlockWarps) blocks of min(W, kFwdBlockWarps) warps
// per tile, W = ceil(th·tw / 128), on `stream` (`fwd_launch`) and returns
// cudaGetLastError() (0 on success). The caller checks shapes, types,
// th·tw <= 1024 and tw % 4 == 0, and allocates the outputs (16-byte
// aligned, as PyTorch allocates them).
extern "C" int composite_pairs_fwd(
    const float* dataT, long long ld, const int* starts, const int* counts,
    int nt, int th, int tw, int ntx,
    float* acc, float* t_final, int* stop, void* stream) {
  return fwd_launch(composite_pairs_fwd_kernel, dataT, ld, starts, counts, nt, th, tw, ntx, acc,
                    t_final, stop, stream);
}
