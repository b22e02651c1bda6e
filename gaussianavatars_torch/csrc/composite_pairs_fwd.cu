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
// ~0.020. The design:
//   * kFwdPix = 4 pixels a thread, consecutive pixels of one row (tiles
//     are tw % 4 == 0 wide), so a pair's nine rows are read from shared
//     memory once a thread (`load_pair`), dy and c·dy² are formed once a
//     pair, and the outputs are stored as 16-byte vectors;
//   * a pair's alpha is formed at the thread's 4 pixels first
//     (`fwd_alpha`, 4 independent chains through expf), then blended with
//     selects, not branches (`fwd_blend`);
//   * a tile's 128-pixel warps are spread over blocks of kBlockWarps = 2
//     warps, 4 blocks a 32×32 tile, each staging the segment kChunk pairs
//     at a time and leaving as soon as its own pixels have stopped
//     (__syncthreads_count): a long walk runs on 4 SMs, not 1, and the
//     benchmark frame's 1,872 blocks are all resident at once (16 an SM at
//     <= 64 registers, 2,112 slots on 132 SMs);
//   * segment starts are read as they are: the GPU needs no 128-lane
//     alignment, the window-local offset only renames the stop ids.
// Tried and not kept (PERF.md): one 8-warp block a tile (0.024 ms at
// the frame, no faster than one thread a pixel on the fitted avatar),
// 1-warp blocks, warps that walk alone with no shared staging, a 64-pair
// chunk, and a per-pair band of rows outside which alpha < 1/255 (the
// frame's front pairs cover whole tiles: slower everywhere).
// Built with --fmad=false and `expf` (not `__expf`) so that the arithmetic
// is operation for operation that of the plain PyTorch version
// (`fwd_call_pairs_reference`); `fwd_alpha` and `fwd_blend` of
// composite_pairs_common.cuh are shared with the v2 schedule
// (composite_pairs_fwd_v2.cu, through `fwd_pair`).
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kFwdPix = 4;      // pixels a thread
constexpr int kChunk = 256;     // pairs staged at a time
constexpr int kBlockWarps = 2;  // warps a block (at most)

// Block b takes warps (b % blocks_per_tile)·warps_per_block.. of tile
// b / blocks_per_tile. A thread's pixels are pixels 4·lane .. 4·lane + 3 of
// its warp's 128, consecutive pixels of one row since tw % 4 == 0. Pixels
// past the tile (a thread's 4 all or none, since P % 4 == 0) start stopped
// and are not written.
__global__ void __launch_bounds__(kBlockWarps * 32, 32 / kBlockWarps) composite_pairs_fwd_kernel(
    const float* __restrict__ dataT, long long ld,
    const int* __restrict__ starts, const int* __restrict__ counts,
    int th, int tw, int ntx,
    float* __restrict__ acc, float* __restrict__ t_final,
    int* __restrict__ stop_out) {
  __shared__ float chunk[kRows][kChunk];
  const int p = th * tw;
  const int block_warps = blockDim.x >> 5;
  const int blocks_per_tile = ((p + 32 * kFwdPix - 1) / (32 * kFwdPix) + block_warps - 1)
                              / block_warps;
  const int tile = blockIdx.x / blocks_per_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (blockIdx.x % blocks_per_tile) * block_warps + (tid >> 5);  // of the tile
  const int start = starts[tile];
  const int count = counts[tile];
  const int head = start & 127;  // TPU window offset of this segment

  // Integer pixel coordinates, as the TPU kernel's `_pixel_coords`.
  const int pix0 = warp * 32 * kFwdPix + kFwdPix * lane;
  const float py = (float)(pix0 / tw) + (float)((tile / ntx) * th);
  float px[kFwdPix], T[kFwdPix], cr[kFwdPix], cg[kFwdPix], cb[kFwdPix];
  int stop[kFwdPix];
  bool done[kFwdPix];
#pragma unroll
  for (int i = 0; i < kFwdPix; ++i) {
    px[i] = (float)((pix0 + i) % tw) + (float)((tile % ntx) * tw);
    T[i] = 1.0f;
    cr[i] = cg[i] = cb[i] = 0.0f;
    stop[i] = kStopNever;
    done[i] = pix0 >= p;
  }
  bool all_done = done[0] && done[1] && done[2] && done[3];

  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    for (int i = tid; i < n; i += blockDim.x) {
      const float* src = dataT + (long long)start + base + i;
#pragma unroll
      for (int k = 0; k < kRows; ++k) chunk[k][i] = src[k * ld];
    }
    __syncthreads();
    for (int j = 0; j < n && !all_done; ++j) {
      const FwdPair q = load_pair(&chunk[0][j], kChunk);
      const float dy = py - q.my;
      const float ccdy2 = q.cc * dy * dy;
      float a[kFwdPix];
#pragma unroll
      for (int i = 0; i < kFwdPix; ++i) a[i] = fwd_alpha(q, px[i] - q.mx, dy, ccdy2);
      all_done = true;
#pragma unroll
      for (int i = 0; i < kFwdPix; ++i) {
        if (fwd_blend(a[i], q, !done[i], T[i], cr[i], cg[i], cb[i])) {
          stop[i] = base + j + head;
          done[i] = true;
        }
        all_done = all_done && done[i];
      }
    }
    if (__syncthreads_count(!all_done) == 0) break;
  }

  if (pix0 < p) {
    float* acc_t = acc + (long long)tile * 3 * p + pix0;
    const long long o = (long long)tile * p + pix0;
    *reinterpret_cast<float4*>(acc_t) = make_float4(cr[0], cr[1], cr[2], cr[3]);
    *reinterpret_cast<float4*>(acc_t + p) = make_float4(cg[0], cg[1], cg[2], cg[3]);
    *reinterpret_cast<float4*>(acc_t + 2 * p) = make_float4(cb[0], cb[1], cb[2], cb[3]);
    *reinterpret_cast<float4*>(t_final + o) = make_float4(T[0], T[1], T[2], T[3]);
    *reinterpret_cast<int4*>(stop_out + o) = make_int4(stop[0], stop[1], stop[2], stop[3]);
  }
}

}  // namespace

// Launches ceil(W / kBlockWarps) blocks of min(W, kBlockWarps) warps per
// tile, W = ceil(th·tw / 128), on `stream` and returns cudaGetLastError()
// (0 on success). The caller checks shapes,
// types, th·tw <= 1024 and tw % 4 == 0, and allocates the outputs (16-byte
// aligned, as PyTorch allocates them).
extern "C" int composite_pairs_fwd(
    const float* dataT, long long ld, const int* starts, const int* counts,
    int nt, int th, int tw, int ntx,
    float* acc, float* t_final, int* stop, void* stream) {
  const int tile_warps = (th * tw + 32 * kFwdPix - 1) / (32 * kFwdPix);
  const int warps = tile_warps < kBlockWarps ? tile_warps : kBlockWarps;
  const int blocks_per_tile = (tile_warps + warps - 1) / warps;
  if (nt > 0) {
    composite_pairs_fwd_kernel<<<nt * blocks_per_tile, warps * 32, 0, (cudaStream_t)stream>>>(
        dataT, ld, starts, counts, th, tw, ntx, acc, t_final, stop);
  }
  return (int)cudaGetLastError();
}
