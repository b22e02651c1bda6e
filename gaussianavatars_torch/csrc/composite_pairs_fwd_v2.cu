// Forward pair compositor on the TPU v2 schedule, for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel `_fwd_kernel_pairs_v2`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:90), which runs when the
// JAX module's implementation switch `_FWD_IMPL` is flipped to it (only
// scripts/kernel_ab.py does). It computes the function of
// composite_pairs_fwd.cu (the v3 kernel's port), with the same per-pixel
// step (`fwd_pair`, composite_pairs_common.cuh) and the same outputs: acc
// [NT, 3, P], t_final [NT, P] and window-local stop ids [NT, P]. Only the
// schedule differs, and it is v2's, translated to one block per tile and one
// thread per pixel:
//   * the walk goes over the segment's 128-aligned window [starts & ~127,
//     starts + count), in 512-pair chunks (TPU `_CHUNK`) aligned to the
//     window, each staged whole into one shared-memory buffer and then
//     walked; staging and walking do not overlap (v2 waits for each chunk's
//     DMA; v3 prefetches the next);
//   * the walk goes in 64-pair groups (TPU `_SUB`); the block leaves after a
//     group when max(stop) < base + (g+1)·64 (:195, :200) and after a chunk
//     when max(stop) < (k+1)·512 (:206);
//   * there is no live-extent bound: every slot of a chunk is visited, and
//     the window's head slots (the previous tile's) and the slots past the
//     segment are masked per slot (:154; v3 stops its group loop at the
//     live extent, :358-361).
// Stop ids are window slots, so they need no renaming.
//
// What bounds it on the card: arithmetic, as for composite_pairs_fwd.cu (an
// expf and about 24 flops per pair and pixel). Against that kernel the v2
// schedule adds a barrier per 64 pairs and visits masked slots, and its
// 512-pair chunks are staged by fewer threads than pairs when P < 512.
// Built with --fmad=false and `expf`, so its outputs equal the plain PyTorch
// version (`fwd_call_pairs_reference`) bit for bit.
#include "composite_pairs_common.cuh"

namespace {

using namespace cpk;

constexpr int kChunk = 512;  // TPU `_CHUNK`
constexpr int kSub = 64;     // TPU `_SUB`

__global__ void composite_pairs_fwd_v2_kernel(
    const float* __restrict__ dataT, long long ld,
    const int* __restrict__ starts, const int* __restrict__ counts,
    int th, int tw, int ntx,
    float* __restrict__ acc, float* __restrict__ t_final,
    int* __restrict__ stop_out) {
  __shared__ float chunk[kRows][kChunk];
  const int p = th * tw;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[tile];
  const int head = start & 127;              // window slots before the segment
  const int start_dn = start - head;         // 128-aligned window base
  const int count_eff = head + counts[tile]; // window slots up to the segment's end
  const int n_chunks = (count_eff + kChunk - 1) / kChunk;

  const float px = (float)(tid % tw) + (float)((tile % ntx) * tw);
  const float py = (float)(tid / tw) + (float)((tile / ntx) * th);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int stop = kStopNever;

  for (int k = 0; k < n_chunks; ++k) {
    const int base = k * kChunk;
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < kChunk; i += p) {
      // Masked slots are staged as zeros; the walk skips them by their id.
      const int sid = base + i;
      const bool live = sid >= head && sid < count_eff;
      const float* src = dataT + (long long)start_dn + sid;
#pragma unroll
      for (int r = 0; r < kRows; ++r) chunk[r][i] = live ? src[r * ld] : 0.0f;
    }
    __syncthreads();

    bool alive = true;
    for (int g = 0; g < kChunk / kSub; ++g) {
      for (int j = 0; j < kSub; ++j) {
        const int c = g * kSub + j;
        const int sid = base + c;
        // Per-slot mask: the window's live slots, and only while the pixel
        // has not stopped (sid < stop).
        if (sid >= head && sid < count_eff && stop == kStopNever &&
            !fwd_pair(&chunk[0][c], kChunk, px, py, T, cr, cg, cb)) {
          stop = sid;
        }
      }
      // Group exit: max(stop) < base + (g + 1)·64. The chunk exit,
      // max(stop) < (k + 1)·512, is this test after the last group.
      if (!__syncthreads_or(stop >= base + (g + 1) * kSub)) {
        alive = false;
        break;
      }
    }
    if (!alive) break;
  }

  const long long o = (long long)tile * p + tid;
  acc[(long long)tile * 3 * p + tid] = cr;
  acc[(long long)tile * 3 * p + p + tid] = cg;
  acc[(long long)tile * 3 * p + 2 * p + tid] = cb;
  t_final[o] = T;
  stop_out[o] = stop;
}

}  // namespace

// Launches one block of th·tw threads per tile on `stream` and returns
// cudaGetLastError() (0 on success). The caller checks shapes, types and
// th·tw <= 1024, and allocates the outputs.
extern "C" int composite_pairs_fwd_v2(
    const float* dataT, long long ld, const int* starts, const int* counts,
    int nt, int th, int tw, int ntx,
    float* acc, float* t_final, int* stop, void* stream) {
  if (nt > 0) {
    composite_pairs_fwd_v2_kernel<<<nt, th * tw, 0, (cudaStream_t)stream>>>(
        dataT, ld, starts, counts, th, tw, ntx, acc, t_final, stop);
  }
  return (int)cudaGetLastError();
}
