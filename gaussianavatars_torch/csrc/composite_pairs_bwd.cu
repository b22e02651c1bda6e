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
// schedule puts pixels inside a thread:
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

constexpr int kPix = 4;                              // pixels a thread
constexpr int kWarps = kMaxWarps * 32 / kPix / 32;   // warps of a 1024-pixel tile
constexpr int kChunk = 256;                          // pairs staged at a time

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
// l & 3 == 0 store field l >> 2 at red[field · kWarps · kGroup], lane 0
// field 8.
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
  constexpr int kField = kWarps * kGroup;
  if ((lane & 3) == 0) red[(lane >> 2) * kField] = v[0];
  if (lane == 0) red[8 * kField] = f8;
}

template <bool kAmp, bool kGcVpu>
__global__ void __launch_bounds__(kWarps * 32, 2) composite_pairs_bwd_kernel(
    const float* __restrict__ dataT, long long ld,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ acc, const float* __restrict__ t_final,
    const int* __restrict__ stop_in, const float* __restrict__ g_acc_t,
    const float* __restrict__ g_t, int th, int tw, int ntx,
    float* __restrict__ dgrad) {
  __shared__ float pairs[kRows][kChunk];
  // Each warp's sums, [buffer][field][warp][pair of the group].
  __shared__ float red[2][kSums][kWarps][kGroup];
  __shared__ int stop_max[kWarps];

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
  // Pixel i of this thread: row i of the warp's kPix rows of 32 pixels.
  // Pixels past the tile take part in nothing (stop 0: no slot passes).
  BwdPixel px[kPix];
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
      float* rb = &red[round & 1][0][warp][0];
      // Level 1: each thread's pixels, then the warp's, for kn pairs.
#pragma unroll 2
      for (int j = 0; j < kn; ++j) {
        const int c = g + j;
        const int sid = base + c + head;
        float s[kSums];
        bool any = false;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          float si[kSums];
          any |= bwd_pair<kAmp, kGcVpu>(&pairs[0][c], kChunk, x0, y0, px[i], sid < px[i].stop,
                                        T[i], qsum[i], si);
#pragma unroll
          for (int k = 0; k < kSums; ++k) s[k] = i == 0 ? si[k] : s[k] + si[k];
        }
        if (__any_sync(kFull, any)) {
          warp_fields(s, rb + j, lane);
        } else if (lane < kSums) {
          rb[lane * kWarps * kGroup + j] = 0.0f;
        }
      }
      __syncthreads();

      // Level 2: thread j of warp 0 sums pair j's partials in warp order.
      if (tid < kn) {
        const float* r = &red[round & 1][0][0][tid];
        float s[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
          float a = r[k * kWarps * kGroup];
          for (int w = 1; w < nwarps; ++w) a = a + r[(k * kWarps + w) * kGroup];
          s[k] = a;
        }
        pair_grad_rows(s, &pairs[0][g + tid], kChunk, x0, y0,
                       dgrad + (long long)start + base + g + tid, ld);
      }
    }
  }

  // The zeros of rows 0..8: this segment's slots past the walk, and this
  // block's share of the columns past the last segment, [total, ld). Written
  // after the walk, they drain while other blocks' walks compute.
  const int total = starts[gridDim.x - 1] + counts[gridDim.x - 1];
  for (int i = needed + tid; i < count; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) dgrad[k * ld + start + i] = 0.0f;
  }
  for (long long c = total + (long long)blockIdx.x * blockDim.x + tid; c < ld;
       c += (long long)gridDim.x * blockDim.x) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) dgrad[k * ld + c] = 0.0f;
  }
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
