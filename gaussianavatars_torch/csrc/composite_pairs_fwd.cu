// Forward pair compositor for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel_pairs_v3`
// (gaussianavatars_tpu/ops/pallas/composite_pairs.py:236), launched there by
// `fwd_call_pairs`. Same function: each image tile walks its segment
// [starts[i], starts[i] + counts[i]) of the (tile, depth)-sorted param-major
// pair table dataT [16, ld] (rows mx, my, conic a/b/c, r, g, b, opacity;
// rows 9..15 unused) front to back. Per pixel:
//   power = -0.5 (a dx² + c dy²) - b dx dy,  alpha = min(0.99, op·e^power);
//   a slot is skipped if power > 0 or alpha < 1/255; the walk stops before
//   the slot that would take T below 1e-4.
// Outputs: premultiplied colour acc [NT, 3, P], final transmittance
// t_final [NT, P], and the per-pixel stop id [NT, P] in the TPU kernel's
// window-local ids (segment index + starts[i] % 128; STOP_NEVER when the
// pixel never stopped), so all three compare element for element with it.
//
// What bounds it on the card: arithmetic, not memory. A pair costs 36 bytes
// of device memory once per tile but is evaluated at every one of the
// tile's P pixels (an expf and about 24 flops each), and each pixel's walk
// is a sequential chain through T. The design follows from that:
//   * one block per tile and one thread per pixel (P = th·tw <= 1024), so
//     a pair is read from device memory once and broadcast to every pixel
//     from shared memory (all threads read the same word: no bank
//     conflicts);
//   * the segment is staged in chunks of P pairs, one pair's nine used rows
//     per thread (coalesced row reads), then each thread walks the chunk;
//   * the block leaves as soon as every pixel has stopped
//     (__syncthreads_count), so the work done is what this frame's data
//     needs, not the segment length;
//   * segment starts are read as they are: the GPU needs no 128-lane
//     alignment, the window-local offset only renames the stop ids.
// Built with --fmad=false and `expf` (not `__expf`) so that the arithmetic
// is operation for operation that of the plain PyTorch version
// (`fwd_call_pairs_reference`). Chunk double buffering (cp.async / TMA) is
// not done here.
#include <cuda_runtime.h>

namespace {

constexpr float kAlphaCutoff = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kStopNever = 0x3FFFFFFF;
constexpr int kRows = 9;  // used rows of the pair table

__global__ void composite_pairs_fwd_kernel(
    const float* __restrict__ dataT, long long ld,
    const int* __restrict__ starts, const int* __restrict__ counts,
    int th, int tw, int ntx,
    float* __restrict__ acc, float* __restrict__ t_final,
    int* __restrict__ stop_out) {
  extern __shared__ float chunk[];  // [kRows][P]
  const int p = th * tw;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int head = start & 127;  // TPU window offset of this segment

  // Integer pixel coordinates, as the TPU kernel's `_pixel_coords`.
  const float px = (float)(tid % tw) + (float)((tile % ntx) * tw);
  const float py = (float)(tid / tw) + (float)((tile / ntx) * th);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int stop = kStopNever;
  bool done = false;

  for (int base = 0; base < count; base += p) {
    const int n = min(p, count - base);
    if (tid < n) {
      const float* src = dataT + (long long)start + base + tid;
#pragma unroll
      for (int k = 0; k < kRows; ++k) chunk[k * p + tid] = src[k * ld];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float mx = chunk[j];
        const float my = chunk[p + j];
        const float ca = chunk[2 * p + j];
        const float cbx = chunk[3 * p + j];
        const float cc = chunk[4 * p + j];
        const float op = chunk[8 * p + j];
        const float dx = px - mx;
        const float dy = py - my;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbx * dx * dy;
        const float v = op * expf(power);
        const float alpha = v > kAlphaMax ? kAlphaMax : v;
        if (!(power <= 0.0f) || !(alpha >= kAlphaCutoff)) continue;
        const float test_t = T * (1.0f - alpha);
        if (!(test_t >= kTEps)) {
          stop = base + j + head;
          done = true;
          break;
        }
        const float w = alpha * T;
        cr = cr + w * chunk[5 * p + j];
        cg = cg + w * chunk[6 * p + j];
        cb = cb + w * chunk[7 * p + j];
        T = test_t;
      }
    }
    // Barrier before the next chunk overwrites shared memory, and the
    // block's early exit once every pixel has stopped.
    if (__syncthreads_count(!done) == 0) break;
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
extern "C" int composite_pairs_fwd(
    const float* dataT, long long ld, const int* starts, const int* counts,
    int nt, int th, int tw, int ntx,
    float* acc, float* t_final, int* stop, void* stream) {
  const int p = th * tw;
  if (nt > 0) {
    const size_t smem = sizeof(float) * kRows * p;
    composite_pairs_fwd_kernel<<<nt, p, smem, (cudaStream_t)stream>>>(
        dataT, ld, starts, counts, th, tw, ntx, acc, t_final, stop);
  }
  return (int)cudaGetLastError();
}
