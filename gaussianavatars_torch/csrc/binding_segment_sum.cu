// The transpose of the binding gathers (`ops/binding_gather.py`): for every
// face f and every face table, the sum of the per-Gaussian gradient rows of
// the Gaussians bound to f. Up to three tables in one launch (the frames'
// centre [F, 3], orientation quaternion [F, 4] and scaling [F, 1]).
//
// Replaces no TPU kernel: the JAX package leaves the transpose of
// `frames.X[binding]` to XLA's scatter-add. PyTorch's own backward of the
// gather (the sort-based `index_put_` with accumulate) hands each distinct
// face to one thread, which counts the face's entries and sums them one by
// one. The fixed-capacity state binds every dead slot to face 0, so face 0
// holds thousands of entries (8,223 of 98,304 at the benchmark's base
// avatar, about 121k at a fit's initial state), and that one thread set the
// whole backward's length.
//
// Input: a face-sorted index of the binding, built on the device
// (`binding_gather.build_face_index`): perm [N] int32, the Gaussians' positions
// sorted stably by face, and offsets [F + 1] int32; face f's entries are
// perm[offsets[f] .. offsets[f + 1]).
//
// Design: deterministic, no atomics.
//   * A block takes THREADS consecutive faces, a thread a face. A face whose
//     run has at most SLICE entries is summed by its thread, in sorted order,
//     from 0.0: the order of PyTorch's index backward, so such faces keep its
//     bits.
//   * A longer run, of n entries, is summed by the whole block of its face,
//     after the short faces. It is cut into S = ceil(n / SLICE) interleaved
//     slices: slice k holds the run's entries k, k + S, k + 2S, ... (at most
//     SLICE of them). A thread sums a slice in order from 0.0, and threads
//     0..COLS-1 (one a column) add the slices' partial sums to the face's
//     total, from 0.0 in slice order, through shared memory, THREADS slices
//     a round. Interleaved, a round's threads read consecutive entries at
//     each step, so the index's loads coalesce, and so do the rows' where
//     the run's positions are consecutive (the padding slots).
//   * Every column is float32 and every entry is summed, the zero rows of the
//     padding slots included, so the result does not depend on them.
//   The plain version (`segment_sum_reference`) makes the same additions in
//   the same order, so the two agree bit for bit.
//
// What bounds it: bytes. Each gradient row read once, the index read once,
// each face row written once: about 3.9 MB at the base avatar's layout
// (98,304 slots, 10,010 faces, 8 columns), 1.2 us at 3.35 TB/s. The rows are
// gathered by perm, so the kernel runs at the loads' latency rather than at
// that bound; the block of the longest run is its critical path.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // faces a block, threads a block
constexpr int SLICE = 32;      // entries a thread sums in order
constexpr int TABLES = 3;
constexpr int WIDTH = 4;       // the widest table's columns
constexpr int COLS = TABLES * WIDTH;

struct Tables {
  const float* grad[TABLES];   // [N, width[t]] per-Gaussian gradient rows
  float* out[TABLES];          // [F, width[t]] face gradients
  int width[TABLES];           // 0: no table
};

// acc = the sum, from 0.0 in order, of the rows perm[lo], perm[lo + step],
// ... (below hi) of every table.
__device__ __forceinline__ void sum_run(float (&acc)[COLS], const Tables& tb,
                                        const int* __restrict__ perm, int lo, int hi,
                                        int step) {
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
#pragma unroll 4
  for (int i = lo; i < hi; i += step) {
    const long long row = perm[i];
#pragma unroll
    for (int t = 0; t < TABLES; ++t) {
#pragma unroll
      for (int j = 0; j < WIDTH; ++j) {
        if (j < tb.width[t]) acc[t * WIDTH + j] += tb.grad[t][row * tb.width[t] + j];
      }
    }
  }
}

// out[face] = acc, every column of every table.
__device__ __forceinline__ void store_row(const Tables& tb, int face,
                                          const float (&acc)[COLS]) {
#pragma unroll
  for (int t = 0; t < TABLES; ++t) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
      if (j < tb.width[t]) tb.out[t][(long long)face * tb.width[t] + j] = acc[t * WIDTH + j];
    }
  }
}

// The run perm[lo .. hi) of `face`, summed by the whole block (see the top).
__device__ __forceinline__ void sum_long_run(const Tables& tb, const int* __restrict__ perm, int face, int lo,
                             int hi, float (&partial)[COLS][THREADS + 1]) {
  const int slices = (hi - lo + SLICE - 1) / SLICE;
  float total = 0.0f;   // threads c < COLS: column c's sum of the slices so far
  for (int base = 0; base < slices; base += THREADS) {
    const int k = base + threadIdx.x;
    float acc[COLS];
    sum_run(acc, tb, perm, lo + k, k < slices ? hi : lo + k, slices);
#pragma unroll
    for (int c = 0; c < COLS; ++c) partial[c][threadIdx.x] = acc[c];
    __syncthreads();
    if (threadIdx.x < COLS) {
      const int n = min(THREADS, slices - base);
#pragma unroll 8
      for (int s = 0; s < n; ++s) total += partial[threadIdx.x][s];
    }
    __syncthreads();
  }
  // Column c's total to thread 0, in the row's order, for one store.
  if (threadIdx.x < COLS) partial[threadIdx.x][0] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float row[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) row[c] = partial[c][0];
    store_row(tb, face, row);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2)
binding_segment_sum_kernel(const int* __restrict__ perm, const int* __restrict__ offsets,
                           int num_faces, Tables tb) {
  // Row c holds column c of a round's partial sums; the padding keeps the
  // COLS threads that add them on distinct banks.
  __shared__ float partial[COLS][THREADS + 1];
  __shared__ unsigned int long_faces[THREADS / 32];
  const int face = blockIdx.x * THREADS + threadIdx.x;
  int lo = 0, hi = 0;
  if (face < num_faces) {
    lo = offsets[face];
    hi = offsets[face + 1];
  }
  const bool is_long = hi - lo > SLICE;
  if (face < num_faces && !is_long) {
    float acc[COLS];
    sum_run(acc, tb, perm, lo, hi, 1);
    store_row(tb, face, acc);
  }
  const unsigned int warp_long = __ballot_sync(0xffffffffu, is_long);
  if ((threadIdx.x & 31) == 0) long_faces[threadIdx.x >> 5] = warp_long;
  __syncthreads();
  for (int w = 0; w < THREADS / 32; ++w) {
    unsigned int bits = long_faces[w];   // the same in every thread
    while (bits) {
      const int f = blockIdx.x * THREADS + w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      sum_long_run(tb, perm, f, offsets[f], offsets[f + 1], partial);
    }
  }
}

}  // namespace

// Face gradients out_t [F, width_t] of up to three tables (width_t 0: no
// table, 1..4 columns otherwise) from the per-Gaussian gradients grad_t
// [N, width_t], float32 and contiguous, over the index (perm, offsets).
// Every element of every out_t is written, the empty faces' as 0.0.
// Returns the CUDA error of the launch (0 when it launched).
extern "C" int binding_segment_sum(const void* perm, const void* offsets, int num_faces,
                                   const void* grad0, void* out0, int width0,
                                   const void* grad1, void* out1, int width1,
                                   const void* grad2, void* out2, int width2, void* stream) {
  const int widths[TABLES] = {width0, width1, width2};
  for (int w : widths) {
    if (w < 0 || w > WIDTH) return (int)cudaErrorInvalidValue;
  }
  if (num_faces <= 0) return 0;
  Tables tb{{(const float*)grad0, (const float*)grad1, (const float*)grad2},
            {(float*)out0, (float*)out1, (float*)out2},
            {width0, width1, width2}};
  const int blocks = (num_faces + THREADS - 1) / THREADS;
  binding_segment_sum_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)perm, (const int*)offsets, num_faces, tb);
  return (int)cudaGetLastError();
}
