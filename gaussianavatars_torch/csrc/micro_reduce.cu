// The per-slot reduction micro-benchmark: four formulations of one function.
//
// Replaces the four Pallas kernels of scripts/micro_reduce_bench.py:
//   micro_reduce_a  ->  kern_a (:46)  per-slot jnp.sum + stack
//   micro_reduce_b  ->  kern_b (:62)  lane reduce, then sublane reduce
//   micro_reduce_c  ->  kern_c (:76)  batched dot_general per field (MXU)
//   micro_reduce_d  ->  kern_d (:99)  one [K, 1024] x [1024, 9] dot (MXU)
// (pallas_call at :119). The TPU experiment decided how the backward
// compositor reduces its per-slot sums; the port asks the same question of
// this card.
//
// The function: x is [NT, C] float32 (C = 512 slots per tile). For every
// slot, the chunk loader broadcasts x[t, s] over an [8, 128] "pixel" block
// (`_fields`: v * ones), and
//     out[t, s] = sum_{r=0..8} sum_{pixels} (1 + r) * x[t, s]
// (46080 * x up to float32 rounding), taken as the reduction each
// formulation names. Every kernel builds the plane values in registers
// (v times a plane of ones staged in shared memory, so the compiler cannot
// see they are equal) and reduces them; none folds the sums into 46080 * x.
// One block per tile; the 8 chunks of K = 64 slots are a loop inside the
// block (the TPU grid's fori_loop).
//
// What bounds it: 468 x 512 x 9 x 1024 = 2.2e9 multiply-adds (4.42 GFLOP),
// 0.066 ms at the H100's 67 TFLOP/s of float32 outside the tensor cores,
// 0.0089 ms at 495 TFLOP/s of dense TF32 (0.027 ms for 3xTF32's three
// products); the bytes (0.96 MB in, 0.96 MB out) take 0.6 us. Operations,
// not bytes. What the designs do about it:
//   A  one sum per slot and field over the whole plane, then the nine
//      added, on the CUDA cores only. The per-slot sums need no block-wide
//      reduction: 4 threads own a slot (64 slots a chunk), each walks
//      its share of every row, reading the ones as float4 broadcasts from
//      shared memory, and keeps the slot's 9 field sums in registers: 9
//      independent chains that hide the arithmetic latency. Each field's
//      products are summed per row (32 terms a thread) and the row sums
//      added into the field's total, so no float32 chain is longer than 32
//      terms; then 2 __shfl_xor_sync per field combine the lanes and the
//      nine are added. No block barrier after the ones are staged. What
//      bounds it is the CUDA cores' issue rate: per pixel one multiply
//      (v * ones) and 9 multiply-adds, written as __fmaf_rn (an explicit
//      fused multiply-add, which --fmad=false leaves alone; it halves the
//      instructions and rounds once per term instead of twice): 10
//      instructions a slot and pixel, 0.073 ms at 128 a clock an SM and
//      1.98 GHz. On an H100 it runs at 56-67 % of the 0.066 ms bound
//      (chip_smoke.py phase 11; the other lane counts timed are in PERF.md).
//   B  per field, a lane reduction of each row's 128 lanes by warp
//      shuffles, then a reduction over the 8 rows, one slot a warp at a
//      time. A warp's lanes form 4 units of 8 threads; unit u holds rows 2u
//      and 2u + 1, each thread 16 lanes of both. The thread forms its share
//      of the plane (v * ones) once a slot and sums its lanes of each
//      (field, row) in registers (18 partials, multiply-adds), then one
//      transposing butterfly across the unit reduces 16 of them at once
//      (14 shuffles leave thread t field t's two row sums), field 8 takes
//      6, the rows across the units 2 and the fields 3: 25 shuffles a
//      slot, with no shared-memory buffer, __syncwarp or single-lane tail.
//      The 4 units of a warp share every shuffle instruction. On an H100 it
//      runs at ~52 % of the 0.066 ms bound (chip_smoke.py phase 11).
//   C  the tensor cores, one product per field: for each r, the chunk's
//      [64 x 1024] plane times a [1024 x 8] matrix whose column 0 is
//      (1 + r), as mma.sync.m16n8k8 TF32 in 3xTF32 (hi*hi + hi*lo + lo*hi,
//      hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)), then each row's
//      sum over the 8 columns. With 1 of 8 columns live the route itself
//      needs 3 x 9 x 128 = 3,456 mma a warp and chunk (0.214 ms of dense
//      TF32 at this size), so the tensor cores bound it. The k-step loop is
//      outside the field loop: each A fragment is built and split once and
//      feeds all nine fields' products, whose B fragments are constants in
//      registers (hi and lo per field) and whose 9 x 2 accumulators stay in
//      registers (72 floats). The products are issued in three passes over
//      the fields, so the two that feed one `small` accumulator are 18
//      apart.
//      Two warps share a chunk's 128 k-steps (their per-slot sums meet in
//      shared memory once per chunk): 8 warps a block, 135 registers, no
//      spills. On an H100 it runs at ~45 % of the route's TF32 floor
//      (chip_smoke.py phase 11; the schedules it was chosen over are in
//      PERF.md).
//   D  the same route with one product per chunk: [64 x 1024] x [1024 x 16]
//      (the 9 basis columns 1 + r, padded to 16), then the sum over them,
//      as Hopper's warpgroup product: one block is one warpgroup and each
//      chunk one wgmma.mma_async m64n16k8 tile a k-step, A (the plane,
//      split once a k-step, by truncation: `split_trunc`) from registers,
//      B (hi and lo) from shared memory through a matrix descriptor. The
//      products are issued asynchronously in committed groups of 4
//      k-steps (12 products), two groups in flight on two register sets
//      of A, and waited for only before a set is rebuilt and before the
//      accumulators are read: no product waits on the one before it as
//      mma.sync's do. The route needs 3 x 128 = 384 m64n16k8 products a
//      chunk, 8 m16n8k8's worth each (0.048 ms of dense TF32 at this
//      size). On an H100 (PERF.md) it takes ~0.10 ms, 45 % of that floor;
//      with `split` (cvt.rna) the A split on the CUDA cores held it at
//      0.17, and the mma.sync schedule it replaces (4 warps a block, the
//      two products into one `small` back to back) took 0.178.
// In C and D the hi*hi products and the two cross products accumulate in
// separate registers (added at the end in float32): the hi*hi partial sums
// need at most 25 significant bits, so the tensor cores' float32
// accumulation keeps them nearly exact, and the cross terms' rounding is
// 2^-11 of the result. Both reach float32 accuracy (relative 1e-5 against
// the plain version, held on the card).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (see
// cuda_build.py). Each entry point launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 512;            // slots per tile
constexpr int K = 64;             // slots per chunk
constexpr int ROWS = 8, LANES = 128;
constexpr int P = ROWS * LANES;   // pixels of the broadcast block
constexpr int N_CHUNKS = C / K;
constexpr int NRED = 9;           // scaled copies (1 + r), r = 0..8

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// `_fields`' plane of ones, staged in shared memory by the whole block.
__device__ __forceinline__ void stage_ones(float* ones) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) ones[i] = 1.0f;
  __syncthreads();
}

// ------------------------------------------------------------------ A ----
constexpr int A_LANES = 4;                   // threads a slot
constexpr int A_QUADS = LANES / 4 / A_LANES; // float4s a thread walks in a row

// K * A_LANES threads: lane q of slot j walks float4 columns q, q + A_LANES,
// ... of every row, so a warp's slots read the same ones (broadcast).
__global__ void __launch_bounds__(K * A_LANES) kern_a(const float* __restrict__ x,
                                                      float* __restrict__ out) {
  __shared__ __align__(16) float ones[P];
  const int slot = threadIdx.x / A_LANES, q = threadIdx.x % A_LANES;
  const float* xt = x + (size_t)blockIdx.x * C;
  float* ot = out + (size_t)blockIdx.x * C;
  stage_ones(ones);
  const float4* ones4 = reinterpret_cast<const float4*>(ones);
  for (int k = 0; k < N_CHUNKS; ++k) {
    const float v = xt[k * K + slot];
    float tot[NRED] = {};
#pragma unroll 1
    for (int row = 0; row < ROWS; ++row) {
      float part[NRED] = {};
#pragma unroll
      for (int j = 0; j < A_QUADS; ++j) {
        const float4 o = ones4[row * (LANES / 4) + q + A_LANES * j];
        const float f[4] = {v * o.x, v * o.y, v * o.z, v * o.w};   // 4 pixels of the plane
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < NRED; ++r) part[r] = __fmaf_rn(f[e], 1.0f + (float)r, part[r]);
      }
#pragma unroll
      for (int r = 0; r < NRED; ++r) tot[r] = tot[r] + part[r];
    }
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < NRED; ++r) {
      float t = tot[r];
#pragma unroll
      for (int o = 1; o < A_LANES; o <<= 1) t = t + __shfl_xor_sync(0xffffffffu, t, o);
      s = s + t;
    }
    if (q == 0) ot[k * K + slot] = s;
  }
}

// ------------------------------------------------------------------ B ----
// 256 threads: 8 warps, each owning 8 of the chunk's 64 slots, one at a
// time. A warp's lanes form 4 units of 8 (unit u = lane >> 3 holds rows 2u
// and 2u + 1 of the plane); thread t = lane & 7 of a unit holds lanes
// t + 8j (j = 0..15) of both rows.
constexpr int B_WARPS = 8;
constexpr int B_UNIT = 8;                  // threads sharing a row's 128 lanes
constexpr int B_PER = LANES / B_UNIT;      // lanes of a row a thread holds

// One level of a transposing butterfly over 2·kHalf values among the 8
// threads of a unit: the threads whose lane bit kOff is set keep the upper
// half of v and hand the partner (lane ^ kOff) the lower, the others the
// reverse; each kept value gains the partner's.
template <int kHalf, int kOff>
__device__ __forceinline__ void b_level(float* v, int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    const float keep = upper ? v[m + kHalf] : v[m];
    const float send = upper ? v[m] : v[m + kHalf];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

__global__ void __launch_bounds__(B_WARPS * 32) kern_b(const float* __restrict__ x,
                                                       float* __restrict__ out) {
  __shared__ float ones[P];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = lane >> 3, t = lane & 7;
  const float* xt = x + (size_t)blockIdx.x * C;
  float* ot = out + (size_t)blockIdx.x * C;
  stage_ones(ones);
  float one[2][B_PER];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int j = 0; j < B_PER; ++j) one[rr][j] = ones[(2 * unit + rr) * LANES + t + B_UNIT * j];
  for (int k = 0; k < N_CHUNKS; ++k) {
    const int base = k * K;
    for (int jj = 0; jj < K / B_WARPS; ++jj) {
      const int slot = base + warp + B_WARPS * jj;
      const float v = xt[slot];
      // The thread's share of the slot's plane (`_fields`: v * ones), formed
      // once and used by all nine fields.
      float f[2][B_PER];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < B_PER; ++j) f[rr][j] = v * one[rr][j];
      // The lane reduction, part 1: per field r and row, the sum of this
      // thread's 16 lanes of (1 + r) * plane, item 2r + rr.
      float part[2 * NRED];
#pragma unroll
      for (int r = 0; r < NRED; ++r) {
        const float c = 1.0f + (float)r;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float a = f[rr][0] * c;
#pragma unroll
          for (int j = 1; j < B_PER; ++j) a = __fmaf_rn(f[rr][j], c, a);
          part[2 * r + rr] = a;
        }
      }
      // Part 2, across the unit's 8 threads: items 0..15 (fields 0..7) by a
      // transposing butterfly (offsets 4, 2, 1: 14 shuffles), after which
      // thread t holds field t's two rows, each summed over all 128 lanes;
      // items 16, 17 (field 8) by one transposing level and two plain ones.
      b_level<8, 4>(part, lane);
      b_level<4, 2>(part, lane);
      b_level<2, 1>(part, lane);
      float f8[2] = {part[16], part[17]};
      b_level<1, 4>(f8, lane);
      f8[0] = f8[0] + __shfl_xor_sync(0xffffffffu, f8[0], 2);
      f8[0] = f8[0] + __shfl_xor_sync(0xffffffffu, f8[0], 1);
      // f8[0] holds field 8's row 2u + (t >> 2); add the unit's other row.
      f8[0] = f8[0] + __shfl_xor_sync(0xffffffffu, f8[0], 4);
      // The row reduction: the unit's two rows, then the 4 units' (offsets
      // 8 and 16).
      float fr = part[0] + part[1];
      fr = fr + __shfl_xor_sync(0xffffffffu, fr, 8);
      fr = fr + __shfl_xor_sync(0xffffffffu, fr, 16);
      f8[0] = f8[0] + __shfl_xor_sync(0xffffffffu, f8[0], 8);
      f8[0] = f8[0] + __shfl_xor_sync(0xffffffffu, f8[0], 16);
      // The nine fields: fields 0..7 across the unit's threads, then field 8.
      fr = fr + __shfl_xor_sync(0xffffffffu, fr, 1);
      fr = fr + __shfl_xor_sync(0xffffffffu, fr, 2);
      fr = fr + __shfl_xor_sync(0xffffffffu, fr, 4);
      if (lane == 0) ot[slot] = fr + f8[0];
    }
  }
}

// ------------------------------------------------------------- C and D ----
// Fragments (PTX ISA, .tf32), g = lane / 4, i = lane % 4. C's mma.m16n8k8:
//   A (16 x 8): a0 (g, i), a1 (g + 8, i), a2 (g, i + 4), a3 (g + 8, i + 4)
//   B (8 x 8):  b0 (k = i, n = g), b1 (k = i + 4, n = g)
//   D (16 x 8): d0 (g, 2i), d1 (g, 2i + 1), d2 (g + 8, 2i), d3 (g + 8, 2i + 1)
// D's wgmma.m64n16k8 takes the same A fragment from each warp w of the
// warpgroup, for rows 16w .. 16w + 15, and leaves each warp the same
// accumulator fragment twice over: d0..d3 for columns 0..7, d4..d7 for
// columns 8..15.
constexpr int MMA_WARPS = K / 16;

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float v) {
  const uint32_t hi = to_tf32(v);
  return {hi, to_tf32(v - __uint_as_float(hi))};
}

// The same split in two instructions, an AND and a subtraction, where
// cvt.rna.tf32 is a sequence on this card: hi = v with the 13 mantissa bits
// that TF32 lacks cleared, lo = v - hi (exact), handed to the tensor cores
// as float32, whose TF32 read drops lo's low bits. hi·hi + hi·lo + lo·hi
// then misses v·w by at most ~2^-20 of it (split: ~2^-21), far inside the
// 1e-5 held.
__device__ __forceinline__ Split split_trunc(float v) {
  const uint32_t hi = __float_as_uint(v) & 0xffffe000u;
  return {hi, __float_as_uint(v - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float d[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// This thread's A fragment of k-step kk: rows g and g + 8 of the warp's
// slots (values vg, vg8) at pixels 8kk + i and 8kk + i + 4, split by
// `split` (kTrunc: `split_trunc`).
template <bool kTrunc = false>
__device__ __forceinline__ void a_fragment(Split a[4], const float* ones, int kk,
                                           int i, float vg, float vg8) {
  const float o0 = ones[kk * 8 + i], o1 = ones[kk * 8 + i + 4];
  a[0] = kTrunc ? split_trunc(vg * o0) : split(vg * o0);
  a[1] = kTrunc ? split_trunc(vg8 * o0) : split(vg8 * o0);
  a[2] = kTrunc ? split_trunc(vg * o1) : split(vg * o1);
  a[3] = kTrunc ? split_trunc(vg8 * o1) : split(vg8 * o1);
}

// The 16 x (8 n_tiles) result's row sums for rows g and g + 8: the
// thread's columns, then the 4 threads of its group.
__device__ __forceinline__ void row_sums(const float* d, int n_tiles, float* sg,
                                         float* sg8) {
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int t = 0; t < n_tiles; ++t) {
    a = a + d[4 * t + 0] + d[4 * t + 1];
    b = b + d[4 * t + 2] + d[4 * t + 3];
  }
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
  *sg = a;
  *sg8 = b;
}

constexpr int C_WARPS = 2 * MMA_WARPS;   // two warps share a chunk's k-steps
constexpr int KSTEPS = P / 8 / 2;        // k-steps a warp takes of a chunk

// C_WARPS warps: warp w owns rows 16 (w % 4) .. + 15 of each chunk and
// k-step half w / 4 of it. One block an SM is enough (the 72 accumulators
// need ~135 registers): without the minimum ptxas keeps it to 128 and
// spills.
__global__ void __launch_bounds__(C_WARPS * 32, 1) kern_c(const float* __restrict__ x,
                                                       float* __restrict__ out) {
  __shared__ float ones[P];
  __shared__ float ksum[2][K];   // the second half's per-slot sums, by chunk parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, i = lane & 3;
  const int rw = warp % MMA_WARPS, ks = warp / MMA_WARPS;
  const float* xt = x + (size_t)blockIdx.x * C;
  float* ot = out + (size_t)blockIdx.x * C;
  stage_ones(ones);
  // B of field r: column 0 is (1 + r), the other columns 0, at every pixel.
  Split b[NRED];
#pragma unroll
  for (int r = 0; r < NRED; ++r) b[r] = split(g == 0 ? 1.0f + (float)r : 0.0f);
  for (int k = 0; k < N_CHUNKS; ++k) {
    const int row0 = k * K + 16 * rw;
    const float vg = xt[row0 + g], vg8 = xt[row0 + g + 8];
    float big[NRED][4] = {}, small[NRED][4] = {};
    for (int kk = ks * KSTEPS; kk < (ks + 1) * KSTEPS; ++kk) {
      Split a[4];
      a_fragment(a, ones, kk, i, vg, vg8);   // one split for all nine fields
      // The 3xTF32 products (small += A_hi B_lo, then A_lo B_hi; big +=
      // A_hi B_hi) in three passes over the fields, so that the two
      // products into one `small` are 18 apart.
#pragma unroll
      for (int r = 0; r < NRED; ++r)
        mma_tf32(small[r], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[r].lo, b[r].lo);
#pragma unroll
      for (int r = 0; r < NRED; ++r)
        mma_tf32(big[r], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[r].hi, b[r].hi);
#pragma unroll
      for (int r = 0; r < NRED; ++r)
        mma_tf32(small[r], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[r].hi, b[r].hi);
    }
    float s = 0.0f, s8 = 0.0f;
#pragma unroll
    for (int r = 0; r < NRED; ++r) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = small[r][e] + big[r][e];
      float rs, rs8;
      row_sums(d, 1, &rs, &rs8);
      s = s + rs;
      s8 = s8 + rs8;
    }
    // The buffer of chunk k is written again at k + 2, after every warp has
    // passed the barrier of k + 1, so one barrier suffices.
    float* buf = ksum[k & 1];
    if (ks == 1 && i == 0) {
      buf[16 * rw + g] = s;
      buf[16 * rw + g + 8] = s8;
    }
    __syncthreads();
    if (ks == 0) {
      s = s + buf[16 * rw + g];
      s8 = s8 + buf[16 * rw + g + 8];
    }
    if (ks == 0 && i == 0) {
      ot[row0 + g] = s;
      ot[row0 + g + 8] = s8;
    }
  }
}

// D: one block is one warpgroup (4 warps, 128 threads), and each chunk of
// K = 64 slots is one wgmma.m64n16k8 tile: warp w's A fragment holds the
// chunk's rows (slots) 16w .. 16w + 15. Per chunk, 128 k-steps of 8
// pixels, each three products: small += A_hi B_lo, small += A_lo B_hi,
// big += A_hi B_hi.
constexpr int D_THREADS = 128;   // one warpgroup
constexpr int D_KSTEPS = P / 8;  // k-steps a chunk
constexpr int D_BATCH = 4;       // k-steps a committed group of products
constexpr int D_N = 16;          // the 9 basis columns, padded

// B's k-slab [8 x 16] (tf32) in wgmma's K-major layout without swizzle:
// core matrices of 8 rows (n) of 16 bytes (4 k), 128 bytes each; the two
// along K are D_LBO bytes apart, the two along N D_SBO. Element (k, n) is
// word (n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + k % 4.
constexpr int D_LBO = 128, D_SBO = 256;

__device__ __forceinline__ int b_slab_word(int k, int n) {
  return (n >> 3) * (D_SBO / 4) + (k >> 2) * (D_LBO / 4) + (n & 7) * 4 + (k & 3);
}

// The shared-memory matrix descriptor of a slab (PTX ISA, "Matrix
// Descriptor"): start address, LBO and SBO in 16-byte units, no swizzle.
__device__ __forceinline__ uint64_t slab_desc(const uint32_t* slab) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(slab);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(D_LBO >> 4) << 16)
         | ((uint64_t)(D_SBO >> 4) << 32);
}

// d += A B on the warpgroup: A [64 x 8] from registers (this thread's
// fragment a), B [8 x 16] from shared memory (descriptor b).
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Pins a register's writes before, and its reads after, this point: the
// compiler may not move them across the wgmma fences and waits.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// A batch of D_BATCH k-steps from kk0: each k-step's A fragment built and
// split once (into `a`, hi then lo), then, after the fence, its three
// products, committed as one group. `a` must not be written again until
// that group has completed (wgmma reads its registers asynchronously).
__device__ __forceinline__ void d_batch(uint32_t (&a)[D_BATCH][2][4], const float* ones, int kk0,
                                        int i, float vg, float vg8, uint64_t b_hi, uint64_t b_lo,
                                        float (&big)[8], float (&small)[8]) {
#pragma unroll
  for (int s = 0; s < D_BATCH; ++s) {
    Split f[4];
    a_fragment<true>(f, ones, kk0 + s, i, vg, vg8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[s][0][e] = f[e].hi;
      a[s][1][e] = f[e].lo;
      pin(a[s][0][e]);
      pin(a[s][1][e]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < D_BATCH; ++s) {
    wgmma_tf32(small, a[s][0], b_lo);
    wgmma_tf32(small, a[s][1], b_hi);
    wgmma_tf32(big, a[s][0], b_hi);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(D_THREADS) kern_d(const float* __restrict__ x,
                                                    float* __restrict__ out) {
  __shared__ float ones[P];
  __shared__ __align__(128) uint32_t slab[2][8 * D_N];   // B's k-slab, hi and lo
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, i = lane & 3;
  const float* xt = x + (size_t)blockIdx.x * C;
  float* ot = out + (size_t)blockIdx.x * C;
  // B [1024 x 16]: column n is (1 + n) for n < 9, else 0, in every row, so
  // its 128 k-slabs are equal: one slab is staged (thread t holds k = t % 8,
  // n = t / 8) and every k-step's products read it through one descriptor.
  {
    const int k = threadIdx.x & 7, n = threadIdx.x >> 3;
    const Split b = split(n < NRED ? 1.0f + (float)n : 0.0f);
    slab[0][b_slab_word(k, n)] = b.hi;
    slab[1][b_slab_word(k, n)] = b.lo;
  }
  // The slab's generic-proxy writes, visible to wgmma's async-proxy reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  stage_ones(ones);
  const uint64_t b_hi = slab_desc(slab[0]), b_lo = slab_desc(slab[1]);
  for (int k = 0; k < N_CHUNKS; ++k) {
    const int row0 = k * K + 16 * warp;
    const float vg = xt[row0 + g], vg8 = xt[row0 + g + 8];
    float big[8], small[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      big[e] = small[e] = 0.0f;
      pin(big[e]);
      pin(small[e]);
    }
    // Two register sets of A, so one batch is built while the other's
    // products run; a set is written again only after wait_group<1> has
    // seen its batch complete.
    uint32_t a[2][D_BATCH][2][4];
    for (int kk = 0; kk < D_KSTEPS; kk += 2 * D_BATCH) {
      d_batch(a[0], ones, kk, i, vg, vg8, b_hi, b_lo, big, small);
      wgmma_wait<1>();
      d_batch(a[1], ones, kk + D_BATCH, i, vg, vg8, b_hi, b_lo, big, small);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    float d[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      pin(big[e]);
      pin(small[e]);
      d[e] = small[e] + big[e];
    }
    float s, s8;
    row_sums(d, 2, &s, &s8);
    if (i == 0) {
      ot[row0 + g] = s;
      ot[row0 + g + 8] = s8;
    }
  }
}

}  // namespace

extern "C" {

// x: [nt, 512] float32 (the [NT, C, 1] table), out: the same shape.
int micro_reduce_a(const float* x, float* out, int nt, cudaStream_t stream) {
  if (nt > 0) kern_a<<<nt, K * A_LANES, 0, stream>>>(x, out);
  return (int)cudaGetLastError();
}

int micro_reduce_b(const float* x, float* out, int nt, cudaStream_t stream) {
  if (nt > 0) kern_b<<<nt, B_WARPS * 32, 0, stream>>>(x, out);
  return (int)cudaGetLastError();
}

int micro_reduce_c(const float* x, float* out, int nt, cudaStream_t stream) {
  if (nt > 0) kern_c<<<nt, C_WARPS * 32, 0, stream>>>(x, out);
  return (int)cudaGetLastError();
}

int micro_reduce_d(const float* x, float* out, int nt, cudaStream_t stream) {
  if (nt > 0) kern_d<<<nt, D_THREADS, 0, stream>>>(x, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
