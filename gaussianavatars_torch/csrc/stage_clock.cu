// The stage clock's stamp: one thread writes the device's %globaltimer (ns)
// into a ring of int64 that lives on the card.
//
// Replaces no TPU kernel: the JAX package's stage ranges run on the host
// around jitted calls. The port replays whole frames and training steps as
// captured CUDA graphs, and a host range never runs inside a replay; a
// kernel launched at a stage's edge during the capture becomes a node of
// the graph and runs at every replay, in the stream's order.
//
// Layout: ring[rows][marks], and counter[0] the number of rows begun. A
// stamp writes mark `mark` of row counter % rows. The stamp that ends a
// row (the end of a frame or a step, KIND 2) then adds one to the counter
// and clears the next row, so that every replay writes a row of its own
// with no host involvement and a row holds only stamps of one frame or
// step. The kind is a template parameter so that a profile tells a row's
// first stamp (KIND 1) and its last (KIND 2) from the others (KIND 0) by
// the kernel's name, which lets it match them with the ring's rows even
// where it lost some records.
//
// What bounds it: one launch (~1-2 us in a graph); the work is a few
// scalar loads and stores, and one loop of `marks` stores at a row's end.
#include <cuda_runtime.h>

template <int KIND>
__global__ void stage_clock_stamp_kernel(long long* ring, long long* counter, int rows,
                                         int marks, int mark) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  long long n = counter[0];
  ring[(n % rows) * marks + mark] = (long long)t;
  if (KIND == 2) {
    n += 1;
    counter[0] = n;
    long long* next = ring + (n % rows) * marks;
    for (int i = 0; i < marks; ++i) next[i] = 0;
  }
}

extern "C" int stage_clock_stamp(void* ring, void* counter, int rows, int marks, int mark,
                                 int kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* r = (long long*)ring;
  long long* c = (long long*)counter;
  if (kind == 1) {
    stage_clock_stamp_kernel<1><<<1, 1, 0, s>>>(r, c, rows, marks, mark);
  } else if (kind == 2) {
    stage_clock_stamp_kernel<2><<<1, 1, 0, s>>>(r, c, rows, marks, mark);
  } else {
    stage_clock_stamp_kernel<0><<<1, 1, 0, s>>>(r, c, rows, marks, mark);
  }
  return (int)cudaGetLastError();
}
