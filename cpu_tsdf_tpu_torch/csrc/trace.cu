// Device-clock stamp and device counts for the port's tracing
// (cpu_tsdf_tpu_torch/tracing.py).
//
// Replaces no TPU kernel: the JAX package has no device stages. Added so
// that a stage boundary inside a CUDA graph is timed at every replay with
// no host sync: a timing event would need one read per replay before the
// next replay overwrites it, while a stamp appends to a ring the host reads
// once a window.
//
// Launch: one block of one thread on the caller's stream, so it runs after
// every earlier operation of the stream and before every later one. It
// reads %globaltimer (nanoseconds, the same clock on every SM), takes the
// next index of the ring with an atomic add on its 64-bit head, and writes
// (time, label) at that index modulo the ring's length. The host orders the
// stamps by index (tracing.py reads head stamps; those past the ring's
// length overwrote the oldest, and count as dropped).
//
// Bound: launch latency, about a microsecond inside a graph; 16 bytes
// written a stamp.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void stamp_kernel(long long* ring, unsigned long long* head, long long n,
                             long long label) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long i = atomicAdd(head, 1ULL) % (unsigned long long)n;
  ring[2 * i] = (long long)t;
  ring[2 * i + 1] = label;
}

extern "C" int tsdf_trace_stamp(void* ring, void* head, long long n, long long label,
                                void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)ring, (unsigned long long*)head,
                                                  n, label);
  return (int)cudaGetLastError();
}

// Device counts: one row of a ring of int32 rows, written with no host sync
// (tracing.count). A row is the group's label, the number k of counts, the
// k counts read from device memory (each an int32 that an earlier
// operation of the stream wrote, such as a list's length) and their k
// budgets, which the launch carries: kCountRow ints in all. One
// block of one thread, as the stamp, so inside a CUDA graph every replay
// records its own counts.
constexpr int kMaxCounts = 7;
constexpr int kCountRow = 2 + 2 * kMaxCounts;

// Mirrors cpu_tsdf_tpu_torch/tracing.py::_CountSpec.
struct CountSpec {
  const int* src[kMaxCounts];
  int budget[kMaxCounts];
  int k;
  int label;
};

__global__ void count_kernel(int* rows, unsigned long long* head, long long n, CountSpec spec) {
  const unsigned long long i = atomicAdd(head, 1ULL) % (unsigned long long)n;
  int* row = rows + kCountRow * i;
  row[0] = spec.label;
  row[1] = spec.k;
  for (int j = 0; j < kMaxCounts; ++j) {
    row[2 + j] = j < spec.k ? *spec.src[j] : 0;
    row[2 + kMaxCounts + j] = j < spec.k ? spec.budget[j] : 0;
  }
}

extern "C" int tsdf_trace_counts(void* rows, void* head, long long n, const void* spec,
                                 void* stream) {
  count_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((int*)rows, (unsigned long long*)head, n,
                                                  *(const CountSpec*)spec);
  return (int)cudaGetLastError();
}
