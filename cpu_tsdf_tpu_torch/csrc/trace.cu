// Device-clock stamp for the port's tracing (cpu_tsdf_tpu_torch/tracing.py).
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
