// Pack-left kernel: stable compaction of each 512-lane row of a mask.
//
// Replaces cpu_tsdf_tpu/ops/marching_cubes.py::_pack_left_rows_kernel and
// its core _pack_left. Its plain version, and the contract, is
// cpu_tsdf_tpu_torch/ops/marching_cubes.py::_pack_left_plain:
// loc[k][r] = the lane of the r-th lane of row k with mask > 0, -1 after the
// last one.
//
// Launch: one warp per row, 8 rows per 256-thread block. The warp walks the
// row in 16 steps of 32 lanes: a ballot gives the set lanes of the step,
// each set lane writes its lane id at the running count plus the popcount
// of the set lanes below it, and the running count grows by the ballot's
// popcount. Then the warp writes -1 from the count to the end of the row.
// The TPU needed a log2(512)-round butterfly of lane rolls for this because
// its vector unit has no ballot or scattered store.
//
// Bound: device memory, one 4-byte read and one 4-byte write per lane
// (2 x rows x 512 x 4 B), coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kLanes = 512;
constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(32 * kRowsPerBlock)
pack_left_kernel(const int* __restrict__ mask, int* __restrict__ loc, int n_rows) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int* m = mask + (size_t)row * kLanes;
  int* out = loc + (size_t)row * kLanes;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
#pragma unroll 4
  for (int base = 0; base < kLanes; base += 32) {
    const bool on = m[base + lane] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) out[count + __popc(ballot & below)] = base + lane;
    count += __popc(ballot);
  }
  for (int r = count + lane; r < kLanes; r += 32) out[r] = -1;
}

extern "C" int tsdf_pack_left(const void* mask, void* loc, int n_rows, void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
    pack_left_kernel<<<blocks, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
        (const int*)mask, (int*)loc, n_rows);
  }
  return (int)cudaGetLastError();
}
