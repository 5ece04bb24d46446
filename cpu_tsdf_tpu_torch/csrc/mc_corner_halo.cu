// Marching-cubes corner-halo kernel: corner stacks, cube filter and per-brick
// compaction for the candidate bricks of one extraction.
//
// Replaces cpu_tsdf_tpu/ops/marching_cubes.py::_corner_halo_kernel and the
// neighbour-row gather of _corner_stacks_pallas. Its plain version, and the
// contract, is cpu_tsdf_tpu_torch/ops/marching_cubes.py::_corner_stacks plus
// _pack_left_plain (the JAX package's _corner_stacks, marching_cubes.py:
// 480-597, and the cube filter at :749-770).
//
// Launch: one block per candidate brick, 512 threads, one per voxel (cube
// lower corner). The block loads its own 8^3 sdf/weight and the +x/+y/+z
// faces, edges and corner of its seven +1 neighbours into a 9^3 halo in
// shared memory; neighbour slots come from brick_map, and a neighbour that
// is unallocated or outside the grid reads d = -1, w = 0 (unobserved). A
// dead slot (negative, >= C, or coords -1) yields d = -1 everywhere and no
// cube. Each thread then writes its cube's 8 corner values in PCL order
// (mc_tables.CORNER_OFFSETS), its ok flag:
//   every corner w >= min_weight and |d| < 1, a sign change (some d < 0 and
//   some d >= 0), and the lower corner interior, 1 <= v < res-1 per axis,
// and the block writes loc, the stable compaction of ok over the brick
// (loc[r] = voxel of the r-th ok cube, -1 after the last), from a warp
// ballot and a scan over the 16 warp counts.
//
// Bound: device memory. Per brick about 729 x 2 x 4 B read (own block and
// halo; each neighbour face is read again by the brick it belongs to) and
// 512 x 10 x 4 B written. Reads are coalesced along z within a row; the
// corner stack is written as two 16-byte stores per thread. The TPU kernel
// assembled the halo with lane rolls and a butterfly pack-left because a
// TPU core has neither shared-memory gathers nor ballots; neither is needed
// here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kVoxels = 512;
constexpr int kHalo = 9 * 9 * 9;

// CORNER_OFFSETS (PCL): corner i at (x, y, z) = ((i&1)^((i>>1)&1), (i>>2)&1, (i>>1)&1)
__constant__ int kCornerHalo[8] = {
    0,              // (0,0,0)
    81,             // (1,0,0)
    81 + 1,         // (1,0,1)
    1,              // (0,0,1)
    9,              // (0,1,0)
    81 + 9,         // (1,1,0)
    81 + 9 + 1,     // (1,1,1)
    9 + 1,          // (0,1,1)
};

__global__ void __launch_bounds__(kVoxels)
corner_halo_kernel(const float* __restrict__ sdf, const float* __restrict__ weight,
                   const int* __restrict__ brick_map, const int* __restrict__ coords,
                   const int* __restrict__ slots, int C, int nbx, int nby, int nbz,
                   int xres, int yres, int zres, float min_weight,
                   float* __restrict__ dstack, int* __restrict__ ok_out,
                   int* __restrict__ loc_out) {
  __shared__ float hd[kHalo];
  __shared__ float hw[kHalo];
  __shared__ int nslot[8];     // index (bx<<2)|(by<<1)|bz, C = missing
  __shared__ int warp_cnt[16];

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int slot = slots[k];
  const bool live = slot >= 0 && slot < C && coords[3 * slot] >= 0;
  int bcx = 0, bcy = 0, bcz = 0;
  if (live) {
    bcx = coords[3 * slot];
    bcy = coords[3 * slot + 1];
    bcz = coords[3 * slot + 2];
  }
  if (t < 8) {
    int s = C;
    if (live) {
      const int nx = bcx + ((t >> 2) & 1), ny = bcy + ((t >> 1) & 1), nz = bcz + (t & 1);
      if (t == 0) {
        s = slot;
      } else if (nx < nbx && ny < nby && nz < nbz) {
        const int m = brick_map[(nx * nby + ny) * nbz + nz];
        if (m >= 0) s = m;
      }
    }
    nslot[t] = s;
  }
  __syncthreads();

  for (int i = t; i < kHalo; i += kVoxels) {
    const int hx = i / 81, hy = (i / 9) % 9, hz = i % 9;
    const int s = nslot[((hx >> 3) << 2) | ((hy >> 3) << 1) | (hz >> 3)];
    float d = -1.0f, w = 0.0f;
    if (s < C) {
      const size_t at = (size_t)s * kVoxels + ((hx & 7) * 8 + (hy & 7)) * 8 + (hz & 7);
      d = sdf[at];
      w = weight[at];
    }
    hd[i] = d;
    hw[i] = w;
  }
  __syncthreads();

  const int lx = t >> 6, ly = (t >> 3) & 7, lz = t & 7;
  const int h0 = (lx * 9 + ly) * 9 + lz;
  float dc[8];
  bool corners_ok = true, neg = false, pos = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float d = hd[h0 + kCornerHalo[c]];
    const float w = hw[h0 + kCornerHalo[c]];
    dc[c] = d;
    corners_ok = corners_ok && w >= min_weight && fabsf(d) < 1.0f;
    neg = neg || d < 0.0f;
    pos = pos || d >= 0.0f;
  }
  const int vx = bcx * 8 + lx, vy = bcy * 8 + ly, vz = bcz * 8 + lz;
  const bool interior = vx >= 1 && vx < xres - 1 && vy >= 1 && vy < yres - 1 &&
                        vz >= 1 && vz < zres - 1;
  const bool ok = live && corners_ok && neg && pos && interior;

  const size_t row = (size_t)k * kVoxels;
  float4* out = reinterpret_cast<float4*>(dstack + (row + t) * 8);
  out[0] = make_float4(dc[0], dc[1], dc[2], dc[3]);
  out[1] = make_float4(dc[4], dc[5], dc[6], dc[7]);
  ok_out[row + t] = ok ? 1 : 0;

  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  const int lane = t & 31, warp = t >> 5;
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const int c = warp_cnt[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (ok) loc_out[row + before + __popc(ballot & ((1u << lane) - 1u))] = t;
  if (t >= total) loc_out[row + t] = -1;
}

extern "C" int tsdf_corner_halo(const void* sdf, const void* weight,
                                const void* brick_map, const void* coords,
                                const void* slots, int n_slots, int C, int nbx,
                                int nby, int nbz, int xres, int yres, int zres,
                                float min_weight, void* dstack, void* ok,
                                void* loc, void* stream) {
  if (n_slots > 0) {
    corner_halo_kernel<<<n_slots, kVoxels, 0, (cudaStream_t)stream>>>(
        (const float*)sdf, (const float*)weight, (const int*)brick_map,
        (const int*)coords, (const int*)slots, C, nbx, nby, nbz, xres, yres,
        zres, min_weight, (float*)dstack, (int*)ok, (int*)loc);
  }
  return (int)cudaGetLastError();
}
