// Marching-cubes corner-halo kernel: cube filter, per-brick compaction and
// the compacted corner stacks of the crossing cubes of one extraction.
//
// Replaces cpu_tsdf_tpu/ops/marching_cubes.py::_corner_halo_kernel and the
// neighbour-row gather of _corner_stacks_pallas. Its plain version, and the
// contract, is cpu_tsdf_tpu_torch/ops/marching_cubes.py::_corner_halo_plain
// (_corner_stacks + _pack_left_plain + a gather; the JAX package's
// _corner_stacks, marching_cubes.py:480-597, and the cube filter at
// :749-770).
//
// Launch: one block per candidate brick, 128 threads, so that 12 bricks (at
// 40 registers) are resident on an SM: a block's life is mostly a chain of
// dependent loads (slot, coords, brick map, rows), and more bricks in
// flight hide more of it (128 threads measured faster than 256 and 512;
// PERF.md). Loads, all issued before the block's first barrier: each
// thread reads one 16-byte group of the brick's own d and w rows (as soon
// as the slot is known to be in range) and one or two halo cells of the
// seven +1 neighbours (the +x face is the neighbour's first 64 contiguous
// floats, the +y face 8 runs of 8, the +z face, the three edges and the
// corner scalars), each looking its neighbour's slot up in brick_map. A
// neighbour that is unallocated or outside the grid reads d = -1, w = 0
// (unobserved); a dead slot (negative, >= C, or coords -1) reads that
// everywhere and has no cube. Then thread t takes the cubes whose lower
// corners are voxels t + 128 i, i = 0..3, and applies the filter:
//   every corner w >= min_weight and |d| < 1, a sign change (some d < 0 and
//   some d >= 0), and the lower corner interior, 1 <= v < res-1 per axis.
// A warp ballot a round and a scan over the 16 (round, warp) counts give
// each crossing cube its rank r in voxel order, and only crossing cubes are
// written (their corners and cube index taken again from the halo):
//   count[k]         the number of crossing cubes of the brick;
//   cube[k][r]       (cubeindex << 9) | voxel, -1 from count[k] on; bit i of
//                    the PCL cubeindex is set iff corner i's d * scale < 0
//                    (scale = max_dist_neg: the sign of the value in meters,
//                    as the emission's case-table lookup sees it);
//   corners[k][r][c] normalized d of corner c in PCL order
//                    (mc_tables.CORNER_OFFSETS); rows >= count[k] unwritten;
//   ntri[k]          the sum of TRI_COUNT[cubeindex] over the crossing cubes.
//
// Bound: device memory. Per brick 729 x 2 x 4 B of halo read, 2 KB of cube
// table written, 32 B of corners per crossing cube (about 8 % of the cubes
// on a fused scan) and 8 B of counts. The former dense stack (512 x 8 floats
// plus ok and loc a brick, about four fifths of the traffic) is gone: it
// existed because a TPU core cannot scatter.

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

// mc_tables.TRI_COUNT: triangles of each cubeindex (held equal to the
// Python table by tests/test_torch_marching_cubes.py).
__constant__ unsigned char kTriCount[256] = {
    0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 2, 1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3,
    1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3, 2, 3, 3, 2, 3, 4, 4, 3, 3, 4, 4, 3, 4, 5, 5, 2,
    1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3, 2, 3, 3, 4, 3, 4, 4, 5, 3, 4, 4, 5, 4, 5, 5, 4,
    2, 3, 3, 4, 3, 4, 2, 3, 3, 4, 4, 5, 4, 5, 3, 2, 3, 4, 4, 3, 4, 5, 3, 2, 4, 5, 5, 4, 5, 2, 4, 1,
    1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3, 2, 3, 3, 4, 3, 4, 4, 5, 3, 2, 4, 3, 4, 3, 5, 2,
    2, 3, 3, 4, 3, 4, 4, 5, 3, 4, 4, 5, 4, 5, 5, 4, 3, 4, 4, 3, 4, 5, 5, 4, 4, 3, 5, 2, 5, 4, 2, 1,
    2, 3, 3, 4, 3, 4, 4, 5, 3, 4, 4, 5, 2, 3, 3, 2, 3, 4, 4, 5, 4, 5, 5, 2, 4, 3, 5, 4, 3, 2, 4, 1,
    3, 4, 4, 5, 4, 5, 3, 4, 4, 5, 5, 2, 3, 4, 2, 1, 2, 3, 3, 2, 3, 4, 2, 1, 3, 2, 4, 1, 2, 1, 1, 0,
};

// Halo cell j (0..216) beyond the own brick: the +1 neighbour it lies in
// (index (bx<<2)|(by<<1)|bz), its voxel in that neighbour's row, and its
// index in the 9^3 halo.
__device__ __forceinline__ void halo_cell(int j, int& nb, int& src, int& h) {
  if (j < 64) {                       // +x face: x = 0 of the neighbour, contiguous
    nb = 4; src = j; h = 8 * 81 + j + (j >> 3);
  } else if (j < 128) {               // +y face: y = 0, 8 runs of 8
    const int i = j - 64, x = i >> 3, z = i & 7;
    nb = 2; src = x * 64 + z; h = x * 81 + 8 * 9 + z;
  } else if (j < 192) {               // +z face: z = 0
    const int i = j - 128, x = i >> 3, y = i & 7;
    nb = 1; src = x * 64 + y * 8; h = x * 81 + y * 9 + 8;
  } else if (j < 200) {               // +x+y edge
    const int z = j - 192;
    nb = 6; src = z; h = 8 * 81 + 8 * 9 + z;
  } else if (j < 208) {               // +x+z edge
    const int y = j - 200;
    nb = 5; src = y * 8; h = 8 * 81 + y * 9 + 8;
  } else if (j < 216) {               // +y+z edge
    const int x = j - 208;
    nb = 3; src = x * 64; h = x * 81 + 8 * 9 + 8;
  } else {                            // +x+y+z corner
    nb = 7; src = 0; h = kHalo - 1;
  }
}

// Thread t of the block takes the cubes of voxels t + 128 i, i = 0..3.
constexpr int kThreads = 128;
constexpr int kRounds = kVoxels / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kOwnLoads = (2 * kVoxels / 4 + kThreads - 1) / kThreads;  // 16-byte groups
constexpr int kHaloLoads = (kHalo - kVoxels + kThreads - 1) / kThreads;

__global__ void __launch_bounds__(kThreads)
corner_halo_kernel(const float* __restrict__ sdf, const float* __restrict__ weight,
                   const int* __restrict__ brick_map, const int* __restrict__ coords,
                   const int* __restrict__ slots, int C, int nbx, int nby, int nbz,
                   int xres, int yres, int zres, float min_weight, float scale,
                   int* __restrict__ count_out, int* __restrict__ cube_out,
                   float* __restrict__ corners_out, int* __restrict__ ntri_out) {
  __shared__ float hd[kHalo];
  __shared__ float hw[kHalo];
  __shared__ int warp_cnt[kRounds * kWarps];  // index round * kWarps + warp: voxel order
  __shared__ int warp_tri[kRounds * kWarps];

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int slot = slots[k];
  const bool in_range = slot >= 0 && slot < C;
  // the own rows (16-byte group q < 128 of d, then of w) are read as soon
  // as the slot is known to be in range; a slot with coords -1 is dead and
  // its rows are replaced below
  float4 own[kOwnLoads];
#pragma unroll
  for (int m = 0; m < kOwnLoads; ++m) {
    const int q = t + m * kThreads;
    own[m] = q < 128 ? make_float4(-1.f, -1.f, -1.f, -1.f) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (in_range && q < 256)
      own[m] = reinterpret_cast<const float4*>((q < 128 ? sdf : weight) +
                                               (size_t)slot * kVoxels)[q & 127];
  }
  const bool live = in_range && coords[3 * slot] >= 0;
  int bcx = 0, bcy = 0, bcz = 0;
  if (live) {
    bcx = coords[3 * slot];
    bcy = coords[3 * slot + 1];
    bcz = coords[3 * slot + 2];
  }
#pragma unroll
  for (int m = 0; m < kHaloLoads; ++m) {  // 217 halo cells
    const int j = t + m * kThreads;
    if (j >= kHalo - kVoxels) break;
    int nb, src, h;
    halo_cell(j, nb, src, h);
    float d = -1.0f, w = 0.0f;
    if (live) {
      const int nx = bcx + ((nb >> 2) & 1), ny = bcy + ((nb >> 1) & 1), nz = bcz + (nb & 1);
      if (nx < nbx && ny < nby && nz < nbz) {
        const int s = brick_map[(nx * nby + ny) * nbz + nz];
        if (s >= 0) {
          d = sdf[(size_t)s * kVoxels + src];
          w = weight[(size_t)s * kVoxels + src];
        }
      }
    }
    hd[h] = d;
    hw[h] = w;
  }
#pragma unroll
  for (int m = 0; m < kOwnLoads; ++m) {
    // group g of a row holds voxels 4g..4g+3 = (x, y, z0..z0+3)
    const int q = t + m * kThreads, g = q & 127;
    if (q >= 256) break;
    float* dst = (q < 128 ? hd : hw) + (g >> 4) * 81 + ((g >> 1) & 7) * 9 + (g & 1) * 4;
    const float4 v = live ? own[m] : (q < 128 ? make_float4(-1.f, -1.f, -1.f, -1.f)
                                              : make_float4(0.f, 0.f, 0.f, 0.f));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  unsigned ballot[kRounds];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int v = t + kThreads * i;
    const int lx = v >> 6, ly = (v >> 3) & 7, lz = v & 7;
    const int h0 = (lx * 9 + ly) * 9 + lz;
    bool corners_ok = true, neg = false, pos = false;
    int cubeindex = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float d = hd[h0 + kCornerHalo[c]];
      const float w = hw[h0 + kCornerHalo[c]];
      corners_ok = corners_ok && w >= min_weight && fabsf(d) < 1.0f;
      neg = neg || d < 0.0f;
      pos = pos || d >= 0.0f;
      cubeindex |= (d * scale < 0.0f ? 1 : 0) << c;
    }
    const int vx = bcx * 8 + lx, vy = bcy * 8 + ly, vz = bcz * 8 + lz;
    const bool interior = vx >= 1 && vx < xres - 1 && vy >= 1 && vy < yres - 1 &&
                          vz >= 1 && vz < zres - 1;
    const bool ok = live && corners_ok && neg && pos && interior;
    ballot[i] = __ballot_sync(0xffffffffu, ok);
    const unsigned tris = __reduce_add_sync(0xffffffffu, ok ? (unsigned)kTriCount[cubeindex] : 0u);
    if (lane == 0) {
      warp_cnt[i * kWarps + warp] = __popc(ballot[i]);
      warp_tri[i * kWarps + warp] = (int)tris;
    }
  }
  __syncthreads();

  int total = 0;
#pragma unroll
  for (int g = 0; g < kRounds * kWarps; ++g) total += warp_cnt[g];
  const size_t row = (size_t)k * kVoxels;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int v = t + kThreads * i;
    if ((ballot[i] >> lane) & 1u) {
      int before = 0;
      for (int g = 0; g < i * kWarps + warp; ++g) before += warp_cnt[g];
      const size_t r = row + before + __popc(ballot[i] & below);
      const int h0 = ((v >> 6) * 9 + ((v >> 3) & 7)) * 9 + (v & 7);
      float dc[8];
      int cubeindex = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        dc[c] = hd[h0 + kCornerHalo[c]];
        cubeindex |= (dc[c] * scale < 0.0f ? 1 : 0) << c;
      }
      cube_out[r] = (cubeindex << 9) | v;
      float4* out = reinterpret_cast<float4*>(corners_out + r * 8);
      out[0] = make_float4(dc[0], dc[1], dc[2], dc[3]);
      out[1] = make_float4(dc[4], dc[5], dc[6], dc[7]);
    }
    if (v >= total) cube_out[row + v] = -1;
  }
  if (t == 0) {
    int tris = 0;
#pragma unroll
    for (int g = 0; g < kRounds * kWarps; ++g) tris += warp_tri[g];
    count_out[k] = total;
    ntri_out[k] = tris;
  }
}

extern "C" int tsdf_corner_halo(const void* sdf, const void* weight,
                                const void* brick_map, const void* coords,
                                const void* slots, int n_slots, int C, int nbx,
                                int nby, int nbz, int xres, int yres, int zres,
                                float min_weight, float scale, void* count,
                                void* cube, void* corners, void* ntri, void* stream) {
  if (n_slots > 0) {
    corner_halo_kernel<<<n_slots, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)sdf, (const float*)weight, (const int*)brick_map,
        (const int*)coords, (const int*)slots, C, nbx, nby, nbz, xres, yres,
        zres, min_weight, scale, (int*)count, (int*)cube, (float*)corners,
        (int*)ntri);
  }
  return (int)cudaGetLastError();
}
