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
// Launch: one block per candidate brick of B^3 voxels, B any even size,
// taken at run time (struct Brick, set up by brick_for): as in fusion.cu,
// powers of two split a cube index with shifts and masks (the kPow2
// layout), other B (6, 10, ...) by division (kDiv). A block has kThreads
// = 128 threads (32 and 64 for the 8 and 64 cubes of B = 2 and 4), so that
// at B = 8 twelve bricks are resident on an SM: a block's life is mostly
// a chain of dependent loads (slot, coords, brick map, rows), and more
// bricks in flight hide more of it (128 threads measured faster than 256
// and 512 at B = 8; PERF.md). From B = 16 on a block has 128 threads for
// every 8 of B, at most kMaxThreads (256 at 16, 512 from 32 on): a
// sphere's extraction has ~500 bricks of 16^3 and ~100 of 32^3, too few
// blocks of 128 to fill 132 SMs (on an H100 at 32^3, 0.169 ms with 128
// threads, 0.087 with 512; PERF.md). A dead slot (negative, >= C, or
// coords -1) has no cube and returns after writing an empty table. The
// block walks its brick in x-slabs of `slab` layers of cubes: the
// (slab+1) x (B+1) x (B+1) corner halo of a slab, sdf and weight, is
// staged in dynamic shared memory, as many layers as fit kHaloBudget and
// at least one. Up to B = 16 one slab is the whole brick (the 17^3 halo of
// B = 16 is 39,304 B); at B = 32 the 33^3 halo (287,496 B) exceeds a
// block's 227 KB, so it goes in 8 slabs of 4 layers (43,560 B each). Past
// B = 118 two halo layers alone exceed 227 KB and the launch function
// refuses the brick size (kBrickTooLarge). Loads, all issued before the
// slab's barrier, kBatch a thread in flight at once: the own rows' layers
// of the slab as 16-byte groups (4
// consecutive voxels; B^2 is a multiple of 4, so a slab's layers are whole
// groups), and the cells of the seven +1 neighbours (the +x face, the +y
// and +z faces, the three edges and the corner), each looking its
// neighbour's slot up in brick_map. A neighbour that is unallocated or
// outside the grid reads d = -1, w = 0 (unobserved). Then thread t takes
// the slab's cubes t + threads * i and applies the filter:
//   every corner w >= min_weight and |d| < 1, a sign change (some d < 0 and
//   some d >= 0), and the lower corner interior, 1 <= v < res-1 per axis.
// A warp ballot a round and a scan over the slab's (round, warp) counts,
// after the earlier slabs' total, give each crossing cube its rank r in
// voxel order (slabs are runs of voxel order), and only crossing cubes are
// written (their corners and cube index taken again from the halo):
//   count[k]         the number of crossing cubes of the brick;
//   cube[k][r]       cubeindex * B^3 + voxel, -1 from count[k] on (at B = 8
//                    (cubeindex << 9) | voxel); bit i of the PCL cubeindex
//                    is set iff corner i's d * scale < 0 (scale =
//                    max_dist_neg: the sign of the value in meters, as the
//                    emission's case-table lookup sees it);
//   corners[k][r][c] normalized d of corner c in PCL order
//                    (mc_tables.CORNER_OFFSETS); rows >= count[k] unwritten;
//   ntri[k]          the sum of TRI_COUNT[cubeindex] over the crossing cubes.
//
// Bound: device memory. Per brick (B+1)^3 x 2 x 4 B of halo read, 4 B^3 B
// of cube table written, 32 B of corners per crossing cube (about 8 % of
// the cubes on a fused scan at B = 8) and 8 B of counts. The former dense
// stack (B^3 x 8 floats plus ok and loc a brick, about four fifths of the
// traffic) is gone: it existed because a TPU core cannot scatter.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 128;
constexpr int kMaxThreads = 512;
// At least 3 blocks of kMaxThreads an SM: at most 40 registers a thread,
// so that at B = 8 twelve blocks of 128 threads are resident (ptxas gives
// 57 without the bound, and 8 blocks fit).
constexpr int kMinBlocks = 3;
constexpr int kBatch = 2;               // loads a thread keeps in flight before it stores them
constexpr int kHaloBudget = 44 * 1024;  // shared bytes of a slab's halo, unless one layer needs more
constexpr int kBrickTooLarge = -1;      // returned when two halo layers do not fit a block

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

// How a cube index splits into (x, y, z): by shifts and masks when B is a
// power of two, by division otherwise (the layout is a template parameter,
// chosen at launch, as in fusion.cu and raycast.cu).
enum Layout : int { kPow2 = 0, kDiv = 1 };

// The sizes of a brick of B^3 voxels and of the block that takes it.
struct Brick {
  int b;        // B
  int shift;    // log2(B) for kPow2, else -1
  int threads;  // a block
  int slab;     // cube layers of a slab
  int rounds;   // of a slab's cubes, a thread
  int entries;  // (round, warp) ballots of a slab
};

static Brick brick_for(int B) {
  Brick br;
  br.b = B;
  br.shift = -1;
  for (int k = 0; k < 31; ++k)
    if ((1 << k) == B) br.shift = k;
  const int V = B * B * B, plane = (B + 1) * (B + 1);
  // kThreads, fewer for the cubes of B = 2 and 4, and kThreads for every 8
  // of B from B = 16 on, where a brick has 8x the cubes and the bricks are
  // too few to fill the card
  const int wide = kThreads * (B >= 16 ? B / 8 : 1);
  br.threads = V < kThreads ? (V > 32 ? 64 : 32) : (wide < kMaxThreads ? wide : kMaxThreads);
  const int fit = kHaloBudget / (plane * 2 * 4) - 1;
  br.slab = fit < 1 ? 1 : (fit < B ? fit : B);
  br.rounds = (br.slab * B * B + br.threads - 1) / br.threads;
  br.entries = br.rounds * (br.threads / 32);
  return br;
}

// Dynamic shared memory of a block: the slab's halo of sdf and weight, the
// ballots, their scan and the triangle total.
static size_t shared_bytes(const Brick& br) {
  const size_t plane = (size_t)(br.b + 1) * (br.b + 1);
  return (2 * (br.slab + 1) * plane + 2 * br.entries + 2) * 4;
}

// (x, y, z) of cube c of a run of whole x-layers of B^2 cubes
template <int L>
__device__ __forceinline__ void split(const Brick& br, int c, int& lx, int& ly, int& lz) {
  if (L == kPow2) {
    lx = c >> (2 * br.shift);
    ly = (c >> br.shift) & (br.b - 1);
    lz = c & (br.b - 1);
  } else {
    const int q = c / br.b;
    lz = c - q * br.b;
    lx = q / br.b;
    ly = q - lx * br.b;
  }
}

// halo offset of corner q (PCL: x = (q&1)^((q>>1)&1), y = (q>>2)&1, z = (q>>1)&1)
__device__ __forceinline__ int corner(int q, int P, int PP) {
  return ((q ^ (q >> 1)) & 1) * PP + ((q >> 2) & 1) * P + ((q >> 1) & 1);
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
corner_halo_kernel(Brick br, const float* __restrict__ sdf, const float* __restrict__ weight,
                   const int* __restrict__ brick_map, const int* __restrict__ coords,
                   const int* __restrict__ slots, int C, int nbx, int nby, int nbz,
                   int xres, int yres, int zres, float min_weight, float scale,
                   int* __restrict__ count_out, int* __restrict__ cube_out,
                   float* __restrict__ corners_out, int* __restrict__ ntri_out) {
  const int B = br.b, NT = br.threads, BB = B * B, V = BB * B, P = B + 1, PP = P * P;
  const int halo = (br.slab + 1) * PP;
  extern __shared__ float smem[];
  float* hd = smem;
  float* hw = hd + halo;
  unsigned* ballots = reinterpret_cast<unsigned*>(hw + halo);  // round * warps + warp: voxel order
  int* before = reinterpret_cast<int*>(ballots + br.entries);  // exclusive scan of their counts
  int* tri_total = before + br.entries + 1;

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const size_t row = (size_t)k * V;
  const int slot = slots[k];
  const bool live = slot >= 0 && slot < C && coords[3 * slot] >= 0;
  if (!live) {  // uniform across the block
    for (int v = t; v < V; v += NT) cube_out[row + v] = -1;
    if (t == 0) count_out[k] = ntri_out[k] = 0;
    return;
  }
  const int bcx = coords[3 * slot], bcy = coords[3 * slot + 1], bcz = coords[3 * slot + 2];
  if (t == 0) *tri_total = 0;
  const int lane = t & 31, warp = t >> 5, warps = NT >> 5;
  const unsigned below = (1u << lane) - 1u;
  int total = 0, tris = 0;

  for (int x0 = 0; x0 < B; x0 += br.slab) {
    const int layers = B - x0 < br.slab ? B - x0 : br.slab;  // cube layers of the slab
    const bool last = x0 + layers == B;
    const int own_layers = last ? layers : layers + 1;        // halo layers with x < B
    const int own_groups = own_layers * BB / 4;
    // the own rows: group q of the slab holds voxels x0 B^2 + 4q .. + 3
    const int n_own = 2 * own_groups;
    for (int q0 = t; q0 < n_own; q0 += kBatch * NT) {
      float4 v4[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * NT;
        if (q < n_own)
          v4[u] = reinterpret_cast<const float4*>((q < own_groups ? sdf : weight) +
                                                  (size_t)slot * V + x0 * BB)[q < own_groups ? q : q - own_groups];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * NT;
        if (q < n_own) {
          float* dst = q < own_groups ? hd : hw;
          const float e[4] = {v4[u].x, v4[u].y, v4[u].z, v4[u].w};
          int lx, ly, lz;  // slab-local voxel
          split<L>(br, 4 * (q < own_groups ? q : q - own_groups), lx, ly, lz);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dst[(lx * P + ly) * P + lz] = e[j];
            if (++lz == B) {
              lz = 0;
              if (++ly == B) {
                ly = 0;
                ++lx;
              }
            }
          }
        }
      }
    }
    // the neighbours' cells: for each halo layer below x = B, the 2B+1
    // cells with y = B or z = B; in the last slab the +x face
    const int n_edge = own_layers * (2 * B + 1);
    const int n_nbr = n_edge + (last ? PP : 0);
    for (int j0 = t; j0 < n_nbr; j0 += kBatch * NT) {
      int h[kBatch], at[kBatch], cell[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * NT;
        h[u] = at[u] = cell[u] = -1;
        if (j < n_nbr) {
          int hx, ly, lz;
          if (j < n_edge) {
            hx = j / (2 * B + 1);
            const int i = j - hx * (2 * B + 1);
            ly = i < P ? B : i - P;
            lz = i < P ? i : B;
          } else {
            const int f = j - n_edge;
            hx = layers;
            ly = f / P;
            lz = f - ly * P;
          }
          const int lx = x0 + hx;
          const int bx = lx == B, by = ly == B, bz = lz == B;
          const int nx = bcx + bx, ny = bcy + by, nz = bcz + bz;
          h[u] = (hx * P + ly) * P + lz;
          at[u] = ((bx ? 0 : lx) * B + (by ? 0 : ly)) * B + (bz ? 0 : lz);
          if (nx < nbx && ny < nby && nz < nbz) cell[u] = (nx * nby + ny) * nbz + nz;
        }
      }
      int s[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s[u] = cell[u] >= 0 ? brick_map[cell[u]] : -1;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        float dv = -1.0f, wv = 0.0f;
        if (s[u] >= 0) {
          const size_t src = (size_t)s[u] * V + at[u];
          dv = sdf[src];
          wv = weight[src];
        }
        if (h[u] >= 0) {
          hd[h[u]] = dv;
          hw[h[u]] = wv;
        }
      }
    }
    __syncthreads();

    const int n_cubes = layers * BB;
#pragma unroll 4
    for (int i = 0; i < br.rounds; ++i) {
      const int c = t + NT * i;  // slab-local cube
      int lx, ly, lz;
      split<L>(br, c, lx, ly, lz);
      const int h0 = (lx * P + ly) * P + lz;
      bool corners_ok = true, neg = false, pos = false;
      int cubeindex = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float d = c < n_cubes ? hd[h0 + corner(q, P, PP)] : 0.0f;
        const float w = c < n_cubes ? hw[h0 + corner(q, P, PP)] : 0.0f;
        corners_ok = corners_ok && w >= min_weight && fabsf(d) < 1.0f;
        neg = neg || d < 0.0f;
        pos = pos || d >= 0.0f;
        cubeindex |= (d * scale < 0.0f ? 1 : 0) << q;
      }
      const int vx = bcx * B + x0 + lx, vy = bcy * B + ly, vz = bcz * B + lz;
      const bool interior = vx >= 1 && vx < xres - 1 && vy >= 1 && vy < yres - 1 &&
                            vz >= 1 && vz < zres - 1;
      const bool ok = c < n_cubes && corners_ok && neg && pos && interior;
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      const unsigned nt = __reduce_add_sync(0xffffffffu, ok ? (unsigned)kTriCount[cubeindex] : 0u);
      if (lane == 0) {
        ballots[i * warps + warp] = ballot;
        tris += (int)nt;
      }
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the slab's (round, warp) counts
      int carry = 0;
      for (int e0 = 0; e0 < br.entries; e0 += 32) {
        const int e = e0 + lane;
        const int n = e < br.entries ? __popc(ballots[e]) : 0;
        int incl = n;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        if (e < br.entries) before[e] = carry + incl - n;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) before[br.entries] = carry;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < br.rounds; ++i) {
      const unsigned ballot = ballots[i * warps + warp];
      if ((ballot >> lane) & 1u) {
        const int c = t + NT * i;
        const size_t r = row + total + before[i * warps + warp] + __popc(ballot & below);
        int lx, ly, lz;
        split<L>(br, c, lx, ly, lz);
        const int h0 = (lx * P + ly) * P + lz;
        float dc[8];
        int cubeindex = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          dc[q] = hd[h0 + corner(q, P, PP)];
          cubeindex |= (dc[q] * scale < 0.0f ? 1 : 0) << q;
        }
        cube_out[r] = cubeindex * V + x0 * BB + c;
        float4* out = reinterpret_cast<float4*>(corners_out + r * 8);
        out[0] = make_float4(dc[0], dc[1], dc[2], dc[3]);
        out[1] = make_float4(dc[4], dc[5], dc[6], dc[7]);
      }
    }
    total += before[br.entries];
    __syncthreads();  // the next slab reuses the halo, the ballots and the scan
  }
  for (int v = total + t; v < V; v += NT) cube_out[row + v] = -1;
  if (lane == 0) atomicAdd(tri_total, tris);
  __syncthreads();
  if (t == 0) {
    count_out[k] = total;
    ntri_out[k] = *tri_total;
  }
}

// brick is the even brick size B. Returns kBrickTooLarge, and launches
// nothing, where a block's shared memory would exceed the card's (B > 118
// on an H100); else the CUDA error code of the launch.
extern "C" int tsdf_corner_halo(const void* sdf, const void* weight,
                                const void* brick_map, const void* coords,
                                const void* slots, int n_slots, int brick, int C,
                                int nbx, int nby, int nbz, int xres, int yres, int zres,
                                float min_weight, float scale, void* count,
                                void* cube, void* corners, void* ntri, void* stream) {
  if (brick < 2 || brick % 2) return (int)cudaErrorInvalidValue;
  const Brick br = brick_for(brick);
  const size_t smem = shared_bytes(br);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return kBrickTooLarge;
  if (n_slots > 0) {
    auto kernel = br.shift >= 0 ? corner_halo_kernel<kPow2> : corner_halo_kernel<kDiv>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<n_slots, br.threads, smem, (cudaStream_t)stream>>>(
        br, (const float*)sdf, (const float*)weight, (const int*)brick_map,
        (const int*)coords, (const int*)slots, C, nbx, nby, nbz, xres, yres, zres,
        min_weight, scale, (int*)count, (int*)cube, (float*)corners, (int*)ntri);
  }
  return (int)cudaGetLastError();
}
