// Marching-cubes emission kernel: the triangles of the crossing cubes that
// the corner-halo kernel compacted, written straight into the mesh.
//
// Replaces cpu_tsdf_tpu/ops/marching_cubes.py::_pack_left_rows_kernel (the
// per-row compaction of the [cube, triangle-slot] mask) together with the
// work around it, _compact_from_loc and _emit_soup_compacted (:213-295,
// :605-628). Its plain version, and the contract, is
// cpu_tsdf_tpu_torch/ops/marching_cubes.py::_emit_plain.
//
// Launch: one block per candidate brick k of B^3 voxels (B any even size,
// taken at run time; powers of two decode a cube code with shifts, other B
// by division, as in mc_corner_halo.cu), kThreads = 128 threads (32 and 64
// for the 8 and 64 cubes of B = 2 and 4), over the brick's count[k]
// crossing cubes in chunks of a block's width (rank order; a brick of a
// fused scan at B = 8 has ~40 crossing cubes and few have more than 128,
// and the launch lasts as long as its slowest brick; at B = 32 a brick has
// ~830, 7 chunks in turn, and a wider block's stage would pass 48 KB of
// shared memory; the stage is sized by the block at launch, so that 64
// threads at B = 4 hold half the shared memory and twice the blocks fit an
// SM); the first chunk's loads are issued together. Thread r
// reads its cube's code (cubeindex * B^3 + voxel; -1 past count[k]) and 8
// corners, scales the corners by max_dist_neg and takes its triangle
// count and edge ids from the packed case table. A
// warp-shuffle scan, then one over the warp sums, gives each thread its
// first triangle within the chunk: that scan is the stable compaction of
// the [cube, slot] mask that the TPU built and packed left, with no mask.
// Each triangle's 3 vertices are interpolated on their edges as
// _edge_points does (PCL interpolateEdge: mu = (0 - v1) / (v2 - v1), 0.5
// where v2 == v1, on the voxel-centre lattice) and passed through
// global_transform as transform_points does, with the same float32
// operations in the same order (the library builds with --fmad=false), so
// the vertices equal the plain version's bit for bit. The chunk's
// triangles are staged in shared memory and leave as one contiguous run at
// tri_off[k] + the chunk's base: vertices [T, 3, 3] and tri_cube[t] =
// slot * B^3 + voxel (int32: the wrapper refuses capacity * B^3 >= 2^31),
// coalesced 4-byte stores (a triangle is 36 B, so its start is 4-byte
// aligned only). The output holds tri_budget triangles, a fixed size that
// a CUDA graph can replay (the JAX package's per-chunk tri_budget): no
// triangle at or past it is stored, and a block whose first triangle lies
// past it returns at once; the caller flags the overflow from the scan of
// the triangle counts.
//
// Bound: device memory. 36 B read per crossing cube (code and corners),
// 40 B written per triangle, a few words per brick; the case table stays in
// L1. The TPU computed every [cube, slot] of a 512-lane mask, packed each
// row with a log2(512)-round butterfly and gathered the survivors' rows;
// here a cube's triangles come from its own table row.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 128;
constexpr int kMaxTris = 5;  // mc_tables.MAX_TRIS_PER_CUBE

// How a cube code splits into (cubeindex, x, y, z): by shifts and masks
// when B is a power of two, by division otherwise (the layout is a
// template parameter, chosen at launch).
enum Layout : int { kPow2 = 0, kDiv = 1 };

// A brick of B^3 voxels and the block that takes it.
struct Brick {
  int b;        // B
  int shift;    // log2(B) for kPow2, else -1
  int threads;  // a block: kThreads, fewer where a brick has fewer cubes
};

// mc_tables.TRI_TABLE and TRI_COUNT packed a cubeindex a word: bits
// 12i+4j..12i+4j+3 hold the edge of vertex j of triangle i, bits 60-63 the
// triangle count (held equal to the Python tables by
// tests/test_torch_marching_cubes.py).
__device__ const unsigned long long kTriRows[256] = {
    0x0000000000000000ull, 0x1000000000000803ull, 0x1000000000000910ull, 0x2000000000893913ull,
    0x1000000000000a21ull, 0x2000000000803a21ull, 0x20000000009a0a20ull, 0x30000008939a3a23ull,
    0x1000000000000b32ull, 0x2000000000b82802ull, 0x2000000000b32910ull, 0x3000000b82892912ull,
    0x2000000000ab1b31ull, 0x3000000ab1b81801ull, 0x30000009a0ab0b30ull, 0x20000000009a8ab8ull,
    0x1000000000000874ull, 0x2000000000743403ull, 0x2000000000874910ull, 0x3000000743493913ull,
    0x2000000000874a21ull, 0x3000000743403a21ull, 0x30000008749a0a20ull, 0x40007434939a3a23ull,
    0x2000000000874b32ull, 0x3000000b72742402ull, 0x3000000874b32910ull, 0x4000b72742492912ull,
    0x3000000874ab1b31ull, 0x4000ab1b71741401ull, 0x40008749a0ab0b30ull, 0x30000009a4ab4b74ull,
    0x1000000000000945ull, 0x2000000000945803ull, 0x2000000000450510ull, 0x3000000843453513ull,
    0x2000000000945a21ull, 0x3000000945803a21ull, 0x30000004505a0a20ull, 0x40008434535a3a23ull,
    0x2000000000945b32ull, 0x3000000945b82802ull, 0x3000000b32450510ull, 0x4000b82842452512ull,
    0x3000000945ab1b31ull, 0x4000945ab1b81801ull, 0x40004505a0ab0b30ull, 0x3000000ab5b85845ull,
    0x2000000000985875ull, 0x3000000753593903ull, 0x3000000870750510ull, 0x2000000000753513ull,
    0x3000000985875a21ull, 0x4000753593903a21ull, 0x40008707505a0a20ull, 0x30000007535a3a23ull,
    0x3000000985875b32ull, 0x4000b72752592902ull, 0x4000b32870750510ull, 0x3000000b72752512ull,
    0x4000985875ab1b31ull, 0x5ab1b71751591901ull, 0x58707505a0ab0b30ull, 0x2000000000ab5b75ull,
    0x1000000000000a56ull, 0x2000000000a56803ull, 0x2000000000a56910ull, 0x3000000a56893913ull,
    0x2000000000561621ull, 0x3000000803561621ull, 0x3000000950560620ull, 0x4000893953563623ull,
    0x2000000000a56b32ull, 0x3000000a56b82802ull, 0x3000000a56b32910ull, 0x4000a56b82892912ull,
    0x30000005616b1b31ull, 0x40005616b1b81801ull, 0x40009505606b0b30ull, 0x3000000b86896956ull,
    0x2000000000874a56ull, 0x3000000a56743403ull, 0x3000000874a56910ull, 0x4000a56743493913ull,
    0x3000000874561621ull, 0x4000743403561621ull, 0x4000874950560620ull, 0x5743493953563623ull,
    0x3000000874a56b32ull, 0x4000a56b72742402ull, 0x4000874a56b32910ull, 0x5a56b72742492912ull,
    0x40008745616b1b31ull, 0x55616b1b71741401ull, 0x58749505606b0b30ull, 0x4000b76746496956ull,
    0x2000000000a96946ull, 0x3000000a96946803ull, 0x30000004606a0a10ull, 0x40008434636a3a13ull,
    0x3000000941461621ull, 0x4000803941461621ull, 0x2000000000460620ull, 0x3000000843463623ull,
    0x3000000a96946b32ull, 0x4000a96946b82802ull, 0x4000b324606a0a10ull, 0x5b828424626a2a12ull,
    0x40009414616b1b31ull, 0x59414616b1b81801ull, 0x30000004606b0b30ull, 0x2000000000b86846ull,
    0x3000000a96986876ull, 0x40007636a3a93903ull, 0x40008707606a0a10ull, 0x30000007636a3a13ull,
    0x4000981871761621ull, 0x5901031371761621ull, 0x3000000870760620ull, 0x2000000000763623ull,
    0x4000a96986876b32ull, 0x5b727626a2a92902ull, 0x5b328707606a0a10ull, 0x4000b727626a2a12ull,
    0x59818717616b1b31ull, 0x2000000000b76901ull, 0x40008707606b0b30ull, 0x1000000000000b76ull,
    0x1000000000000b67ull, 0x2000000000b67803ull, 0x2000000000b67910ull, 0x3000000b67893913ull,
    0x2000000000b67a21ull, 0x3000000b67803a21ull, 0x3000000b679a0a20ull, 0x4000b678939a3a23ull,
    0x2000000000672732ull, 0x3000000672782802ull, 0x3000000672732910ull, 0x4000672782892912ull,
    0x3000000a61671731ull, 0x4000a61671781801ull, 0x40009a0a60670730ull, 0x30000008979a7a67ull,
    0x20000000008b4b64ull, 0x3000000b63643403ull, 0x30000008b4b64910ull, 0x4000b63643493913ull,
    0x30000008b4b64a21ull, 0x4000b63643403a21ull, 0x40008b4b649a0a20ull, 0x5b636434939a3a23ull,
    0x3000000642482832ull, 0x2000000000642402ull, 0x4000642482832910ull, 0x3000000642492912ull,
    0x4000a61641481831ull, 0x3000000a61641401ull, 0x59a0a60640480830ull, 0x20000000009a4a64ull,
    0x2000000000945b67ull, 0x3000000945b67803ull, 0x3000000b67450510ull, 0x4000b67843453513ull,
    0x3000000945b67a21ull, 0x4000945b67803a21ull, 0x4000b674505a0a20ull, 0x5b678434535a3a23ull,
    0x3000000945672732ull, 0x4000945672782802ull, 0x4000672732450510ull, 0x5672782842452512ull,
    0x4000945a61671731ull, 0x5945a61671781801ull, 0x54505a0a60670730ull, 0x40008474575a7a67ull,
    0x30000009858b5b65ull, 0x4000b63653593903ull, 0x40008b0b60650510ull, 0x3000000b63653513ull,
    0x40009858b5b65a21ull, 0x5b63653593903a21ull, 0x58b0b606505a0a20ull, 0x4000b636535a3a23ull,
    0x4000652592982832ull, 0x3000000652592902ull, 0x5830320260650510ull, 0x2000000000652512ull,
    0x5a61651591981831ull, 0x4000a61651591901ull, 0x2000000000a65830ull, 0x1000000000000a65ull,
    0x2000000000ba7a57ull, 0x3000000ba7a57803ull, 0x3000000ba7a57910ull, 0x4000ba7a57893913ull,
    0x30000005717b1b21ull, 0x40008035717b1b21ull, 0x40009505707b0b20ull, 0x58939535737b3b23ull,
    0x3000000a52572732ull, 0x4000a52572782802ull, 0x4000a52572732910ull, 0x5a52572782892912ull,
    0x2000000000571731ull, 0x3000000571781801ull, 0x3000000950570730ull, 0x2000000000897957ull,
    0x30000008b4ba4a54ull, 0x4000ba3a53543403ull, 0x40008b4ba4a54910ull, 0x5ba3a53543493913ull,
    0x40005414818b1b21ull, 0x55414010313b1b21ull, 0x59505404808b0b20ull, 0x2000000000954b23ull,
    0x4000a52542482832ull, 0x3000000a52542402ull, 0x5a52542482832910ull, 0x4000a52542492912ull,
    0x3000000541481831ull, 0x2000000000541401ull, 0x4000950540480830ull, 0x1000000000000954ull,
    0x3000000ba7a97947ull, 0x4000ba7a97947803ull, 0x40004707b0ba0a10ull, 0x58434737b3ba3a13ull,
    0x40009414717b1b21ull, 0x58039414717b1b21ull, 0x30000004707b0b20ull, 0x40008434737b3b23ull,
    0x4000a92942472732ull, 0x5a92942472782802ull, 0x54707303202a0a10ull, 0x2000000000847a12ull,
    0x3000000941471731ull, 0x4000941471781801ull, 0x2000000000470730ull, 0x1000000000000847ull,
    0x2000000000a9b98bull, 0x3000000ba3a93903ull, 0x30000008b0ba0a10ull, 0x2000000000ba3a13ull,
    0x30000009818b1b21ull, 0x40009010313b1b21ull, 0x20000000008b0b20ull, 0x1000000000000b23ull,
    0x3000000a92982832ull, 0x2000000000a92902ull, 0x40008303202a0a10ull, 0x1000000000000a12ull,
    0x2000000000981831ull, 0x1000000000000901ull, 0x1000000000000830ull, 0x0000000000000000ull,
};

// Lattice constants, each the float32 of the Python double that the plain
// version multiplies or adds.
struct EmitGrid {
  float cell[3];   // cfg.cell_size
  float half[3];   // cfg.{x,y,z}size / 2
  float scale;     // cfg.max_dist_neg
};

__device__ __forceinline__ float pick8(const float (&v)[8], int i) {
  float r = v[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) r = i == c ? v[c] : r;
  return r;
}

// Corner c's offset along axis a (PCL): x = (c&1)^((c>>1)&1), y = (c>>2)&1,
// z = (c>>1)&1.
__device__ __forceinline__ bool corner_bit(int c, int axis) {
  return axis == 0 ? ((c ^ (c >> 1)) & 1) : axis == 1 ? ((c >> 2) & 1) : ((c >> 1) & 1);
}

// Vertex on edge e (PCL numbering: 0-3 and 4-7 the two rings, 8-11 the
// risers) of the cube with values v and lower-corner centre ctr: _edge_points'
// p1 + mu * (p2 - p1), each corner at ctr + (0 or cell) per axis.
__device__ __forceinline__ void edge_vertex(int e, const float (&v)[8], const float (&ctr)[3],
                                            const EmitGrid& g, float (&p)[3]) {
  const int a = e < 8 ? e : e - 8;
  const int b = e < 8 ? ((e & 4) | ((e + 1) & 3)) : e - 4;
  const float v1 = pick8(v, a), v2 = pick8(v, b);
  const float denom = v2 - v1;
  const float mu = denom == 0.0f ? 0.5f : (0.0f - v1) / denom;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float p1 = ctr[x] + (corner_bit(a, x) ? g.cell[x] : 0.0f);
    const float p2 = ctr[x] + (corner_bit(b, x) ? g.cell[x] : 0.0f);
    p[x] = p1 + mu * (p2 - p1);
  }
}

// code = cubeindex * B^3 + voxel -> cubeindex and the voxel's (x, y, z)
template <int L>
__device__ __forceinline__ int decode(const Brick& br, int code, int (&l)[3]) {
  const int B = br.b;
  int cubeindex, voxel;
  if (L == kPow2) {
    cubeindex = code >> (3 * br.shift);
    voxel = code & (B * B * B - 1);
    l[0] = voxel >> (2 * br.shift);
    l[1] = (voxel >> br.shift) & (B - 1);
    l[2] = voxel & (B - 1);
  } else {
    cubeindex = code / (B * B * B);
    voxel = code - cubeindex * (B * B * B);
    const int q = voxel / B;
    l[2] = voxel - q * B;
    l[0] = q / B;
    l[1] = q - l[0] * B;
  }
  return cubeindex;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
emit_kernel(Brick br, const int* __restrict__ slots, const int* __restrict__ coords,
            const int* __restrict__ count, const int* __restrict__ cube,
            const float* __restrict__ corners, const int* __restrict__ tri_off,
            const float* __restrict__ transform, EmitGrid g,
            int tri_budget, float* __restrict__ verts, int* __restrict__ tri_cube) {
  const int NT = br.threads, B = br.b, V = B * B * B;
  __shared__ float m[12];
  __shared__ int warp_sum[kThreads / 32];
  extern __shared__ float st_v[];                            // [NT * kMaxTris * 9]
  int* st_c = reinterpret_cast<int*>(st_v + NT * kMaxTris * 9);  // [NT * kMaxTris]

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  // independent loads first: the count, the first chunk's codes (the cube
  // table is -1 from count on, so a code says whether its row is live), the
  // slot and the triangle offset
  const int n = count[k];
  int code = t < V ? cube[(size_t)k * V + t] : -1;
  const int slot = slots[k];
  int base = tri_off[k];
  if (n == 0 || base >= tri_budget) return;  // uniform across the block
  if (t < 12) m[t] = transform[t];
  const int b0[3] = {coords[3 * slot] * B, coords[3 * slot + 1] * B, coords[3 * slot + 2] * B};
  const int lane = t & 31, warp = t >> 5;

  for (int r0 = 0; r0 < n; r0 += NT) {
    const int r = r0 + t;  // past B^3 where NT does not divide it
    if (r0 > 0) code = r < V ? cube[(size_t)k * V + r] : -1;
    unsigned long long tri_row = 0ull;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    int l[3] = {0, 0, 0};
    if (code >= 0) {
      tri_row = __ldg(&kTriRows[decode<L>(br, code, l)]);
      const float4* src = reinterpret_cast<const float4*>(corners + ((size_t)k * V + r) * 8);
      lo = src[0];
      hi = src[1];
    }
    const int nt = (int)(tri_row >> 60);
    int incl = nt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int first = incl - nt, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int s = w < (NT >> 5) ? warp_sum[w] : 0;
      first += w < warp ? s : 0;
      total += s;
    }

    if (nt > 0) {
      const float v[8] = {lo.x * g.scale, lo.y * g.scale, lo.z * g.scale, lo.w * g.scale,
                          hi.x * g.scale, hi.y * g.scale, hi.z * g.scale, hi.w * g.scale};
      float ctr[3];  // voxel_center: (i + 0.5) * cell - size / 2
#pragma unroll
      for (int x = 0; x < 3; ++x) ctr[x] = ((float)(b0[x] + l[x]) + 0.5f) * g.cell[x] - g.half[x];
      const int ref = slot * V + (l[0] * B + l[1]) * B + l[2];
      for (int i = 0; i < nt; ++i) {
        float out[9];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float p[3];
          edge_vertex((int)((tri_row >> (12 * i + 4 * j)) & 15ull), v, ctr, g, p);
#pragma unroll
          for (int row = 0; row < 3; ++row)  // transform_points: m0*x + m1*y + m2*z + m3
            out[3 * j + row] = m[4 * row] * p[0] + m[4 * row + 1] * p[1] +
                               m[4 * row + 2] * p[2] + m[4 * row + 3];
        }
        float* dst = st_v + (first + i) * 9;
#pragma unroll
        for (int q = 0; q < 9; ++q) dst[q] = out[q];
        st_c[first + i] = ref;
      }
    }
    __syncthreads();
    const int keep = min(total, tri_budget - base);  // stored below the budget
    float* dv = verts + (size_t)base * 9;
    for (int f = t; f < keep * 9; f += NT) dv[f] = st_v[f];
    for (int f = t; f < keep; f += NT) tri_cube[base + f] = st_c[f];
    base += total;
    __syncthreads();  // the next chunk reuses warp_sum and the stage
    if (base >= tri_budget) break;  // uniform across the block
  }
}

// brick is the even brick size B; verts and tri_cube hold tri_budget
// triangles.
extern "C" int tsdf_mc_emit(const void* slots, const void* coords, const void* count,
                            const void* cube, const void* corners, const void* tri_off,
                            const void* transform, int n_slots, int brick, int tri_budget,
                            const float* grid, void* verts, void* tri_cube, void* stream) {
  if (brick < 2 || brick % 2) return (int)cudaErrorInvalidValue;
  if (n_slots > 0) {
    EmitGrid g;
    for (int x = 0; x < 3; ++x) {
      g.cell[x] = grid[x];
      g.half[x] = grid[3 + x];
    }
    g.scale = grid[6];
    Brick br;
    br.b = brick;
    br.shift = -1;
    for (int k = 0; k < 31; ++k)
      if ((1 << k) == brick) br.shift = k;
    const int V = brick * brick * brick;
    br.threads = V >= kThreads ? kThreads : (V > 32 ? 64 : 32);
    auto kernel = br.shift >= 0 ? emit_kernel<kPow2> : emit_kernel<kDiv>;
    // the stage: the triangles of one chunk at most
    const size_t stage = (size_t)br.threads * kMaxTris * 10 * 4;
    kernel<<<n_slots, br.threads, stage, (cudaStream_t)stream>>>(
        br, (const int*)slots, (const int*)coords, (const int*)count, (const int*)cube,
        (const float*)corners, (const int*)tri_off, (const float*)transform, g,
        tri_budget, (float*)verts, (int*)tri_cube);
  }
  return (int)cudaGetLastError();
}
