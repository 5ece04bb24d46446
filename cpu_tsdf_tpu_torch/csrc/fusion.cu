// Brick fusion kernel: one depth frame (and its color) fused into the brick
// volume, in place.
//
// Replaces cpu_tsdf_tpu/ops/pallas_fusion.py::_kernel_inplace together with
// the chunk chain around it (fuse_bricks_inplace, brick_meta,
// expand_extra_meta) and the XLA color transform after it. The contract is
// the plain engine, cpu_tsdf_tpu_torch/ops/fusion_kernel.py::
// fuse_bricks_plain (the JAX package's xla_update branch, bricks.py:531-559,
// ops/fusion.py:91-138 and ops/color.py::update_color).
//
// Launch: the rows' voxels are cut into groups of kVoxelsPerThread = 4
// consecutive voxels of one brick of B^3 (voxel order (lx*B+ly)*B+lz, the
// order of convert.soa_inner and the checkpoint layout), G = B^3 / 4 groups
// a row, and thread g of the launch takes group g mod G of row g / G, in
// blocks of kThreads. B is any even size, so B^3 is a multiple of 8 and a
// group never crosses a row: at B = 8 a block is one row (as the TPU
// kernel's grid step is), at B = 2 and 4 a block takes 64 and 8 rows so no
// thread idles, at B = 16 and 32 a row takes 8 and 64 blocks. Powers of two
// split a group index with shifts and masks; other B (6, 10, ...) divide
// once a thread (the voxels of a group follow by increments). A row is
// (bx, by, bz, slot); slot < 0 marks a row without a brick, whose threads
// write nothing (not even to the dump row C-1). Rows of one frame name
// distinct slots (band and carve lists are disjoint, the allocator hands
// out unique rows), so threads never write the same voxel.
//
// Bound: device memory. Each live row reads and writes its B^3 voxels of
// sdf/weight/M/nsample (32 B a voxel) and of color (nc floats a voxel each
// way) once; with 4 voxels a thread these are 16-byte loads and stores. The
// depth image (and rgb) is read by projection, which is a gather; it is
// 1.2 MB (3.7 MB) at 640x480 and stays in the 50 MB L2. So that a thread
// waits for memory once rather than three times, the pose is read once per
// block into shared memory, the state loads are issued before the
// projection, and the depth and rgb pixels are loaded together. The color
// update runs here, on the voxels the thread already holds, so nothing per
// voxel is written for a later pass. The TPU kernel's one-hot MXU lookup,
// its bf16 three-plane split, the row band, the column window and the
// multipass tiles all existed because a TPU core cannot gather from VMEM;
// here depth[v][u] is a plain load, so none of them is carried over, and
// there is no pass budget to overflow.
//
// Rounding: u = trunc(uf) picks a depth pixel, so one ulp in uf can move a
// voxel onto the neighbouring pixel and change d by the whole depth step
// between them. This file is compiled with --fmad=false and without
// --use_fast_math, every expression keeps the plain engine's operation
// order (transform = m0*x + m1*y + m2*z + m3 left to right, then
// x*fx/z + cx), and every constant comes in FusionParams as the float32
// rounding of the Python double the plain engine uses. Pixel indices then
// match the plain engine bit for bit, and weight and nsample exactly. The
// color transform keeps update_color's order as PyTorch's CUDA kernels
// evaluate it: tensor divisions are IEEE divisions; a tensor divided by a
// Python scalar is multiplied by the scalar's float32 reciprocal; ** is
// powf with the float32 exponent.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrors cpu_tsdf_tpu_torch/ops/fusion_kernel.py::FusionParams field for
// field (all 4-byte members, no padding).
struct FusionParams {
  float cell_x, cell_y, cell_z;        // cfg.xsize / cfg.xres
  float half_x, half_y, half_z;        // cfg.xsize / 2
  float coarse_x, coarse_y, coarse_z;  // cfg.xsize / 2^num_coarse_levels
  float fx, fy, pcx, pcy;
  float min_dist, max_dist;            // sensor range
  float max_dist_pos, max_dist_neg;    // truncation band
  float max_weight;
  float tan_h, tan_v;                  // 1.1x-FOV frustum slopes
  int xres, yres, zres;
  int n_coarse;
  int width, height;
  int frustum_culling, weight_by_depth, weight_by_variance;
  int color_mode;                      // kNone, kRGB, kRGBNormalized, kLAB
};

constexpr int kVoxelsPerThread = 4;  // one float4 / int4 of each state field
constexpr int kThreads = 128;

// How a group index splits into (row, voxel): by shifts and masks when B is
// a power of two, by division otherwise (the layout is a template
// parameter, chosen at launch, as in raycast.cu).
enum Layout : int { kPow2 = 0, kDiv = 1 };

struct Brick {
  int b;            // B
  int shift;        // log2(B) for kPow2
  int group_shift;  // log2(B^3 / 4) for kPow2
  int groups;       // B^3 / 4
};

enum ColorMode : int { kNone = 0, kRGB = 1, kRGBNormalized = 2, kLAB = 3 };

template <int CM>
struct Color {
  static constexpr int nc = CM == kNone ? 0 : (CM == kRGBNormalized ? 4 : 3);
};

// A Python float constant as PyTorch hands it to a float32 kernel.
#define F32(x) ((float)(x))

__device__ __forceinline__ int pixel_index(float f, int n) {
  // Clamp before the conversion: a voxel near the camera plane projects to
  // a huge coordinate, and the float->int conversion of an out-of-range
  // value differs between devices. trunc of the clamped value keeps the
  // validity rule 0 <= u < n, including u in (-1, 0) -> 0.
  f = fminf(fmaxf(f, -2.0f), (float)(n + 1));
  return (int)truncf(f);
}

// The projection of voxel (gx, gy, gz): its pixel, camera z, and whether
// the sensor range, the image and the coarse frustum admit it.
struct Projection {
  int pix;
  float vz;
  bool valid;
};

__device__ __forceinline__ Projection project(const FusionParams& p, const float* m,
                                              int gx, int gy, int gz) {
  const float cx = ((float)gx + 0.5f) * p.cell_x - p.half_x;
  const float cy = ((float)gy + 0.5f) * p.cell_y - p.half_y;
  const float cz = ((float)gz + 0.5f) * p.cell_z - p.half_z;
  const float vx = m[0] * cx + m[1] * cy + m[2] * cz + m[3];
  const float vy = m[4] * cx + m[5] * cy + m[6] * cz + m[7];
  const float vz = m[8] * cx + m[9] * cy + m[10] * cz + m[11];
  const int u = pixel_index(vx * p.fx / vz + p.pcx, p.width);
  const int v = pixel_index(vy * p.fy / vz + p.pcy, p.height);
  bool valid = vz >= p.min_dist && vz <= p.max_dist && vz > 0.0f &&
               u >= 0 && u < p.width && v >= 0 && v < p.height;
  if (p.frustum_culling) {
    // the coarse octree cell holding the voxel, tested by its centre
    // against the 1.1x-FOV frustum (tsdf_volume_octree.cpp:619-652)
    const float ccx = ((float)((gx * p.n_coarse) / p.xres) + 0.5f) * p.coarse_x - p.half_x;
    const float ccy = ((float)((gy * p.n_coarse) / p.yres) + 0.5f) * p.coarse_y - p.half_y;
    const float ccz = ((float)((gz * p.n_coarse) / p.zres) + 0.5f) * p.coarse_z - p.half_z;
    const float fx_ = m[0] * ccx + m[1] * ccy + m[2] * ccz + m[3];
    const float fy_ = m[4] * ccx + m[5] * ccy + m[6] * ccz + m[7];
    const float fz_ = m[8] * ccx + m[9] * ccy + m[10] * ccz + m[11];
    valid = valid && fz_ >= p.min_dist && fz_ <= p.max_dist &&
            fabsf(fx_) <= p.tan_h * fz_ && fabsf(fy_) <= p.tan_v * fz_;
  }
  return {valid ? v * p.width + u : 0, vz, valid};
}

// color_ops.rgb_to_lab's linearize (octree.cpp:436-481).
__device__ __forceinline__ float linearize(float c) {
  c = c * (1.0f / F32(255.0));
  const float lin = c > F32(0.0405) ? powf((c + F32(0.055)) * (1.0f / F32(1.055)), F32(2.4))
                                    : c * (1.0f / F32(12.92));
  return lin * F32(100.0);
}

__device__ __forceinline__ float lab_f(float t) {
  return t > F32(0.008856) ? powf(fabsf(t), F32(1.0 / 3.0))
                           : F32(7.787) * t + F32(16.0 / 116.0);
}

// update_color for one voxel that saw (r, g, b) with effective weight
// w_new, from pre-update weight w0; wsum = w0 + w_new > 0.
template <int CM>
__device__ __forceinline__ void update_color(float* c, float w0, float w_new, float wsum,
                                             float r, float g, float b) {
  if constexpr (CM == kRGB) {
    // uint8 truncation after every update (octree.cpp:333-335)
    c[0] = truncf((w0 * c[0] + w_new * r) / wsum);
    c[1] = truncf((w0 * c[1] + w_new * g) / wsum);
    c[2] = truncf((w0 * c[2] + w_new * b) / wsum);
  } else if constexpr (CM == kRGBNormalized) {
    // chromaticity + intensity (octree.cpp:379-393)
    const float i = sqrtf(r * r + g * g + b * b);
    const float obs[4] = {r / i, g / i, b / i, i};
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (w0 * c[k] + w_new * obs[k]) / wsum;
  } else if constexpr (CM == kLAB) {
    // average in CIELAB (octree.cpp:530-543)
    const float rf = linearize(r), gf = linearize(g), bf = linearize(b);
    const float X = (rf * F32(0.4124) + gf * F32(0.3576) + bf * F32(0.1805)) * (1.0f / F32(95.047));
    const float Y = (rf * F32(0.2126) + gf * F32(0.7152) + bf * F32(0.0722)) * (1.0f / F32(100.0));
    const float Z = (rf * F32(0.0193) + gf * F32(0.1192) + bf * F32(0.9505)) * (1.0f / F32(108.883));
    const float fx = lab_f(X), fy = lab_f(Y), fz = lab_f(Z);
    const float obs[3] = {F32(116.0) * fy - F32(16.0), F32(500.0) * (fx - fy),
                          F32(200.0) * (fy - fz)};
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = (w0 * c[k] + w_new * obs[k]) / wsum;
  }
}

// Whether the frame observes a voxel, from its projection and the loaded
// depth z alone (z is 0 where the projection failed): a reading, and no
// carving behind the band. It reads no state.
__device__ __forceinline__ bool observed(const FusionParams& p, const Projection& o, float z) {
  return o.valid && !isnan(z) && z - o.vz >= -p.max_dist_neg;
}

// One voxel's update from its projection and the loaded depth z and
// (r, g, b); returns whether the voxel was observed (and changed).
template <int CM>
__device__ __forceinline__ bool fuse_voxel(const FusionParams& p, const Projection& o,
                                           float z, float r, float g, float b, float& d,
                                           float& w, float& Mv, int& n, float* c) {
  const bool valid = observed(p, o, z);
  float d_new = z - o.vz;
  d_new = fminf(d_new, p.max_dist_pos) / p.max_dist_neg;
  float w_new = 1.0f;
  if (p.weight_by_depth) w_new = 1.0f - fminf(z / 10.0f, 1.0f);

  const float d0 = d, w0 = w, M0 = Mv;
  const int n0 = n;
  if (p.weight_by_variance && n0 > 5) {
    // the reference's n/(n-1) factor is integer division, i.e. 1
    const float var = M0 / (w0 > 0.0f ? w0 : 1.0f);
    w_new = w_new * expf(-((d_new - d0) * (d_new - d0)) / (2.0f * var));
  }
  if (!valid) return false;

  // weighted average, cap AFTER the average (octree.cpp:153-163); wsum == 0
  // keeps the old d
  const float wsum = w0 + w_new;
  const float d_upd = wsum > 0.0f ? (d0 * w0 + d_new * w_new) / wsum : d0;
  d = d_upd;
  // not fminf: a NaN gate (exp(-0/0) when M0 == 0 and d_new == d0) must
  // stay NaN, as in the plain engine's clamp and the reference
  w = wsum > p.max_weight ? p.max_weight : wsum;
  Mv = M0 + w_new * (d_new - d_upd) * (d_new - d0);
  n = n0 + 1;
  // a NaN gate leaves the color as it was, as does wsum == 0
  if (CM != kNone && w_new >= 0.0f && wsum > 0.0f) update_color<CM>(c, w0, w_new, wsum, r, g, b);
  return true;
}

template <int L, int CM>
__global__ void __launch_bounds__(kThreads)
fuse_kernel(FusionParams p, Brick br, long long n_groups, const int4* __restrict__ rows,
            const float* __restrict__ pose,  // pose_inv rows 0..2, 12 floats
            const float* __restrict__ depth, const float* __restrict__ rgb,
            float* __restrict__ sdf, float* __restrict__ weight,
            float* __restrict__ M, int* __restrict__ nsample,
            float* __restrict__ color) {
  constexpr int V = kVoxelsPerThread;
  constexpr int NC = Color<CM>::nc;
  constexpr int NCV = NC > 0 ? NC * V : 1;
  __shared__ float m[12];
  const int t = threadIdx.x;
  if (t < 12) m[t] = pose[t];
  const long long gid = (long long)blockIdx.x * kThreads + t;
  long long ri = 0;  // the row
  int gi = 0;        // the group within it
  if (L == kPow2) {
    ri = gid >> br.group_shift;
    gi = (int)(gid & (br.groups - 1));
  } else {
    ri = gid / br.groups;
    gi = (int)(gid - ri * br.groups);
  }
  int4 row = make_int4(0, 0, 0, -1);
  if (gid < n_groups) row = rows[ri];
  const bool live = row.w >= 0;
  const int v0 = gi * V;
  const size_t at = (size_t)row.w * (size_t)(br.groups * V) + v0;

  // the state first: it does not depend on the projection
  float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f), w4 = d4, m4 = d4;
  int4 n4 = make_int4(0, 0, 0, 0);
  float c[NCV];
  if (live) {
    d4 = *reinterpret_cast<const float4*>(sdf + at);
    w4 = *reinterpret_cast<const float4*>(weight + at);
    m4 = *reinterpret_cast<const float4*>(M + at);
    n4 = *reinterpret_cast<const int4*>(nsample + at);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float4 c4 = reinterpret_cast<const float4*>(color + at * NC)[k];
      c[4 * k] = c4.x; c[4 * k + 1] = c4.y; c[4 * k + 2] = c4.z; c[4 * k + 3] = c4.w;
    }
  }
  __syncthreads();  // the pose
  if (!live) return;
  float d[V] = {d4.x, d4.y, d4.z, d4.w}, w[V] = {w4.x, w4.y, w4.z, w4.w};
  float Mv[V] = {m4.x, m4.y, m4.z, m4.w};
  int n[V] = {n4.x, n4.y, n4.z, n4.w};

  // the group's first voxel (lx, ly, lz); the next ones follow in z, then
  // y, then x (at B = 2 and 6 a group crosses a z run)
  int lx, ly, lz;
  if (L == kPow2) {
    lx = v0 >> (2 * br.shift);
    ly = (v0 >> br.shift) & (br.b - 1);
    lz = v0 & (br.b - 1);
  } else {
    const int q = v0 / br.b;
    lz = v0 - q * br.b;
    lx = q / br.b;
    ly = q - lx * br.b;
  }
  Projection o[V];
  float z[V], r[V], g[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    o[k] = project(p, m, row.x * br.b + lx, row.y * br.b + ly, row.z * br.b + lz);
    if (++lz == br.b) {
      lz = 0;
      if (++ly == br.b) {
        ly = 0;
        ++lx;
      }
    }
  }
  // the depth and rgb pixels of all V voxels, loaded together
#pragma unroll
  for (int k = 0; k < V; ++k) {
    z[k] = o[k].valid ? depth[o[k].pix] : 0.0f;
    r[k] = g[k] = b[k] = 0.0f;
    if (NC > 0 && o[k].valid) {
      const float* px = rgb + 3 * o[k].pix;
      r[k] = px[0];
      g[k] = px[1];
      b[k] = px[2];
    }
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < V; ++k)
    any |= fuse_voxel<CM>(p, o[k], z[k], r[k], g[k], b[k], d[k], w[k], Mv[k], n[k],
                          c + (NC > 0 ? k * NC : 0));
  if (!any) return;

  *reinterpret_cast<float4*>(sdf + at) = make_float4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<float4*>(weight + at) = make_float4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<float4*>(M + at) = make_float4(Mv[0], Mv[1], Mv[2], Mv[3]);
  *reinterpret_cast<int4*>(nsample + at) = make_int4(n[0], n[1], n[2], n[3]);
#pragma unroll
  for (int k = 0; k < NC; ++k)
    reinterpret_cast<float4*>(color + at * NC)[k] =
        make_float4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
}

// color and rgb are null when color_mode is kNone. Every state pointer must
// be 16-byte aligned (read and written as float4 / int4); brick is the even
// brick size B.
extern "C" int tsdf_fuse_bricks(const FusionParams* params, const void* rows,
                                int n_rows, int brick, const void* pose,
                                const void* depth, const void* rgb, void* sdf,
                                void* weight, void* M, void* nsample, void* color,
                                void* stream) {
  if (n_rows > 0) {
    const FusionParams& p = *params;
    cudaStream_t s = (cudaStream_t)stream;
    Brick br;
    br.b = brick;
    br.groups = brick * brick * brick / kVoxelsPerThread;
    br.shift = br.group_shift = -1;
    for (int k = 0; k < 31; ++k) {
      if ((1 << k) == brick) br.shift = k;
      if ((1 << k) == br.groups) br.group_shift = k;
    }
    const long long n_groups = (long long)n_rows * br.groups;
    const unsigned n_blocks = (unsigned)((n_groups + kThreads - 1) / kThreads);
#define TSDF_FUSE(L, CM)                                                          \
  fuse_kernel<L, CM><<<n_blocks, kThreads, 0, s>>>(                               \
      p, br, n_groups, (const int4*)rows, (const float*)pose, (const float*)depth, \
      (const float*)rgb, (float*)sdf, (float*)weight, (float*)M, (int*)nsample,    \
      (float*)color)
#define TSDF_FUSE_LAYOUT(CM)                      \
  if (br.shift >= 0) TSDF_FUSE(kPow2, CM);        \
  else TSDF_FUSE(kDiv, CM)
    switch (p.color_mode) {
      case kRGB: TSDF_FUSE_LAYOUT(kRGB); break;
      case kRGBNormalized: TSDF_FUSE_LAYOUT(kRGBNormalized); break;
      case kLAB: TSDF_FUSE_LAYOUT(kLAB); break;
      default: TSDF_FUSE_LAYOUT(kNone); break;
    }
#undef TSDF_FUSE_LAYOUT
#undef TSDF_FUSE
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Dense fusion kernel: one depth frame (and its color) fused IN PLACE into
// the dense [nx, yres, zres] X-slab starting at plane x0.
//
// Replaces the JAX package's jitted dense integrate (cpu_tsdf_tpu/ops/
// fusion.py:141, jax.jit with the volume donated, donate_argnums=(0,)),
// which XLA fuses into a few loops over the grid; it is not a Pallas
// kernel. The contract is the plain version, cpu_tsdf_tpu_torch/ops/
// fusion.py::integrate_slab_plain, bit for bit. The per-voxel expression
// is the brick kernel's: project(), observed() and fuse_voxel<CM>() above
// (with update_color<CM>), so both fusions compile one expression, in the
// same operation order, under --fmad=false.
//
// Bound on this card: device memory, by a little. A frame observes ~0.1 %
// of the grid (128,978 of 512^3 voxels on the main path); their state and
// color, read and written once, and the images are ~12 MB (0.0036 ms at
// 3.35 TB/s). The voxels that could be observed at all (inside the pinhole
// frustum, within the sensor's range, in front of the frame's deepest
// reading plus the band: ~0.6 % of the grid) must also be projected and
// tested, ~77 float32 operations each (0.001 ms). A pass over every voxel
// (the design this replaces: 7.5 GB read and written, 2.24 ms), or even
// projecting every voxel (0.15 ms), is 40-600x that. What the kernel
// waits on in practice is latency: a group's depth gather, then its state.
//
// Design:
// 1. In place. The volume is donated, as in JAX: a voxel the frame does
//    not observe is neither read nor written.
// 2. Projection before any state access. A voxel's projection, range,
//    pixel and coarse frustum tests and depth gather come first; its state
//    (and the rgb pixel) is loaded only when observed() holds. Four voxels
//    that share a 16-byte vector are loaded and stored together if any of
//    them is observed (the others are written back as they were). The
//    variance gate reads only an observed voxel's state.
// 3. Each (x, y) column culled to its z-interval. Along a column the
//    camera-frame point is affine in the z index, p(z) = a + z b, so every
//    test that admits a voxel is a linear inequality in z: p_z within the
//    sensor range, p_z at most d_max + max_dist_neg (d_max the frame's
//    deepest reading: no voxel behind it passes d_new >= -max_dist_neg),
//    and the pixel tests multiplied out by p_z > 0 (u_f > -1 and u_f < W:
//    the C++ cast truncates toward zero). column_interval() intersects them
//    in double, each relaxed by a bound on the float32 rounding of the
//    per-voxel expression (and the pixel tests by kPixelSlack pixels),
//    rounds outwards and widens by one voxel each end. Inside the interval
//    the exact per-voxel test decides; the interval only culls. The plain
//    version of the cull is ops/fusion_kernel.py::dense_column_intervals.
// 4. Launch. Warp w of the n_warps = ceil(n_cols / 32) takes the 32
//    columns w, w + n_warps, w + 2 n_warps, ... (the layout is
//    (x*yres + y)*zres + z, so they lie 1/32 of the grid apart): long
//    columns cluster where the view runs along z, and spreading a warp's
//    columns over the grid evens out the warps' work. Each lane computes
//    one column's interval, a warp scan lays the columns' V-voxel groups
//    end to end, and the lanes walk them 32 at a time: a column's groups
//    go to neighbouring lanes, so the 16-byte accesses coalesce, and an
//    empty column costs its lane nothing past the interval. V = 4 when
//    zres is a multiple of 4 and every state pointer is 16-byte aligned,
//    else 1. Offsets are 64-bit: a 1024 x 1024 x 704 grid with color has
//    more than 2^31 color entries.
// 5. d_max comes from depth_max_kernel, launched first on the same stream
//    into a 4-byte buffer: no host sync. NaN readings are skipped; an
//    all-NaN frame gives -inf and every interval empty; a +inf reading
//    would observe every voxel in front of it, and lifts the far limit.
//    Its plain version is ops/fusion_kernel.py::depth_max. d_max computed
//    by torch instead (nan_to_num and amax, passed in as a device float)
//    made the wrapper 0.005 ms slower on an H100 80GB HBM3 at 700 W (0.0717
//    against 0.0663-0.0669 ms, chip_smoke.py phase 13), so the reduction
//    stays here. With col_range given, each column's interval is written there:
//    the card tests and chip_smoke.py read the cull back and hold it
//    against its plain version, dense_column_intervals, which takes
//    depth_max, column for column.

constexpr int kDenseThreads = 128;
constexpr int kDenseWarps = kDenseThreads / 32;
constexpr double kPixelSlack = 1.0;  // pixels added to each side of the image
constexpr double kRoundingSlack = 1e-5;  // of the transform's magnitude, in metres

// A float as an unsigned key whose order is the float order (NaN aside).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  if (k == 0u) return -INFINITY;  // no reading
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The largest reading of the depth image, NaN skipped (fmaxf drops NaN),
// as an order key atomically maxed into *key (zeroed before the launch).
__global__ void __launch_bounds__(256) depth_max_kernel(const float* __restrict__ depth, int n,
                                                        unsigned* __restrict__ key) {
  float acc = -INFINITY;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    acc = fmaxf(acc, depth[i]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  if ((threadIdx.x & 31) == 0) atomicMax(key, order_key(acc));
}

// {z : alpha + beta z >= 0} intersected into the real interval [lo, hi].
__device__ __forceinline__ void clip_ge(double alpha, double beta, double& lo, double& hi) {
  if (beta > 0.0) {
    lo = fmax(lo, -alpha / beta);
  } else if (beta < 0.0) {
    hi = fmin(hi, -alpha / beta);
  } else if (alpha < 0.0) {
    hi = -INFINITY;
  }
}

struct ZRange {
  int lo, hi;  // voxel indices, inclusive; empty when lo > hi
};

// The z-interval of column (gx, gy) that holds every voxel the frame can
// observe (see the design note, item 3). pose: pose_inv rows 0..2.
__device__ ZRange column_interval(const FusionParams& p, const float* m, int gx, int gy,
                                  float dmax) {
  if (!(dmax > -INFINITY)) return {1, 0};  // no reading in the frame
  // the column's cell centre as project() computes it (exact in double)
  const double cx = ((float)gx + 0.5f) * p.cell_x - p.half_x;
  const double cy = ((float)gy + 0.5f) * p.cell_y - p.half_y;
  const double cz0 = 0.5 * (double)p.cell_z - (double)p.half_z;  // plane z = 0
  const double hz = (double)p.half_z + (double)p.cell_z;
  double a[3], b[3], e[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double m0 = m[4 * i], m1 = m[4 * i + 1], m2 = m[4 * i + 2], m3 = m[4 * i + 3];
    a[i] = m0 * cx + m1 * cy + m2 * cz0 + m3;
    b[i] = m2 * (double)p.cell_z;
    // far above the float32 rounding of project()'s transform (a few ulp)
    e[i] = kRoundingSlack * (fabs(m0 * cx) + fabs(m1 * cy) + fabs(m2) * hz + fabs(m3)) + 1e-9;
  }
  double lo = 0.0, hi = (double)(p.zres - 1);
  const double z_near = (double)p.min_dist - e[2];
  clip_ge(a[2] - z_near, b[2], lo, hi);                             // p_z >= min_dist
  clip_ge((double)p.max_dist + e[2] - a[2], -b[2], lo, hi);       // p_z <= max_dist
  const double z_far = (double)dmax + (double)p.max_dist_neg;
  if (z_far < INFINITY)                                             // p_z <= d_max + neg
    clip_ge(z_far + 1e-6 * fabs(z_far) + e[2] - a[2], -b[2], lo, hi);
  // the pixel tests multiplied out by p_z, where p_z >= z_near > 0 and the
  // pixel's rounding error is well inside kPixelSlack
  const double W = p.width, H = p.height, fx = p.fx, fy = p.fy, pcx = p.pcx, pcy = p.pcy;
  const double err_u = (fabs(fx) * e[0] + (W + fabs(pcx) + 2.0) * e[2]) / z_near;
  const double err_v = (fabs(fy) * e[1] + (H + fabs(pcy) + 2.0) * e[2]) / z_near;
  if (z_near > 0.0 && err_u <= 0.5 * kPixelSlack && err_v <= 0.5 * kPixelSlack) {
    const double u_lo = pcx + 1.0 + kPixelSlack, u_hi = W + kPixelSlack - pcx;
    const double v_lo = pcy + 1.0 + kPixelSlack, v_hi = H + kPixelSlack - pcy;
    clip_ge(fx * a[0] + u_lo * a[2], fx * b[0] + u_lo * b[2], lo, hi);  // u_f > -1
    clip_ge(u_hi * a[2] - fx * a[0], u_hi * b[2] - fx * b[0], lo, hi);  // u_f < W
    clip_ge(fy * a[1] + v_lo * a[2], fy * b[1] + v_lo * b[2], lo, hi);  // v_f > -1
    clip_ge(v_hi * a[2] - fy * a[1], v_hi * b[2] - fy * b[1], lo, hi);  // v_f < H
  }
  if (!(lo <= hi)) return {1, 0};
  // lo and hi lie in [0, zres - 1] here: round outwards, one voxel more
  return {max((int)floor(lo) - 1, 0), min((int)ceil(hi) + 1, p.zres - 1)};
}

// The V voxels of column c (global x gx, y gy) from z = gz0: projected and
// tested first, their state loaded, fused and stored only when one of them
// is observed.
template <int V, int CM>
__device__ __forceinline__ void fuse_dense_group(
    const FusionParams& p, const float* m, long long c, int gx, int gy, int gz0,
    const float* __restrict__ depth, const float* __restrict__ rgb, float* __restrict__ sdf,
    float* __restrict__ weight, float* __restrict__ M, int* __restrict__ nsample,
    float* __restrict__ color) {
  constexpr int NC = Color<CM>::nc;
  constexpr int NCV = NC > 0 ? NC * V : 1;
  Projection o[V];
  float z[V];
  bool obs[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = project(p, m, gx, gy, gz0 + k);
#pragma unroll
  for (int k = 0; k < V; ++k) z[k] = o[k].valid ? depth[o[k].pix] : 0.0f;
  bool any = false;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    obs[k] = observed(p, o[k], z[k]);
    any |= obs[k];
  }
  if (!any) return;

  const long long i0 = c * p.zres + gz0;
  float r[V], g[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    r[k] = g[k] = b[k] = 0.0f;
    if (NC > 0 && obs[k]) {
      const float* px = rgb + 3 * o[k].pix;
      r[k] = px[0];
      g[k] = px[1];
      b[k] = px[2];
    }
  }
  float d[V], w[V], Mv[V], cl[NCV];
  int n[V];
  if constexpr (V == 4) {
    const float4 d4 = *reinterpret_cast<const float4*>(sdf + i0);
    const float4 w4 = *reinterpret_cast<const float4*>(weight + i0);
    const float4 m4 = *reinterpret_cast<const float4*>(M + i0);
    const int4 n4 = *reinterpret_cast<const int4*>(nsample + i0);
    d[0] = d4.x; d[1] = d4.y; d[2] = d4.z; d[3] = d4.w;
    w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
    Mv[0] = m4.x; Mv[1] = m4.y; Mv[2] = m4.z; Mv[3] = m4.w;
    n[0] = n4.x; n[1] = n4.y; n[2] = n4.z; n[3] = n4.w;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float4 c4 = reinterpret_cast<const float4*>(color + i0 * NC)[k];
      cl[4 * k] = c4.x; cl[4 * k + 1] = c4.y; cl[4 * k + 2] = c4.z; cl[4 * k + 3] = c4.w;
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      fuse_voxel<CM>(p, o[k], z[k], r[k], g[k], b[k], d[k], w[k], Mv[k], n[k],
                     cl + (NC > 0 ? k * NC : 0));
    *reinterpret_cast<float4*>(sdf + i0) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(weight + i0) = make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(M + i0) = make_float4(Mv[0], Mv[1], Mv[2], Mv[3]);
    *reinterpret_cast<int4*>(nsample + i0) = make_int4(n[0], n[1], n[2], n[3]);
#pragma unroll
    for (int k = 0; k < NC; ++k)
      reinterpret_cast<float4*>(color + i0 * NC)[k] =
          make_float4(cl[4 * k], cl[4 * k + 1], cl[4 * k + 2], cl[4 * k + 3]);
  } else {
    d[0] = sdf[i0];
    w[0] = weight[i0];
    Mv[0] = M[i0];
    n[0] = nsample[i0];
#pragma unroll
    for (int k = 0; k < NC; ++k) cl[k] = color[i0 * NC + k];
    fuse_voxel<CM>(p, o[0], z[0], r[0], g[0], b[0], d[0], w[0], Mv[0], n[0], cl);
    sdf[i0] = d[0];
    weight[i0] = w[0];
    M[i0] = Mv[0];
    nsample[i0] = n[0];
#pragma unroll
    for (int k = 0; k < NC; ++k) color[i0 * NC + k] = cl[k];
  }
}

template <int V, int CM>
__global__ void __launch_bounds__(kDenseThreads)
fuse_dense_kernel(FusionParams p, int x0, long long n_cols,
                  const float* __restrict__ pose,  // pose_inv rows 0..2, 12 floats
                  const unsigned* __restrict__ dmax_key, const float* __restrict__ depth,
                  const float* __restrict__ rgb, float* __restrict__ sdf,
                  float* __restrict__ weight, float* __restrict__ M,
                  int* __restrict__ nsample, float* __restrict__ color,
                  int* __restrict__ col_range) {
  __shared__ float m[12];
  __shared__ int ends[kDenseWarps][32];   // inclusive prefix sums of the groups
  __shared__ int first[kDenseWarps][32];  // each column's first group
  const int t = threadIdx.x, lane = t & 31, wi = t >> 5;
  if (t < 12) m[t] = pose[t];
  __syncthreads();  // the pose
  const float dmax = from_order_key(*dmax_key);
  const long long n_warps = (n_cols + 31) / 32;
  const long long w = (long long)blockIdx.x * kDenseWarps + wi;
  if (w >= n_warps) return;  // the whole warp

  const long long col = w + lane * n_warps;  // the lane's column
  int g_first = 0, count = 0;
  if (col < n_cols) {
    const int lx = (int)(col / p.yres);
    const ZRange zr = column_interval(p, m, x0 + lx, (int)(col - (long long)lx * p.yres), dmax);
    if (col_range != nullptr) {
      col_range[2 * col] = zr.lo;
      col_range[2 * col + 1] = zr.hi;
    }
    if (zr.lo <= zr.hi) {
      g_first = zr.lo / V;
      count = zr.hi / V - g_first + 1;
    }
  }
  int end = count;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, end, s);
    if (lane >= s) end += v;
  }
  ends[wi][lane] = end;
  first[wi][lane] = g_first;
  __syncwarp();
  const int total = __shfl_sync(0xffffffffu, end, 31);
  for (int item = lane; item < total; item += 32) {
    // the column j of the item: the number of columns whose groups end at
    // or before it
    int j = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      if (ends[wi][j + s - 1] <= item) j += s;
    const int g = first[wi][j] + item - (j > 0 ? ends[wi][j - 1] : 0);
    const long long c = w + j * n_warps;
    const int lx = (int)(c / p.yres);
    fuse_dense_group<V, CM>(p, m, c, x0 + lx, (int)(c - (long long)lx * p.yres), g * V, depth,
                            rgb, sdf, weight, M, nsample, color);
  }
}

static bool aligned16(const void* ptr) { return ptr == nullptr || (uintptr_t)ptr % 16 == 0; }

// The slab holds planes [x0, x0 + nx) of the params' xres x yres x zres
// grid; its state and color are updated in place. rgb and color are null
// when color_mode is kNone. dmax_key is a 4-byte device buffer for the
// frame's deepest reading (overwritten). col_range, int32 [nx * yres, 2] or
// null, receives each column's z-interval [lo, hi] (lo > hi where empty).
extern "C" int tsdf_fuse_dense(const FusionParams* params, int x0, int nx, const void* pose,
                               void* dmax_key, const void* depth, const void* rgb, void* sdf,
                               void* weight, void* M, void* nsample, void* color,
                               void* col_range, void* stream) {
  const FusionParams& p = *params;
  const long long n_cols = (long long)nx * p.yres;
  if (n_cols > 0 && p.zres > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(dmax_key, 0, sizeof(unsigned), s);
    if (err != cudaSuccess) return (int)err;
    const int n_pix = p.width * p.height;
    const int pix_blocks = n_pix > 256 * 132 ? 132 : (n_pix + 255) / 256 + (n_pix == 0);
    depth_max_kernel<<<pix_blocks, 256, 0, s>>>((const float*)depth, n_pix, (unsigned*)dmax_key);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const bool vec = p.zres % 4 == 0 && aligned16(sdf) && aligned16(weight) && aligned16(M) &&
                     aligned16(nsample) && aligned16(color);
    const long long n_warps = (n_cols + 31) / 32;
    const unsigned n_blocks = (unsigned)((n_warps + kDenseWarps - 1) / kDenseWarps);
#define TSDF_DENSE(V, CM)                                                                  \
  fuse_dense_kernel<V, CM><<<n_blocks, kDenseThreads, 0, s>>>(                              \
      p, x0, n_cols, (const float*)pose, (const unsigned*)dmax_key, (const float*)depth,    \
      (const float*)rgb, (float*)sdf, (float*)weight, (float*)M, (int*)nsample, (float*)color, \
      (int*)col_range)
#define TSDF_DENSE_VEC(CM)      \
  if (vec) TSDF_DENSE(4, CM);   \
  else TSDF_DENSE(1, CM)
    switch (p.color_mode) {
      case kRGB: TSDF_DENSE_VEC(kRGB); break;
      case kRGBNormalized: TSDF_DENSE_VEC(kRGBNormalized); break;
      case kLAB: TSDF_DENSE_VEC(kLAB); break;
      default: TSDF_DENSE_VEC(kNone); break;
    }
#undef TSDF_DENSE_VEC
#undef TSDF_DENSE
  }
  return (int)cudaGetLastError();
}
