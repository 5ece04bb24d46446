// Ray-march kernel: per-ray adaptive march, half-voxel backtrack, trilinear
// zero-crossing refinement and central-difference normals.
//
// Replaces cpu_tsdf_tpu/ops/pallas_raycast.py::_kernel (with the pair list,
// render tables and chunking around it: build_pairs, make_render_pack,
// raycast_pairs). The contract is the plain march,
// cpu_tsdf_tpu_torch/ops/raycast_kernel.py::march_plain, which is the JAX
// package's reference march ops/raycast.py::render_rays (cpp:318-419).
//
// Launch: one thread per ray, 128 threads a block. Where the rays form a
// camera image (ops/raycast_kernel.py::tile_width), each warp takes an 8x4
// pixel tile, else 32 neighbouring rays; either way a warp's rays stay close
// through the volume and mostly end alike (hit or miss). Each thread marches
// the reference recurrence on the global voxel grid and, for a found
// crossing, refines it and takes the normal itself; it writes its 8
// channels (t_bt, found, t*, valid, nvalid, nx, ny, nz) straight to the
// channel-major output, coalesced; no per-thread array, so nothing goes to
// local memory.
//
// Bound: not device memory. One view touches a few thousand bricks (about
// 8k live bricks x 2 KB = 16 MB at 512^3, plus the 1 MB brick map), which
// stay in the 50 MB L2, and the bytes bound is ~2 % of the kernel's time.
// The leading hypothesis, not confirmed by profiler counters (issue-slot
// use and active lanes were not measured): instruction issue, diluted by
// idle lanes. The evidence, on an H100 (PERF.md): taking the integer
// divisions out of the voxel lookup halved the SASS and cut the time 2.3x
// with the same loads; with the refinement and normals cut off the march
// keeps about two thirds of the time, and a warp issues until its longest
// ray ends. A sample costs three IEEE divisions for the voxel choice
// (kept: bit equality with the plain version) and the voxel lookup, so
// the lookup is made cheap:
//   * brick and offset by shift and mask when B is a power of two (B = 8 on
//     the main path, B = 4 in the card tests): no integer division in any
//     voxel lookup. A B that is not a power of two (possible only where the
//     resolution is not one, e.g. 96^3 with B = 6) takes the division path,
//     one division per axis and query; dense volumes (B = 0) index directly.
//     The layout is a template parameter, chosen at launch;
//   * the march keeps the last sample's brick and slot in registers and
//     reloads the brick map only when a sample enters another brick (inside
//     the band the step is ~1.5 mm against a 47 mm brick);
//   * a trilinear query looks up its base voxel's brick once and a
//     neighbour's slot only for the corners that cross a brick border.
// The refinement and normals (a third of the time) stay in the marching
// thread: a second launch over a list of the found rays, at 8 lanes a ray
// or at 1, and a persistent march that refills idle lanes were all slower
// on an H100 (PERF.md).
//
// The TPU kernel's machinery existed because a TPU core cannot gather from
// VMEM: the (brick, 32x32 tile) pair list and its sort, the pair-local march
// anchor, the haloed 16^3 int16 tables, the broadcast-row lookup scan, the
// per-call chunking and the r_budget / pair_budget overflow. A Hopper thread
// gathers directly, so none of it is carried over: the march runs on the
// global grid, on float32 values, with no budget to overflow.
//
// Rounding: the crossing test and the voxel choice compare floats, so the
// kernel must round as the plain version does. This file is compiled with
// --fmad=false and without --use_fast_math; each expression keeps the plain
// version's operation order (x = o + t*d; index = floor((x + size/2) /
// size * res); the trilinear terms ((d*wx)*wy)*wz summed in dx, dy, dz
// order); divisions are IEEE divisions, as the plain version's div_const;
// every constant comes in RaycastParams as the float32 rounding of the
// Python double that the plain version uses. Only integer indexing, load
// reuse and scheduling differ from the plain version, so the channels are
// bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrors cpu_tsdf_tpu_torch/ops/raycast_kernel.py::RaycastParams field for
// field (all 4-byte members, no padding).
struct RaycastParams {
  float size_x, size_y, size_z;              // cfg.xsize
  float half_x, half_y, half_z;              // cfg.xsize / 2
  float cell_x, cell_y, cell_z;              // cfg.xsize / cfg.xres
  float two_cell_x, two_cell_y, two_cell_z;  // 2 * cell
  float min_dist, max_dist;                  // sensor range
  float min_step;                            // max_dist_neg * 3 / 4
  float min_adaptive_step;                   // min(cell) / 4
  float mdn;                                 // max_dist_neg
  float half_cell;                           // cfg.zsize / cfg.zres / 2
  int xres, yres, zres;
  int brick;                                 // B; 0 = dense [X, Y, Z] layout
  int nbx, nby, nbz;
  int capacity;
  int max_steps, bt_max;
  int trilinear;                             // use_trilinear_interpolation
  int brick_shift;                           // log2(B) if B is a power of two, else -1
  int brick_mask;                            // B - 1
  int tile_width;                            // rays form rows this long: 8x4 warp tiles; 0 = none
  int relay_x_lo, relay_x_hi;                // relay march: the voxel x range of this slab
};

// The relay march (ops/raycast_kernel.py::march(relay=...)) splits a ray's
// phase-1 march between slabs of the volume held by different ranks: a
// thread starts from the ray's state and suspends it at the first sample
// inside the volume but outside [relay_x_lo, relay_x_hi), so the next slab's
// owner resumes exactly where this one stopped. The state rows, [8, n]:
enum RelayRow : int {
  kRelayT = 0, kRelayStep, kRelayLastD, kRelayLastW, kRelayHit, kRelayIter,
  kRelaySuspended,   // 1: suspended at a sample outside the slab; 0: done here
  kRelayIx,          // the voxel x index of that sample
  kRelayRows
};

// One ray's phase-1 state: the march's loop variables.
struct MarchState {
  float t, step, last_d, last_w;
  bool hit;
  int it;
  bool suspended;
  int ix;
};

constexpr int kThreads = 128;

enum Layout : int { kDense = 0, kPow2 = 1, kDiv = 2 };

// The brick (and slot) of the last voxel a thread looked up.
struct BrickCache {
  int bx = -1, by = -1, bz = -1, slot = -1;
};

template <int L>
struct Volume {
  RaycastParams p;
  const float* __restrict__ rd;
  const int* __restrict__ bmap;

  __device__ __forceinline__ int brick_of(int i) const {
    return L == kPow2 ? i >> p.brick_shift : i / p.brick;
  }
  __device__ __forceinline__ int local_of(int i, int b) const {
    return L == kPow2 ? i & p.brick_mask : i - b * p.brick;
  }
  __device__ __forceinline__ int slot_of(int bx, int by, int bz) const {
    return __ldg(bmap + (bx * p.nby + by) * p.nbz + bz);
  }
  // The packed value at offset (lx, ly, lz) of the brick in `slot`; an
  // unallocated brick (slot < 0) is unobserved, NaN.
  __device__ __forceinline__ float in_brick(int slot, int lx, int ly, int lz) const {
    if (slot < 0) return nanf("");
    const size_t s = (size_t)min(slot, p.capacity - 1);
    if (L == kPow2) {
      const int sh = p.brick_shift;
      return __ldg(rd + (s << (3 * sh)) + ((((lx << sh) | ly) << sh) | lz));
    }
    const int B = p.brick;
    return __ldg(rd + s * (size_t)(B * B * B) + (lx * B + ly) * B + lz);
  }
  __device__ __forceinline__ float dense(int ix, int iy, int iz) const {
    return __ldg(rd + ((size_t)ix * p.yres + iy) * p.zres + iz);
  }

  // The packed value at voxel indices clipped to the grid (gather_dw),
  // through the brick cache c.
  __device__ __forceinline__ float at(int ix, int iy, int iz, BrickCache& c) const {
    ix = min(max(ix, 0), p.xres - 1);
    iy = min(max(iy, 0), p.yres - 1);
    iz = min(max(iz, 0), p.zres - 1);
    if (L == kDense) return dense(ix, iy, iz);
    const int bx = brick_of(ix), by = brick_of(iy), bz = brick_of(iz);
    if (bx != c.bx || by != c.by || bz != c.bz) {
      c.bx = bx;
      c.by = by;
      c.bz = bz;
      c.slot = slot_of(bx, by, bz);
    }
    return in_brick(c.slot, local_of(ix, bx), local_of(iy, by), local_of(iz, bz));
  }

  __device__ __forceinline__ int index(float x, float half, float size, int res) const {
    return (int)floorf((x + half) / size * (float)res);
  }

  __device__ __forceinline__ bool inside(float x, float y, float z) const {
    return !isnan(z) && fabsf(x) <= p.half_x && fabsf(y) <= p.half_y &&
           fabsf(z) <= p.half_z;
  }

  // Nearest-voxel (d, w, inside) at a point: the march's sample.
  __device__ __forceinline__ void sample(float x, float y, float z, BrickCache& c,
                                         float& d, float& w, bool& in) const {
    const float r = at(index(x, p.half_x, p.size_x, p.xres),
                       index(y, p.half_y, p.size_y, p.yres),
                       index(z, p.half_z, p.size_z, p.zres), c);
    const bool obs = !isnan(r);
    d = obs ? r : -1.0f;
    w = obs ? 1.0f : 0.0f;
    in = inside(x, y, z);
  }

  // tsdf_value_vol: trilinear (the un-adjusted-index validity quirk of
  // interpolate.py:23-47) or nearest, as the config says. c is read, not
  // updated: the march's brick serves the base corner when it matches.
  __device__ __forceinline__ float value(float x, float y, float z, const BrickCache& c,
                                         bool& valid) const {
    int ix = index(x, p.half_x, p.size_x, p.xres);
    int iy = index(y, p.half_y, p.size_y, p.yres);
    int iz = index(z, p.half_z, p.size_z, p.zres);
    const bool exists = ix >= 0 && iy >= 0 && iz >= 0 && ix < p.xres &&
                        iy < p.yres && iz < p.zres;
    if (!p.trilinear) {
      BrickCache own = c;
      const float r = at(ix, iy, iz, own);
      valid = exists && !isnan(r);
      return isnan(r) ? -1.0f : r;
    }
    valid = exists && ix > 0 && ix < p.xres - 1 && iy > 0 && iy < p.yres - 1 &&
            iz > 0 && iz < p.zres - 1;
    // step back along axes where the point lies below the voxel centre
    if (x < ((float)ix + 0.5f) * p.cell_x - p.half_x) ix -= 1;
    if (y < ((float)iy + 0.5f) * p.cell_y - p.half_y) iy -= 1;
    if (z < ((float)iz + 0.5f) * p.cell_z - p.half_z) iz -= 1;
    // base corner in [0, res-2]: every corner is inside the grid
    ix = min(max(ix, 0), p.xres - 2);
    iy = min(max(iy, 0), p.yres - 2);
    iz = min(max(iz, 0), p.zres - 2);
    const float a = (x - (((float)ix + 0.5f) * p.cell_x - p.half_x)) * (float)p.xres / p.size_x;
    const float b = (y - (((float)iy + 0.5f) * p.cell_y - p.half_y)) * (float)p.yres / p.size_y;
    const float cc = (z - (((float)iz + 0.5f) * p.cell_z - p.half_z)) * (float)p.zres / p.size_z;
    int bx = 0, by = 0, bz = 0, lx = 0, ly = 0, lz = 0, s0 = -1;
    if (L != kDense) {
      bx = brick_of(ix);
      by = brick_of(iy);
      bz = brick_of(iz);
      lx = local_of(ix, bx);
      ly = local_of(iy, by);
      lz = local_of(iz, bz);
      s0 = (bx == c.bx && by == c.by && bz == c.bz) ? c.slot : slot_of(bx, by, bz);
    }
    const int last = p.brick - 1;
    float val = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      float r;
      if (L == kDense) {
        r = dense(ix + dx, iy + dy, iz + dz);
      } else {
        // a +1 corner on the brick's last plane lies in the next brick
        const int sx = dx && lx == last, sy = dy && ly == last, sz = dz && lz == last;
        const int slot = (sx | sy | sz) ? slot_of(bx + sx, by + sy, bz + sz) : s0;
        r = in_brick(slot, sx ? 0 : lx + dx, sy ? 0 : ly + dy, sz ? 0 : lz + dz);
      }
      valid = valid && !isnan(r);
      const float term = (isnan(r) ? -1.0f : r) * (dx ? a : 1.0f - a) *
                         (dy ? b : 1.0f - b) * (dz ? cc : 1.0f - cc);
      val = k == 0 ? term : val + term;
    }
    return val;
  }

  // The point of the q-th normal query around the hit (hx, hy, hz): -x, +x,
  // -y, +y, -z, +z one cell away.
  __device__ __forceinline__ void normal_point(int q, float hx, float hy, float hz,
                                               float& x, float& y, float& z) const {
    x = hx;
    y = hy;
    z = hz;
    if (q == 0) x = hx - p.cell_x;
    else if (q == 1) x = hx + p.cell_x;
    else if (q == 2) y = hy - p.cell_y;
    else if (q == 3) y = hy + p.cell_y;
    else if (q == 4) z = hz - p.cell_z;
    else z = hz + p.cell_z;
  }

  // Adaptive march (cpp:318-371) and, where it found a crossing, the
  // half-voxel backtrack (cpp:329-354) of one ray from state s; t ends as
  // t_bt. With R (the relay march), a sample inside the volume but outside
  // the slab suspends the ray: s then holds the state at that sample.
  template <bool R>
  __device__ __forceinline__ void march(float ox, float oy, float oz, float dx, float dy,
                                        float dz, BrickCache& c, float& t, bool& found,
                                        MarchState& s) const {
    float step = s.step, last_d = s.last_d, last_w = s.last_w;
    bool hit_voxel = s.hit, done = false;
    t = s.t;
    found = false;
    s.suspended = false;
    for (int it = s.it; it < p.max_steps && !done; ++it) {
      const float x = ox + t * dx, y = oy + t * dy, z = oz + t * dz;
      if (R) {
        const int ix = index(x, p.half_x, p.size_x, p.xres);
        if (inside(x, y, z) && (ix < p.relay_x_lo || ix >= p.relay_x_hi)) {
          s = MarchState{t, step, last_d, last_w, hit_voxel, it, true, ix};
          return;
        }
      }
      float d, w;
      bool in;
      sample(x, y, z, c, d, w, in);
      const bool crossing = in && ((d < 0.0f && last_d > 0.0f) || (d > 0.0f && last_d < 0.0f)) &&
                            last_w != 0.0f && w != 0.0f;
      // leaving the volume after having been inside ends the ray (cpp:363-367)
      const bool exit_ray = !in && hit_voxel;
      if (in && !crossing) {
        last_d = d;
        last_w = w;
        step = fmaxf(fabsf(d) * p.mdn, p.min_adaptive_step);
      }
      hit_voxel = hit_voxel || in;
      found = crossing;
      if (!crossing && !exit_ray) t = t + step;
      done = crossing || exit_ray || t >= p.max_dist;
    }
    if (!found) return;
    const float old_t = t - step;
    for (int it = 0; it < p.bt_max; ++it) {
      if (t < old_t) break;
      const float t_new = t - p.half_cell;
      float d, w;
      bool in;
      sample(ox + t_new * dx, oy + t_new * dy, oz + t_new * dz, c, d, w, in);
      if (!in) {
        t = t_new;
        break;
      }
      if ((last_d > 0.0f && d > 0.0f) || (last_d < 0.0f && d < 0.0f)) {
        last_d = d;  // the pre-crossing sample; t stays (the step is re-added)
        break;
      }
      t = t_new;
    }
  }

  // Refinement and normals of a found ray (cpp:378-419): channels 2..7.
  __device__ __forceinline__ void tail(const BrickCache& c, float ox, float oy, float oz,
                                       float dx, float dy, float dz, float t, int i,
                                       int n, float* __restrict__ out) const {
    const float t_prev = t - p.half_cell;
    bool valid_prev, valid_curr;
    const float last_tri = value(ox + t_prev * dx, oy + t_prev * dy, oz + t_prev * dz, c,
                                 valid_prev);
    const float d_tri = value(ox + t * dx, oy + t * dy, oz + t * dz, c, valid_curr);
    const bool valid = valid_prev && valid_curr && !isnan(d_tri) && !isnan(last_tri);
    float denom = last_tri - d_tri;
    if (denom == 0.0f) denom = 1e-20f;
    const float t_star = t + p.half_cell * (-1.0f + fabsf(last_tri / denom));
    out[2 * (size_t)n + i] = t_star;
    out[3 * (size_t)n + i] = valid ? 1.0f : 0.0f;
    float nvf = 0.0f, nxo = 0.0f, nyo = 0.0f, nzo = 0.0f;
    if (valid) {
      const float hx = ox + t_star * dx, hy = oy + t_star * dy, hz = oz + t_star * dz;
      bool nvalid = inside(hx, hy, hz);
      float v[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        float x, y, z;
        bool ok;
        normal_point(q, hx, hy, hz, x, y, z);
        v[q] = value(x, y, z, c, ok);
        nvalid = nvalid && ok;
      }
      const float nx = (v[1] - v[0]) * p.mdn / p.two_cell_x;
      const float ny = (v[3] - v[2]) * p.mdn / p.two_cell_y;
      const float nz = (v[5] - v[4]) * p.mdn / p.two_cell_z;
      float nn = sqrtf(nx * nx + ny * ny + nz * nz);
      if (nn == 0.0f) nn = 1.0f;
      nvf = nvalid ? 1.0f : 0.0f;
      nxo = nx / nn;
      nyo = ny / nn;
      nzo = nz / nn;
    }
    out[4 * (size_t)n + i] = nvf;
    out[5 * (size_t)n + i] = nxo;
    out[6 * (size_t)n + i] = nyo;
    out[7 * (size_t)n + i] = nzo;
  }
};

// The ray of thread k of the grid: pixel order, or, with tile_width > 0 and
// a 2-D grid of blocks of 4 warps, one 8x4 pixel tile a warp (32x4 pixels a
// block), so that a warp's rays stay together in both image directions.
__device__ __forceinline__ int ray_of_thread(const RaycastParams& p) {
  if (p.tile_width == 0) return blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (blockIdx.y * 4 + (lane >> 3)) * p.tile_width + blockIdx.x * 32 + warp * 8 +
         (lane & 7);
}

template <int L, bool R>
__global__ void __launch_bounds__(kThreads)
raycast_kernel(RaycastParams params, const float* __restrict__ rd,
               const int* __restrict__ bmap, const float* __restrict__ origins,
               const float* __restrict__ dirs, int n_rays, float* __restrict__ out,
               float* __restrict__ relay) {
  const int i = ray_of_thread(params);
  if (i >= n_rays) return;
  const Volume<L> vol{params, rd, bmap};
  const float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  const size_t n = n_rays;
  MarchState s{params.min_dist, params.min_step, 0.0f, 0.0f, false, 0, false, 0};
  if (R) {
    s = MarchState{relay[kRelayT * n + i], relay[kRelayStep * n + i],
                   relay[kRelayLastD * n + i], relay[kRelayLastW * n + i],
                   relay[kRelayHit * n + i] != 0.0f, (int)relay[kRelayIter * n + i], false, 0};
  }
  BrickCache cache;
  float t;
  bool found;
  vol.template march<R>(ox, oy, oz, dx, dy, dz, cache, t, found, s);
  if (R) {
    relay[kRelayT * n + i] = s.t;
    relay[kRelayStep * n + i] = s.step;
    relay[kRelayLastD * n + i] = s.last_d;
    relay[kRelayLastW * n + i] = s.last_w;
    relay[kRelayHit * n + i] = s.hit ? 1.0f : 0.0f;
    relay[kRelayIter * n + i] = (float)s.it;
    relay[kRelaySuspended * n + i] = s.suspended ? 1.0f : 0.0f;
    relay[kRelayIx * n + i] = (float)s.ix;
  }
  out[i] = t;
  out[n + i] = found ? 1.0f : 0.0f;
  if (found) {
    vol.tail(cache, ox, oy, oz, dx, dy, dz, t, i, n_rays, out);
  } else {
#pragma unroll
    for (int ch = 2; ch < 8; ++ch) out[ch * n + i] = 0.0f;
  }
}

// The grid: one thread a ray; with tile_width (a multiple of 32 whose rows
// come in groups of 4) blocks of 32x4 pixels.
static dim3 raycast_grid(const RaycastParams& p, int n) {
  if (p.tile_width > 0) return dim3(p.tile_width / 32, n / p.tile_width / 4);
  return dim3((n + kThreads - 1) / kThreads);
}

// relay: null for the whole march, else the [8, n] relay state, read and
// written in place.
extern "C" int tsdf_raycast(const RaycastParams* params, const void* rd,
                            const void* brick_map, const void* origins,
                            const void* dirs, int n_rays, void* out, void* relay,
                            void* stream) {
  if (n_rays > 0) {
    const RaycastParams& p = *params;
    const dim3 grid = raycast_grid(p, n_rays);
    cudaStream_t st = (cudaStream_t)stream;
#define TSDF_RAYCAST(L, R)                                                         \
  raycast_kernel<L, R><<<grid, kThreads, 0, st>>>(                                 \
      p, (const float*)rd, (const int*)brick_map, (const float*)origins,           \
      (const float*)dirs, n_rays, (float*)out, (float*)relay)
    if (relay == nullptr) {
      if (p.brick == 0) TSDF_RAYCAST(kDense, false);
      else if (p.brick_shift >= 0) TSDF_RAYCAST(kPow2, false);
      else TSDF_RAYCAST(kDiv, false);
    } else {
      if (p.brick == 0) TSDF_RAYCAST(kDense, true);
      else if (p.brick_shift >= 0) TSDF_RAYCAST(kPow2, true);
      else TSDF_RAYCAST(kDiv, true);
    }
#undef TSDF_RAYCAST
  }
  return (int)cudaGetLastError();
}
