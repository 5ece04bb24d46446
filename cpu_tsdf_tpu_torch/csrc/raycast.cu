// Ray-march kernel: per-ray adaptive march, half-voxel backtrack, trilinear
// zero-crossing refinement and central-difference normals.
//
// Replaces cpu_tsdf_tpu/ops/pallas_raycast.py::_kernel (with the pair list,
// render tables and chunking around it: build_pairs, make_render_pack,
// raycast_pairs). The contract is the plain march,
// cpu_tsdf_tpu_torch/ops/raycast_kernel.py::march_plain, which is the JAX
// package's reference march ops/raycast.py::render_rays (cpp:318-419).
//
// Launch: one thread per ray, rays in pixel order, 128 threads a block, so
// a warp holds 32 neighbouring pixels of one image row whose rays stay
// close through the volume. Each thread marches the reference recurrence on
// the global voxel grid and writes 8 channels (t_bt, found, t*, valid,
// nvalid, nx, ny, nz), channel-major, so the stores are coalesced.
//
// Bound: device memory, and in practice the latency of dependent gathers.
// Every step is a brick-map load followed by a load from the brick's row of
// the packed render view (NaN = unobserved, bricks.py:730-778); a dense
// volume is one load. The rays of one view touch a few thousand bricks
// (about 8k live bricks x 2 KB = 16 MB at 512^3, plus the 1 MB brick map),
// which stays in the 50 MB L2 across the march. The TPU kernel's machinery
// existed because a TPU core cannot gather from VMEM: the (brick, 32x32
// tile) pair list and its sort, the pair-local march anchor, the haloed
// 16^3 int16 tables, the broadcast-row lookup scan, the per-call chunking
// and the r_budget / pair_budget overflow. A Hopper thread gathers
// directly, so none of it is carried over: the march runs on the global
// grid, on float32 values, with no budget to overflow.
//
// Rounding: the crossing test and the voxel choice compare floats, so the
// kernel must round as the plain version does. This file is compiled with
// --fmad=false and without --use_fast_math; each expression keeps the plain
// version's operation order (x = o + t*d; index = floor((x + size/2) /
// size * res); the trilinear terms ((d*wx)*wy)*wz summed in dx, dy, dz
// order); divisions are IEEE divisions, as the plain version's div_const;
// every constant comes in RaycastParams as the float32 rounding of the
// Python double that the plain version uses.

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
};

constexpr int kThreads = 128;
constexpr int kChannels = 8;

struct Volume {
  RaycastParams p;
  const float* __restrict__ rd;
  const int* __restrict__ bmap;

  // The packed value at voxel indices clipped to the grid (gather_dw);
  // NaN = unobserved, and an unallocated brick is unobserved.
  __device__ __forceinline__ float at(int ix, int iy, int iz) const {
    ix = min(max(ix, 0), p.xres - 1);
    iy = min(max(iy, 0), p.yres - 1);
    iz = min(max(iz, 0), p.zres - 1);
    if (p.brick == 0) return __ldg(rd + ((size_t)ix * p.yres + iy) * p.zres + iz);
    const int B = p.brick;
    const int slot = __ldg(bmap + ((ix / B) * p.nby + iy / B) * p.nbz + iz / B);
    if (slot < 0) return nanf("");
    const size_t row = (size_t)min(slot, p.capacity - 1) * (B * B * B);
    return __ldg(rd + row + ((ix % B) * B + iy % B) * B + iz % B);
  }

  __device__ __forceinline__ int index(float x, float half, float size, int res) const {
    return (int)floorf((x + half) / size * (float)res);
  }

  __device__ __forceinline__ bool inside(float x, float y, float z) const {
    return !isnan(z) && fabsf(x) <= p.half_x && fabsf(y) <= p.half_y &&
           fabsf(z) <= p.half_z;
  }

  // Nearest-voxel (d, w, inside) at a point: the march's sample.
  __device__ __forceinline__ void sample(float x, float y, float z, float& d,
                                         float& w, bool& in) const {
    const float r = at(index(x, p.half_x, p.size_x, p.xres),
                       index(y, p.half_y, p.size_y, p.yres),
                       index(z, p.half_z, p.size_z, p.zres));
    const bool obs = !isnan(r);
    d = obs ? r : -1.0f;
    w = obs ? 1.0f : 0.0f;
    in = inside(x, y, z);
  }

  // tsdf_value_vol: trilinear (the un-adjusted-index validity quirk of
  // interpolate.py:23-47) or nearest, as the config says.
  __device__ __forceinline__ float value(float x, float y, float z, bool& valid) const {
    int ix = index(x, p.half_x, p.size_x, p.xres);
    int iy = index(y, p.half_y, p.size_y, p.yres);
    int iz = index(z, p.half_z, p.size_z, p.zres);
    const bool exists = ix >= 0 && iy >= 0 && iz >= 0 && ix < p.xres &&
                        iy < p.yres && iz < p.zres;
    if (!p.trilinear) {
      const float r = at(ix, iy, iz);
      valid = exists && !isnan(r);
      return isnan(r) ? -1.0f : r;
    }
    valid = exists && ix > 0 && ix < p.xres - 1 && iy > 0 && iy < p.yres - 1 &&
            iz > 0 && iz < p.zres - 1;
    // step back along axes where the point lies below the voxel centre
    if (x < ((float)ix + 0.5f) * p.cell_x - p.half_x) ix -= 1;
    if (y < ((float)iy + 0.5f) * p.cell_y - p.half_y) iy -= 1;
    if (z < ((float)iz + 0.5f) * p.cell_z - p.half_z) iz -= 1;
    ix = min(max(ix, 0), p.xres - 2);
    iy = min(max(iy, 0), p.yres - 2);
    iz = min(max(iz, 0), p.zres - 2);
    const float a = (x - (((float)ix + 0.5f) * p.cell_x - p.half_x)) * (float)p.xres / p.size_x;
    const float b = (y - (((float)iy + 0.5f) * p.cell_y - p.half_y)) * (float)p.yres / p.size_y;
    const float c = (z - (((float)iz + 0.5f) * p.cell_z - p.half_z)) * (float)p.zres / p.size_z;
    float val = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      const float r = at(ix + dx, iy + dy, iz + dz);
      valid = valid && !isnan(r);
      const float term = (isnan(r) ? -1.0f : r) * (dx ? a : 1.0f - a) *
                         (dy ? b : 1.0f - b) * (dz ? c : 1.0f - c);
      val = k == 0 ? term : val + term;
    }
    return val;
  }
};

__global__ void __launch_bounds__(kThreads)
raycast_kernel(RaycastParams params, const float* __restrict__ rd,
               const int* __restrict__ bmap, const float* __restrict__ origins,
               const float* __restrict__ dirs, int n_rays, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const Volume vol{params, rd, bmap};
  const RaycastParams& p = vol.p;
  const float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];

  // ---- phase 1: adaptive march (cpp:318-371) ----
  float t = p.min_dist, step = p.min_step, last_d = 0.0f, last_w = 0.0f;
  bool hit_voxel = false, found = false, done = false;
  for (int it = 0; it < p.max_steps && !done; ++it) {
    float d, w;
    bool in;
    vol.sample(ox + t * dx, oy + t * dy, oz + t * dz, d, w, in);
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

  float ch[kChannels] = {t, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (found) {
    // ---- phase 2: half-voxel backtrack (cpp:329-354) ----
    const float old_t = t - step;
    for (int it = 0; it < p.bt_max; ++it) {
      if (t < old_t) break;
      const float t_new = t - p.half_cell;
      float d, w;
      bool in;
      vol.sample(ox + t_new * dx, oy + t_new * dy, oz + t_new * dz, d, w, in);
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

    // ---- phase 3: trilinear refinement (cpp:378-390) ----
    const float t_prev = t - p.half_cell;
    bool valid_prev, valid_curr;
    const float last_tri = vol.value(ox + t_prev * dx, oy + t_prev * dy, oz + t_prev * dz,
                                     valid_prev);
    const float d_tri = vol.value(ox + t * dx, oy + t * dy, oz + t * dz, valid_curr);
    const bool valid = valid_prev && valid_curr && !isnan(d_tri) && !isnan(last_tri);
    float denom = last_tri - d_tri;
    if (denom == 0.0f) denom = 1e-20f;
    const float t_star = t + p.half_cell * (-1.0f + fabsf(last_tri / denom));
    ch[0] = t;
    ch[1] = 1.0f;
    ch[2] = t_star;
    ch[3] = valid ? 1.0f : 0.0f;

    if (valid) {
      // ---- normals: central differences at +-1 cell (cpp:398-419) ----
      const float hx = ox + t_star * dx, hy = oy + t_star * dy, hz = oz + t_star * dz;
      bool nvalid = vol.inside(hx, hy, hz), ok;
      const float d_xm = vol.value(hx - p.cell_x, hy, hz, ok); nvalid = nvalid && ok;
      const float d_xp = vol.value(hx + p.cell_x, hy, hz, ok); nvalid = nvalid && ok;
      const float d_ym = vol.value(hx, hy - p.cell_y, hz, ok); nvalid = nvalid && ok;
      const float d_yp = vol.value(hx, hy + p.cell_y, hz, ok); nvalid = nvalid && ok;
      const float d_zm = vol.value(hx, hy, hz - p.cell_z, ok); nvalid = nvalid && ok;
      const float d_zp = vol.value(hx, hy, hz + p.cell_z, ok); nvalid = nvalid && ok;
      const float nx = (d_xp - d_xm) * p.mdn / p.two_cell_x;
      const float ny = (d_yp - d_ym) * p.mdn / p.two_cell_y;
      const float nz = (d_zp - d_zm) * p.mdn / p.two_cell_z;
      float nn = sqrtf(nx * nx + ny * ny + nz * nz);
      if (nn == 0.0f) nn = 1.0f;
      ch[4] = nvalid ? 1.0f : 0.0f;
      ch[5] = nx / nn;
      ch[6] = ny / nn;
      ch[7] = nz / nn;
    }
  }
#pragma unroll
  for (int c = 0; c < kChannels; ++c) out[(size_t)c * n_rays + i] = ch[c];
}

extern "C" int tsdf_raycast(const RaycastParams* params, const void* rd,
                            const void* brick_map, const void* origins,
                            const void* dirs, int n_rays, void* out, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    raycast_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        *params, (const float*)rd, (const int*)brick_map, (const float*)origins,
        (const float*)dirs, n_rays, (float*)out);
  }
  return (int)cudaGetLastError();
}
