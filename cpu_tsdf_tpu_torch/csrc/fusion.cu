// Brick fusion kernel: one depth frame fused into the brick volume, in place.
//
// Replaces cpu_tsdf_tpu/ops/pallas_fusion.py::_kernel_inplace together with
// the chunk chain around it (fuse_bricks_inplace, brick_meta,
// expand_extra_meta). The contract is the plain engine,
// cpu_tsdf_tpu_torch/ops/fusion_kernel.py::fuse_bricks_plain (the JAX
// package's xla_update branch, bricks.py:531-559, and ops/fusion.py:91-138).
//
// Launch: one block per row of the frame's update list (band candidates,
// then carve slots), 512 threads, one per voxel of the 8^3 brick. A row is
// (bx, by, bz, slot); slot < 0 marks a row without a brick, which returns at
// once and writes nothing (not even to the dump row C-1). Rows of one frame
// name distinct slots (band and carve lists are disjoint, the allocator
// hands out unique rows), so blocks never write the same voxel.
//
// Bound: device memory. Each live row reads and writes its 512 voxels of
// sdf/weight/M/nsample once (16 KiB), coalesced: thread t owns voxel t of
// the row. The depth image (and rgb) is read by projection, which is a
// gather; it is 1.2 MB (3.7 MB) at 640x480 and stays in the 50 MB L2. The
// TPU kernel's one-hot MXU lookup, its bf16 three-plane split, the row band,
// the column window and the multipass tiles all existed because a TPU core
// cannot gather from VMEM; here depth[v][u] is a plain load, so none of them
// is carried over, and there is no pass budget to overflow.
//
// Rounding: u = trunc(uf) picks a depth pixel, so one ulp in uf can move a
// voxel onto the neighbouring pixel and change d by the whole depth step
// between them. This file is compiled with --fmad=false and without
// --use_fast_math, every expression keeps the plain engine's operation
// order (transform = m0*x + m1*y + m2*z + m3 left to right, then
// x*fx/z + cx), and every constant comes in FusionParams as the float32
// rounding of the Python double the plain engine uses. Pixel indices then
// match the plain engine bit for bit, and weight and nsample exactly.

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
};

constexpr int kVoxels = 512;  // 8^3, one thread each
constexpr int kAux = 5;       // r, g, b, w_eff (-1 = no observation), w0

__device__ __forceinline__ int pixel_index(float f, int n) {
  // Clamp before the conversion: a voxel near the camera plane projects to
  // a huge coordinate, and the float->int conversion of an out-of-range
  // value differs between devices. trunc of the clamped value keeps the
  // validity rule 0 <= u < n, including u in (-1, 0) -> 0.
  f = fminf(fmaxf(f, -2.0f), (float)(n + 1));
  return (int)truncf(f);
}

__global__ void __launch_bounds__(kVoxels)
fuse_kernel(FusionParams p, const int4* __restrict__ rows,
            const float* __restrict__ pose,  // pose_inv rows 0..2, 12 floats
            const float* __restrict__ depth, const float* __restrict__ rgb,
            float* __restrict__ sdf, float* __restrict__ weight,
            float* __restrict__ M, int* __restrict__ nsample,
            float* __restrict__ aux) {
  const int4 row = rows[blockIdx.x];
  if (row.w < 0) return;
  const int t = threadIdx.x;
  const size_t at = (size_t)row.w * kVoxels + t;

  const int gx = row.x * 8 + (t >> 6);
  const int gy = row.y * 8 + ((t >> 3) & 7);
  const int gz = row.z * 8 + (t & 7);
  const float cx = ((float)gx + 0.5f) * p.cell_x - p.half_x;
  const float cy = ((float)gy + 0.5f) * p.cell_y - p.half_y;
  const float cz = ((float)gz + 0.5f) * p.cell_z - p.half_z;

  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = pose[i];
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

  float z = 0.0f;
  if (valid) {
    z = depth[v * p.width + u];
    valid = !isnan(z);
  }
  float d_new = z - vz;
  valid = valid && d_new >= -p.max_dist_neg;  // no carving behind the band
  d_new = fminf(d_new, p.max_dist_pos) / p.max_dist_neg;
  float w_new = 1.0f;
  if (p.weight_by_depth) w_new = 1.0f - fminf(z / 10.0f, 1.0f);

  const float d0 = sdf[at], w0 = weight[at], M0 = M[at];
  const int n0 = nsample[at];
  if (p.weight_by_variance && n0 > 5) {
    // the reference's n/(n-1) factor is integer division, i.e. 1
    const float var = M0 / (w0 > 0.0f ? w0 : 1.0f);
    w_new = w_new * expf(-((d_new - d0) * (d_new - d0)) / (2.0f * var));
  }

  if (aux != nullptr) {
    float* a = aux + (size_t)blockIdx.x * kAux * kVoxels + t;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (valid) {
      const float* px = rgb + 3 * (v * p.width + u);
      r = px[0];
      g = px[1];
      b = px[2];
    }
    a[0 * kVoxels] = r;
    a[1 * kVoxels] = g;
    a[2 * kVoxels] = b;
    a[3 * kVoxels] = valid ? w_new : -1.0f;
    a[4 * kVoxels] = w0;
  }
  if (!valid) return;

  // weighted average, cap AFTER the average (octree.cpp:153-163); wsum == 0
  // keeps the old d
  const float wsum = w0 + w_new;
  const float d_upd = wsum > 0.0f ? (d0 * w0 + d_new * w_new) / wsum : d0;
  sdf[at] = d_upd;
  // not fminf: a NaN gate (exp(-0/0) when M0 == 0 and d_new == d0) must
  // stay NaN, as in the plain engine's clamp and the reference
  weight[at] = wsum > p.max_weight ? p.max_weight : wsum;
  M[at] = M0 + w_new * (d_new - d_upd) * (d_new - d0);
  nsample[at] = n0 + 1;
}

extern "C" int tsdf_fuse_bricks(const FusionParams* params, const void* rows,
                                int n_rows, const void* pose, const void* depth,
                                const void* rgb, void* sdf, void* weight,
                                void* M, void* nsample, void* aux,
                                void* stream) {
  if (n_rows > 0) {
    fuse_kernel<<<n_rows, kVoxels, 0, (cudaStream_t)stream>>>(
        *params, (const int4*)rows, (const float*)pose, (const float*)depth,
        (const float*)rgb, (float*)sdf, (float*)weight, (float*)M,
        (int*)nsample, (float*)aux);
  }
  return (int)cudaGetLastError();
}
