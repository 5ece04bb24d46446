// Brick activation kernels: which bricks a depth frame may update, and
// which live bricks it carves.
//
// Replaces no TPU kernel: the JAX package runs activation as XLA ops inside
// its jitted frame (cpu_tsdf_tpu/activation.py), and the port ran the same
// function as some 1,100 small PyTorch kernels a frame (its plain version,
// cpu_tsdf_tpu_torch/activation.py, which stays the contract). Each of
// those kernels did almost no work: the stage reads ~2 MB, under a
// microsecond of the card's bandwidth, and took ~1.27 ms of launches inside
// the frame's CUDA graph. Here the stage is seven launches:
//
//   depth_mips       mip_base_kernel    the base level of the NaN-aware min
//                                       and max pyramids, up to a block a
//                                       texel
//                    mip_levels_kernel  one block: the levels above it, the
//                                       2x2-dilated tables, the level table
//   band candidates  tile_kernel        every tile's band test (dilated
//                                       tables), one bit a tile by ballot
//                    brick_kernel       each block finds its listed tiles by
//                                       a scan of the tile bits, then one
//                                       thread a brick: the rough test
//                                       against its tile's bounds and, for a
//                                       rough brick, the tight test with its
//                                       own footprint; two bits a brick
//                    band_list_kernel   one block: the ranks of both bit
//                                       sets by block scans, the list
//   carve slots      carve_kernel       one thread a slot, one bit by ballot
//                    carve_list_kernel  one block: the ranks, the list
//
// The lists are the plain version's bit for bit: the candidate list in
// tile-major order (ascending listed tile, then local brick id), a brick
// listed only if it is rough with a rough rank below U2 and tight with a
// tight rank below the update budget, the counts full (not clamped), the
// overflow flag set by the tile budget, U2 and the update budget; the carve
// list in ascending slot order. Nothing is written to device memory but
// the tables, one bit a tile and two a listed brick, the listed tile ids
// and the lists, so no stage waits on a rough list in memory.
//
// Bound: launch latency. The stage reads the depth image once (1.2 MB at
// 640x480), the brick coords once (12 B a slot), a few KB of tables and
// bits, and writes the lists: ~1.7 MB at the benchmark's sizes, 0.5 us at
// 3.35 TB/s, against ~1.5-3 us a launch inside a graph. The single-block
// kernels stay short (a few bit words a thread); the per-brick and per-slot
// tests run on as many blocks as there are bricks and slots.
//
// Rounding: compiled with --fmad=false, every expression in the plain
// version's operation order (a transform summed m0*x + m1*y + m2*z + m3
// left to right, true divisions, sqrtf, x*x for ** 2), every constant the
// float32 rounding of the Python double the plain version computes (passed
// in ActParams), clamps that propagate NaN as torch.clamp does. A
// footprint's mip level is the exact integer ceil(log2(span)), which equals
// the plain version's float log2 for every span an image allows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxLevels = 32;
// The tiles of one tested range: pick_tile_bricks keeps a grid of at most
// 33 tiles an axis, so at most 33^3 tiles, 1124 bit words.
constexpr int kMaxTileWords = 1152;
constexpr int kThreads = 256;      // the multi-block kernels
constexpr int kListThreads = 1024;  // the single-block kernels

// Mirrors cpu_tsdf_tpu_torch/ops/activation_kernel.py::MipLayout. The
// pyramid's levels from base_level up, packed flat: level k (k = 0 ..
// n_levels - 1, level base_level + k of the image) holds heights[k] x
// widths[k] texels from offsets[k] on. width and height are the image's;
// a base texel covers 2^cell_h_shift x 2^cell_w_shift pixels of the image
// padded to powers of two with NaN.
struct MipLayout {
  int width, height;
  int base_level, n_levels, n_texels;
  int cell_h_shift, cell_w_shift;
  int offsets[kMaxLevels], widths[kMaxLevels], heights[kMaxLevels];
};

// Mirrors ops/activation_kernel.py::ActParams (4-byte members only).
struct ActParams {
  float fx, fy, pcx, pcy;
  float width_f, height_f;                         // float(W), float(H)
  float u_clip, v_clip;                            // W + 4.0, H + 4.0
  float tan_h, tan_v;                              // the straddling sphere's cone
  float m_lo, m_hi;                                // band margins
  float min_dist, max_dist;                        // sensor range
  float z_eps_lo, z_eps_hi;                        // 1e-3, 2e-3
  float half_x, half_y, half_z;                    // cfg.xsize / 2
  float size_x, size_y, size_z;                    // cfg.xsize
  float tile_x, tile_y, tile_z;                    // TB * B * cell
  float brick_x, brick_y, brick_z;                 // B * cell
  float carve_half_x, carve_half_y, carve_half_z;  // 0.5 * B * cell
  float carve_r;                                   // a brick's bounding radius
  int nbx, nby, nbz;                               // bricks an axis
  int tb_shift;                                    // log2 of TB, the tile's edge in bricks
  int ntx, nty, ntz;                               // tiles an axis
  int tile_first, n_tiles;                         // tested tiles: ids [first, first + n)
  int tile_budget;
  int slab_lo, slab_hi;                            // bricks with bx in [lo, hi)
  int rough_budget, update_budget;                 // U2 and the list's length
};

// The four tables of DepthMips (min, max and their dilated variants).
struct Tables {
  const float* mn;
  const float* mx;
  const float* mn_d;
  const float* mx_d;
};

// ---------------------------------------------------------------------------
// the plain version's arithmetic
// ---------------------------------------------------------------------------

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Sphere {
  float x, y, z, r;  // camera-frame centre, radius
};

// cam_center_radius: a volume-frame AABB's bounding sphere in the camera frame
__device__ __forceinline__ Sphere box_sphere(const ActParams& p, const float* m, float x0,
                                             float y0, float z0, float x1, float y1, float z1) {
  const float cx = (x0 + x1) * 0.5f - p.half_x;
  const float cy = (y0 + y1) * 0.5f - p.half_y;
  const float cz = (z0 + z1) * 0.5f - p.half_z;
  const float dx = x1 - x0, dy = y1 - y0, dz = z1 - z0;
  Sphere s;
  s.r = 0.5f * sqrtf(dx * dx + dy * dy + dz * dz);
  s.x = m[0] * cx + m[1] * cy + m[2] * cz + m[3];
  s.y = m[4] * cx + m[5] * cy + m[6] * cz + m[7];
  s.z = m[8] * cx + m[9] * cy + m[10] * cz + m[11];
  return s;
}

__device__ __forceinline__ Sphere tile_sphere(const ActParams& p, const float* m, int tx, int ty,
                                              int tz) {
  const float x0 = (float)tx * p.tile_x, y0 = (float)ty * p.tile_y, z0 = (float)tz * p.tile_z;
  return box_sphere(p, m, x0, y0, z0, clamp_max(x0 + p.tile_x, p.size_x),
                    clamp_max(y0 + p.tile_y, p.size_y), clamp_max(z0 + p.tile_z, p.size_z));
}

__device__ __forceinline__ Sphere brick_sphere(const ActParams& p, const float* m, int bx, int by,
                                               int bz) {
  const float x0 = (float)bx * p.brick_x, y0 = (float)by * p.brick_y, z0 = (float)bz * p.brick_z;
  return box_sphere(p, m, x0, y0, z0, x0 + p.brick_x, y0 + p.brick_y, z0 + p.brick_z);
}

__device__ __forceinline__ float take(const float* t, int idx, int n) {
  return t[clamp_int(idx, 0, n - 1)];
}

// _footprint_depth_bounds: (dmin, dmax) over the pixel rect [u0,u1]x[v0,v1]
__device__ __forceinline__ void footprint_bounds(const MipLayout& L, const Tables& T, int u0,
                                                 int u1, int v0, int v1, bool dilated,
                                                 bool need_max, float* dmin, float* dmax) {
  const int span = max(max(u1 - u0, v1 - v0), 0) + 1;
  int lvl = span <= 1 ? 0 : 32 - __clz(span - 1);  // ceil(log2(span))
  lvl = clamp_int(lvl, L.base_level, L.base_level + L.n_levels - 1);
  const int li = lvl - L.base_level;
  const int off = L.offsets[li], wl = L.widths[li], n = L.n_texels;
  const int tu0 = u0 >> lvl, tu1 = u1 >> lvl, tv0 = v0 >> lvl, tv1 = v1 >> lvl;
  if (dilated) {
    const int idx = off + tv0 * wl + tu0;
    *dmin = take(T.mn_d, idx, n);
    if (need_max) *dmax = take(T.mx_d, idx, n);
    return;
  }
  const int i00 = off + tv0 * wl + tu0, i01 = off + tv0 * wl + tu1;
  const int i10 = off + tv1 * wl + tu0, i11 = off + tv1 * wl + tu1;
  *dmin = fminf(fminf(take(T.mn, i00, n), take(T.mn, i01, n)),
                fminf(take(T.mn, i10, n), take(T.mn, i11, n)));
  if (need_max)
    *dmax = fmaxf(fmaxf(take(T.mx, i00, n), take(T.mx, i01, n)),
                  fmaxf(take(T.mx, i10, n), take(T.mx, i11, n)));
}

// px() of _sphere_footprint: round, pad and clamp a bound to a pixel
__device__ __forceinline__ int pixel_bound(float f, bool up, int pad, float clip, int n) {
  const float c = clamp2(f, -4.0f, clip);
  return clamp_int((int)(up ? ceilf(c) : floorf(c)) + pad, 0, n - 1);
}

struct Footprint {
  bool usable;  // the sphere lies in front of the camera plane
  float dmin, dmax;
};

// _sphere_footprint: depth bounds under a sphere's conservative footprint
__device__ __forceinline__ Footprint sphere_footprint(const ActParams& p, const MipLayout& L,
                                                      const Tables& T, const Sphere& s,
                                                      bool dilated, bool need_max) {
  const float z_lo = s.z - s.r, z_hi = s.z + s.r;
  Footprint f;
  f.usable = z_lo > p.z_eps_lo;
  const float zl = clamp_min(z_lo, p.z_eps_lo);
  const float zh = clamp_min(z_hi, p.z_eps_hi);
  const float x_lo = s.x - s.r, x_hi = s.x + s.r;
  const float y_lo = s.y - s.r, y_hi = s.y + s.r;
  const float u_min = p.fx * (x_lo >= 0.0f ? x_lo / zh : x_lo / zl) + p.pcx;
  const float u_max = p.fx * (x_hi >= 0.0f ? x_hi / zl : x_hi / zh) + p.pcx;
  const float v_min = p.fy * (y_lo >= 0.0f ? y_lo / zh : y_lo / zl) + p.pcy;
  const float v_max = p.fy * (y_hi >= 0.0f ? y_hi / zl : y_hi / zh) + p.pcy;
  const bool empty = (u_min > p.width_f) | (u_max < -1.0f) | (v_min > p.height_f) |
                     (v_max < -1.0f);
  const int u0 = pixel_bound(u_min, false, -1, p.u_clip, L.width);
  const int u1 = pixel_bound(u_max, true, 1, p.u_clip, L.width);
  const int v0 = pixel_bound(v_min, false, -1, p.v_clip, L.height);
  const int v1 = pixel_bound(v_max, true, 1, p.v_clip, L.height);
  float dmin, dmax = 0.0f;
  footprint_bounds(L, T, u0, u1, v0, v1, dilated, need_max, &dmin, &dmax);
  f.dmin = empty ? INFINITY : dmin;
  f.dmax = empty ? -INFINITY : dmax;
  return f;
}

// _band_test: the sphere MAY hold voxels this frame updates in band
__device__ __forceinline__ bool band_test(const ActParams& p, const MipLayout& L, const Tables& T,
                                          const Sphere& s, bool dilated) {
  const float z_lo = s.z - s.r, z_hi = s.z + s.r;
  const bool in_sensor = (z_hi >= p.min_dist) & (z_lo <= p.max_dist);
  const Footprint f = sphere_footprint(p, L, T, s, dilated, true);
  if (f.usable) return in_sensor & (z_lo <= f.dmax + p.m_lo) & (z_hi >= f.dmin - p.m_hi);
  // straddles the camera plane: the cone and the whole image's bounds
  const float zc = clamp_min(z_hi, 0.0f);
  const bool cone = (fabsf(s.x) - s.r <= p.tan_h * zc) & (fabsf(s.y) - s.r <= p.tan_v * zc);
  const float gmin = T.mn[L.n_texels - 1], gmax = T.mx[L.n_texels - 1];
  const bool glob = (z_lo <= gmax + p.m_lo) & (z_hi >= gmin - p.m_hi);
  return in_sensor & cone & glob;
}

// ---------------------------------------------------------------------------
// scans
// ---------------------------------------------------------------------------

// Exclusive prefix sum of one int a thread over the block (blockDim.x a
// multiple of 32); *total receives the block's sum. Every thread calls it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before;
}

// The words [*w0, *w1) of n_words that thread threadIdx.x takes, in order.
__device__ __forceinline__ void word_chunk(int n_words, int* w0, int* w1) {
  const int per = (n_words + blockDim.x - 1) / blockDim.x;
  *w0 = min((int)threadIdx.x * per, n_words);
  *w1 = min(*w0 + per, n_words);
}

// ---------------------------------------------------------------------------
// depth mips
// ---------------------------------------------------------------------------

// A base texel's cells (its pixels, 2^(cell_h_shift + cell_w_shift) of
// them) are read by min(cells, kThreads) threads, kThreads / that texels a
// block: one load a thread at bricks of 8, 16 at bricks of 32.
__global__ void __launch_bounds__(kThreads) mip_base_kernel(MipLayout L, const float* depth,
                                                            float* mn, float* mx) {
  __shared__ float warp_mn[kThreads / 32], warp_mx[kThreads / 32];
  const int cells = 1 << (L.cell_h_shift + L.cell_w_shift);
  const int per_texel = min(cells, kThreads);
  const int texels = kThreads / per_texel;  // a block's
  const int lane = threadIdx.x % per_texel, warp = threadIdx.x >> 5;
  const int w0 = L.widths[0], n0 = L.heights[0] * w0;
  const int cw_mask = (1 << L.cell_w_shift) - 1;
  for (int first = blockIdx.x * texels; first < n0; first += gridDim.x * texels) {
    const int t = first + threadIdx.x / per_texel;
    const int ty = t / w0, tx = t - ty * w0;
    float a = INFINITY, b = -INFINITY;
    for (int i = lane; i < cells && t < n0; i += per_texel) {
      const int y = (ty << L.cell_h_shift) + (i >> L.cell_w_shift);
      const int x = (tx << L.cell_w_shift) + (i & cw_mask);
      if (y < L.height && x < L.width) {
        const float d = depth[y * L.width + x];
        if (!isnan(d)) {  // NaN (and the padding) is +inf for min, -inf for max
          a = fminf(a, d);
          b = fmaxf(b, d);
        }
      }
    }
    for (int o = min(per_texel, 32) >> 1; o > 0; o >>= 1) {
      a = fminf(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    if (per_texel > 32) {  // a texel spans warps: its first thread takes theirs
      if ((threadIdx.x & 31) == 0) {
        warp_mn[warp] = a;
        warp_mx[warp] = b;
      }
      __syncthreads();
      if (lane == 0) {
        for (int k = 1; k < per_texel / 32; ++k) {
          a = fminf(a, warp_mn[warp + k]);
          b = fmaxf(b, warp_mx[warp + k]);
        }
      }
      __syncthreads();  // warp_mn is rewritten by the next texels
    }
    if (lane == 0 && t < n0) {
      mn[t] = a;
      mx[t] = b;
    }
  }
}

__global__ void __launch_bounds__(kListThreads) mip_levels_kernel(MipLayout L, float* mn, float* mx,
                                                                  float* mn_d, float* mx_d,
                                                                  int* level_table) {
  for (int k = 0; k < L.n_levels; ++k) {
    const int h = L.heights[k], w = L.widths[k], o = L.offsets[k];
    if (k > 0) {  // level k from level k - 1
      const int pw = L.widths[k - 1], po = L.offsets[k - 1];
      const int fy = L.heights[k - 1] / h, fx = pw / w;  // 1 or 2
      for (int t = threadIdx.x; t < h * w; t += blockDim.x) {
        const int y = t / w, x = t - y * w;
        float a = INFINITY, b = -INFINITY;
        for (int dy = 0; dy < fy; ++dy)
          for (int dx = 0; dx < fx; ++dx) {
            const int i = po + (y * fy + dy) * pw + x * fx + dx;
            a = fminf(a, mn[i]);
            b = fmaxf(b, mx[i]);
          }
        mn[o + t] = a;
        mx[o + t] = b;
      }
      __syncthreads();
    }
    // level k's dilated texels (the next level reads level k too, and
    // writes nothing they read)
    for (int t = threadIdx.x; t < h * w; t += blockDim.x) {
      const int y = t / w, x = t - y * w;
      const int r0 = o + y * w, r1 = o + min(y + 1, h - 1) * w, x1 = min(x + 1, w - 1);
      mn_d[o + t] = fminf(fminf(mn[r0 + x], mn[r1 + x]), fminf(mn[r0 + x1], mn[r1 + x1]));
      mx_d[o + t] = fmaxf(fmaxf(mx[r0 + x], mx[r1 + x]), fmaxf(mx[r0 + x1], mx[r1 + x1]));
    }
  }
  if ((int)threadIdx.x < L.n_levels) {
    level_table[threadIdx.x] = L.offsets[threadIdx.x];
    level_table[L.n_levels + threadIdx.x] = L.widths[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// band candidates
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tile_coords(const ActParams& p, int t, int* tx, int* ty, int* tz) {
  const int plane = p.nty * p.ntz;
  *tx = t / plane;
  *ty = (t / p.ntz) % p.nty;
  *tz = t % p.ntz;
}

__global__ void __launch_bounds__(kThreads) tile_kernel(ActParams p, MipLayout L, Tables T,
                                                        const float* pose, unsigned* tile_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool act = false;
  if (i < p.n_tiles) {
    int tx, ty, tz;
    tile_coords(p, i + p.tile_first, &tx, &ty, &tz);
    act = band_test(p, L, T, tile_sphere(p, pose, tx, ty, tz), true);
  }
  const unsigned bits = __ballot_sync(0xffffffffu, act);
  if ((threadIdx.x & 31) == 0 && i < p.n_tiles) tile_words[i >> 5] = bits;
}

// A listed tile as the brick pass reads it.
struct TileInfo {
  int tx, ty, tz;
  bool usable;
  float dmax_lo, dmin_hi;  // t_dmax + m_lo, t_dmin - m_hi
};

// The count of listed tiles: every thread of the block calls it.
__device__ __forceinline__ int count_tiles(const ActParams& p, const unsigned* tile_words,
                                           int* prefix) {
  const int n_words = (p.n_tiles + 31) >> 5;
  int w0, w1;
  word_chunk(n_words, &w0, &w1);
  int c = 0;
  for (int w = w0; w < w1; ++w) c += __popc(tile_words[w]);
  int total;
  int run = block_exclusive_scan(c, &total);
  if (prefix != nullptr)
    for (int w = w0; w < w1; ++w) {
      prefix[w] = run;
      run += __popc(tile_words[w]);
    }
  return total;
}

// Items: listed tile position q >> (3 tb_shift), local brick id the rest.
__global__ void __launch_bounds__(kThreads) brick_kernel(ActParams p, MipLayout L, Tables T,
                                                         const float* pose,
                                                         const unsigned* tile_words,
                                                         int* tile_list, unsigned* rough_words,
                                                         unsigned* tight_words, int n_items) {
  __shared__ int prefix[kMaxTileWords];
  __shared__ TileInfo tiles[kThreads / 64];
  const int n_listed = min(count_tiles(p, tile_words, prefix), p.tile_budget);
  __syncthreads();  // the prefix
  const int shift3 = 3 * p.tb_shift;
  const int q0 = blockIdx.x * blockDim.x;
  const int p_first = q0 >> shift3;
  if (p_first >= n_listed) return;  // the whole block
  const int n_pos = min(((q0 + (int)blockDim.x - 1) >> shift3) - p_first + 1, n_listed - p_first);
  if ((int)threadIdx.x < n_pos) {
    // the listed tile at position pos: bit pos - prefix[w] of the last word
    // w whose prefix is at most pos
    const int pos = p_first + threadIdx.x;
    int lo = 0, hi = ((p.n_tiles + 31) >> 5) - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (prefix[mid] <= pos) lo = mid;
      else hi = mid - 1;
    }
    unsigned bits = tile_words[lo];
    for (int k = pos - prefix[lo]; k > 0; --k) bits &= bits - 1;
    const int t = (lo << 5) + __ffs(bits) - 1 + p.tile_first;
    tile_list[pos] = t;
    TileInfo ti;
    tile_coords(p, t, &ti.tx, &ti.ty, &ti.tz);
    const Footprint f = sphere_footprint(p, L, T, tile_sphere(p, pose, ti.tx, ti.ty, ti.tz),
                                         true, true);
    ti.usable = f.usable;
    ti.dmax_lo = f.dmax + p.m_lo;
    ti.dmin_hi = f.dmin - p.m_hi;
    tiles[threadIdx.x] = ti;
  }
  __syncthreads();
  const int q = q0 + threadIdx.x;
  bool rough = false, tight = false;
  if ((q >> shift3) < n_listed) {
    const TileInfo ti = tiles[(q >> shift3) - p_first];
    const int li = q & ((1 << shift3) - 1);
    const int tb_mask = (1 << p.tb_shift) - 1;
    const int bx = (ti.tx << p.tb_shift) + (li >> (2 * p.tb_shift));
    const int by = (ti.ty << p.tb_shift) + ((li >> p.tb_shift) & tb_mask);
    const int bz = (ti.tz << p.tb_shift) + (li & tb_mask);
    const bool in_grid = bx < p.nbx && by < p.nby && bz < p.nbz && bx >= p.slab_lo &&
                         bx < p.slab_hi;
    const Sphere s = brick_sphere(p, pose, bx, by, bz);
    const float zb_lo = s.z - s.r, zb_hi = s.z + s.r;
    const bool z_refine = ((zb_lo <= ti.dmax_lo) & (zb_hi >= ti.dmin_hi)) | !ti.usable;
    rough = in_grid & z_refine & (zb_lo <= p.max_dist) & (zb_hi >= p.min_dist);
    if (rough) tight = band_test(p, L, T, s, false);
  }
  const unsigned r_bits = __ballot_sync(0xffffffffu, rough);
  const unsigned t_bits = __ballot_sync(0xffffffffu, tight);
  if ((threadIdx.x & 31) == 0 && q < n_items) {
    rough_words[q >> 5] = r_bits;
    tight_words[q >> 5] = t_bits;
  }
}

// The bits of a word's tight bricks whose rough rank is below the rough
// budget, given `room` rough ranks left before it: all of them when the
// word's rough bricks fit, else those among its first `room` rough bricks.
__device__ __forceinline__ unsigned under_budget(unsigned rough, int room) {
  if (room <= 0) return 0u;
  unsigned later = rough;
  for (int k = 0; k < room && later; ++k) later &= later - 1;
  return ~later;
}

__global__ void __launch_bounds__(kListThreads) band_list_kernel(ActParams p,
                                                                 const unsigned* tile_words,
                                                                 const int* tile_list,
                                                                 const unsigned* rough_words,
                                                                 const unsigned* tight_words,
                                                                 int* cand, int* n_band_out,
                                                                 bool* overflow) {
  const int n_tiles = count_tiles(p, tile_words, nullptr);
  const int n_listed = min(n_tiles, p.tile_budget);
  const int shift3 = 3 * p.tb_shift;
  const int n_words = (n_listed << shift3) >> 5;  // TB^3 >= 64: whole words
  int w0, w1;
  word_chunk(n_words, &w0, &w1);
  int c = 0;
  for (int w = w0; w < w1; ++w) c += __popc(rough_words[w]);
  int n_rough;
  const int rough_before = block_exclusive_scan(c, &n_rough);
  c = 0;
  for (int w = w0, r = rough_before; w < w1; ++w) {
    const unsigned rw = rough_words[w];
    c += __popc(tight_words[w] & under_budget(rw, p.rough_budget - r));
    r += __popc(rw);
  }
  int n_band;
  int rank = block_exclusive_scan(c, &n_band);
  const int tb_mask = (1 << p.tb_shift) - 1;
  for (int w = w0, r = rough_before; w < w1 && r < p.rough_budget; ++w) {
    const unsigned rw = rough_words[w];
    unsigned bits = tight_words[w] & under_budget(rw, p.rough_budget - r);
    r += __popc(rw);
    if (bits == 0u) continue;
    // a word's 32 bricks lie in one tile (TB^3 >= 64)
    int tx, ty, tz;
    tile_coords(p, tile_list[(w << 5) >> shift3], &tx, &ty, &tz);
    for (; bits != 0u && rank < p.update_budget; bits &= bits - 1, ++rank) {
      const int li = ((w << 5) + __ffs(bits) - 1) & ((1 << shift3) - 1);
      const int bx = (tx << p.tb_shift) + (li >> (2 * p.tb_shift));
      const int by = (ty << p.tb_shift) + ((li >> p.tb_shift) & tb_mask);
      const int bz = (tz << p.tb_shift) + (li & tb_mask);
      cand[rank] = (bx * p.nby + by) * p.nbz + bz;
    }
  }
  for (int i = min(n_band, p.update_budget) + threadIdx.x; i < p.update_budget; i += blockDim.x)
    cand[i] = -1;
  if (threadIdx.x == 0) {
    *n_band_out = n_band;
    *overflow = n_tiles > p.tile_budget || n_rough > p.rough_budget || n_band > p.update_budget;
  }
}

// ---------------------------------------------------------------------------
// carve slots
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) carve_kernel(ActParams p, MipLayout L, Tables T,
                                                         const float* pose, const int* coords,
                                                         int n_slots, unsigned* words) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  bool carve = false;
  if (s < n_slots && coords[3 * s] >= 0) {
    const float* m = pose;
    const float x0 = (float)coords[3 * s] * p.brick_x;
    const float y0 = (float)coords[3 * s + 1] * p.brick_y;
    const float z0 = (float)coords[3 * s + 2] * p.brick_z;
    const float cx = x0 + p.carve_half_x - p.half_x;
    const float cy = y0 + p.carve_half_y - p.half_y;
    const float cz = z0 + p.carve_half_z - p.half_z;
    Sphere sp;
    sp.r = p.carve_r;
    sp.x = m[0] * cx + m[1] * cy + m[2] * cz + m[3];
    sp.y = m[4] * cx + m[5] * cy + m[6] * cz + m[7];
    sp.z = m[8] * cx + m[9] * cy + m[10] * cz + m[11];
    const bool in_sensor = (sp.z + sp.r >= p.min_dist) & (sp.z - sp.r <= p.max_dist);
    const Footprint f = sphere_footprint(p, L, T, sp, false, false);
    // an empty or NaN-only footprint gives +inf: not a carve candidate
    carve = in_sensor & f.usable & isfinite(f.dmin) & (sp.z + sp.r < f.dmin - p.m_hi);
  }
  const unsigned bits = __ballot_sync(0xffffffffu, carve);
  if ((threadIdx.x & 31) == 0 && s < n_slots) words[s >> 5] = bits;
}

// ids of the set bits in ascending order, the first `budget` of them,
// -1 padded; *count the full count
__global__ void __launch_bounds__(kListThreads) carve_list_kernel(const unsigned* words,
                                                                  int n_slots, int budget,
                                                                  int* out, int* count) {
  int w0, w1;
  word_chunk((n_slots + 31) >> 5, &w0, &w1);
  int c = 0;
  for (int w = w0; w < w1; ++w) c += __popc(words[w]);
  int n;
  int rank = block_exclusive_scan(c, &n);
  for (int w = w0; w < w1 && rank < budget; ++w)
    for (unsigned bits = words[w]; bits != 0u && rank < budget; bits &= bits - 1, ++rank)
      out[rank] = (w << 5) + __ffs(bits) - 1;
  for (int i = min(n, budget) + threadIdx.x; i < budget; i += blockDim.x) out[i] = -1;
  if (threadIdx.x == 0) *count = n;
}

// ---------------------------------------------------------------------------
// launch functions (each returns the CUDA error code of its launches)
// ---------------------------------------------------------------------------

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

static inline Tables tables_of(const void* mn, const void* mx, const void* mn_d, const void* mx_d) {
  Tables t;
  t.mn = (const float*)mn;
  t.mx = (const float*)mx;
  t.mn_d = (const float*)mn_d;
  t.mx_d = (const float*)mx_d;
  return t;
}

// depth [H, W] -> tables [4, n_texels] (min, max, dilated min, dilated max)
// and level_table [2, n_levels] (offsets, widths)
extern "C" int tsdf_depth_mips(const MipLayout* layout, const void* depth, void* tables,
                               void* level_table, void* stream) {
  const MipLayout& L = *layout;
  cudaStream_t s = (cudaStream_t)stream;
  float* t = (float*)tables;
  const long long n0 = (long long)L.heights[0] * L.widths[0];
  const int cells = 1 << (L.cell_h_shift + L.cell_w_shift);
  const unsigned grid = blocks_for(n0, kThreads / (cells < kThreads ? cells : kThreads));
  mip_base_kernel<<<grid < 1024u ? grid : 1024u, kThreads, 0, s>>>(L, (const float*)depth, t,
                                                                    t + L.n_texels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mip_levels_kernel<<<1, kListThreads, 0, s>>>(L, t, t + L.n_texels, t + 2 * L.n_texels,
                                              t + 3 * L.n_texels, (int*)level_table);
  return (int)cudaGetLastError();
}

// scratch: int32 [tile words + tile_budget + 2 * item words]; cand: int32
// [update_budget + 1] (the list, then n_band); overflow: one bool. Returns
// -1, launching nothing, for more tiles than kMaxTileWords words hold.
extern "C" int tsdf_band_candidates(const MipLayout* layout, const ActParams* params,
                                    const void* mn, const void* mx, const void* mn_d,
                                    const void* mx_d, const void* pose, void* scratch,
                                    void* cand, void* overflow, void* stream) {
  const MipLayout& L = *layout;
  const ActParams& p = *params;
  cudaStream_t s = (cudaStream_t)stream;
  const Tables T = tables_of(mn, mx, mn_d, mx_d);
  const int n_tile_words = (p.n_tiles + 31) / 32;
  if (n_tile_words > kMaxTileWords) return -1;
  const int n_items = p.tile_budget << (3 * p.tb_shift);
  unsigned* tile_words = (unsigned*)scratch;
  int* tile_list = (int*)scratch + n_tile_words;
  unsigned* rough_words = (unsigned*)(tile_list + p.tile_budget);
  unsigned* tight_words = rough_words + n_items / 32;
  if (p.n_tiles > 0) {
    tile_kernel<<<blocks_for(p.n_tiles, kThreads), kThreads, 0, s>>>(p, L, T, (const float*)pose,
                                                                     tile_words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_items > 0) {
    brick_kernel<<<blocks_for(n_items, kThreads), kThreads, 0, s>>>(
        p, L, T, (const float*)pose, tile_words, tile_list, rough_words, tight_words, n_items);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int* list = (int*)cand;
  band_list_kernel<<<1, kListThreads, 0, s>>>(p, tile_words, tile_list, rough_words, tight_words,
                                             list, list + p.update_budget, (bool*)overflow);
  return (int)cudaGetLastError();
}

// coords int32 [n_slots, 3]; words: int32 [(n_slots + 31) / 32] scratch;
// out: int32 [budget + 1] (the slots, then their full count)
extern "C" int tsdf_carve_slots(const MipLayout* layout, const ActParams* params, const void* mn,
                                const void* mx, const void* mn_d, const void* mx_d,
                                const void* pose, const void* coords, int n_slots, int budget,
                                void* words, void* out, void* stream) {
  const MipLayout& L = *layout;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_slots > 0) {
    carve_kernel<<<blocks_for(n_slots, kThreads), kThreads, 0, s>>>(
        *params, L, tables_of(mn, mx, mn_d, mx_d), (const float*)pose, (const int*)coords,
        n_slots, (unsigned*)words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int* list = (int*)out;
  carve_list_kernel<<<1, kListThreads, 0, s>>>((const unsigned*)words, n_slots, budget, list,
                                              list + budget);
  return (int)cudaGetLastError();
}
