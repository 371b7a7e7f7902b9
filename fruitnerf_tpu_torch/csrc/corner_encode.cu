// Corner-mode multiresolution grid encoding (exact instant-ngp trilinear),
// forward and backward, for Hopper.
//
// Replaces the Pallas TPU kernels of fruitnerf_tpu/ops/pallas/hash_grid.py:
//   forward   _fwd_kernel (:163), through _fwd_impl's pallas_call at :1032
//             (mode="corner", reached through grid_encode_flat)
//   backward  _bwd_kernel (:203), through _bwd_vjp's pallas_call at :1091
//
// What it computes, per point p and level l (res_l, T_l rows of F floats):
//   s = pos * res_l, cell = floor(s), t = s - cell
//   corner c = 4cx + 2cy + cz is entry (ix, iy, iz) = cell + (cx, cy, cz):
//   idx_c = ix + iy*(res+1) + iz*(res+1)^2         when (res+1)^3 <= T_l
//         = (ix ^ iy*2654435761 ^ iz*805459861) & (T_l - 1)   in uint32
//   out[p, l*F + f] = sum_c w_c(t) * table[offset_l + idx_c][f]
// with trilinear weights w_c. An index outside [0, T_l) (the +1 corner of a
// position at exactly 1.0 on a direct level) reads zero and takes no
// gradient, as the TPU kernel's one-hot matches nothing there. Nothing is
// read or written past a level's rows.
//
// The TPU kernel fetched each corner with a one-hot matmul over a
// [128, F*T/128] table tile, because the TPU has no fast gather. Here a
// corner is one F-float load, and the whole table of the fruit_nerf corner
// layout (16 levels x 8192 rows x 2 floats, 1 MB) stays in the H100's 50 MB
// L2. Neither kernel is bound by arithmetic; the bound is the bytes of
// positions, gradients and outputs (about 10 us a train step at 3.35 TB/s).
// What held the first version of these kernels far above it was how their
// threads met the table:
//   * a train step's points are ray-major, 48 consecutive samples of one
//     ray, so neighbouring points mostly share a cell at the coarse levels,
//     and with it all eight corner rows;
//   * one thread per point (backward) put a warp's 32 lanes on the same few
//     rows in the same instruction: 8F scalar atomics per (point, level)
//     that the L2 serialises, and gradient reads at a stride of L*F floats;
//   * one thread per (point, level) (forward) put a point's levels in
//     adjacent lanes, so no two lanes of a load ever shared a row.
//
// The design, cell_encode.cu's tile: a block takes 32 consecutive points,
// one lane per point, and its warps take the levels (warp w: levels w,
// w + W, ...). The tile's positions and its [n, L*F] gradients or outputs
// pass through shared memory, read and written as contiguous rows and
// staged with an odd row stride, so the 32 lanes at one level hit 32 banks.
// The shared memory is sized to the layout at launch, leaving the rest of
// the SM's L1 to the table's rows.
//   * forward: lanes of one cell read the same eight addresses, so each
//     corner is one request for the warp.
//   * backward: the key of a run is the lane's cell at that level (a cell
//     fixes all eight corner rows and their in-range flags). A segmented
//     warp scan, two corners (cx = 0, 1) and 2F floats at a time, leaves
//     each run's 8F sums in its last lane, which adds them to dTable's
//     64-bit fixed-point sums with integer atomics (fixed_sum.cuh), so that
//     dTable does not depend on the order of the adds. A warp-uniform ballot
//     skips the scan when no run is longer than one lane. Two cells whose
//     corners hash onto one row are a collision, not a run: such lanes add
//     apart. dPositions re-reads the corner rows only
//     when it is wanted, is summed per warp over its levels, then over the
//     warps in shared memory, and is written once, coalesced.
//   * both: at F = 2 the rows of corners cx = 0 and 1 form one aligned
//     16-byte pair whenever ix is even on a hashed level (ix + 1 == ix ^ 1
//     leaves the hash's other bits alone) or the first row is even on a
//     direct one; such a pair is one float4 load, not two float2.
// Everything is float32. The TPU kernel rounds the table and the 8-corner
// sum to the compute dtype, and in its backward the dTable terms and the
// dPos products (bfloat16 on the preset); that divergence is deliberate.
//
// A scene axis (blockIdx.y), as in cell_encode.cu: S scenes of P points,
// each reading its positions and table at its scene strides (0: one array
// for every scene), its column maxima and fixed-point scales its own, so
// scene s of a batched launch equals a launch of scene s alone, bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

#define CORNER_MAX_LEVELS 32
#define CORNER_MAX_FEATURES 8
#define TILE 32       // points a block: one per lane
#define MAX_WARPS 16  // warps a block; each takes levels w, w + W, ...

struct CornerLevels {
  int num_levels;
  int res[CORNER_MAX_LEVELS];
  int rows[CORNER_MAX_LEVELS];      // T_l
  int offset[CORNER_MAX_LEVELS];    // first row of level l in the flat table
  int direct[CORNER_MAX_LEVELS];    // 1 when (res+1)^3 <= T_l
};

// Row of entry (ix, iy, iz) at level l, or -1 when it lies outside [0, T_l).
__device__ __forceinline__ int corner_row(const CornerLevels& lv, int l,
                                          int ix, int iy, int iz) {
  if (lv.direct[l]) {
    const long long stride = (long long)lv.res[l] + 1;
    const long long idx = (long long)ix + (long long)iy * stride +
                          (long long)iz * stride * stride;
    return (idx >= 0 && idx < lv.rows[l]) ? (int)idx : -1;
  }
  const uint32_t h = (uint32_t)ix ^ ((uint32_t)iy * 2654435761u) ^
                     ((uint32_t)iz * 805459861u);
  return (int)(h & (uint32_t)(lv.rows[l] - 1));
}

// F floats of flat row `row`; rows are F floats apart in a 16-byte aligned
// table, so a row is 8-byte aligned at F = 2, 16 at F = 4 and 32 at F = 8.
template <int F>
__device__ __forceinline__ void load_entry(const float* __restrict__ table,
                                           long long row, float* v) {
  const float* p = table + row * F;
  if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else if constexpr (F == 4 || F == 8) {
#pragma unroll
    for (int k = 0; k < F / 4; ++k) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + k);
      v[4 * k] = a.x;
      v[4 * k + 1] = a.y;
      v[4 * k + 2] = a.z;
      v[4 * k + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(p + f);
  }
}

// Adds F floats to flat row `row` of the fixed-point dTable sums, feature f
// at scale[f].
template <int F>
__device__ __forceinline__ void add_entry(unsigned long long* __restrict__ acc,
                                          long long row, const float* d,
                                          const double* scale) {
#pragma unroll
  for (int f = 0; f < F; ++f) add_fixed(acc + row * F + f, d[f], scale[f]);
}

// Flat row (offset_l + row) of entry (ix, iy, iz) at level l, or -1 when
// the entry lies outside [0, T_l).
__device__ __forceinline__ long long corner_flat(const CornerLevels& lv, int l,
                                                 int ix, int iy, int iz) {
  const int row = corner_row(lv, l, ix, iy, iz);
  return row < 0 ? -1 : (long long)lv.offset[l] + row;
}

// The entries of corners cx = 0 and cx = 1 of one (cy, cz), at flat rows a
// and b (-1: a zero entry). At F = 2 rows a and b == a ^ 1 are one aligned
// 16-byte pair, read or added as one float4: on a hashed level whenever ix
// is even (ix + 1 == ix ^ 1), on a direct level whenever a is even. A zero
// entry reads row 0 and is zeroed, so no load waits on a branch.
template <int F>
__device__ __forceinline__ void load_pair(const float* __restrict__ table,
                                          long long a, long long b, float* va,
                                          float* vb) {
  if constexpr (F == 2) {
    if (a >= 0 && b == (a ^ 1)) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(table + (a & ~1LL) * 2));
      const bool odd = a & 1;
      va[0] = odd ? q.z : q.x;
      va[1] = odd ? q.w : q.y;
      vb[0] = odd ? q.x : q.z;
      vb[1] = odd ? q.y : q.w;
      return;
    }
  }
  load_entry<F>(table, a < 0 ? 0 : a, va);
  load_entry<F>(table, b < 0 ? 0 : b, vb);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    va[f] = a < 0 ? 0.f : va[f];
    vb[f] = b < 0 ? 0.f : vb[f];
  }
}

// Scaled coordinates of a point at level l: integer cell and fractions.
__device__ __forceinline__ void cell_of(float x, float y, float z, float r,
                                       int* ix, int* iy, int* iz, float* tx,
                                       float* ty, float* tz) {
  const float sx = x * r, sy = y * r, sz = z * r;
  const float fx = floorf(sx), fy = floorf(sy), fz = floorf(sz);
  *tx = sx - fx;
  *ty = sy - fy;
  *tz = sz - fz;
  *ix = (int)fx;
  *iy = (int)fy;
  *iz = (int)fz;
}

// Row stride of the tile's [n, width] block in shared memory: the smallest
// odd number >= width, so the 32 lanes of a warp, each at its own point and
// the same column, hit 32 banks.
__host__ __device__ __forceinline__ int tile_stride(int width) { return width | 1; }

// Shared memory is sized at launch to the layout (at most 41.4 KB, at 32
// levels and F = 8), so that a small layout leaves the SM's L1 to the
// table: positions [TILE * 3], the tile's block [TILE * stride] and, in the
// backward, the columns' fixed-point scales [width] (first, as doubles) and
// the warps' dPositions [warps * TILE * 3].
static size_t fwd_smem(int width) {
  return sizeof(float) * (TILE * 3 + TILE * tile_stride(width));
}

static size_t bwd_smem(int width, int warps) {
  return sizeof(double) * width + fwd_smem(width) + sizeof(float) * warps * TILE * 3;
}

// The forward's blocks an SM must hold: 3 at F <= 2 (40 registers a
// thread, where they fit), 2 from F = 3 (64). Left to itself ptxas aims the
// F = 3 and 4 forwards at 40 as well, and since the scene axis keeps the
// scene's table pointer live in the level loop they spill there.
template <int F>
__global__ void __launch_bounds__(TILE * MAX_WARPS, F <= 2 ? 3 : 2)
corner_encode_fwd_kernel(const float* __restrict__ pos,
                         const float* __restrict__ table,
                         float* __restrict__ out, int num_points,
                         long long pos_stride, long long table_stride,
                         CornerLevels lv) {
  extern __shared__ float smem[];  // fwd_smem
  const int num_levels = lv.num_levels;
  const int width = num_levels * F, stride = tile_stride(width);
  float* s_pos = smem;
  float* s_out = smem + TILE * 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  const long long p0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, (long long)num_points - p0);
  // the scene's table; its positions and outputs are offset where they are
  // read and written, so that no other pointer stays live in the level loop
  const long long scene = blockIdx.y;
  table += scene * table_stride;

  const float* src = pos + scene * pos_stride + 3 * p0;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) s_pos[i] = src[i];
  __syncthreads();
  const bool live = lane < n;
  const float x = live ? s_pos[3 * lane] : 0.f;
  const float y = live ? s_pos[3 * lane + 1] : 0.f;
  const float z = live ? s_pos[3 * lane + 2] : 0.f;
  for (int l = warp; l < num_levels; l += num_warps) {
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    if (live) {
      int ix, iy, iz;
      float tx, ty, tz;
      cell_of(x, y, z, (float)lv.res[l], &ix, &iy, &iz, &tx, &ty, &tz);
      const float wx[2] = {1.f - tx, tx};
      const float wy[2] = {1.f - ty, ty};
      const float wz[2] = {1.f - tz, tz};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // corners k (cx = 0) and 4 + k (cx = 1)
        const int cy = k >> 1, cz = k & 1;
        const long long a = corner_flat(lv, l, ix, iy + cy, iz + cz);
        const long long b = corner_flat(lv, l, ix + 1, iy + cy, iz + cz);
        float va[F], vb[F];
        load_pair<F>(table, a, b, va, vb);
        const float wyz = wy[cy] * wz[cz];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += wyz * (wx[0] * va[f] + wx[1] * vb[f]);
      }
    }
    float* so = s_out + lane * stride + l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) so[f] = acc[f];
  }
  __syncthreads();
  // out is [P, L*F] float, level-major: the tile's rows are contiguous
  float* dst = out + ((long long)blockIdx.y * num_points + p0) * width;
  for (int i = threadIdx.x; i < n * width; i += blockDim.x)
    dst[i] = s_out[(i / width) * stride + i % width];
}

template <int F>
__global__ void __launch_bounds__(TILE * MAX_WARPS)
corner_encode_bwd_kernel(const float* __restrict__ pos,
                         const float* __restrict__ table,
                         const float* __restrict__ grad,
                         unsigned long long* __restrict__ acc,
                         const unsigned* __restrict__ colmax,
                         float* __restrict__ dpos, int num_points,
                         long long pos_stride, long long table_stride,
                         long long entries, int needs_pos_grad, CornerLevels lv) {
  extern __shared__ double s_scale[];  // bwd_smem: [width] scales, then floats
  const unsigned kAll = 0xffffffffu;
  const int num_levels = lv.num_levels;
  const int width = num_levels * F, stride = tile_stride(width);
  float* smem = reinterpret_cast<float*>(s_scale + width);
  float* s_pos = smem;
  float* s_grad = smem + TILE * 3;
  float* s_dpos = s_grad + TILE * stride;  // [warps][TILE * 3]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  const long long p0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, (long long)num_points - p0);
  const long long scene = blockIdx.y;
  pos += scene * pos_stride;
  table += scene * table_stride;
  grad += scene * num_points * width;
  acc += scene * entries;
  colmax += scene * width;
  if (needs_pos_grad) dpos += scene * num_points * 3;

  const float* src = grad + p0 * width;
  for (int i = threadIdx.x; i < n * width; i += blockDim.x)
    s_grad[(i / width) * stride + i % width] = src[i];
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) s_pos[i] = pos[3 * p0 + i];
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    s_scale[i] = fixed_scale(colmax[i], num_points);
  __syncthreads();
  const bool live = lane < n;
  const float x = live ? s_pos[3 * lane] : 0.f;
  const float y = live ? s_pos[3 * lane + 1] : 0.f;
  const float z = live ? s_pos[3 * lane + 2] : 0.f;
  const unsigned upto_lane = kAll >> (31 - lane);  // lanes 0..lane
  float dx = 0.f, dy = 0.f, dz = 0.f;

  // every lane of the warp runs every iteration: the shuffles need all 32
  for (int l = warp; l < num_levels; l += num_warps) {
    const float r = (float)lv.res[l];
    int ix, iy, iz;
    float tx, ty, tz;
    cell_of(x, y, z, r, &ix, &iy, &iz, &tx, &ty, &tz);
    float g[F];  // zero past the tile: such a lane adds nothing
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = live ? s_grad[lane * stride + l * F + f] : 0.f;

    // runs of consecutive live lanes in one cell; lanes past the tile
    // each start their own
    const int px = __shfl_up_sync(kAll, ix, 1);
    const int py = __shfl_up_sync(kAll, iy, 1);
    const int pz = __shfl_up_sync(kAll, iz, 1);
    const bool joins = live && lane > 0 && px == ix && py == iy && pz == iz;
    const unsigned heads = __ballot_sync(kAll, !joins);
    const bool scan = heads != kAll;  // some run is longer than one lane (warp-uniform)
    const int start = 31 - __clz(heads & upto_lane);  // first lane of my run
    const bool adds = live && (lane == 31 || ((heads >> (lane + 1)) & 1u));

    const float wx[2] = {1.f - tx, tx};
    const float wy[2] = {1.f - ty, ty};
    const float wz[2] = {1.f - tz, tz};
    float lx = 0.f, ly = 0.f, lz = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // corners k (cx = 0) and 4 + k (cx = 1)
      const int cy = k >> 1, cz = k & 1;
      const float wyz = wy[cy] * wz[cz];
      float da[F], db[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        da[f] = wx[0] * wyz * g[f];
        db[f] = wx[1] * wyz * g[f];
      }
      if (scan) {  // a segmented inclusive scan: each run's sums in its last lane
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float va = __shfl_up_sync(kAll, da[f], off);
            const float vb = __shfl_up_sync(kAll, db[f], off);
            if (lane - off >= start) {
              da[f] += va;
              db[f] += vb;
            }
          }
        }
      }
      // the same for every lane of a run: the cell fixes them
      const long long a = corner_flat(lv, l, ix, iy + cy, iz + cz);
      const long long b = corner_flat(lv, l, ix + 1, iy + cy, iz + cz);
      if (adds) {  // a zero entry takes none
        if (a >= 0) add_entry<F>(acc, a, da, s_scale + l * F);
        if (b >= 0) add_entry<F>(acc, b, db, s_scale + l * F);
      }
      if (needs_pos_grad && live) {
        float va[F], vb[F];
        load_pair<F>(table, a, b, va, vb);
        float dwa = 0.f, dwb = 0.f;  // d out_l / d w_c, contracted with g
#pragma unroll
        for (int f = 0; f < F; ++f) {
          dwa += g[f] * va[f];
          dwb += g[f] * vb[f];
        }
        const float s = wx[0] * dwa + wx[1] * dwb;
        lx += wyz * (dwb - dwa);
        ly += (cy ? 1.f : -1.f) * wz[cz] * s;
        lz += (cz ? 1.f : -1.f) * wy[cy] * s;
      }
    }
    dx += r * lx;
    dy += r * ly;
    dz += r * lz;
  }

  if (needs_pos_grad) {  // a kernel argument: uniform over the block
    s_dpos[warp * TILE * 3 + 3 * lane] = dx;
    s_dpos[warp * TILE * 3 + 3 * lane + 1] = dy;
    s_dpos[warp * TILE * 3 + 3 * lane + 2] = dz;
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < num_warps; ++w) s += s_dpos[w * TILE * 3 + i];
      dpos[3 * p0 + i] = s;
    }
  }
}

static int fill_corner_levels(CornerLevels* lv, int num_levels, const int* res,
                              const int* rows, const int* offset,
                              const int* direct) {
  if (num_levels < 1 || num_levels > CORNER_MAX_LEVELS) return 0;
  lv->num_levels = num_levels;
  for (int l = 0; l < num_levels; ++l) {
    lv->res[l] = res[l];
    lv->rows[l] = rows[l];
    lv->offset[l] = offset[l];
    lv->direct[l] = direct[l];
  }
  return 1;
}

// One warp a level up to MAX_WARPS levels; more levels loop over the warps.
static dim3 tile_block(int num_levels) {
  return dim3(TILE * (num_levels < MAX_WARPS ? num_levels : MAX_WARPS));
}

static unsigned tiles(int num_points) {
  return (unsigned)((num_points + TILE - 1) / TILE);
}

// Grid of a launch: the point tiles of a scene by the scenes.
static dim3 scene_grid(int num_points, int num_scenes) {
  return dim3(tiles(num_points), (unsigned)num_scenes);
}

// What every launch takes beyond its pointers.
struct CornerLaunch {
  int num_points, num_scenes, needs_pos_grad;
  long long pos_stride, table_stride;
};

template <int F>
static void launch_fwd(cudaStream_t stream, const float* pos,
                       const float* table, float* out, const CornerLaunch& c,
                       const CornerLevels& lv) {
  const dim3 block = tile_block(lv.num_levels);
  corner_encode_fwd_kernel<F><<<scene_grid(c.num_points, c.num_scenes), block,
                                fwd_smem(lv.num_levels * F), stream>>>(
      pos, table, out, c.num_points, c.pos_stride, c.table_stride, lv);
}

static long long table_rows(const CornerLevels& lv) {
  return (long long)lv.offset[lv.num_levels - 1] + lv.rows[lv.num_levels - 1];
}

template <int F>
static void launch_bwd(cudaStream_t stream, const float* pos,
                       const float* table, const float* grad, float* dtable,
                       float* dpos, void* work, const CornerLaunch& c,
                       const CornerLevels& lv) {
  const int width = lv.num_levels * F;
  const long long entries = table_rows(lv) * F;
  fixed_begin(stream, work, entries, grad, c.num_points, width, c.num_scenes);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(work);
  const dim3 block = tile_block(lv.num_levels);
  corner_encode_bwd_kernel<F><<<scene_grid(c.num_points, c.num_scenes), block,
                                bwd_smem(width, block.x / 32), stream>>>(
      pos, table, grad, acc,
      reinterpret_cast<const unsigned*>(acc + entries * c.num_scenes), dpos,
      c.num_points, c.pos_stride, c.table_stride, entries, c.needs_pos_grad, lv);
  fixed_end(stream, work, entries, dtable, c.num_points, F, F, lv, c.num_scenes);
}

static int bad_scenes(int num_scenes, long long table_stride) {
  return num_scenes < 1 || num_scenes > 65535 || table_stride % 4;
}

// Plain C interface, loaded with ctypes. Pointers are device pointers except
// the four per-level arrays, which are host arrays copied into the kernel's
// parameters. 1 <= num_features <= CORNER_MAX_FEATURES; the table is 16-byte
// aligned. num_scenes scenes (1..65535) of num_points points each: scene s
// reads pos + s * pos_stride ([P, 3]) and table + s * table_stride
// ([L*T, F]), strides in floats (0: one array for every scene; the table's
// a multiple of 4, so every scene's table is 16-byte aligned), and writes
// out[s] of a contiguous [S, P, L*F]. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int corner_encode_fwd(const float* pos, const float* table,
                                 float* out, int num_points, int num_scenes,
                                 long long pos_stride, long long table_stride,
                                 int num_features, int num_levels,
                                 const int* res, const int* rows,
                                 const int* offset, const int* direct,
                                 void* stream) {
  CornerLevels lv;
  if (!fill_corner_levels(&lv, num_levels, res, rows, offset, direct) ||
      bad_scenes(num_scenes, table_stride))
    return (int)cudaErrorInvalidValue;
  if (num_points <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const CornerLaunch c{num_points, num_scenes, 0, pos_stride, table_stride};
#define CORNER_FWD_CASE(F)                                                  \
  case F:                                                                   \
    launch_fwd<F>(s, pos, table, out, c, lv);                               \
    break;
  switch (num_features) {
    CORNER_FWD_CASE(1)
    CORNER_FWD_CASE(2)
    CORNER_FWD_CASE(3)
    CORNER_FWD_CASE(4)
    CORNER_FWD_CASE(5)
    CORNER_FWD_CASE(6)
    CORNER_FWD_CASE(7)
    CORNER_FWD_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CORNER_FWD_CASE
  return (int)cudaGetLastError();
}

// Bytes of the backward's work buffer at a table of total_rows rows, for
// num_scenes scenes.
extern "C" long long corner_encode_bwd_work_bytes(long long total_rows,
                                                  int num_features,
                                                  int num_levels, int num_scenes) {
  return fixed_work_bytes(total_rows * num_features, num_levels * num_features, num_scenes);
}

// Scenes, strides and table as in corner_encode_fwd; grad is a contiguous
// [S, P, L*F], dtable a contiguous [S, L*T, F] and dpos [S, P, 3]. dtable
// is written whole (every row, touched or not); work is
// corner_encode_bwd_work_bytes long and 8-byte aligned; dpos is written
// only when needs_pos_grad is nonzero. With no points dtable is zeroed.
extern "C" int corner_encode_bwd(const float* pos, const float* table,
                                 const float* grad, float* dtable, float* dpos,
                                 void* work, int num_points, int num_scenes,
                                 long long pos_stride, long long table_stride,
                                 int num_features, int needs_pos_grad,
                                 int num_levels, const int* res,
                                 const int* rows, const int* offset,
                                 const int* direct, void* stream) {
  CornerLevels lv;
  if (!fill_corner_levels(&lv, num_levels, res, rows, offset, direct) ||
      bad_scenes(num_scenes, table_stride))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_points <= 0)
    return (int)cudaMemsetAsync(
        dtable, 0, sizeof(float) * table_rows(lv) * num_features * num_scenes, s);
  const CornerLaunch c{num_points, num_scenes, needs_pos_grad, pos_stride, table_stride};
#define CORNER_BWD_CASE(F)                                                  \
  case F:                                                                   \
    launch_bwd<F>(s, pos, table, grad, dtable, dpos, work, c, lv);          \
    break;
  switch (num_features) {
    CORNER_BWD_CASE(1)
    CORNER_BWD_CASE(2)
    CORNER_BWD_CASE(3)
    CORNER_BWD_CASE(4)
    CORNER_BWD_CASE(5)
    CORNER_BWD_CASE(6)
    CORNER_BWD_CASE(7)
    CORNER_BWD_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CORNER_BWD_CASE
  return (int)cudaGetLastError();
}
