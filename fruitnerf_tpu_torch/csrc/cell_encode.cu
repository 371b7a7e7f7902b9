// Cell-mode multiresolution grid encoding, forward and backward, for Hopper.
//
// Replaces the Pallas TPU kernels of fruitnerf_tpu/ops/pallas/hash_grid.py:
//   forward   _cell2_fwd_kernel (:523), through the pallas_call at :702
//             (cell_encode / _cell2_fwd_impl)
//   backward  _cell2_bwd_kernel (:581), through the pallas_call at :777
//             (_cell_encode_bwd)
//
// What it computes, per point p and level l (res_l, T_l rows of 16 floats):
//   s = pos * res_l, cell = floor(s), t = s - cell
//   row = ix + iy*res + iz*res^2               when res^3 <= T_l (direct)
//       = (ix ^ iy*2654435761 ^ iz*805459861) & (T_l - 1)   in uint32
//   out[p, 2l + f] = sum_c w_c(t) * table[offset_l + row][2c + f]
// with trilinear weights w_c over the 8 corners c = 4cx + 2cy + cz. A row
// index outside [0, T_l) (a position at exactly 1.0) reads a zero row and
// takes no gradient, as the TPU kernel's one-hot matches nothing there.
//
// The TPU kernel fetched a cell row with a one-hot matmul (the TPU has no
// fast gather); here a row is four float4 loads. The whole table of the
// fruit_nerf grid variant (12 x 4096 + 4 x 8192 rows x 64 B, about 5.2 MB)
// stays in the H100's 50 MB L2. Neither kernel is bound by arithmetic
// (about 60 and 150 float operations per (point, level)). The forward is
// bound by how its threads meet the table; the backward by how its dTable
// adds lie, not their bytes (bench/atomic_rates.cu on the H100: about 89 G
// scattered 8-byte adds a second with the sums in the L2, 398 G when 16
// lanes add one 128-byte line; PERF.md).
//
// The design: a block takes a tile of 32 consecutive points, one lane per
// point, and its warps take the levels (warp w: levels w, w + W, ...). The
// tile's positions and gradients (or outputs) pass through shared memory,
// read and written as contiguous rows. The train step's points are
// ray-major (48 consecutive samples of one ray), so neighbouring points
// mostly share a cell at the coarse levels: in a warp, lanes that hit the
// same row issue one load for it, and in the backward the lanes of each run
// of consecutive points on one row sum their 16 products with a segmented
// warp scan. dTable is summed in 64-bit fixed point (fixed_sum.cuh), so it
// does not depend on the order of the adds. The run-end lanes stage their
// 16 sums in the warp's shared memory and the whole warp adds them, a row
// (16 entries, one 128-byte line) to each half of the warp, rather than
// each run-end lane issuing 16 scattered 8-byte adds.
// Points that share a row but not a run (a hash collision) add apart.
// dPositions is summed per warp over its levels, then over the warps
// through shared memory, and written once, coalesced. The backward holds
// 63 registers a thread, so two 512-thread blocks fit an SM.
// Everything is float32. The TPU kernel rounds the table, the saved rows
// and the per-point dTable terms to bfloat16; that divergence is deliberate.
//
// A scene axis (blockIdx.y), the counterpart of jax.vmap over the
// pallas_calls: S scenes of P points each, scene s reading its positions
// and table at s times their scene strides (0: one array for every scene)
// and writing its own outputs. The backward's column maxima and fixed-point
// scales are taken per (scene, column) from that scene's gradients, so
// scene s of a batched launch equals a launch of scene s alone, bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

#define CELL_MAX_LEVELS 32
#define TILE 32          // points a block: one per lane
#define MAX_WARPS 16     // warps a block; each takes levels w, w + W, ...

struct CellLevels {
  int num_levels;
  int res[CELL_MAX_LEVELS];
  int rows[CELL_MAX_LEVELS];      // T_l
  int offset[CELL_MAX_LEVELS];    // first row of level l in the flat table
  int direct[CELL_MAX_LEVELS];    // 1 when res^3 <= T_l
};

// Row of the cell that holds (x, y, z) at level l, or -1 when it lies
// outside [0, T_l). Writes the in-cell fractions.
__device__ __forceinline__ int cell_row(const CellLevels& lv, int l, float x,
                                        float y, float z, float* tx,
                                        float* ty, float* tz) {
  const int res = lv.res[l];
  const float r = (float)res;
  const float sx = x * r, sy = y * r, sz = z * r;
  const float fx = floorf(sx), fy = floorf(sy), fz = floorf(sz);
  *tx = sx - fx;
  *ty = sy - fy;
  *tz = sz - fz;
  const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
  if (lv.direct[l]) {
    const long long idx = (long long)ix + (long long)iy * res +
                          (long long)iz * res * res;
    return (idx >= 0 && idx < lv.rows[l]) ? (int)idx : -1;
  }
  const uint32_t h = (uint32_t)ix ^ ((uint32_t)iy * 2654435761u) ^
                     ((uint32_t)iz * 805459861u);
  return (int)(h & (uint32_t)(lv.rows[l] - 1));
}

__device__ __forceinline__ void load_row(const float4* __restrict__ table,
                                         long long row, float v[16]) {
  const float4* p = table + row * 4;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2),
               d = __ldg(p + 3);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
  v[12] = d.x; v[13] = d.y; v[14] = d.z; v[15] = d.w;
}

// The tile's [n, 2L] block of a [P, 2L] array and the shared-memory copy it
// is staged in, with a row stride of 2L + 1 floats so that the 32 lanes of
// a warp, each at its own point and the same level, hit 32 banks.
__device__ __forceinline__ int tile_stride(int num_levels) {
  return 2 * num_levels + 1;
}

__global__ void __launch_bounds__(TILE * MAX_WARPS)
cell_encode_fwd_kernel(const float* __restrict__ pos,
                       const float4* __restrict__ table,
                       float* __restrict__ out, int num_points,
                       long long pos_stride, long long table_stride4,
                       CellLevels lv) {
  __shared__ float s_pos[TILE * 3];
  __shared__ float s_out[TILE * (2 * CELL_MAX_LEVELS + 1)];
  const int num_levels = lv.num_levels;
  const int width = 2 * num_levels, stride = tile_stride(num_levels);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  const long long p0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, (long long)num_points - p0);
  const long long scene = blockIdx.y;
  pos += scene * pos_stride;
  table += scene * table_stride4;
  out += scene * num_points * width;

  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) s_pos[i] = pos[3 * p0 + i];
  __syncthreads();
  const bool live = lane < n;
  const float x = live ? s_pos[3 * lane] : 0.f;
  const float y = live ? s_pos[3 * lane + 1] : 0.f;
  const float z = live ? s_pos[3 * lane + 2] : 0.f;
  for (int l = warp; l < num_levels; l += num_warps) {
    float tx = 0.f, ty = 0.f, tz = 0.f;
    const int row = live ? cell_row(lv, l, x, y, z, &tx, &ty, &tz) : -1;
    float ax = 0.f, ay = 0.f;
    if (row >= 0) {
      float v[16];
      load_row(table, (long long)lv.offset[l] + row, v);
      const float wx[2] = {1.f - tx, tx};
      const float wy[2] = {1.f - ty, ty};
      const float wz[2] = {1.f - tz, tz};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float w = wx[(c >> 2) & 1] * wy[(c >> 1) & 1] * wz[c & 1];
        ax += w * v[2 * c];
        ay += w * v[2 * c + 1];
      }
    }
    s_out[lane * stride + 2 * l] = ax;
    s_out[lane * stride + 2 * l + 1] = ay;
  }
  __syncthreads();
  // out is [P, 2L] float, level-major: the tile's rows are contiguous
  float* dst = out + p0 * width;
  for (int i = threadIdx.x; i < n * width; i += blockDim.x)
    dst[i] = s_out[(i / width) * stride + i % width];
}

// A warp's stage: the sums of its tile's runs at one level, 16 floats a run
// at a row stride of 17 floats (the 32 lanes, each writing its run's entry
// k, hit 32 banks), then after the level loop its lanes' dPositions.
#define RUN_STRIDE 17

__global__ void __launch_bounds__(TILE * MAX_WARPS, 2)
cell_encode_bwd_kernel(const float* __restrict__ pos,
                       const float4* __restrict__ table,
                       const float* __restrict__ grad,
                       unsigned long long* __restrict__ acc,
                       const unsigned* __restrict__ colmax,
                       float* __restrict__ dpos, int num_points,
                       long long pos_stride, long long table_stride4,
                       long long entries, int needs_pos_grad, CellLevels lv) {
  __shared__ double s_scale[2 * CELL_MAX_LEVELS];  // fixed-point scale of each column
  __shared__ float s_pos[TILE * 3];
  __shared__ float s_grad[TILE * (2 * CELL_MAX_LEVELS + 1)];
  __shared__ float s_stage[MAX_WARPS][TILE * RUN_STRIDE];
  __shared__ int s_rows[MAX_WARPS][TILE];
  const unsigned kAll = 0xffffffffu;
  const int num_levels = lv.num_levels;
  const int width = 2 * num_levels, stride = tile_stride(num_levels);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  const long long p0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, (long long)num_points - p0);
  const long long scene = blockIdx.y;
  pos += scene * pos_stride;
  table += scene * table_stride4;
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
  float* stage = s_stage[warp];
  int* rows = s_rows[warp];
  float dx = 0.f, dy = 0.f, dz = 0.f;

  // every lane of the warp runs every iteration: the shuffles need all 32
  for (int l = warp; l < num_levels; l += num_warps) {
    float tx = 0.f, ty = 0.f, tz = 0.f;
    const int row = live ? cell_row(lv, l, x, y, z, &tx, &ty, &tz) : -1;
    // flat row, or -1: a zero row (no gradient) or a lane past the tile
    const int key = row >= 0 ? lv.offset[l] + row : -1;
    const float gx = key >= 0 ? s_grad[lane * stride + 2 * l] : 0.f;
    const float gy = key >= 0 ? s_grad[lane * stride + 2 * l + 1] : 0.f;
    const float wx[2] = {1.f - tx, tx};
    const float wy[2] = {1.f - ty, ty};
    const float wz[2] = {1.f - tz, tz};
    float d[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = wx[(c >> 2) & 1] * wy[(c >> 1) & 1] * wz[c & 1];
      d[2 * c] = w * gx;
      d[2 * c + 1] = w * gy;
    }

    // runs of consecutive lanes on one row: a segmented inclusive scan
    // leaves each run's sum in its last lane
    const int prev = __shfl_up_sync(kAll, key, 1);
    const unsigned heads = __ballot_sync(kAll, lane == 0 || prev != key);
    if (heads != kAll) {  // some run is longer than one lane (warp-uniform)
      const int start = 31 - __clz(heads & upto_lane);  // first lane of my run
      // the scan's steps: log2 of the warp's longest run
      const int longest = (int)__reduce_max_sync(kAll, (unsigned)(lane - start + 1));
      for (int off = 1; off < longest; off <<= 1) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float v = __shfl_up_sync(kAll, d[k], off);
          if (lane - off >= start) d[k] += v;
        }
      }
    }
    // the run-end lanes stage their sums in lane order; the warp adds them,
    // a cell row (16 entries, 128 bytes) to half the warp
    const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
    const unsigned adders = __ballot_sync(kAll, last && key >= 0);
    if (last && key >= 0) {
      const int r = __popc(adders & (upto_lane >> 1));
#pragma unroll
      for (int k = 0; k < 16; ++k) stage[r * RUN_STRIDE + k] = d[k];
      rows[r] = key;
    }
    __syncwarp();
    add_staged<16, 1, 2>(acc, stage, RUN_STRIDE, rows, __popc(adders), s_scale + 2 * l, lane);
    __syncwarp();  // the stage is free for the next level

    if (needs_pos_grad && key >= 0) {
      float v[16];
      load_row(table, key, v);
      const float res = (float)lv.res[l];
      float lx = 0.f, ly = 0.f, lz = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
        const float dw = gx * v[2 * c] + gy * v[2 * c + 1];
        lx += (cx ? 1.f : -1.f) * wy[cy] * wz[cz] * dw;
        ly += (cy ? 1.f : -1.f) * wx[cx] * wz[cz] * dw;
        lz += (cz ? 1.f : -1.f) * wx[cx] * wy[cy] * dw;
      }
      dx += res * lx;
      dy += res * ly;
      dz += res * lz;
    }
  }

  if (needs_pos_grad) {  // a kernel argument: uniform over the block
    stage[3 * lane] = dx;
    stage[3 * lane + 1] = dy;
    stage[3 * lane + 2] = dz;
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < num_warps; ++w) s += s_stage[w][i];
      dpos[3 * p0 + i] = s;
    }
  }
}

static int fill_levels(CellLevels* lv, int num_levels, const int* res,
                       const int* rows, const int* offset, const int* direct) {
  if (num_levels < 1 || num_levels > CELL_MAX_LEVELS) return 0;
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

// Grid of the launch: the point tiles of a scene by the scenes.
static dim3 scene_grid(int num_points, int num_scenes) {
  return dim3(tiles(num_points), (unsigned)num_scenes);
}

// Plain C interface, loaded with ctypes. Pointers are device pointers except
// the four per-level arrays, which are host arrays copied into the kernel's
// parameters. num_scenes scenes (1..65535) of num_points points each: scene
// s reads pos + s * pos_stride ([P, 3]) and table + s * table_stride
// ([sum T_l, 16]), strides in floats (0: one array for every scene; the
// table's a multiple of 4), and writes out[s] of a contiguous [S, P, 2L].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cell_encode_fwd(const float* pos, const float* table,
                               float* out, int num_points, int num_scenes,
                               long long pos_stride, long long table_stride,
                               int num_levels, const int* res, const int* rows,
                               const int* offset, const int* direct,
                               void* stream) {
  CellLevels lv;
  if (!fill_levels(&lv, num_levels, res, rows, offset, direct) ||
      num_scenes < 1 || num_scenes > 65535 || table_stride % 4)
    return (int)cudaErrorInvalidValue;
  if (num_points <= 0) return 0;
  cell_encode_fwd_kernel<<<scene_grid(num_points, num_scenes),
                           tile_block(num_levels), 0, (cudaStream_t)stream>>>(
      pos, reinterpret_cast<const float4*>(table), out, num_points, pos_stride,
      table_stride / 4, lv);
  return (int)cudaGetLastError();
}

static long long table_rows(const CellLevels& lv) {
  return (long long)lv.offset[lv.num_levels - 1] + lv.rows[lv.num_levels - 1];
}

// Bytes of the backward's work buffer at a table of total_rows rows, for
// num_scenes scenes.
extern "C" long long cell_encode_bwd_work_bytes(long long total_rows,
                                                int num_levels, int num_scenes) {
  return fixed_work_bytes(total_rows * 16, 2 * num_levels, num_scenes);
}

// Scenes, strides and table as in cell_encode_fwd; grad is a contiguous
// [S, P, 2L], dtable a contiguous [S, sum T_l, 16] and dpos [S, P, 3].
// dtable is written whole (every row, touched or not); work is
// cell_encode_bwd_work_bytes long and 8-byte aligned; dpos is written only
// when needs_pos_grad is nonzero. With no points dtable is zeroed.
extern "C" int cell_encode_bwd(const float* pos, const float* table,
                               const float* grad, float* dtable, float* dpos,
                               void* work, int num_points, int num_scenes,
                               long long pos_stride, long long table_stride,
                               int needs_pos_grad, int num_levels,
                               const int* res, const int* rows,
                               const int* offset, const int* direct,
                               void* stream) {
  CellLevels lv;
  if (!fill_levels(&lv, num_levels, res, rows, offset, direct) ||
      num_scenes < 1 || num_scenes > 65535 || table_stride % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long entries = table_rows(lv) * 16;
  if (num_points <= 0)
    return (int)cudaMemsetAsync(dtable, 0, sizeof(float) * entries * num_scenes, s);
  fixed_begin(s, work, entries, grad, num_points, 2 * num_levels, num_scenes);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(work);
  cell_encode_bwd_kernel<<<scene_grid(num_points, num_scenes),
                           tile_block(num_levels), 0, s>>>(
      pos, reinterpret_cast<const float4*>(table), grad, acc,
      reinterpret_cast<const unsigned*>(acc + entries * num_scenes), dpos,
      num_points, pos_stride, table_stride / 4, entries, needs_pos_grad, lv);
  fixed_end<16, 2>(s, work, entries, dtable, num_points, lv, num_scenes);
  return (int)cudaGetLastError();
}
