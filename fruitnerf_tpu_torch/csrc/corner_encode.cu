// Corner-mode multiresolution grid encoding (exact instant-ngp trilinear),
// forward and backward, for Hopper.
//
// Replaces the Pallas TPU kernels of fruitnerf_tpu/ops/pallas/hash_grid.py:
//   forward   _fwd_kernel  (mode="corner", reached through grid_encode_flat /
//                           _fwd_impl)
//   backward  _bwd_kernel  (mode="corner", reached through _bwd_vjp)
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
// [128, F*T/128] table tile and a lane mask, because the TPU has no fast
// gather. Here a corner is one F-float load (float2 at F = 2). The whole
// table of the fruit_nerf corner layout (16 levels x 8192 rows x 2 floats,
// 1 MB) stays in the H100's 50 MB L2, so:
//   * forward: one thread per (point, level) makes eight 8-byte gathers from
//     L2 at scattered rows and writes F floats. It is bound by L2 gather
//     latency, not by DRAM bandwidth or arithmetic.
//   * backward: one thread per point loops over the levels. dTable takes
//     8*F float atomicAdds per (point, level) into a table the wrapper
//     zero-fills; they contend on the coarse levels (level 0 is direct with
//     17^3 = 4913 entries for ~200k points a step). dPos re-reads the eight
//     rows only when it is wanted, and is summed over the levels in
//     registers and written once.
// Everything is float32. The TPU kernel rounds the table and the 8-corner
// sum to the compute dtype, and in its backward the dTable terms and the
// dPos products (bfloat16 on the preset); that divergence is deliberate.
// Making these kernels fast (vector atomics, a shared-memory pre-reduction
// of the coarse levels) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define CORNER_MAX_LEVELS 32
#define CORNER_MAX_FEATURES 8

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

// F floats of flat row `row`; rows are F floats apart, so a row is 8-byte
// aligned at F = 2 and 16-byte aligned at F = 4 (the table is 16-byte
// aligned).
template <int F>
__device__ __forceinline__ void load_entry(const float* __restrict__ table,
                                           long long row, float* v) {
  const float* p = table + row * F;
  if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else if constexpr (F == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(p + f);
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

template <int F>
__global__ void corner_encode_fwd_kernel(const float* __restrict__ pos,
                                         const float* __restrict__ table,
                                         float* __restrict__ out,
                                         int num_points, CornerLevels lv) {
  const int num_levels = lv.num_levels;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)num_points * num_levels) return;
  const int p = (int)(i / num_levels);
  const int l = (int)(i - (long long)p * num_levels);
  int ix, iy, iz;
  float tx, ty, tz;
  cell_of(pos[3 * p], pos[3 * p + 1], pos[3 * p + 2], (float)lv.res[l], &ix,
          &iy, &iz, &tx, &ty, &tz);
  const float wx[2] = {1.f - tx, tx};
  const float wy[2] = {1.f - ty, ty};
  const float wz[2] = {1.f - tz, tz};
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    const int row = corner_row(lv, l, ix + cx, iy + cy, iz + cz);
    if (row < 0) continue;  // zero entry
    float v[F];
    load_entry<F>(table, (long long)lv.offset[l] + row, v);
    const float w = wx[cx] * wy[cy] * wz[cz];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += w * v[f];
  }
  // out is [P, L, F], i.e. [P, L*F] level-major: element i*F + f
  float* o = out + i * F;
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

template <int F>
__global__ void corner_encode_bwd_kernel(const float* __restrict__ pos,
                                         const float* __restrict__ table,
                                         const float* __restrict__ grad,
                                         float* __restrict__ dtable,
                                         float* __restrict__ dpos,
                                         int num_points, int needs_pos_grad,
                                         CornerLevels lv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= num_points) return;
  const int num_levels = lv.num_levels;
  const float x = pos[3 * p], y = pos[3 * p + 1], z = pos[3 * p + 2];
  float dx = 0.f, dy = 0.f, dz = 0.f;
  for (int l = 0; l < num_levels; ++l) {
    const float r = (float)lv.res[l];
    int ix, iy, iz;
    float tx, ty, tz;
    cell_of(x, y, z, r, &ix, &iy, &iz, &tx, &ty, &tz);
    const float wx[2] = {1.f - tx, tx};
    const float wy[2] = {1.f - ty, ty};
    const float wz[2] = {1.f - tz, tz};
    float g[F];
    const float* gp = grad + ((long long)p * num_levels + l) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = gp[f];
    float lx = 0.f, ly = 0.f, lz = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
      const int row = corner_row(lv, l, ix + cx, iy + cy, iz + cz);
      if (row < 0) continue;  // zero entry: no table gradient, no position term
      const long long flat = (long long)lv.offset[l] + row;
      const float w = wx[cx] * wy[cy] * wz[cz];
      float* d = dtable + flat * F;
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(d + f, w * g[f]);
      if (needs_pos_grad) {
        float v[F];
        load_entry<F>(table, flat, v);
        float dw = 0.f;  // d out_l / d w_c, contracted with g
#pragma unroll
        for (int f = 0; f < F; ++f) dw += g[f] * v[f];
        lx += (cx ? 1.f : -1.f) * wy[cy] * wz[cz] * dw;
        ly += (cy ? 1.f : -1.f) * wx[cx] * wz[cz] * dw;
        lz += (cz ? 1.f : -1.f) * wx[cx] * wy[cy] * dw;
      }
    }
    dx += r * lx;
    dy += r * ly;
    dz += r * lz;
  }
  if (needs_pos_grad) {
    dpos[3 * p] = dx;
    dpos[3 * p + 1] = dy;
    dpos[3 * p + 2] = dz;
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

static const int kCornerThreads = 256;

template <int F>
static void launch_fwd(unsigned blocks, cudaStream_t stream, const float* pos,
                       const float* table, float* out, int num_points,
                       const CornerLevels& lv) {
  corner_encode_fwd_kernel<F><<<blocks, kCornerThreads, 0, stream>>>(
      pos, table, out, num_points, lv);
}

template <int F>
static void launch_bwd(unsigned blocks, cudaStream_t stream, const float* pos,
                       const float* table, const float* grad, float* dtable,
                       float* dpos, int num_points, int needs_pos_grad,
                       const CornerLevels& lv) {
  corner_encode_bwd_kernel<F><<<blocks, kCornerThreads, 0, stream>>>(
      pos, table, grad, dtable, dpos, num_points, needs_pos_grad, lv);
}

// Plain C interface, loaded with ctypes. Pointers are device pointers except
// the four per-level arrays, which are host arrays copied into the kernel's
// parameters. 1 <= num_features <= CORNER_MAX_FEATURES. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int corner_encode_fwd(const float* pos, const float* table,
                                 float* out, int num_points, int num_features,
                                 int num_levels, const int* res,
                                 const int* rows, const int* offset,
                                 const int* direct, void* stream) {
  CornerLevels lv;
  if (!fill_corner_levels(&lv, num_levels, res, rows, offset, direct))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)num_points * num_levels;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kCornerThreads - 1) / kCornerThreads);
  const cudaStream_t s = (cudaStream_t)stream;
#define CORNER_FWD_CASE(F)                                                  \
  case F:                                                                   \
    launch_fwd<F>(blocks, s, pos, table, out, num_points, lv);              \
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

// dtable must be zero-filled by the caller; dpos is written only when
// needs_pos_grad is nonzero.
extern "C" int corner_encode_bwd(const float* pos, const float* table,
                                 const float* grad, float* dtable, float* dpos,
                                 int num_points, int num_features,
                                 int needs_pos_grad, int num_levels,
                                 const int* res, const int* rows,
                                 const int* offset, const int* direct,
                                 void* stream) {
  CornerLevels lv;
  if (!fill_corner_levels(&lv, num_levels, res, rows, offset, direct))
    return (int)cudaErrorInvalidValue;
  if (num_points == 0) return 0;
  const unsigned blocks =
      (unsigned)((num_points + kCornerThreads - 1) / kCornerThreads);
  const cudaStream_t s = (cudaStream_t)stream;
#define CORNER_BWD_CASE(F)                                                  \
  case F:                                                                   \
    launch_bwd<F>(blocks, s, pos, table, grad, dtable, dpos, num_points,    \
                  needs_pos_grad, lv);                                      \
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
