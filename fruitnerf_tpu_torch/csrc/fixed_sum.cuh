// Order-free sums for the dTable of the grid backward kernels
// (cell_encode.cu, corner_encode.cu).
//
// Float atomics add a dTable entry's terms in whatever order the L2 takes
// them, so two runs of one train step differ in the last bits of dTable and
// training does not repeat under one seed. Here each term is rounded once to
// a 64-bit fixed-point integer and added with an integer atomic. Integer
// addition is exact, so the sum does not depend on the order; a last pass
// turns the sums back into float32.
//
// The scale is a power of two chosen per gradient column (level l, feature
// f) from m = max_p |grad[p, l*F + f]|. No dTable entry of that column can
// sum to more than P*m in magnitude: a point adds sum_c w_c |g| <= |g| to an
// entry, since the trilinear weights are non-negative and sum to 1. With
// P*m < 2^e, the scale 2^(61 - e) keeps every partial sum below 2^62, and a
// term is rounded to 2^(e - 61) < P*m*2^-60. At a train step's P = 200,704
// that is 1.7e-13 of m, far finer than float32's rounding of a sum near m.
// A column whose gradient holds a non-finite value gets NaN in every entry
// (float atomics would have put it only in the entries its points touch).
//
// What an add costs on the H100 follows how the warp's lanes lie, not the
// bytes or the operations it carries (bench/atomic_rates.cu, PERF.md): 32 lanes
// on 32 scattered 8-byte entries run at about 89 G adds/s with the sums in
// the L2 and 14 G/s past it, as f32, u32, float2 and float4 adds do; the
// same adds grouped 4 lanes to a 32-byte sector run at 250 and 56 G/s, 16
// lanes to a 128-byte line at 398 and 125 G/s. So a warp adds its runs'
// sums together (add_staged): the run-end lanes put their sums in the
// warp's shared-memory stage, and the warp then adds them with its lanes
// on consecutive entries of one run's rows, a whole 128-byte cell row or a
// corner pair's 2F entries an instruction. (A 64-bit add in shared memory,
// which could merge runs within a block first, compiles to a CAS loop.)
//
// The caller passes one work buffer, zeroed here: the [entries] int64 sums,
// then the [width] column maxima as float bits. It is fixed_work_bytes long.
// With S scenes (the kernels' scene axis) it holds S of each, scene-major:
// [S, entries] sums, then [S, width] maxima, each scene's taken from its
// own gradients alone, so a scene's sums and scales do not depend on the
// other scenes of the launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FIXED_MAX_BITS 0x7f800000u  // float bits at and above it are inf or NaN
#define FIXED_MAX_WIDTH 256          // gradient columns: 32 levels x 8 features

static long long fixed_work_bytes(long long entries, int width, int num_scenes) {
  return (long long)num_scenes *
         (entries * (long long)sizeof(unsigned long long) + (long long)width * sizeof(unsigned));
}

// Scale of a column whose largest |gradient| has float bits `bits` (0 when
// every gradient is zero; then any scale will do).
__device__ __forceinline__ double fixed_scale(unsigned bits, int num_points) {
  if (bits == 0u || bits >= FIXED_MAX_BITS) return 1.0;
  int e;
  frexp((double)num_points * (double)__uint_as_float(bits), &e);  // P*m < 2^e
  return ldexp(1.0, 61 - e);
}

// The warp's adds of its staged runs. `runs` runs lie in `stage`, run r's
// SLOTS sums at stage[r * stride + j]; they go to ROWS rows of dTable,
// rows[r * ROWS + j / (SLOTS / ROWS)] (-1: a zero entry, which takes
// none), each row SLOTS / ROWS consecutive entries; entry e of a row is
// feature e % FEATURES, at scale[feature]. Slot g of the warp's flat list
// goes to lane g % 32, so one instruction adds 32 consecutive slots: the
// 16 entries of two cell rows, or the 2F entries of 32 / (2F) corner pairs.
// Every lane of the warp calls it.
template <int SLOTS, int ROWS, int FEATURES>
__device__ __forceinline__ void add_staged(unsigned long long* __restrict__ acc,
                                           const float* stage, int stride, const int* rows,
                                           int runs, const double* scale, int lane) {
  constexpr int kWidth = SLOTS / ROWS;  // entries a row
#pragma unroll 4
  for (int g = lane; g < runs * SLOTS; g += 32) {
    const int r = g / SLOTS, j = g % SLOTS;
    const int row = rows[r * ROWS + j / kWidth];
    const int e = j % kWidth;
    if (row < 0) continue;
    const long long q = __double2ll_rn((double)stage[r * stride + j] * scale[e % FEATURES]);
    if (q != 0) atomicAdd(acc + (long long)row * kWidth + e, (unsigned long long)q);
  }
}

// Largest |grad| of each of the `width` columns of a row-major [n / width,
// width] float array, as float bits (which order as the floats do); scene
// blockIdx.y's array and maxima follow its predecessors'. The block size and
// the grid's stride are multiples of width, so a thread keeps to one column;
// the block takes each column's maximum over its threads and adds one
// atomicMax a column.
static __global__ void column_max_kernel(const float* __restrict__ grad, long long n,
                                         int width, unsigned* __restrict__ colmax) {
  __shared__ unsigned s_max[FIXED_MAX_WIDTH];
  grad += (long long)blockIdx.y * n;
  colmax += (long long)blockIdx.y * width;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned m = 0u;
  for (long long i = first; i < n; i += stride) m = max(m, __float_as_uint(grad[i]) & 0x7fffffffu);
  s_max[threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.x < width) {  // thread t's column is t % width
    for (int t = threadIdx.x + width; t < blockDim.x; t += width) m = max(m, s_max[t]);
    if (m != 0u) atomicMax(colmax + threadIdx.x, m);
  }
}

// dtable[e] = acc[e] / scale of e's column, level by level (blockIdx.y) and
// scene by scene (blockIdx.z; each scene's `entries` sums and dTable, and
// its columns' maxima, follow its predecessors'): a level's rows are
// ROW_WIDTH floats each, and entry k of a row holds feature k % FEATURES.
template <int ROW_WIDTH, int FEATURES, class Levels>
static __global__ void fixed_to_float_kernel(const long long* __restrict__ acc,
                                             const unsigned* __restrict__ colmax,
                                             float* __restrict__ dtable, long long entries,
                                             int num_points, Levels lv) {
  __shared__ double s_inv[FEATURES];
  __shared__ bool s_bad[FEATURES];
  const int l = blockIdx.y;
  acc += (long long)blockIdx.z * entries;
  dtable += (long long)blockIdx.z * entries;
  colmax += (long long)blockIdx.z * lv.num_levels * FEATURES;
  if (threadIdx.x < FEATURES) {
    const unsigned bits = colmax[l * FEATURES + threadIdx.x];
    s_inv[threadIdx.x] = 1.0 / fixed_scale(bits, num_points);  // a power of two: exact
    s_bad[threadIdx.x] = bits >= FIXED_MAX_BITS;
  }
  __syncthreads();
  const long long begin = (long long)lv.offset[l] * ROW_WIDTH;
  const long long end = begin + (long long)lv.rows[l] * ROW_WIDTH;
  for (long long e = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x; e < end;
       e += (long long)gridDim.x * blockDim.x) {
    const int f = (int)(e % ROW_WIDTH) % FEATURES;
    dtable[e] = s_bad[f] ? __int_as_float(0x7fc00000) : (float)((double)acc[e] * s_inv[f]);
  }
}

// Zeroes the work buffer and writes the column maxima of grad [S, P, width]
// (width <= FIXED_MAX_WIDTH). Every level of the layout is written by the
// conversion, so the whole buffer is zeroed.
static void fixed_begin(cudaStream_t s, void* work, long long entries, const float* grad,
                        int num_points, int width, int num_scenes) {
  cudaMemsetAsync(work, 0, (size_t)fixed_work_bytes(entries, width, num_scenes), s);
  unsigned* colmax = reinterpret_cast<unsigned*>(
      reinterpret_cast<unsigned long long*>(work) + entries * num_scenes);
  const int threads = width * (width < 256 ? 256 / width : 1);
  const long long n = (long long)num_points * width;
  const long long blocks = (n + threads - 1) / threads;
  const dim3 grid((unsigned)(blocks < 512 ? blocks : 512), (unsigned)num_scenes);
  column_max_kernel<<<grid, threads, 0, s>>>(grad, n, width, colmax);
}

// Writes dtable [S, entries] from the sums in the work buffer.
template <int ROW_WIDTH, int FEATURES, class Levels>
static void fixed_end(cudaStream_t s, const void* work, long long entries, float* dtable,
                      int num_points, const Levels& lv, int num_scenes) {
  const long long* acc = reinterpret_cast<const long long*>(work);
  const unsigned* colmax = reinterpret_cast<const unsigned*>(acc + entries * num_scenes);
  int most = 0;
  for (int l = 0; l < lv.num_levels; ++l) most = lv.rows[l] > most ? lv.rows[l] : most;
  const long long blocks = ((long long)most * ROW_WIDTH + 255) / 256;
  const dim3 grid((unsigned)(blocks < 512 ? blocks : 512), (unsigned)lv.num_levels,
                  (unsigned)num_scenes);
  fixed_to_float_kernel<ROW_WIDTH, FEATURES, Levels><<<grid, 256, 0, s>>>(
      acc, colmax, dtable, entries, num_points, lv);
}
