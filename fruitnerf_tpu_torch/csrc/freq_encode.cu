// Frequency encoding (nerf_encode), forward and backward, for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves nerf_encode
// (fruitnerf_tpu/fields/encodings.py) to XLA, which fuses the product, the
// sines and cosines and the concatenation into their consumer. ATen runs it
// as a product, sin, cos, a concatenation and a cast to the MLP's dtype, and
// its concatenation copies rows 33, 45 or 87 values wide (no multiple of 4,
// so no vector access) at 0.18-0.25 TB/s of the H100's 3.35 (PERF.md).
//
// What it computes, for a row x of D values (1..4) and F octaves (1..16):
//   out = [x_0 .. x_{D-1}, sin(x_d f_k) .., cos(x_d f_k) ..]
// the sines and the cosines each d-major (column D + d*F + k, and D + D*F +
// d*F + k), f_k = float32(pi) * 2^k, the value torch.linspace and ** give.
// The product is rounded once (no contraction into an FMA), its sine and
// cosine are the precise sinf and cosf that ATen's sin and cos call (the
// build has no fast-math flag), and each value is rounded once to the output
// type: float, or bf16 to nearest even as .to(torch.bfloat16) rounds. So
// the forward equals the plain composition, and its cast, bitwise.
// The backward reads x and the output's gradient, in the type the forward
// wrote, and recomputes the sines and cosines:
//   dx_d = g_d + sum_k u_k,
//   u_k = (g_sin,dk cos(x_d f_k) - g_cos,dk sin(x_d f_k)) f_k
// every product and difference rounded once, as autograd's sin, cos and mul
// backwards round them, and the octaves summed in the order ATen's CUDA sum
// reduces a contiguous row of F values: lane l of the B = 2^floor(log2 F)
// lanes holds (0 + u_l) + (0 + u_{l+B}), and the lanes meet in a halving
// tree (l with l + B/2, then l + B/4, ...). So on the card the backward
// equals autograd of the plain composition bitwise (the plain version's
// closed form, freq_encode_bwd_torch, sums in the same order). Nothing but x
// is saved for it.
//
// Bound: the output's bytes, D (1 + 2F) values a row written once (the
// backward: the gradient's bytes, read once), then the sinf/cosf arithmetic.
// Rows are the width above, which misaligns them for vector access, but a
// block's rows are one contiguous span: the forward builds its tile in shared
// memory, element by element, then stores the span as 16-byte vectors; the
// backward loads its gradient span into shared memory the same way. A tile
// is a multiple of 8 rows, so every span starts 16-byte aligned. Rows are
// independent, so a scene axis (torch.func.vmap over scenes) is more rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FREQ_MAX_DIMS 4
#define FREQ_MAX_OCTAVES 16
#define FREQ_THREADS 256
#define FREQ_TILE_BYTES 32768  // a block's staged span, at most
#define FREQ_MAX_TILE_ROWS 512

// i / n for 0 <= i < 2^15 and 1 <= n <= 132 (a tile's element indices and
// the widths): the quotient's fraction lies at least 1/264 from an integer,
// far above the float product's error, so truncation gives it exactly, in
// three instructions where an integer division by a runtime n takes many
static __device__ __forceinline__ int quot(int i, float inv_n) {
  return (int)(((float)i + 0.5f) * inv_n);
}

// float32(pi) * 2^k, exact (a power-of-two scaling)
static __device__ __forceinline__ float band(int k) {
  return __fmul_rn(3.14159274101257324f, (float)(1 << k));
}

static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
static __device__ __forceinline__ float get(const float* p) { return *p; }
static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(FREQ_THREADS)
    freq_encode_fwd_kernel(const float* __restrict__ x, T* __restrict__ out,
                           long long rows, int dims, int octaves,
                           int tile_rows) {
  extern __shared__ int4 smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int width = dims * (1 + 2 * octaves), df = dims * octaves;
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int n = (int)min((long long)tile_rows, rows - row0);
  const float* xt = x + row0 * dims;
  const float inv_dims = 1.0f / dims, inv_df = 1.0f / df,
              inv_octaves = 1.0f / octaves;
  for (int i = threadIdx.x; i < n * dims; i += blockDim.x) {
    const int r = quot(i, inv_dims);
    put(tile + r * width + (i - r * dims), xt[i]);
  }
  for (int i = threadIdx.x; i < n * df; i += blockDim.x) {
    const int r = quot(i, inv_df), j = i - r * df, d = quot(j, inv_octaves);
    const float s = __fmul_rn(xt[r * dims + d], band(j - d * octaves));
    T* o = tile + r * width + dims + j;
    put(o, sinf(s));
    put(o + df, cosf(s));
  }
  __syncthreads();
  T* ot = out + row0 * width;
  const int elems = n * width, per = 16 / sizeof(T), vecs = elems / per;
  int4* ov = reinterpret_cast<int4*>(ot);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) ov[i] = smem[i];
  for (int i = vecs * per + threadIdx.x; i < elems; i += blockDim.x)
    ot[i] = tile[i];
}

// u_k of the header, from the gradients of its sine (gs[k]) and cosine
// (gc[k]) columns
template <typename T>
static __device__ __forceinline__ float octave_term(const T* gs, const T* gc,
                                                    float x, int k) {
  const float f = band(k), s = __fmul_rn(x, f);
  return __fmul_rn(__fsub_rn(__fmul_rn(get(gs + k), cosf(s)),
                             __fmul_rn(get(gc + k), sinf(s))),
                   f);
}

// sum_k u_k in ATen's order (header): lanes taken in bit-reversed order and
// merged pairwise as they come, which walks the halving tree
template <typename T>
static __device__ __forceinline__ float octave_sum(const T* gs, const T* gc,
                                                   float x, int octaves) {
  const int bits = 31 - __clz(octaves), lanes = 1 << bits;
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f, v = 0.0f;
  for (int m = 0; m < lanes; ++m) {
    const int l = bits ? (int)(__brev(m) >> (32 - bits)) : 0;
    v = __fadd_rn(0.0f, octave_term(gs, gc, x, l));
    if (l + lanes < octaves)
      v = __fadd_rn(v, __fadd_rn(0.0f, octave_term(gs, gc, x, l + lanes)));
    if (m & 1) {
      v = __fadd_rn(p0, v);
      if (m & 2) {
        v = __fadd_rn(p1, v);
        if (m & 4) {
          v = __fadd_rn(p2, v);
          if (m & 8) v = __fadd_rn(p3, v);
          else p3 = v;
        } else {
          p2 = v;
        }
      } else {
        p1 = v;
      }
    } else {
      p0 = v;
    }
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(FREQ_THREADS)
    freq_encode_bwd_kernel(const float* __restrict__ x,
                           const T* __restrict__ grad, float* __restrict__ dx,
                           long long rows, int dims, int octaves,
                           int tile_rows) {
  extern __shared__ int4 smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int width = dims * (1 + 2 * octaves), df = dims * octaves;
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int n = (int)min((long long)tile_rows, rows - row0);
  const T* gt = grad + row0 * width;
  const int elems = n * width, per = 16 / sizeof(T), vecs = elems / per;
  const int4* gv = reinterpret_cast<const int4*>(gt);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) smem[i] = gv[i];
  for (int i = vecs * per + threadIdx.x; i < elems; i += blockDim.x)
    tile[i] = gt[i];
  __syncthreads();
  const float* xt = x + row0 * dims;
  const float inv_dims = 1.0f / dims;
  for (int i = threadIdx.x; i < n * dims; i += blockDim.x) {
    const int r = quot(i, inv_dims), d = i - r * dims;
    const T* gs = tile + r * width + dims + d * octaves;  // its sines' gradient
    dx[row0 * dims + i] = __fadd_rn(get(tile + r * width + d),
                                    octave_sum(gs, gs + df, xt[i], octaves));
  }
}

// Rows a block takes: a multiple of 8 (a 16-byte aligned span in either
// type) whose span fits FREQ_TILE_BYTES.
static int tile_rows(int width, int elem_bytes) {
  int rows = (FREQ_TILE_BYTES / (width * elem_bytes)) & ~7;
  rows = rows < 8 ? 8 : rows;
  return rows > FREQ_MAX_TILE_ROWS ? FREQ_MAX_TILE_ROWS : rows;
}

static bool valid(long long rows, int dims, int octaves, int bf16) {
  return rows >= 0 && dims >= 1 && dims <= FREQ_MAX_DIMS && octaves >= 1 &&
         octaves <= FREQ_MAX_OCTAVES && (bf16 == 0 || bf16 == 1);
}

template <typename T>
static int launch_fwd(const float* x, void* out, long long rows, int dims,
                      int octaves, cudaStream_t s) {
  const int width = dims * (1 + 2 * octaves);
  const int tr = tile_rows(width, sizeof(T));
  const long long blocks = (rows + tr - 1) / tr;
  freq_encode_fwd_kernel<T><<<(unsigned)blocks, FREQ_THREADS,
                              (size_t)tr * width * sizeof(T), s>>>(
      x, reinterpret_cast<T*>(out), rows, dims, octaves, tr);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const float* x, const void* grad, float* dx,
                      long long rows, int dims, int octaves, cudaStream_t s) {
  const int width = dims * (1 + 2 * octaves);
  const int tr = tile_rows(width, sizeof(T));
  const long long blocks = (rows + tr - 1) / tr;
  freq_encode_bwd_kernel<T><<<(unsigned)blocks, FREQ_THREADS,
                              (size_t)tr * width * sizeof(T), s>>>(
      x, reinterpret_cast<const T*>(grad), dx, rows, dims, octaves, tr);
  return (int)cudaGetLastError();
}

// x a contiguous [rows, dims] float; out a contiguous [rows, dims (1 + 2
// octaves)] of float (out_bf16 0) or bf16 (1), 16-byte aligned.
extern "C" int freq_encode_fwd(const float* x, void* out, long long rows,
                               int dims, int octaves, int out_bf16,
                               void* stream) {
  if (!valid(rows, dims, octaves, out_bf16)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? launch_fwd<__nv_bfloat16>(x, out, rows, dims, octaves, s)
                  : launch_fwd<float>(x, out, rows, dims, octaves, s);
}

// grad as the forward's out (its type by grad_bf16, 16-byte aligned); dx a
// contiguous [rows, dims] float.
extern "C" int freq_encode_bwd(const float* x, const void* grad, float* dx,
                               long long rows, int dims, int octaves,
                               int grad_bf16, void* stream) {
  if (!valid(rows, dims, octaves, grad_bf16)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return grad_bf16
             ? launch_bwd<__nv_bfloat16>(x, grad, dx, rows, dims, octaves, s)
             : launch_bwd<float>(x, grad, dx, rows, dims, octaves, s);
}
