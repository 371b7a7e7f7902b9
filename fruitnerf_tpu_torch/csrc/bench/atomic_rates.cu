// Rates of the global and shared-memory atomic adds that a dTable
// reduction can be built from, at the access patterns of the grid backward
// kernels (csrc/cell_encode.cu, csrc/corner_encode.cu). A program of its
// own, not part of the port's kernel library; PERF.md's atomic rates come
// from it. On the card, from the root of the repo:
//
//   mkdir -p fruitnerf_tpu_torch/_build/bench
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o fruitnerf_tpu_torch/_build/bench/atomic_rates \
//       fruitnerf_tpu_torch/csrc/bench/atomic_rates.cu
//   fruitnerf_tpu_torch/_build/bench/atomic_rates
//   cuobjdump -sass fruitnerf_tpu_torch/_build/bench/atomic_rates | grep -E 'ATOM|RED'
//
// It prints, for a buffer that fits the L2 (8 MiB) and one far past it
// (512 MiB), each pattern's median ms of 10 launches and its atomic
// operations a second. The last command shows which instructions each
// pattern compiled to (pattern 9: one ATOMS or a CAS loop).
//
// Each warp issues ITERS atomic instructions, each at a fresh pseudo-
// random place in a buffer of `entries` 8-byte entries; the pattern says
// how the 32 lanes of one instruction lie:
//   0 u64, 32 lanes on 32 scattered entries
//   1 u64, 8 groups of 4 lanes, each group on one 32-byte sector
//   2 u64, 2 groups of 16 lanes, each group on one 128-byte line
//   3 u64, 32 lanes on 32 consecutive entries (two 128-byte lines)
//   4 float4, 32 lanes on 32 scattered 16-byte pairs of entries
//   5 float2, 32 lanes on 32 scattered entries
//   6 float2, 8 groups of 4 lanes, each group on one 32-byte sector
//   7 f32, 32 lanes on 32 scattered entries
//   8 u32, 32 lanes on 32 scattered entries
//   9 u64 in shared memory, 32 lanes on 32 scattered entries of 2048
//  10 u64, 16 groups of 2 lanes, each group on one 16-byte half sector
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>
#include <vector>

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

template <int PATTERN>
__global__ void atomic_rates_kernel(void* buf, long long entries, int iters) {
  __shared__ unsigned long long s_acc[2048];
  const int lane = threadIdx.x & 31;
  const uint32_t warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (PATTERN == 9) {
    for (int i = threadIdx.x; i < 2048; i += blockDim.x) s_acc[i] = 0ull;
    __syncthreads();
  }
  unsigned long long* u64 = reinterpret_cast<unsigned long long*>(buf);
  const uint32_t n = (uint32_t)entries;  // entries < 2^32
  for (int it = 0; it < iters; ++it) {
    const uint32_t h = mix(warp * 0x9e3779b9u + (uint32_t)it * 0x85ebca6bu);
    const unsigned long long v = (unsigned long long)(lane + 1);
    if (PATTERN == 0) {
      atomicAdd(u64 + mix(h + lane) % n, v);
    } else if (PATTERN == 1) {
      atomicAdd(u64 + (mix(h + (lane >> 2)) % (n / 4)) * 4 + (lane & 3), v);
    } else if (PATTERN == 2) {
      atomicAdd(u64 + (mix(h + (lane >> 4)) % (n / 16)) * 16 + (lane & 15), v);
    } else if (PATTERN == 3) {
      atomicAdd(u64 + (h % (n / 32)) * 32 + lane, v);
    } else if (PATTERN == 4) {
      float4* f4 = reinterpret_cast<float4*>(buf);
      atomicAdd(f4 + mix(h + lane) % (n / 2), make_float4(1.f, 1.f, 1.f, 1.f));
    } else if (PATTERN == 5) {
      float2* f2 = reinterpret_cast<float2*>(buf);
      atomicAdd(f2 + mix(h + lane) % n, make_float2(1.f, 1.f));
    } else if (PATTERN == 6) {
      float2* f2 = reinterpret_cast<float2*>(buf);
      atomicAdd(f2 + (mix(h + (lane >> 2)) % (n / 4)) * 4 + (lane & 3), make_float2(1.f, 1.f));
    } else if (PATTERN == 7) {
      atomicAdd(reinterpret_cast<float*>(buf) + mix(h + lane) % (2 * n), 1.f);
    } else if (PATTERN == 8) {
      atomicAdd(reinterpret_cast<unsigned*>(buf) + mix(h + lane) % (2 * n), 1u);
    } else if (PATTERN == 9) {
      atomicAdd(s_acc + (mix(h + lane) & 2047u), v);
    } else if (PATTERN == 10) {
      atomicAdd(u64 + (mix(h + (lane >> 1)) % (n / 2)) * 2 + (lane & 1), v);
    }
  }
  if (PATTERN == 9) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2048; i += blockDim.x)
      if (s_acc[i] == 0x5eedull) u64[i] = s_acc[i];  // keeps the shared adds alive
  }
}

constexpr int BLOCKS = 132 * 8;  // 8 blocks of 256 threads on each of the 132 SMs
constexpr int ITERS = 256;
constexpr int PATTERNS = 11;
const char* const WHAT[PATTERNS] = {
    "u64, 32 lanes on 32 scattered entries", "u64, 8 sectors of 4 lanes",
    "u64, 2 lines of 16 lanes", "u64, 32 consecutive entries", "float4, 32 scattered",
    "float2, 32 scattered", "float2, 8 sectors of 4 lanes", "f32, 32 scattered",
    "u32, 32 scattered", "u64 shared memory, 32 scattered of 2048",
    "u64, 16 half sectors of 2 lanes"};

template <int P>
void launch(void* buf, long long entries) {
  atomic_rates_kernel<P><<<BLOCKS, 256>>>(buf, entries, ITERS);
}

void launch_pattern(int pattern, void* buf, long long entries) {
  switch (pattern) {
    case 0: launch<0>(buf, entries); break;
    case 1: launch<1>(buf, entries); break;
    case 2: launch<2>(buf, entries); break;
    case 3: launch<3>(buf, entries); break;
    case 4: launch<4>(buf, entries); break;
    case 5: launch<5>(buf, entries); break;
    case 6: launch<6>(buf, entries); break;
    case 7: launch<7>(buf, entries); break;
    case 8: launch<8>(buf, entries); break;
    case 9: launch<9>(buf, entries); break;
    default: launch<10>(buf, entries); break;
  }
}

#define CHECK(x)                                                              \
  do {                                                                        \
    cudaError_t e_ = (x);                                                     \
    if (e_ != cudaSuccess) {                                                  \
      fprintf(stderr, "%s: %s\n", #x, cudaGetErrorString(e_));                \
      return 1;                                                               \
    }                                                                         \
  } while (0)

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  printf("atomic_rates on %s: %d blocks of 256 threads, %d instructions a warp\n", prop.name,
         BLOCKS, ITERS);
  const double ops = double(BLOCKS) * 256 * ITERS;
  cudaEvent_t start, stop;
  CHECK(cudaEventCreate(&start));
  CHECK(cudaEventCreate(&stop));
  for (long long mib : {8LL, 512LL}) {
    void* buf;
    CHECK(cudaMalloc(&buf, mib << 20));
    CHECK(cudaMemset(buf, 0, mib << 20));
    const long long entries = (mib << 20) / 8;
    for (int pattern = 0; pattern < PATTERNS; ++pattern) {
      for (int i = 0; i < 3; ++i) launch_pattern(pattern, buf, entries);
      CHECK(cudaGetLastError());
      std::vector<float> ms(10);
      for (float& t : ms) {
        CHECK(cudaEventRecord(start));
        launch_pattern(pattern, buf, entries);
        CHECK(cudaEventRecord(stop));
        CHECK(cudaEventSynchronize(stop));
        CHECK(cudaEventElapsedTime(&t, start, stop));
      }
      std::sort(ms.begin(), ms.end());
      const float med = ms[ms.size() / 2];
      printf("%lld MiB buffer, pattern %d (%s): %.4f ms, %.2f G ops/s\n", mib, pattern,
             WHAT[pattern], med, ops / (med * 1e-3) / 1e9);
    }
    CHECK(cudaFree(buf));
  }
  return 0;
}
