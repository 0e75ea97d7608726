// Shared-memory cost of a warp's load by width and by which lanes share an
// address, on the card (tools/time_flash_bwd.py --smem builds and runs it).
// Blocks of 8 warps, 4 an SM; every warp issues ITERS × 8 loads of one pattern
// and adds what it read (all four floats of an LDS.128, so that the compiler
// keeps the full width).  Each block records its SM and the SM's clock64 at its
// loop's start and end; an SM's cycles a warp load are the span from its first
// block's start to its last block's end over the loads its blocks issued, and
// the line gives their mean over the SMs.  Lane l reads element
// (l / SHARE) % DISTINCT: DISTINCT elements, each read by SHARE consecutive
// lanes (SHARE = 1: lane l % DISTINCT), consecutive in shared memory and free
// of bank conflicts.  Prints one JSON line a pattern.
#include <cstdio>
#include <cuda_runtime.h>

constexpr int ITERS = 2048, WARPS = 8, BLOCKS_PER_SM = 4;

__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

template <int W, int DISTINCT, int SHARE>
__global__ void __launch_bounds__(32 * WARPS) probe(float* out, long long* span) {
  __shared__ float4 tile[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tile[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31, idx = (lane / SHARE) % DISTINCT;
  const float* base = reinterpret_cast<const float*>(tile);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long t0 = clock64();
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = (idx * W + 128 * j + 4 * it) & 4095;   // a multiple of W
      if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(base + e);
        acc[j & 3] += (v.x + v.y) + (v.z + v.w);
      } else if constexpr (W == 2) {
        const float2 v = *reinterpret_cast<const float2*>(base + e);
        acc[j & 3] += v.x + v.y;
      } else {
        acc[j & 3] += base[e];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    span[3 * blockIdx.x] = smid();
    span[3 * blockIdx.x + 1] = t0;
    span[3 * blockIdx.x + 2] = clock64();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int W, int DISTINCT, int SHARE>
void run(int sms, float* out, long long* span, long long* host, const char* kernels_use) {
  const int blocks = sms * BLOCKS_PER_SM;
  probe<W, DISTINCT, SHARE><<<blocks, 32 * WARPS>>>(out, span);   // warm-up
  probe<W, DISTINCT, SHARE><<<blocks, 32 * WARPS>>>(out, span);
  cudaMemcpy(host, span, 3 * blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  double total = 0;
  int used = 0;
  for (int s = 0; s < sms; ++s) {
    long long lo = -1, hi = -1;
    int n = 0;
    for (int b = 0; b < blocks; ++b) {
      if (host[3 * b] != s) continue;
      lo = (lo < 0 || host[3 * b + 1] < lo) ? host[3 * b + 1] : lo;
      hi = host[3 * b + 2] > hi ? host[3 * b + 2] : hi;
      ++n;
    }
    if (n == 0) continue;
    total += static_cast<double>(hi - lo) / (static_cast<double>(n) * WARPS * ITERS * 8);
    ++used;
  }
  const int per_quarter = SHARE >= 8 ? 1 : (8 / SHARE < DISTINCT ? 8 / SHARE : DISTINCT);
  printf("{\"load\": \"LDS.%d\", \"distinct_a_warp\": %d, \"lanes_an_address\": %d, "
         "\"distinct_a_quarter_warp\": %d, \"sm_cycles_a_warp_load\": %.3f, \"as_in\": \"%s\"}\n",
         32 * W, DISTINCT, 32 / DISTINCT, per_quarter, total / used, kernels_use);
}

int main() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  float* out;
  long long* span;
  cudaMalloc(&out, sizeof(float) * sms * BLOCKS_PER_SM * 32 * WARPS);
  cudaMalloc(&span, 3 * sizeof(long long) * sms * BLOCKS_PER_SM);
  long long* host = new long long[3 * sms * BLOCKS_PER_SM];
  run<4, 32, 1>(sms, out, span, host, "");
  run<4, 16, 1>(sms, out, span, host, "the backward's q, dout, K columns (16 lanes)");
  run<4, 8, 1>(sms, out, span, host, "the forward's K and V columns (8 lanes)");
  run<4, 4, 8>(sms, out, span, host, "the forward's q and P rows (4 row groups)");
  run<4, 2, 16>(sms, out, span, host, "the backward's K, V, dS rows (2 row groups)");
  run<4, 4, 1>(sms, out, span, host, "");
  run<4, 2, 1>(sms, out, span, host, "");
  run<4, 1, 32>(sms, out, span, host, "");
  run<2, 32, 1>(sms, out, span, host, "");
  run<1, 32, 1>(sms, out, span, host, "");
  const cudaError_t err = cudaDeviceSynchronize();
  delete[] host;
  return err == cudaSuccess ? 0 : 1;
}
