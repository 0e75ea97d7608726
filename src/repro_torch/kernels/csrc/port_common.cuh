// Device helpers shared by the port's kernels (repro_torch/kernels/*/csrc).
//
// Floating-point arithmetic in these kernels goes through the _rn
// intrinsics (__fadd_rn, __fmul_rn, ...) wherever the order of operations
// must match the plain PyTorch version: nvcc may not contract them into an
// FMA, so each product and sum is rounded once, as torch and XLA round them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace port {

// ---- threefry2x32, the JAX PRNG (repro_torch/prng.py) ----------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                             uint32_t x1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// jax.random.gumbel (mode "low") from one element's 32 random bits:
// u uniform on [tiny, 1), then -log(-log(u)) with the precise logf.
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float tiny = 1.17549435e-38f;  // FLT_MIN, jnp.finfo(float32).tiny
  float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  u = fmaxf(tiny, __fadd_rn(__fmul_rn(u, __fsub_rn(1.0f, tiny)), tiny));
  return -logf(-logf(u));
}

// ---- padded CSC column access (flat PaddedCSC or TieredCSC) ----------------

struct Cols {
  const int* idx;         // (D, width) light-tier row ids (the whole table when flat)
  const float* val;       // (D, width)
  const int* nnz;         // (D,) true column counts
  const int* heavy_slot;  // (D,) heavy-table row of each heavy column (unused when flat)
  const int* hidx;        // (H, full) heavy-tier row ids
  const float* hval;      // (H, full)
  int width;              // light-tier pad width (== full when flat)
  int full;               // heavy-tier pad width

  // Live lanes of column j: sets ri/rv to its row ids/values, returns nnz[j].
  __device__ __forceinline__ int col(int j, const int*& ri, const float*& rv) const {
    const int k = nnz[j];
    if (k > width) {
      const long long s = heavy_slot[j];
      ri = hidx + s * full;
      rv = hval + s * full;
    } else {
      ri = idx + static_cast<long long>(j) * width;
      rv = val + static_cast<long long>(j) * width;
    }
    return k;
  }
};

// ---- block reductions with a fixed order (bitwise reproducible) -------------

// (v, i) beats (bv, bi): larger value, ties to the lower index (jnp.argmax).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

struct ArgMax {
  float v;
  int i;
};

template <int THREADS>
__device__ ArgMax block_argmax(float v, int i) {
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? sv[lane] : -INFINITY;
    i = lane < THREADS / 32 ? si[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  const ArgMax r{sv[0], si[0]};
  __syncthreads();  // the arrays are reused by the next call
  return r;
}

template <int THREADS>
__device__ float block_sum(float x) {
  __shared__ float s[THREADS];
  s[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + stride]);
    __syncthreads();
  }
  const float r = s[0];
  __syncthreads();
  return r;
}

}  // namespace port
