// wgmma_tile_check: the tile helpers of the wgmma backward (csrc/sm90.cuh)
// held on their own, on one warpgroup, against torch.matmul.  Replaces no
// Pallas kernel: it checks the building blocks that flash_attention_bwd.cu
// stands on, at head dim 64, over several key tiles (the width and walk at
// which an earlier wgmma attention trial went wrong):
//   TMA boxes of 64 x 64 bf16 into 128-byte-swizzled panels;
//   s_j = K_j · qᵀ        (both operands K-major in shared memory; the Sᵀ of
//                          the backward);
//   y  += bf16(s_j) · dout (A from the accumulator's registers, B MN-major; the
//                          dV product);
//   z  += bf16(s_j)ᵀ · K_j (A written by the threads into a swizzled panel and
//                          read MN-major, B MN-major; the dQ product).
// Plain version: kernels/flash_attention/tiles.py.  Bound: a few microseconds of
// launch; it is a check, not a path.
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace port::sm90;

constexpr int PANEL = 64 * 128;   // bytes of a 64 x 64 bf16 panel

__global__ void __launch_bounds__(128)
    tile_check_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tdo, int nk, float* __restrict__ s_out,
                      float* __restrict__ y_out, float* __restrict__ z_out) {
  extern __shared__ __align__(1024) unsigned char raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* q_s = sm;
  unsigned char* do_s = sm + PANEL;
  unsigned char* k_s = sm + 2 * PANEL;
  unsigned char* p_s = sm + 3 * PANEL;   // bf16(s_j)ᵀ: rows keys, columns queries
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 4 * PANEL);
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_tx(bar, 2 * PANEL);
    tma_load_2d(q_s, &tq, bar, 0, 0);
    tma_load_2d(do_s, &tdo, bar, 0, 0);
  }
  mbar_wait(bar, 0);

  float y[32], z[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) y[r] = z[r] = 0.0f;
  const uint32_t aq = smem_u32(q_s), ado = smem_u32(do_s), ak = smem_u32(k_s), ap = smem_u32(p_s);

  for (int j = 0; j < nk; ++j) {
    if (tid == 0) {
      mbar_arrive_tx(bar, PANEL);
      tma_load_2d(k_s, &tk, bar, 0, 64 * j);
    }
    mbar_wait(bar, (j + 1) & 1);

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<0, 0>(s, desc(ak + kk * 32, 16, 1024), desc(aq + kk * 32, 16, 1024), kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(s);

    float* so = s_out + static_cast<long long>(j) * 64 * 64;
    uint32_t p[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int jb = m >> 1, i = m & 1;
      const int row = 16 * w + (l >> 2) + 8 * i, col = 8 * jb + 2 * (l & 3);
      so[row * 64 + col] = s[2 * m];
      so[row * 64 + col + 1] = s[2 * m + 1];
      p[m] = bf16x2(s[2 * m], s[2 * m + 1]);
      *reinterpret_cast<uint32_t*>(p_s + swizzled(row, col)) = p[m];
    }
    fence_proxy_async();
    __syncthreads();

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<1>(y, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                desc(ado + kk * 16 * 128, PANEL, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<1, 1>(z, desc(ap + kk * 16 * 128, PANEL, 1024), desc(ak + kk * 16 * 128, PANEL, 1024),
                   1);
    wg_commit();
    wg_wait<0>();
    pin(y);
    pin(z);
    __syncthreads();   // k_s and p_s are rewritten next
  }

#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int jb = r >> 2, i = (r >> 1) & 1, e = r & 1;
    const int row = 16 * w + (l >> 2) + 8 * i, col = 8 * jb + 2 * (l & 3) + e;
    y_out[row * 64 + col] = y[r];
    z_out[row * 64 + col] = z[r];
  }
}

}  // namespace

// q, dout: (64, 64) bf16; k: (nk·64, 64) bf16; s_out: (nk, 64, 64) float32
// (rows keys); y_out, z_out: (64, 64) float32.
extern "C" int port_wgmma_tile_check(const void* q, const void* k, const void* dout, int nk,
                                     float* s_out, float* y_out, float* z_out,
                                     cudaStream_t stream) {
  CUtensorMap tq, tk, tdo;
  const cuuint64_t dq[2] = {64, 64}, dk[2] = {64, static_cast<cuuint64_t>(nk) * 64};
  const cuuint64_t stride[1] = {128};
  const cuuint32_t box[2] = {64, 64};
  cudaError_t err = make_map(&tq, q, 2, dq, stride, box);
  if (err == cudaSuccess) err = make_map(&tk, k, 2, dk, stride, box);
  if (err == cudaSuccess) err = make_map(&tdo, dout, 2, dq, stride, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = 4 * PANEL + 1024 + 64;
  err = cudaFuncSetAttribute(tile_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_check_kernel<<<1, 128, bytes, stream>>>(tq, tk, tdo, nk, s_out, y_out, z_out);
  return static_cast<int>(cudaGetLastError());
}
