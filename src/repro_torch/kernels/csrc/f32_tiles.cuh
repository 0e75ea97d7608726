// The float32 attention tiles on the CUDA cores, shared by the forward
// (flash_attention/csrc/flash_attention.cu) and the float32 route of the
// backward (flash_attention/csrc/flash_attention_bwd.cu).
//
// Tiles are copied from device memory to shared memory by cp.async, 16 bytes a
// thread, and kept in their row-major layout (a row of `width` floats is
// C = width / 4 chunks of 16 bytes).  Chunk c of row r is stored at
//   r·C + (c ^ ((r / G) % min(C, 8)))
// (`chunk_at`): the products read a float4 of four consecutive columns of
// rows that lie G apart for the lanes of one quarter-warp, and the XOR sends
// them to distinct banks; a read of one row's chunks by the lanes is free of
// conflicts either way.
//
// The loop bounds live here once, as plain functions that the CPU's order
// model (kernels/flash_attention/ref.py visited_tiles) copies line for line:
// `key_span` (the key tiles a range of query rows visits: the forward),
// `query_span` and `first_key_tile` (the query tiles a key tile visits, and
// the first key tile that visits a query tile: the backward's key-major
// pass).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace port {
namespace f32 {

constexpr float NEG = -1e30f;   // a hidden score, as models/flash.py's NEG
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- cp.async ---------------------------------------------------------------

// 16 bytes from `src` to shared `dst`; zeros when !live (nothing is read)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

// 4 bytes from `src` to shared `dst`; zero when !live (nothing is read)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- swizzled row-major tiles -------------------------------------------------

template <int C, int G>
__device__ __forceinline__ int chunk_at(int r, int c) {
  constexpr int M = (C < 8 ? C : 8) - 1;
  return r * C + (c ^ static_cast<int>((static_cast<unsigned>(r) / G) & M));
}

template <int C, int G>
__device__ __forceinline__ float4 ld4(const float* tile, int r, int c) {
  return reinterpret_cast<const float4*>(tile)[chunk_at<C, G>(r, c)];
}

template <int C, int G>
__device__ __forceinline__ void st4(float* tile, int r, int c, float4 v) {
  reinterpret_cast<float4*>(tile)[chunk_at<C, G>(r, c)] = v;
}

// rows [r0, r0 + R) of a row-major source (row stride `stride` floats, C
// chunks a row) into a swizzled tile by THREADS threads; rows >= n are zeros.
// A thread copies one column of chunks, every THREADS / C rows.
template <int R, int C, int G, int THREADS>
__device__ __forceinline__ void load_tile(float* tile, const float* src, long long stride, int r0,
                                          int n) {
  static_assert(THREADS % C == 0, "a thread's column");
  constexpr int RS = THREADS / C;
  const int c = threadIdx.x % C, r1 = threadIdx.x / C;
  const float* p = src + (r0 + r1) * stride + 4 * c;
#pragma unroll
  for (int k = 0; k < (R + RS - 1) / RS; ++k) {
    const int r = r1 + k * RS;
    if (R % RS == 0 || r < R) {
      const bool live = r0 + r < n;
      cp16(tile + 4 * chunk_at<C, G>(r, c), live ? p + k * RS * stride : src, live);
    }
  }
}

// 2^x in one MUFU op (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float at(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---- loop bounds ----------------------------------------------------------------

// The key tiles [lo, hi) of width bk that query rows [q0, q1) visit (q1 <= sq):
// models/flash.py's _bounds, with the rows past Sq left out and nothing
// visited when the window ends before the first key.
__host__ __device__ __forceinline__ void key_span(int q0, int q1, int bk, int sk, int causal,
                                                  int window, int& lo, int& hi) {
  const int nk = (sk + bk - 1) / bk;
  hi = causal ? min((q1 + bk - 1) / bk, nk) : nk;
  lo = window ? max(q0 - window + 1, 0) / bk : 0;
  if (q1 <= q0 || (window && q0 - window + 1 >= sk)) hi = lo;
}

// The query tiles [t_lo, t_hi) of height bm that keys [k0, k1) visit (k1 <= sk).
__host__ __device__ __forceinline__ void query_span(int k0, int k1, int bm, int sq, int causal,
                                                    int window, int& t_lo, int& t_hi) {
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(sq, k1 - 1 + window) : sq;
  t_lo = q_begin / bm;
  t_hi = q_end > q_begin ? (q_end + bm - 1) / bm : t_lo;
}

// The first key tile (width bn) that visits query tile t (height bm); the key
// tiles that visit it are consecutive.
__host__ __device__ __forceinline__ int first_key_tile(int t, int bm, int bn, int window) {
  if (!window) return 0;
  const int x = t * bm - bn + 1 - window;
  return x < 0 ? 0 : x / bn + 1;
}

}  // namespace f32
}  // namespace port
