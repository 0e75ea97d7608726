// scatter_add_ordered: out = dst with src[i] added at idx[i] for every live
// lane, each target's terms in input order.
//
// No Pallas counterpart: this is the port's repair of the scatter-adds that
// the JAX package writes as `.at[idx].add(src)` (fw_jax's v̄/q̄/α updates,
// the eager oracles' setup Xᵀq, distributed/fw_shard.py's α scatters).  XLA
// on the CPU adds each target's terms one at a time in input order, and so
// does the plain version (scatter/ref.py).  Float atomics, and PyTorch's
// CUDA `index_put_(accumulate=True)` (a sort by target, then its own sums),
// add in another order, so α drifted from the CPU's in the last bits and a
// near-tie of two coordinates went the other way.
//
// Contract: out[t] = ((dst[t] + s_a) + s_b) + ... over the live lanes
// a < b < ... with idx = t, every add __fadd_rn; a target without live
// lanes keeps dst[t] (the wrapper copies dst into out first).
//
// Design: the wrapper groups the lanes by target with a stable sort of the
// keys (a dead lane's key is n, past every target), so each target's lanes
// are one run of the sorted order, in input order.  `run_bounds` marks each
// run's first and last position (a thread per position), and `chains` gives
// each target a warp: the warp loads 16 × 32 of its run's terms at a time
// (coalesced reads of the permutation, gathers of src) and stages them in
// shared memory; its first lane adds them in order, four to a shared load,
// while the next 512 are in flight.  A group's 512 dependent adds (~2,000
// cycles) outlast the next group's two dependent loads (permutation, then
// term), so a long chain costs about one add (~4 cycles) a term.
//
// Bound on the H100: bytes, reading each lane's index and term once and
// writing dst: (8 · lanes + 8 · n) B at 3.35 TB/s.  The latency floor is the
// longest run's chain of dependent adds: the head column's 20,242 terms at
// the rcv1.binary shape, ~0.04 ms at 4 cycles an add.  The sort is PyTorch's
// (a radix sort) and is not counted in this kernel's launches.
#include "port_common.cuh"

namespace {

constexpr int BOUNDS_THREADS = 256;
constexpr int CHAIN_THREADS = 256;   // 8 warps, one target each
constexpr int CHAIN_UNROLL = 16;     // 32-term groups a warp loads at once
constexpr int CHAIN_SPAN = 32 * CHAIN_UNROLL;

__global__ void run_bounds(const int* __restrict__ keys, int k, int n, int* __restrict__ start,
                           int* __restrict__ end) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= k) return;
  const int t = keys[p];
  if (t < 0 || t >= n) return;   // a dead lane
  if (p == 0 || keys[p - 1] != t) start[t] = static_cast<int>(p);
  if (p == k - 1 || keys[p + 1] != t) end[t] = static_cast<int>(p + 1);
}

__device__ __forceinline__ void load_terms(float (&v)[CHAIN_UNROLL], long long base, int e,
                                           int lane, const long long* __restrict__ perm,
                                           const float* __restrict__ src) {
#pragma unroll
  for (int u = 0; u < CHAIN_UNROLL; ++u) {
    const long long p = base + 32 * u + lane;
    v[u] = p < e ? src[perm[p]] : 0.0f;
  }
}

// acc + buf[0], + buf[1], ... + buf[cnt - 1], one add at a time, four terms a
// shared load; the tail is added term by term (dst may be -0.0, so no +0
// padding may be added).
__device__ __forceinline__ float add_staged(float acc, const float* buf, int cnt) {
  int i = 0;
#pragma unroll 4
  for (; i + 4 <= cnt; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(buf + i);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x.x), x.y), x.z), x.w);
  }
  for (; i < cnt; ++i) acc = __fadd_rn(acc, buf[i]);
  return acc;
}

__global__ void chains(const int* __restrict__ start, const int* __restrict__ end,
                       const long long* __restrict__ perm, const float* __restrict__ src,
                       float* __restrict__ out, int n) {
  __shared__ __align__(16) float stage[CHAIN_THREADS / 32][CHAIN_SPAN];
  const long long t = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= n) return;   // warp-uniform
  const int s = start[t], e = end[t];
  if (s >= e) return;
  float* buf = stage[threadIdx.x >> 5];
  float acc = out[t];
  float nxt[CHAIN_UNROLL];
  load_terms(nxt, s, e, lane, perm, src);
  for (long long base = s; base < e; base += CHAIN_SPAN) {
#pragma unroll
    for (int u = 0; u < CHAIN_UNROLL; ++u) buf[32 * u + lane] = nxt[u];
    __syncwarp();
    load_terms(nxt, base + CHAIN_SPAN, e, lane, perm, src);   // the next group, in flight
    const long long left = e - base;
    const int cnt = left < CHAIN_SPAN ? static_cast<int>(left) : CHAIN_SPAN;
    if (lane == 0) acc = add_staged(acc, buf, cnt);
    __syncwarp();
  }
  if (lane == 0) out[t] = acc;
}

}  // namespace

// keys: (k,) int32 targets sorted stably (dead lanes keyed n or more); perm:
// (k,) int64 input lane of each sorted position; src: (k,) float32 terms in
// input order; out: (n,) float32, dst on entry; bounds: (2n,) int32 scratch.
extern "C" int port_scatter_add_ordered(const int* keys, const long long* perm, const float* src,
                                        int k, float* out, int n, int* bounds,
                                        cudaStream_t stream) {
  if (k < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaMemsetAsync(bounds, 0, sizeof(int) * 2 * static_cast<size_t>(n), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  run_bounds<<<(k + BOUNDS_THREADS - 1) / BOUNDS_THREADS, BOUNDS_THREADS, 0, stream>>>(
      keys, k, n, bounds, bounds + n);
  const long long threads = 32LL * n;
  chains<<<static_cast<unsigned>((threads + CHAIN_THREADS - 1) / CHAIN_THREADS), CHAIN_THREADS, 0,
           stream>>>(bounds, bounds + n, perm, src, out, n);
  return static_cast<int>(cudaGetLastError());
}
