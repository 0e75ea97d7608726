// two_level_draw: rebuild the log-sum-exps of the groups the last Frank-Wolfe
// step touched, then one exponential-mechanism draw j ~ softmax(v.flatten()),
// in one launch.
//
// Replaces src/repro/kernels/bsls_draw/kernel.py::little_step_pallas (body
// _little_step_kernel) together with the big step that
// src/repro/kernels/bsls_draw/ops.py::two_level_draw runs in XLA before it,
// and the group rebuild that src/repro/core/samplers/bsls_jax.py::tl_update
// runs in XLA after each step:
//
//   c[g] = logsumexp(v[g, :])   for every group g with touched[g]; touched[g] = 0
//   kg, km = split(key)
//   g = argmax(c + gumbel(kg, (G,)))        big step over the G group sums
//   m = argmax(v[g, :] + gumbel(km, (1, M))) little step inside group g
//   out = g·M + m
//
// Layout: one block per group.  A touched group's block rebuilds c[g] as
// logsumexp_rows (core/samplers/two_level.py) computes it — amax, 0 where it
// is not finite, log(Σ exp(v - amax)) + amax with the precise expf/logf —
// summing in one fixed order (a thread's strided elements in order, then a
// halving tree), so its bits are the same from launch to launch; it clears
// touched[g].  An untouched group's block only arrives.  Each block then
// fences its c[g] and adds one to a device-wide arrival counter; the last
// to arrive resets the counter to 0 (the next launch, or a graph replay,
// finds it there) and draws, reading the new c past L1 (__ldcg).  The
// Gumbel noise comes from the step's key with the same threefry2x32 bits as
// jax.random (partitionable mode: element c of a shape uses counter (0, c)),
// so a draw equals the JAX package's draw for the same key and c.  Ties go
// to the lower index, as jnp.argmax.  In a masked run (done != null) the
// launch still rebuilds (the step that set done touched groups), then
// writes the sentinel -1 instead of a draw.  The rebuild-only instance
// (DRAW = false) is the same kernel without the arrival and the draw.
//
// Lanes (the JAX package's vmap of the draw over a sweep group's configs):
// the grid's second axis is the lane b, and every per-config array has a
// leading lane axis — c (B, G), v (B, G, M), touched (B, G), out (B,),
// done (B,) — with one arrival counter per lane: the last block to arrive
// within lane b draws lane b's coordinate and resets lane b's counter.
// Lane b's key is row b of a (B, 2) uint32 table in device memory (one
// table per step, uploaded once per chunk).  The single-config launch is
// the lane form with B = 1 and its key by value: the same code.
//
// Bound on the H100: neither bytes nor operations.  It reads touched (4·G B),
// the touched groups' rows of v (4·M B each) and c, and writes their c and
// flags and 4 B of output, with about 100 integer operations per element
// for the noise: kilobytes and tens of thousands of operations at G, M ≈ √D.
// Launch latency and the chain rebuild → arrival → two block reductions
// set its time; one launch replaces the ten or so torch launches of the
// rebuild that ran between two draws.
#include "port_common.cuh"

namespace {

constexpr int DRAW_THREADS = 256;

// The block's largest value (every thread gets it).
__device__ float block_max(float x) {
  __shared__ float s[DRAW_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (lane == 0) s[warp] = x;
  __syncthreads();
  x = s[0];
#pragma unroll
  for (int k = 1; k < DRAW_THREADS / 32; ++k) x = fmaxf(x, s[k]);
  __syncthreads();  // s is reused by the next call
  return x;
}

// c[g] = logsumexp(v[g, :]), by the whole block; thread 0 writes it.
__device__ void rebuild_group(const float* __restrict__ v, float* c, int g, int group_size) {
  const float* row = v + static_cast<long long>(g) * group_size;
  float mx = -INFINITY;
  for (int m = threadIdx.x; m < group_size; m += DRAW_THREADS) mx = fmaxf(mx, row[m]);
  mx = block_max(mx);
  const float amax = isfinite(mx) ? mx : 0.0f;
  float s = 0.0f;
  for (int m = threadIdx.x; m < group_size; m += DRAW_THREADS)
    s = __fadd_rn(s, expf(__fsub_rn(row[m], amax)));
  s = port::block_sum<DRAW_THREADS>(s);
  if (threadIdx.x == 0) c[g] = __fadd_rn(logf(s), amax);
}

// The draw, by the whole block, from the groups' c and v.
__device__ void draw(const float* c, const float* __restrict__ v, int groups, int group_size,
                     uint32_t k0, uint32_t k1, int* out) {
  uint32_t kg0, kg1, km0, km1;
  port::threefry2x32(k0, k1, 0u, 0u, kg0, kg1);
  port::threefry2x32(k0, k1, 0u, 1u, km0, km1);

  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int g = threadIdx.x; g < groups; g += DRAW_THREADS) {
    uint32_t a, b;
    port::threefry2x32(kg0, kg1, 0u, static_cast<uint32_t>(g), a, b);
    const float s = __fadd_rn(__ldcg(c + g), port::gumbel_from_bits(a ^ b));
    if (port::better(s, g, bv, bi)) {
      bv = s;
      bi = g;
    }
  }
  const int g = port::block_argmax<DRAW_THREADS>(bv, bi).i;

  const float* row = v + static_cast<long long>(g) * group_size;
  bv = -INFINITY;
  bi = 0x7fffffff;
  for (int m = threadIdx.x; m < group_size; m += DRAW_THREADS) {
    uint32_t a, b;
    port::threefry2x32(km0, km1, 0u, static_cast<uint32_t>(m), a, b);
    const float s = __fadd_rn(row[m], port::gumbel_from_bits(a ^ b));
    if (port::better(s, m, bv, bi)) {
      bv = s;
      bi = m;
    }
  }
  const int m = port::block_argmax<DRAW_THREADS>(bv, bi).i;
  if (threadIdx.x == 0) out[0] = g * group_size + m;
}

// Block g rebuilds group g if touched; with DRAW, the last block to arrive
// draws.  touched == null (no rebuild): one block, which draws.
template <bool DRAW>
__global__ void __launch_bounds__(DRAW_THREADS)
    two_level_draw_kernel(float* c, const float* __restrict__ v, int groups, int group_size,
                          int* touched, uint32_t k0, uint32_t k1, const uint32_t* keys,
                          int* out, const bool* done, unsigned* arrivals) {
  __shared__ bool s_last;
  const int b = blockIdx.y;  // the lane: every per-config array is offset to its row
  c += static_cast<long long>(b) * groups;
  v += static_cast<long long>(b) * groups * group_size;
  if (touched != nullptr) touched += static_cast<long long>(b) * groups;
  if (DRAW) {
    out += b;
    arrivals += b;
    if (done != nullptr) done += b;
    if (keys != nullptr) {
      k0 = keys[2 * b];
      k1 = keys[2 * b + 1];
    }
  }
  if (touched != nullptr && touched[blockIdx.x] != 0) {  // the same for the whole block
    rebuild_group(v, c, blockIdx.x, group_size);
    if (threadIdx.x == 0) touched[blockIdx.x] = 0;  // every thread read it before the barriers
  }
  if (!DRAW) return;
  if (gridDim.x > 1) {  // one block (no rebuild) draws at once
    if (threadIdx.x == 0) {
      __threadfence();  // this block's c[g] is visible before it arrives
      s_last = atomicAdd(arrivals, 1u) == gridDim.x - 1;  // lane b's blocks only
    }
    __syncthreads();
    if (!s_last) return;
    if (threadIdx.x == 0) *arrivals = 0u;  // every block has arrived
    __threadfence();
  }
  if (done != nullptr && *done) {
    if (threadIdx.x == 0) out[0] = -1;
    return;
  }
  draw(c, v, groups, group_size, k0, k1, out);
}

__global__ void empty_kernel() {}

}  // namespace

// draw != 0: rebuild the touched groups (touched may be null) and draw into
// out; draw == 0: rebuild only.  lanes >= 1 configs, each with its own rows
// of c, v, touched, out, done and arrivals; keys: a (lanes, 2) device table
// of the lanes' keys, or null to use (k0, k1) (one lane).
extern "C" int port_two_level_draw(float* c, const float* v, int groups, int group_size,
                                   int* touched, uint32_t k0, uint32_t k1,
                                   const uint32_t* keys, int* out, const bool* done,
                                   unsigned* arrivals, int draw, int lanes,
                                   cudaStream_t stream) {
  if (lanes < 1 || lanes > 65535 || (draw && keys == nullptr && lanes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (draw) {
    const dim3 grid(touched != nullptr ? groups : 1, lanes);
    two_level_draw_kernel<true><<<grid, DRAW_THREADS, 0, stream>>>(
        c, v, groups, group_size, touched, k0, k1, keys, out, done, arrivals);
  } else {
    if (touched == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    two_level_draw_kernel<false><<<dim3(groups, lanes), DRAW_THREADS, 0, stream>>>(
        c, v, groups, group_size, touched, k0, k1, keys, out, done, arrivals);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: the device time of a launch that does nothing (the
// practical floor beside the latency-bound kernels' times).
extern "C" int port_launch_floor(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
