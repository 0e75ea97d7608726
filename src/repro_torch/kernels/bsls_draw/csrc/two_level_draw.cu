// two_level_draw: one exponential-mechanism draw j ~ softmax(v.flatten()).
//
// Replaces src/repro/kernels/bsls_draw/kernel.py::little_step_pallas (body
// _little_step_kernel) together with the big step that
// src/repro/kernels/bsls_draw/ops.py::two_level_draw runs in XLA before it:
//
//   kg, km = split(key)
//   g = argmax(c + gumbel(kg, (G,)))        big step over the G group sums
//   m = argmax(v[g, :] + gumbel(km, (1, M))) little step inside group g
//   out = g·M + m
//
// Both steps run in one block of one launch, so the winning group never
// returns to the host.  The Gumbel noise is generated in the kernel from the
// step's key with the same threefry2x32 bits as jax.random (partitionable
// mode: element c of a shape uses counter (0, c)), so a draw equals the JAX
// package's draw for the same key.  Ties go to the lower index, as
// jnp.argmax; logf is the precise one.  In a masked run (done != null) a
// launch that finds the early-stopping flag set writes the sentinel -1 and
// draws nothing.
//
// Bound on the H100: neither bytes nor operations.  It reads c (4·G B), one
// row of v (4·M B) and writes 4 B, with about 100 integer operations per
// element for the noise; at G, M ≈ √D that is a few kilobytes and a few tens
// of thousands of operations, so the launch and the block's two reductions
// (latency) set its time.
#include "port_common.cuh"

namespace {

constexpr int DRAW_THREADS = 256;

__global__ void __launch_bounds__(DRAW_THREADS)
    two_level_draw_kernel(const float* __restrict__ c, const float* __restrict__ v, int groups,
                          int group_size, uint32_t k0, uint32_t k1, int* __restrict__ out,
                          const bool* __restrict__ done) {
  if (done != nullptr && *done) {
    if (threadIdx.x == 0) out[0] = -1;
    return;
  }
  uint32_t kg0, kg1, km0, km1;
  port::threefry2x32(k0, k1, 0u, 0u, kg0, kg1);
  port::threefry2x32(k0, k1, 0u, 1u, km0, km1);

  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int g = threadIdx.x; g < groups; g += DRAW_THREADS) {
    uint32_t a, b;
    port::threefry2x32(kg0, kg1, 0u, static_cast<uint32_t>(g), a, b);
    const float s = __fadd_rn(c[g], port::gumbel_from_bits(a ^ b));
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

}  // namespace

extern "C" int port_two_level_draw(const float* c, const float* v, int groups, int group_size,
                                   uint32_t k0, uint32_t k1, int* out, const bool* done,
                                   cudaStream_t stream) {
  two_level_draw_kernel<<<1, DRAW_THREADS, 0, stream>>>(c, v, groups, group_size, k0, k1, out,
                                                        done);
  return static_cast<int>(cudaGetLastError());
}
