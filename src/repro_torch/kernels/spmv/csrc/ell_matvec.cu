// ell_matvec: out = X·w over the padded CSR, the margins v = X·w that every
// Alg 1 step computes.
//
// Replaces src/repro/kernels/spmv/kernel.py::ell_matvec_pallas (kernel.py:45,
// pl.pallas_call at :55; body _matvec_kernel), which holds a (256, K) tile of
// row ids and values plus the whole of w in VMEM per grid step and sums each
// row's K lanes, padding lanes included.  Nothing is carried from one grid
// step to the next, so the rows are independent; the GPU has no VMEM for w,
// and its L2 (50 MB) holds w (4·D B, 189 KB at D = 47,236) for the launch.
//
// Bound on the H100: bytes.  It must read each live entry once (4 B id +
// 4 B value), nnz (4·N B) and w (4·D B), and write out (4·N B); two flops
// per entry is far below the card's float32 rate.  At the rcv1.binary shape
// that is 12 MB, 3.7 µs at 3.35 TB/s.
//
// Design: a group of L lanes owns one row; a warp holds 32/L rows.  Lane g
// of a group takes the row's live entries g, g+L, g+2L, …: it first issues
// all its loads of ids and values for up to ITEMS of them (read-only path,
// unrolled into registers), then all its gathers of w, then the products.
// The padded lanes k >= nnz[i] are never loaded.  Each lane adds its
// products in ascending k, then the L partial sums are added by a fixed xor
// butterfly, so the result is bitwise the same from run to run.  A row's
// sum is rounded in another order than the plain version's, which sums the
// padded row with torch.sum: the two agree within 1e-5 of Σ|terms| per row.
// The grid covers the rows once (ROWS_PER_BLOCK = 256/L rows a block), or
// strides over them from a smaller grid.  chip_smoke.py sweeps L ∈ {4, 8,
// 16, 32} and the grid on an H100 (PERF.md, row 4): L = 32 (a row a warp,
// ITEMS = 4 covers 128 entries in one pass) on DEFAULT_BLOCKS, the blocks
// of 256 threads the 132 SMs hold at once, was the best in the Alg 1 loop,
// but by less than the run-to-run spread over L = 16, and no shape came
// near the byte bound: issuing the loads ahead did not shorten what bounds
// it, the scattered 4-byte gathers of w (PERF.md §7).
#include "port_common.cuh"

namespace {

constexpr int MV_THREADS = 256;
constexpr int DEFAULT_LANES = 32;
constexpr int DEFAULT_BLOCKS = 132 * 8;  // 8 resident blocks on each SM of an H100

template <int L, int ITEMS>
__global__ void __launch_bounds__(MV_THREADS)
    ell_matvec_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                      const int* __restrict__ nnz, int k_pad, const float* __restrict__ w,
                      float* __restrict__ out, int n) {
  constexpr int ROWS_PER_WARP = 32 / L;
  const int lane = threadIdx.x & 31;
  const int g = lane & (L - 1);                 // lane in the row's group
  const int warp = (blockIdx.x * MV_THREADS + threadIdx.x) >> 5;
  const int warps = gridDim.x * (MV_THREADS / 32);
  // the loop bound is the same for the whole warp, so every lane reaches
  // the shuffles; a group past the last row walks an empty row
  for (int base = warp * ROWS_PER_WARP; base < n; base += warps * ROWS_PER_WARP) {
    const int i = base + lane / L;
    const int len = i < n ? __ldg(nnz + i) : 0;
    const long long row = static_cast<long long>(i < n ? i : 0) * k_pad;
    const int* ri = idx + row;
    const float* rv = val + row;
    float acc = 0.0f;
    for (int k0 = 0; k0 < len; k0 += L * ITEMS) {
      int c[ITEMS];
      float x[ITEMS];
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int k = k0 + g + L * u;
        c[u] = k < len ? __ldg(ri + k) : -1;
        x[u] = k < len ? __ldg(rv + k) : 0.0f;
      }
      float wc[ITEMS];
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) wc[u] = c[u] >= 0 ? __ldg(w + c[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < ITEMS; ++u)
        if (c[u] >= 0) acc = __fadd_rn(acc, __fmul_rn(x[u], wc[u]));
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (g == 0 && i < n) out[i] = acc;
  }
}

template <int L, int ITEMS>
int launch(const int* idx, const float* val, const int* nnz, int k_pad, const float* w,
           float* out, int n, int blocks, cudaStream_t stream) {
  constexpr int ROWS_PER_BLOCK = MV_THREADS / L;
  const int cover = max(1, (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const int grid = min(blocks > 0 ? blocks : DEFAULT_BLOCKS, cover);
  ell_matvec_kernel<L, ITEMS><<<grid, MV_THREADS, 0, stream>>>(idx, val, nnz, k_pad, w, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lanes: L (4, 8, 16 or 32; 0 → DEFAULT_LANES); blocks: at most this many
// blocks, striding over the rows (0 → DEFAULT_BLOCKS); never more blocks than
// one per ROWS_PER_BLOCK rows.
extern "C" int port_ell_matvec(const int* idx, const float* val, const int* nnz, int k_pad,
                               const float* w, float* out, int n, int lanes, int blocks,
                               cudaStream_t stream) {
  switch (lanes == 0 ? DEFAULT_LANES : lanes) {
    case 4: return launch<4, 16>(idx, val, nnz, k_pad, w, out, n, blocks, stream);
    case 8: return launch<8, 16>(idx, val, nnz, k_pad, w, out, n, blocks, stream);
    case 16: return launch<16, 8>(idx, val, nnz, k_pad, w, out, n, blocks, stream);
    case 32: return launch<32, 4>(idx, val, nnz, k_pad, w, out, n, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
