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
// Design: one warp owns one row i.  Its 32 lanes stride over the row's live
// entries k < nnz[i] only (the padded lanes add ±0 and are skipped), so the
// loads of a row's ids and values are coalesced; each lane gathers w[ids]
// from L2 and adds its products in ascending k.  The 32 partial sums are
// then added by a butterfly of warp shuffles, whose order is fixed, so the
// result is bitwise the same from run to run.  A row's sum is rounded in
// another order than the plain version's, which sums the padded row with
// torch.sum: the two agree within 1e-5 of Σ|terms| per row.
//
// Bound on the H100: bytes.  It must read each live entry once (4 B id +
// 4 B value), nnz (4·N B) and w (4·D B), and write out (4·N B); two flops
// per entry is far below the card's float32 rate.  Rows of ~74 live entries
// give each warp about two loads of ids and values, so the launch, the
// dependent gather of w after the id load, and the shuffle tail add latency
// that a 12 MB sweep does not hide completely.
#include "port_common.cuh"

namespace {

constexpr int MV_THREADS = 256;
constexpr int MV_WARPS = MV_THREADS / 32;

__global__ void __launch_bounds__(MV_THREADS)
    ell_matvec_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                      const int* __restrict__ nnz, int k_pad, const float* __restrict__ w,
                      float* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * MV_WARPS;
  for (int i = blockIdx.x * MV_WARPS + (threadIdx.x >> 5); i < n; i += stride) {
    const int* ri = idx + static_cast<long long>(i) * k_pad;
    const float* rv = val + static_cast<long long>(i) * k_pad;
    const int len = nnz[i];
    float acc = 0.0f;
    for (int k = lane; k < len; k += 32) acc = __fadd_rn(acc, __fmul_rn(rv[k], w[ri[k]]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) out[i] = acc;
  }
}

}  // namespace

extern "C" int port_ell_matvec(const int* idx, const float* val, const int* nnz, int k_pad,
                               const float* w, float* out, int n, cudaStream_t stream) {
  const int blocks = max(1, min((n + MV_WARPS - 1) / MV_WARPS, 132 * 16));
  ell_matvec_kernel<<<blocks, MV_THREADS, 0, stream>>>(idx, val, nnz, k_pad, w, out, n);
  return static_cast<int>(cudaGetLastError());
}
