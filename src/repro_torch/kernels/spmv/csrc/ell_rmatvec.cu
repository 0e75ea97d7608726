// ell_rmatvec: out = Xᵀ·q over the padded CSC, for the Frank-Wolfe setup sweep.
//
// Replaces src/repro/kernels/spmv/kernel.py::ell_rmatvec_pallas (body
// _rmatvec_kernel), which scatter-adds row tiles of the padded CSR into one
// output block that stays resident across the TPU's sequential grid.  Blocks
// on the GPU run in parallel and in no order, so that scatter would need
// float atomics, whose order (and so whose rounding) changes from run to run.
//
// Design: a gather over the PaddedCSC instead.  One warp owns one output
// column j: its 32 lanes load 32 consecutive live entries (coalesced) and
// form values[j,k]·q[rows[j,k]]; the products are then added to the sum one
// by one in ascending lane order through warp shuffles.  CSC rows are
// ascending, so this is the order in which the TPU kernel's sequential row
// scatter adds them, and the result is deterministic without atomics.  Only
// the live lanes k < nnz[j] are read; a TieredCSC column is read from the
// tier that holds it.
//
// Bound on the H100: bytes.  It must read each live entry (4 B row id + 4 B
// value), q (4·N B) and nnz (4·D B) once, and write out (4·D B); a few
// flops per entry is far below the card's float32 rate.  The serial add chain
// of the longest column (every row, in a power-law matrix) sets a latency
// floor above that byte bound.
#include "port_common.cuh"

namespace {

constexpr int RMV_THREADS = 256;
constexpr int RMV_WARPS = RMV_THREADS / 32;

__global__ void __launch_bounds__(RMV_THREADS)
    ell_rmatvec_kernel(const port::Cols cols, const float* __restrict__ q,
                       float* __restrict__ out, int d) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * RMV_WARPS;
  for (int j = blockIdx.x * RMV_WARPS + (threadIdx.x >> 5); j < d; j += stride) {
    const int* ri;
    const float* rv;
    const int n = cols.col(j, ri, rv);
    float acc = 0.0f;
    for (int base = 0; base < n; base += 32) {
      const int k = base + lane;
      const float p = k < n ? __fmul_rn(rv[k], q[ri[k]]) : 0.0f;
      const int cnt = min(32, n - base);
      for (int s = 0; s < cnt; ++s) acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, p, s));
    }
    if (lane == 0) out[j] = acc;
  }
}

}  // namespace

extern "C" int port_ell_rmatvec(const int* cidx, const float* cval, const int* cnnz,
                                const int* heavy_slot, const int* hidx, const float* hval,
                                int width, int full, const float* q, float* out, int d,
                                cudaStream_t stream) {
  const port::Cols cols{cidx, cval, cnnz, heavy_slot, hidx, hval, width, full};
  const int blocks = max(1, min((d + RMV_WARPS - 1) / RMV_WARPS, 132 * 16));
  ell_rmatvec_kernel<<<blocks, RMV_THREADS, 0, stream>>>(cols, q, out, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* port_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
