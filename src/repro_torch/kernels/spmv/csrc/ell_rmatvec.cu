// ell_rmatvec: out = Xᵀ·q over the padded CSC, for the Frank-Wolfe setup sweep
// and every Alg 1 step's gradient.
//
// Replaces src/repro/kernels/spmv/kernel.py::ell_rmatvec_pallas (pl.pallas_call
// at kernel.py:96, body _rmatvec_kernel), which scatter-adds row tiles of the
// padded CSR into one output block that stays resident across the TPU's
// sequential grid.  Blocks on the GPU run in parallel and in no order, so that
// scatter would need float atomics, whose order (and so whose rounding)
// changes from run to run.
//
// The order of the sums is part of the function (spmv/ref.py): each column's
// live entries, in ascending row order, are cut into segments of `seg`
// entries (SEGMENT = 256 in spmv/ref.py); a segment's partial is
// ((0 + a0) + a1) + ... in row order, and the column's result the same chain
// over its partials in segment order.  Products are __fmul_rn(v, q[row]) and
// every add __fadd_rn: no FMAs, no atomics, the plain version's bits.
//
// Design: the work is spread over the whole card in tasks.  A task is one
// segment of a column longer than `seg` (a warp; it writes its partial) or a
// whole column of at most `seg` entries (a group of 8 lanes, four columns to
// a warp; it writes out[j] itself).  The long columns' segment tasks come
// from a table built once per matrix (ref.py build_segments) and run first.
// A lane group loads four chunks of consecutive entries coalesced (the ids
// and values, then the gathers of q) and stages the products in shared
// memory; its first lane then adds them in order, reading four at a time, so
// its dependent chain costs an add (~4 cycles) per entry.  A second, small kernel
// adds each long column's partials in segment order.  A TieredCSC column is
// read from the tier that holds it (port::Cols::col); segment boundaries
// depend only on an entry's rank in its column, so flat and tiered give the
// same bits.
//
// Bound on the H100: bytes.  It must read each live entry once (4 B row id +
// 4 B value), q (4·N B) and nnz (4·D B), and write out (4·D B): 8·nnz + 4·N +
// 8·D = 12.4 MB at the rcv1.binary shape, 3.7 us at 3.35 TB/s.  The latency
// floor is one segment's chain, no longer a whole column's: the old design
// gave each column to one warp, so the power-law head column (every row,
// 20,242 entries) ran 20,242 dependent shuffle-and-add steps, ~0.4 ms, while
// the rest of the card sat idle; now its 80 segments run side by side and
// their partials add in 80 steps.
#include "port_common.cuh"

namespace {

constexpr int RMV_THREADS = 256;
constexpr int RMV_WARPS = RMV_THREADS / 32;
constexpr int RMV_GROUP = 4;   // chunks of a lane group's entries loaded before the adds
constexpr int RMV_SPAN = 32 * RMV_GROUP;
constexpr int RMV_COLS = 4;    // short columns per warp, 8 lanes each

// acc + buf[0..cnt) added one at a time, four per shared load (buf holds +0
// up to the next multiple of four: acc is never -0, so adding one changes
// nothing).
__device__ __forceinline__ float add_staged(float acc, const float* buf, int cnt) {
#pragma unroll 4
  for (int t = 0; t < cnt; t += 4) {
    const float4 x = *reinterpret_cast<const float4*>(buf + t);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x.x), x.y), x.z), x.w);
  }
  return acc;
}

// Lanes of a warp in groups of L, one task per group.  A group loads L·4
// consecutive entries of its task (coalesced), stages their products in
// `buf` (L·4 floats) and its first lane adds them in order, four per shared
// load.  `span` is the longest task of the warp, so every lane runs the same
// iterations; dead lanes stage +0.  The sum is valid in the group's first
// lane.
template <int L>
__device__ __forceinline__ float chain_sum(const int* __restrict__ ri, const float* __restrict__ rv,
                                           const float* __restrict__ q, int lo, int hi, int span,
                                           float* buf) {
  constexpr int W = L * RMV_GROUP;
  const int li = threadIdx.x & (L - 1);
  float acc = 0.0f;
  for (int off = 0; off < span; off += W) {
    const int base = lo + off;
    int r[RMV_GROUP];
    float v[RMV_GROUP];
#pragma unroll
    for (int c = 0; c < RMV_GROUP; ++c) {
      const int k = base + c * L + li;
      r[c] = k < hi ? ri[k] : 0;
      v[c] = k < hi ? rv[k] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < RMV_GROUP; ++c) {
      const int k = base + c * L + li;
      buf[c * L + li] = k < hi ? __fmul_rn(v[c], q[r[c]]) : 0.0f;
    }
    __syncwarp();
    if (li == 0) acc = add_staged(acc, buf, min(W, hi - base));
    __syncwarp();
  }
  return acc;
}

// One task per warp: first the long columns' segments, a whole warp each
// (partials[u]); then the columns of at most one segment, RMV_COLS to a
// warp, a lane group each (out[j] directly).
__global__ void __launch_bounds__(RMV_THREADS)
    ell_rmatvec_kernel(const port::Cols cols, const float* __restrict__ q,
                       float* __restrict__ out, int d, int seg, const int2* __restrict__ tasks,
                       int n_tasks, float* __restrict__ partials) {
  constexpr int L = 32 / RMV_COLS;
  __shared__ __align__(16) float stage[RMV_WARPS][RMV_SPAN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * RMV_WARPS + warp;
  if (u < n_tasks + (d + RMV_COLS - 1) / RMV_COLS) {
    const int* ri;
    const float* rv;
    if (u < n_tasks) {
      const int2 t = tasks[u];
      const int n = cols.col(t.x, ri, rv);
      const int lo = t.y * seg, hi = min(lo + seg, n);
      const float s = chain_sum<32>(ri, rv, q, lo, hi, hi - lo, stage[warp]);
      if (lane == 0) partials[u] = s;
    } else {
      const int j = (u - n_tasks) * RMV_COLS + lane / L;
      const int count = j < d ? cols.col(j, ri, rv) : 0;
      const int n = count > seg ? 0 : count;   // a long column: its segment tasks write it
      int span = n;
#pragma unroll
      for (int off = L; off < 32; off <<= 1) span = max(span, __shfl_xor_sync(0xffffffffu, span, off));
      const float s = chain_sum<L>(ri, rv, q, 0, n, span, stage[warp] + (lane / L) * L * RMV_GROUP);
      if ((lane & (L - 1)) == 0 && j < d && count <= seg) out[j] = s;
    }
  }
}

// A warp per long column: its partials, loaded coalesced and staged, added
// in segment order by lane 0.
__global__ void __launch_bounds__(RMV_THREADS)
    ell_rmatvec_finish(const float* __restrict__ partials, const int* __restrict__ long_cols,
                       const int* __restrict__ first, int n_long, float* __restrict__ out) {
  __shared__ __align__(16) float stage[RMV_WARPS][RMV_SPAN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * RMV_WARPS + warp;
  if (c >= n_long) return;
  const int lo = first[c], hi = first[c + 1];
  float* buf = stage[warp];
  float acc = 0.0f;
  for (int base = lo; base < hi; base += RMV_SPAN) {
#pragma unroll
    for (int i = 0; i < RMV_GROUP; ++i) {
      const int t = base + i * 32 + lane;
      buf[i * 32 + lane] = t < hi ? partials[t] : 0.0f;
    }
    __syncwarp();
    if (lane == 0) acc = add_staged(acc, buf, min(RMV_SPAN, hi - base));
    __syncwarp();
  }
  if (lane == 0) out[long_cols[c]] = acc;
}

}  // namespace

extern "C" int port_ell_rmatvec(const int* cidx, const float* cval, const int* cnnz,
                                const int* heavy_slot, const int* hidx, const float* hval,
                                int width, int full, const float* q, float* out, int d,
                                int seg, const int* tasks, int n_tasks, const int* long_cols,
                                const int* first, int n_long, float* partials,
                                cudaStream_t stream) {
  if (seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const port::Cols cols{cidx, cval, cnnz, heavy_slot, hidx, hval, width, full};
  const int work = n_tasks + (d + RMV_COLS - 1) / RMV_COLS;
  const int blocks = max(1, (work + RMV_WARPS - 1) / RMV_WARPS);
  ell_rmatvec_kernel<<<blocks, RMV_THREADS, 0, stream>>>(
      cols, q, out, d, seg, reinterpret_cast<const int2*>(tasks), n_tasks, partials);
  if (n_long > 0)
    ell_rmatvec_finish<<<(n_long + RMV_WARPS - 1) / RMV_WARPS, RMV_THREADS, 0, stream>>>(
        partials, long_cols, first, n_long, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* port_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
