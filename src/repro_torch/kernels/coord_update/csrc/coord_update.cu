// coord_update: one Frank-Wolfe step for the selected column j (paper Alg 2,
// lines 16-29), in one launch of one block.
//
// Replaces src/repro/kernels/coord_update/kernel.py::coord_update_pallas
// (bodies from _build_kernel, one per objective), which runs lines 22-28:
//
//   v̄[rows] += η·d̃·x/w_m                          (line 23)
//   γ = h(w_m·v̄[rows]) − q̄[rows]  (or grad(m, y))  (line 24)
//   q̄[rows] += γ                                   (line 25)
//   α += (γ/N)ᵀ·X[rows, :]                          (line 26)
//   g̃ += w_m·Σᵢ (γᵢ/N)·⟨X[i,:], w⟩                 (line 27)
//
// This kernel also folds in what the JAX scan does around that call, so a
// step needs no host round trip and no extra launches:
//   * lines 16-21: it reads j from device memory (written by the draw kernel
//     or by the host queue), computes d̃, the gap, η, w_m and w[j], and writes
//     the step's gap and coordinate into the run's output arrays;
//   * line 29: it refreshes the queue priority of every touched coordinate
//     (|α|, scaled by the EM scale when private) and either marks the
//     coordinate's group for the log-sum-exp rebuild (two-level sampler) or
//     ratchets the group's bound (group argmax);
//   * early stopping (masked runs, done != null): a launch that finds the
//     device flag done set writes only the sentinels gap 0 and coordinate
//     -1 and leaves the state as it was; the launch whose gap is <= gap_tol
//     applies its step and sets done and stop_at (the global step t), so a
//     masked run needs no host round trip either.
//
// The TPU kernel was race-free only because its grid runs in sequence; it
// also walked every padded lane, whose "+0" writes land on row 0 and
// column 0.  Here:
//   * only live lanes are walked: k < nnz[j] for the column, r < nnz[i] for
//     each row, so no padding lane can race with a real update;
//   * rows of one column are distinct, so lines 23-25 and the per-row dot
//     ⟨X[i,:], w⟩ run one thread per row;
//   * α is scattered one row at a time, in lane order, with the row's
//     entries spread over the threads (a row's column ids are distinct) and
//     a barrier between rows.  Every α[c] therefore receives its additions in
//     the TPU kernel's order, with no float atomics: two runs give bitwise
//     equal α, and selection cannot flip between runs;
//   * Δg̃ is a block reduction in a fixed order;
//   * the only atomic is the integer max of the group bound, which is
//     order-independent (priorities are ≥ 0, so float order = int order).
//
// Bound on the H100: bytes.  A step must read the column's live entries,
// v̄/q̄ (and y) of its rows, the rows' live entries and w, α at the touched
// coordinates, and write v̄, q̄, α and the priorities back: tens of
// kilobytes for a light column, a few megabytes for the densest one.  This
// simple design does not reach that bound on long columns: the row-by-row α
// scatter costs one block barrier per row of column j (20,242 barriers for
// the head column of an rcv1-shaped matrix).  A deterministic parallel
// scatter is the first redesign on ROADMAP.md.
#include "port_common.cuh"

namespace {

constexpr int CU_THREADS = 1024;

enum Loss { LOGISTIC = 0, SQUARED = 1, LAD = 2, HUBER = 3, SMOOTHED_HINGE = 4 };

// The per-row map q̄ tracks: h(m) for separable objectives, grad(m, y) for
// label-coupled ones (repro_torch/core/losses.py, operation for operation).
template <int LOSS>
__device__ __forceinline__ float row_map(float m, float y) {
  if (LOSS == LOGISTIC) return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-m)));
  if (LOSS == SQUARED) return m;
  if (LOSS == LAD) {
    const float r = __fsub_rn(m, y);
    return __fdiv_rn(r, __fsqrt_rn(__fadd_rn(__fmul_rn(r, r), 0.0625f)));  // μ² = 0.25²
  }
  if (LOSS == HUBER) return fminf(fmaxf(__fsub_rn(m, y), -0.5f), 0.5f);  // δ = 0.5
  const float yt = __fsub_rn(__fmul_rn(2.0f, y), 1.0f);  // smoothed hinge
  const float z = __fmul_rn(yt, m);
  const float dz = z <= 0.0f ? -1.0f : (z < 1.0f ? __fsub_rn(z, 1.0f) : 0.0f);
  return __fmul_rn(yt, dz);
}

struct Args {
  const int* j;        // (1,) selected coordinate
  port::Cols cols;     // padded CSC (flat or tiered)
  const int* ridx;     // (N, kr) padded CSR
  const float* rval;
  const int* rnnz;
  int kr;
  const float* y;      // (N,) labels, label-coupled objectives only
  float* w;            // (D,)
  float* w_m;          // (1,)
  float* g_tilde;      // (1,)
  float* vbar;         // (N,)
  float* qbar;         // (N,)
  float* alpha;        // (D,)
  float* prio;         // (G·M,) sampler log-weights v or queue priorities p
  float* bound;        // (G,) group-argmax bounds, or null
  int* touched;        // (G,) two-level touched flags, or null
  int group_size;
  float em_scale;
  float t;             // global step number t (1-based)
  float lam;
  float inv_n;
  int d;
  float* gaps;         // (steps,) this run's outputs
  int* coords;
  int slot;
  float* gs;           // (N,) scratch: γᵢ/N of each lane
  bool* done;          // (1,) early-stopping flag, or null (fixed-T run)
  int* stop_at;        // (1,) steps applied when done was set
  float gap_tol;
};

template <int LOSS>
__global__ void __launch_bounds__(CU_THREADS) coord_update_kernel(const Args a) {
  __shared__ int s_n;
  __shared__ const int* s_rows;
  __shared__ const float* s_xv;
  __shared__ float s_edt, s_wm, s_gt;
  __shared__ bool s_frozen;
  const int tid = threadIdx.x;

  // ---- lines 16-21 ---------------------------------------------------------
  if (tid == 0) s_frozen = a.done != nullptr && *a.done;
  __syncthreads();
  if (s_frozen) {  // the run stopped at an earlier step: sentinels only
    if (tid == 0) {
      a.gaps[a.slot] = 0.0f;
      a.coords[a.slot] = -1;
    }
    return;
  }
  if (tid == 0) {
    const int j = min(a.j[0], a.d - 1);
    const float aj = a.alpha[j];
    const float sgn = aj > 0.0f ? 1.0f : (aj < 0.0f ? -1.0f : aj);
    const float dt = aj == 0.0f ? a.lam : __fmul_rn(-a.lam, sgn);
    const float gt = a.g_tilde[0];
    const float gap = __fsub_rn(gt, __fmul_rn(dt, aj));
    a.gaps[a.slot] = gap;
    a.coords[a.slot] = j;
    if (a.done != nullptr && a.gap_tol > 0.0f && gap <= a.gap_tol) {
      *a.done = true;  // this step is still applied; later launches freeze
      *a.stop_at = static_cast<int>(a.t);
    }
    const float eta = __fdiv_rn(2.0f, __fadd_rn(a.t, 2.0f));
    const float ome = __fsub_rn(1.0f, eta);
    const float wm = __fmul_rn(a.w_m[0], ome);
    const float edt = __fmul_rn(eta, dt);
    a.w[j] = __fadd_rn(a.w[j], __fdiv_rn(edt, wm));
    s_gt = __fadd_rn(__fmul_rn(gt, ome), __fmul_rn(edt, aj));
    s_edt = edt;
    s_wm = wm;
    s_n = a.cols.col(j, s_rows, s_xv);
  }
  __syncthreads();
  const int n = s_n;
  const int* rows = s_rows;
  const float* xv = s_xv;
  const float edt = s_edt, wm = s_wm;

  // ---- lines 23-25 and the row dots of line 27: one thread per row --------
  float part = 0.0f;
  for (int k = tid; k < n; k += CU_THREADS) {
    const int i = rows[k];
    const float vb = __fadd_rn(a.vbar[i], __fdiv_rn(__fmul_rn(edt, xv[k]), wm));
    a.vbar[i] = vb;
    const float hm = row_map<LOSS>(__fmul_rn(wm, vb), LOSS >= LAD ? a.y[i] : 0.0f);
    const float q = a.qbar[i];
    const float gamma = __fsub_rn(hm, q);
    a.qbar[i] = __fadd_rn(q, gamma);
    const float g = __fmul_rn(gamma, a.inv_n);
    a.gs[k] = g;
    const int* ri = a.ridx + static_cast<long long>(i) * a.kr;
    const float* rv = a.rval + static_cast<long long>(i) * a.kr;
    float dot = 0.0f;
    for (int r = 0, rn = a.rnnz[i]; r < rn; ++r) dot = __fadd_rn(dot, __fmul_rn(rv[r], a.w[ri[r]]));
    part = __fadd_rn(part, __fmul_rn(g, dot));
  }
  const float total = port::block_sum<CU_THREADS>(part);  // ends with a barrier

  // ---- line 26: α += (γ/N)·X[rows,:], one row at a time in lane order -----
  for (int k = 0; k < n; ++k) {
    const int i = rows[k];
    const float g = a.gs[k];
    const int* ri = a.ridx + static_cast<long long>(i) * a.kr;
    const float* rv = a.rval + static_cast<long long>(i) * a.kr;
    for (int r = tid, rn = a.rnnz[i]; r < rn; r += CU_THREADS) {
      const int c = ri[r];
      a.alpha[c] = __fadd_rn(a.alpha[c], __fmul_rn(g, rv[r]));
    }
    __syncthreads();
  }

  // ---- line 29: refresh the queue at every touched coordinate -------------
  for (int k = tid; k < n; k += CU_THREADS) {
    const int i = rows[k];
    const int* ri = a.ridx + static_cast<long long>(i) * a.kr;
    for (int r = 0, rn = a.rnnz[i]; r < rn; ++r) {
      const int c = ri[r];
      const float p = fabsf(a.alpha[c]);
      if (a.touched != nullptr) {
        a.prio[c] = __fmul_rn(p, a.em_scale);
        a.touched[c / a.group_size] = 1;
      } else {
        a.prio[c] = p;
        atomicMax(reinterpret_cast<int*>(a.bound) + c / a.group_size, __float_as_int(p));
      }
    }
  }

  if (tid == 0) {
    a.w_m[0] = wm;
    a.g_tilde[0] = __fadd_rn(s_gt, __fmul_rn(wm, total));
  }
}

template <int LOSS>
void launch(const Args& a, cudaStream_t stream) {
  coord_update_kernel<LOSS><<<1, CU_THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" int port_coord_update(
    int loss, const int* j, const int* cidx, const float* cval, const int* cnnz,
    const int* heavy_slot, const int* hidx, const float* hval, int width, int full,
    const int* ridx, const float* rval, const int* rnnz, int kr, const float* y, float* w,
    float* w_m, float* g_tilde, float* vbar, float* qbar, float* alpha, float* prio,
    float* bound, int* touched, int group_size, float em_scale, float t, float lam,
    float inv_n, int d, float* gaps, int* coords, int slot, float* gs, bool* done,
    int* stop_at, float gap_tol, cudaStream_t stream) {
  const Args a{j, port::Cols{cidx, cval, cnnz, heavy_slot, hidx, hval, width, full},
               ridx, rval, rnnz, kr, y, w, w_m, g_tilde, vbar, qbar, alpha, prio, bound,
               touched, group_size, em_scale, t, lam, inv_n, d, gaps, coords, slot, gs,
               done, stop_at, gap_tol};
  switch (loss) {
    case LOGISTIC: launch<LOGISTIC>(a, stream); break;
    case SQUARED: launch<SQUARED>(a, stream); break;
    case LAD: launch<LAD>(a, stream); break;
    case HUBER: launch<HUBER>(a, stream); break;
    case SMOOTHED_HINGE: launch<SMOOTHED_HINGE>(a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
