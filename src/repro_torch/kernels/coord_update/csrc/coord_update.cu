// coord_update: one Frank-Wolfe step for the selected column j (paper Alg 2,
// lines 16-29), in two stream-ordered launches.
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
// It also folds in what the JAX scan does around that call, so a step needs
// no host round trip:
//   * lines 16-21: j is read from device memory (written by the draw kernel
//     or by the host queue); d̃, the gap, η, w_m and w[j] are computed and
//     the step's gap and coordinate written into the run's output arrays;
//   * line 29: the queue priority of every touched coordinate (|α|, scaled
//     by the EM scale when private) is refreshed and the coordinate's group
//     either marked for the log-sum-exp rebuild (two-level sampler) or its
//     bound ratcheted (group argmax, an integer atomicMax: priorities are
//     >= 0, so float order = int order);
//   * early stopping (masked runs, done != null): a step that finds done set
//     writes only the sentinels gap 0 and coordinate -1; the step whose gap
//     is <= gap_tol is applied and sets done and stop_at (the global step t).
//
// The order of α's float32 additions is part of the function: every α[c]
// equals ((α_old[c] + t₁) + t₂) + … with tₖ = γᵢ/N · x_ic over the rows i of
// column j that hold c, in ascending row order — the TPU kernel's sequential
// grid order, and the CPU plain version's index_add_ over the rows' live
// lanes (ref.py).  Two runs, and the card and the CPU fed the same γ, give
// the same α bit for bit, so the selection cannot flip between them.  Rows
// that do not hold c are skipped, never added as +0 (that would turn an α
// of -0.0 into +0.0).  The rule needs each column's rows not to fall, for
// column j and for every column c; ops.owner_table checks that once per
// matrix.
//
// Repeated entries (a row that lists one column twice; HostCSR keeps both,
// and tocsc's stable sort keeps them in the row's lane order) follow the
// JAX package's scatter-adds:
//   * column j lists row i on lanes k..k+m-1: v̄[i] takes the m lanes'
//     terms in lane order, every lane the same γ from it, q̄[i] adds that γ
//     m times, and α adds row i's entries once per lane.  The first lane's
//     warp does the whole run; the other lanes return.  When column j lists
//     any row twice (ops.owner_table's col_repeats, read on the device),
//     the owners walk their rows with each member row's run of entries
//     repeated once per lane of j (repeat_walk), or j's lanes (lane terms,
//     one per lane of the run);
//   * column c lists row i twice: its owner chains both entries, in order,
//     as members of one row; such a column gets no lane-term slot (a lane
//     of j holds one term); the short route adds a row that lists a column
//     twice (row_repeats) with one thread, in lane order.
//
// Two routes, picked on the device from nnz[j] (no host sync: on the
// private path the draw kernel writes j and the host never sees it):
//
//   short (nnz[j] <= SHORT_ROUTE_MAX_ROWS): block 0 of the rows kernel does
//     the whole step: a warp per row for lines 23-25 and the row dots, α
//     scattered one row at a time in lane order (a row's column ids are
//     distinct; each thread fetches its entry of the next row while this
//     one is added) with a block barrier between rows, then the refresh
//     with a warp per row.  A few barriers cost less than the long route's
//     second launch and its walks.
//   long: the rows kernel spreads lines 23-25 and the row dots over the
//     card, a warp per row with its loads issued together; it leaves γᵢ/N
//     by row, stamped with the step's epoch, and stamps every light column
//     it touches.  The owners kernel gives each column an owner: a warp for
//     a stamped light column (<= warp_owner_max rows), a block for each
//     heavy one.  The owner walks the column's rows in ascending order
//     (through port::Cols::col, flat or tiered), tests membership, forms
//     the products with __fmul_rn and chains __fadd_rn over the members
//     from α_old[c], then writes the line-29 refresh of c itself; a heavy
//     column with no member is left as it was.  The longest columns (a
//     lane-term slot each) hold terms by lane k of column j, written by the
//     rows kernel when nnz[c] > nnz[j]: their owner then walks j's lanes,
//     in the same ascending row order, instead of its own rows.  A block
//     owner stages PASS terms at a time in shared memory while warp 0
//     chains the previous pass.  No barrier per row, no float atomics.
//
// A non-member's staged term is -0.0: x + (-0.0) == x bit for bit for every
// x under round-to-nearest (-0.0 and +0.0 included), so adding it is the
// same as skipping it (+0.0 would not be: -0.0 + +0.0 = +0.0).  A pass or a
// group of 32 with many members is chained whole; a sparse group walks its
// members' bits.
//
// Both routes leave γᵢ/N and the row's part γᵢ/N·⟨X[i,:], w⟩ in the
// scratch in lane order, and sum the parts in one fixed tree (sum_parts),
// so they give the same bits for every output; Δg̃'s order differs from the
// CPU's (allclose there), but is fixed from launch to launch.
//
// Lanes (the JAX package's vmap of the kernel over a sweep group's B
// configs): the grid's second axis is the lane b.  Both kernels offset every
// per-config array to lane b's row — j (B,), w and α (B, D), w_m and g̃
// (B,), v̄ and q̄ (B, N), the queue (B, G·M) and its flags or bounds (B, G),
// done/stop_at (B,), gaps/coords (B, steps) — and read λ, the EM scale and
// gap_tol from (B,) tables; t and the output slot are shared (lanes advance
// in lockstep), and so are the matrix, the owner table and the segment
// tables.  Each lane picks its route from its own nnz[j_b] (the owners
// kernel skips a lane on the short route through the lane's plan).  Every
// scratch array that holds one step's state has a lane axis too (γᵢ/N and
// the parts, the row and column stamps, the plan, the route counts, the
// lane terms, the row multiplicities): a stamp array shared by two lanes
// would let lane b' read lane b's stamps as members of its own column.  One
// epoch per launch serves all lanes, because each lane's stamps are its own.
// The single-config launch is the same kernels compiled without the lane
// offsets (LANES = false), its scalars by value; lane b of a lane launch
// gives its bits.
//
// Traps the design avoids:
//   * stale membership marks: every mark (row, light column, lane term) is
//     stamped with an epoch that the wrapper increments per call, so a
//     scratch reused with the same t never sees the last call's marks;
//   * masked runs: the owners kernel never reads done (the rows kernel's
//     blocks read it, and the step that sets it is still applied); the
//     step's decision travels in the scratch's plan, and done/stop_at are
//     written last, by the owners kernel's block 0;
//   * hot columns: a column in most rows is not stamped (every row would
//     store to one word); its owner finds its members itself.
//
// Bound on the H100: bytes (a few megabytes for the densest column: its
// rows' entries, v̄/q̄ of its rows, α and the priorities at the touched
// coordinates; 4 µs for the head column).  What bounds it instead:
//   * long route: the longest dependent chain of this exact order, one
//     __fadd_rn per member of the column with the most (20,242 for the head
//     column selected against itself, ~4 cycles each, ~46 µs), and the rows
//     kernel's dependent gathers (row ids → entries → w);
//   * short route: a block barrier and a round trip to α per row of j.
// Breaking the chain needs a segmented order (ROADMAP B1).
#include "port_common.cuh"

namespace {

constexpr int ROW_THREADS = 1024;    // rows kernel: a warp per row; the short route's block
constexpr int ROW_BLOCKS_MAX = 264;  // 2 × 132 SMs
constexpr int OWNER_THREADS = 256;   // owners kernel
constexpr int OWNER_WARPS = OWNER_THREADS / 32;
constexpr int RED_THREADS = 256;     // the fixed tree of Δg̃, on both routes
// A column of at most this many rows takes the short route: the two routes'
// times cross at 13-14 rows on an H100 (chip_smoke.py's sweep; PERF.md, row 1).
constexpr int SHORT_ROUTE_MAX_ROWS = 13;
constexpr unsigned FULL = 0xffffffffu;

enum Loss { LOGISTIC = 0, SQUARED = 1, LAD = 2, HUBER = 3, SMOOTHED_HINGE = 4 };
enum Route { ROUTE_AUTO = 0, ROUTE_SHORT = 1, ROUTE_LONG = 2 };
enum ColumnKind { LIGHT = -1, HEAVY = -2 };  // col_info's kind, beside lane slots >= 0

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

// What the rows kernel hands the owners kernel (int32[8] in the scratch).
struct Plan {
  int long_route;  // 1: the owners kernel runs this step; 0: frozen or done in-block
  int j;
  int n;           // nnz[j]
  int stop;        // this step crosses gap_tol: set done / stop_at after it
  float wm, gt, wj;
  int repeated;    // column j lists a row twice
};

struct Args {
  const int* j;        // (1,) selected coordinate
  port::Cols cols;     // padded CSC (flat or tiered), rows not falling in a column
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
  bool* done;          // (1,) early-stopping flag, or null (fixed-T run)
  int* stop_at;        // (1,) steps applied when done was set
  float gap_tol;
  // scratch (ops.CoordScratch)
  float* gs;           // (lane_stride,) γᵢ/N of lane k of column j
  float* parts;        // (lane_stride,) γᵢ/N·⟨X[i,:], w⟩ of lane k
  int2* rowinfo;       // (N,) by row: (γᵢ/N bits, epoch) — the long route's members
  int* colstamp;       // (D,) epoch of the last step that touched the (light) column
  Plan* plan;
  int* routes;         // (2,) steps taken by the short and the long route
  int epoch;
  int route;
  const int* heavy;    // (H,) columns of more than warp_owner_max rows, longest first
  int n_heavy;
  int warp_owner_max;
  int light_blocks;
  const int2* col_info;  // (D,) (kind, nnz): kind = lane-term slot >= 0 or HEAVY of a
                         // column of more than warp_owner_max rows, LIGHT of another
  int2* lane_terms;      // (S, lane_stride): (γᵢ/N·x_ic bits, epoch) by lane k of column j
  const int* col_repeats;  // (D,) 1: the column lists a row twice (null: no repeats)
  const int* row_repeats;  // (N,) 1: the row lists a column twice (null: no repeats)
  int* rowmult;          // (N,) lanes of column j that list the row (steps whose j repeats)
  int lane_stride;       // lanes of the longest column (N, or more when one lists a row twice)
  // lanes: per-lane scalar tables (null: the by-value lam/em_scale/gap_tol)
  // and the strides between two lanes' rows of the per-config arrays
  const float* lams;     // (B,) λ
  const float* em_scales;  // (B,) EM scale
  const float* gap_tols;   // (B,) gap_tol
  int n_rows;            // N: v̄, q̄, rowinfo, rowmult
  int prio_stride;       // G·M: prio
  int groups;            // G: touched or bound
  int out_stride;        // gaps, coords
  int terms_stride;      // S·lane_stride: lane_terms
};

// Lane b's view of the arguments: every per-config pointer at lane b's row,
// its scalars from the tables.  A single-config launch (LANES = false) uses
// the arguments as given: its kernels compile as they did before lanes, so
// the offsets cost them no registers.
template <bool LANES>
__device__ __forceinline__ Args lane_args(Args a) {
  if constexpr (!LANES) return a;
  const long long b = blockIdx.y;
  a.j += b;
  a.w += b * a.d;
  a.w_m += b;
  a.g_tilde += b;
  a.vbar += b * a.n_rows;
  a.qbar += b * a.n_rows;
  a.alpha += b * a.d;
  a.prio += b * a.prio_stride;
  if (a.bound != nullptr) a.bound += b * a.groups;
  if (a.touched != nullptr) a.touched += b * a.groups;
  a.gaps += b * a.out_stride;
  a.coords += b * a.out_stride;
  if (a.done != nullptr) {
    a.done += b;
    a.stop_at += b;
  }
  a.lam = a.lams[b];
  a.em_scale = a.em_scales[b];
  a.gap_tol = a.gap_tols[b];
  a.gs += b * a.lane_stride;
  a.parts += b * a.lane_stride;
  a.rowinfo += b * a.n_rows;
  a.colstamp += b * a.d;
  a.plan += b;
  a.routes += 2 * b;
  a.lane_terms += b * a.terms_stride;
  a.rowmult += b * a.n_rows;
  return a;
}

struct Scalars {
  const int* rows;
  const float* xv;
  int j, n;
  float edt, wm, gt, wj, gap;
  bool stop;
  bool repeated;  // column j lists a row twice
};

// Lines 16-21 (every block of the rows kernel computes the same bits).
template <bool REPEATS>
__device__ __forceinline__ Scalars step_scalars(const Args& a) {
  Scalars s;
  s.j = min(a.j[0], a.d - 1);
  const float aj = a.alpha[s.j];
  const float sgn = aj > 0.0f ? 1.0f : (aj < 0.0f ? -1.0f : aj);
  const float dt = aj == 0.0f ? a.lam : __fmul_rn(-a.lam, sgn);
  const float gt = a.g_tilde[0];
  s.gap = __fsub_rn(gt, __fmul_rn(dt, aj));
  s.stop = a.done != nullptr && a.gap_tol > 0.0f && s.gap <= a.gap_tol;
  const float eta = __fdiv_rn(2.0f, __fadd_rn(a.t, 2.0f));
  const float ome = __fsub_rn(1.0f, eta);
  s.wm = __fmul_rn(a.w_m[0], ome);
  s.edt = __fmul_rn(eta, dt);
  s.wj = __fadd_rn(a.w[s.j], __fdiv_rn(s.edt, s.wm));
  s.gt = __fadd_rn(__fmul_rn(gt, ome), __fmul_rn(s.edt, aj));
  s.n = a.cols.col(s.j, s.rows, s.xv);
  s.repeated = REPEATS && a.col_repeats[s.j] != 0;
  return s;
}

// Lines 23-25 and the row dot of line 27 for lane k of column j, by one warp.
// The dot reads w after line 21 (w[j] is substituted, not read back: it is
// written at the end of the step).  Lane l sums the row's entries l, l+32, …
// in order, then an xor butterfly (every lane ends with the same bits).  A
// row's loads are issued ROW_UNROLL chunks of 32 at a time, so a row costs
// about two dependent round trips to memory, not one per chunk.  A row that
// column j lists on lanes k..k+m-1 is done whole by lane k's warp.
constexpr int ROW_UNROLL = 4;

template <int LOSS, bool REPEATS>
__device__ __forceinline__ void row_step(const Args& a, const Scalars& s, int k, int lane,
                                         bool stamp) {
  const int i = s.rows[k];
  int m = 1;  // lanes of column j that list row i
  if (REPEATS && s.repeated) {
    if (k > 0 && s.rows[k - 1] == i) return;  // the run's first lane does it
    while (k + m < s.n && s.rows[k + m] == i) ++m;
  }
  // every lane computes γᵢ/N (the same bits; its loads overlap the row's)
  float vb = __fadd_rn(a.vbar[i], __fdiv_rn(__fmul_rn(s.edt, s.xv[k]), s.wm));
  for (int r = 1; r < m; ++r) vb = __fadd_rn(vb, __fdiv_rn(__fmul_rn(s.edt, s.xv[k + r]), s.wm));
  const float hm = row_map<LOSS>(__fmul_rn(s.wm, vb), LOSS >= LAD ? a.y[i] : 0.0f);
  const float q = a.qbar[i];
  const float gamma = __fsub_rn(hm, q);
  const float g = __fmul_rn(gamma, a.inv_n);
  const int* ri = a.ridx + static_cast<long long>(i) * a.kr;
  const float* rv = a.rval + static_cast<long long>(i) * a.kr;
  const int rn = a.rnnz[i];
  float dot = 0.0f;
  for (int base = 0; base < rn; base += 32 * ROW_UNROLL) {
    int c[ROW_UNROLL], st[ROW_UNROLL];
    int2 ci[ROW_UNROLL];
    float x[ROW_UNROLL], wc[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int r = base + 32 * u + lane;
      c[u] = r < rn ? ri[r] : -1;
      x[u] = r < rn ? rv[r] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      wc[u] = c[u] < 0 ? 0.0f : (c[u] == s.j ? s.wj : a.w[c[u]]);
      ci[u] = stamp && c[u] >= 0 ? a.col_info[c[u]] : make_int2(HEAVY, 0);
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) st[u] = ci[u].x == LIGHT ? a.colstamp[c[u]] : a.epoch;
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      if (c[u] >= 0) dot = __fadd_rn(dot, __fmul_rn(x[u], wc[u]));
      // a light column is stamped (idempotent: every row and lane that holds
      // it stores the same epoch); a heavy one is not (every row would store
      // to it), its owner finds its members itself
      if (ci[u].x == LIGHT && st[u] != a.epoch) a.colstamp[c[u]] = a.epoch;
      if (ci[u].x >= 0 && s.n < ci[u].y)  // its owner walks j's lanes: a term per lane
        for (int r = 0; r < m; ++r)
          a.lane_terms[static_cast<long long>(ci[u].x) * a.lane_stride + k + r] =
              make_int2(__float_as_int(__fmul_rn(g, x[u])), a.epoch);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot = __fadd_rn(dot, __shfl_xor_sync(FULL, dot, off));
  if (lane == 0) {
    a.vbar[i] = vb;
    float qn = __fadd_rn(q, gamma);
    a.gs[k] = g;
    a.parts[k] = __fmul_rn(g, dot);
    for (int r = 1; r < m; ++r) {
      qn = __fadd_rn(qn, gamma);
      a.gs[k + r] = g;
      a.parts[k + r] = __fmul_rn(g, dot);
    }
    a.qbar[i] = qn;
    if (stamp) {
      a.rowinfo[i] = make_int2(__float_as_int(g), a.epoch);
      if (REPEATS && s.repeated) a.rowmult[i] = m;
    }
  }
}

// Line 29 for one coordinate, from its final α.
__device__ __forceinline__ void refresh(const Args& a, int c, float alpha_c) {
  const float p = fabsf(alpha_c);
  if (a.touched != nullptr) {
    a.prio[c] = __fmul_rn(p, a.em_scale);
    a.touched[c / a.group_size] = 1;
  } else {
    a.prio[c] = p;
    atomicMax(reinterpret_cast<int*>(a.bound) + c / a.group_size, __float_as_int(p));
  }
}

// Δg̃'s sum of the n parts, one fixed tree on both routes: thread t < 256
// adds parts t, t+256, … in order, then a halving tree.  Every thread of the
// block (blockDim >= 256) must call it.
__device__ __forceinline__ float sum_parts(const float* parts, int n) {
  __shared__ float s[RED_THREADS];
  const int tid = threadIdx.x;
  if (tid < RED_THREADS) {
    float acc = 0.0f;
    int k = tid;
    for (; k + 3 * RED_THREADS < n; k += 4 * RED_THREADS) {  // loads ahead of the chain
      const float p0 = parts[k], p1 = parts[k + RED_THREADS];
      const float p2 = parts[k + 2 * RED_THREADS], p3 = parts[k + 3 * RED_THREADS];
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, p0), p1), p2), p3);
    }
    for (; k < n; k += RED_THREADS) acc = __fadd_rn(acc, parts[k]);
    s[tid] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int stride = RED_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) s[tid] = __fadd_rn(s[tid], s[tid + stride]);
    __syncthreads();
  }
  const float r = s[0];
  __syncthreads();
  return r;
}

// The step's last writes: w[j], w_m, g̃ and the early-stopping flags.
__device__ __forceinline__ void finish(const Args& a, int j, float wj, float wm, float gt,
                                       float total, bool stop) {
  a.w[j] = wj;
  a.w_m[0] = wm;
  a.g_tilde[0] = __fadd_rn(gt, __fmul_rn(wm, total));
  if (stop) {
    *a.done = true;
    *a.stop_at = static_cast<int>(a.t);
  }
}

// acc ← acc + terms[l], for l = 0..31 in order, where bit l of mask is set
// (the members).  The 32 terms are staged in shared memory, a non-member's
// as -0.0: x + (-0.0) == x bit for bit for every x under round-to-nearest
// (-0.0 and +0.0 included), so adding it is the same as skipping it.  A
// group with few members walks its set bits; a fuller one adds all 32,
// eight 16-byte loads ahead of the chain.  Every lane of the warp reads the
// same terms and ends with the same bits.
constexpr int CHAIN_SPARSE = 4;

__device__ __forceinline__ float chain32(float acc, const float* terms, unsigned mask) {
  if (__popc(mask) <= CHAIN_SPARSE) {
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      acc = __fadd_rn(acc, terms[l]);
    }
    return acc;
  }
  float4 q[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) q[v] = reinterpret_cast<const float4*>(terms)[v];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    acc = __fadd_rn(acc, q[v].x);
    acc = __fadd_rn(acc, q[v].y);
    acc = __fadd_rn(acc, q[v].z);
    acc = __fadd_rn(acc, q[v].w);
  }
  return acc;
}

// Column and term of entry r of lane k's row (-1 past the row's end), and
// whether the row lists a column twice.
template <bool REPEATS>
__device__ __forceinline__ void fetch_entry(const Args& a, const Scalars& s, int k, int r,
                                            int& c, float& term, bool& rep) {
  const int i = s.rows[k];
  const long long at = static_cast<long long>(i) * a.kr + r;
  const bool live = r < a.rnnz[i];
  c = live ? a.ridx[at] : -1;
  term = live ? __fmul_rn(a.gs[k], a.rval[at]) : 0.0f;
  rep = REPEATS && a.row_repeats[i] != 0;
}

// ---- the rows kernel: lines 16-25 and the row dots; the short route whole --

template <int LOSS, bool REPEATS, bool LANES>
__global__ void __launch_bounds__(ROW_THREADS) rows_kernel(const Args args) {
  const Args a = lane_args<LANES>(args);
  __shared__ Scalars s_sc;
  __shared__ int s_state;  // 0 frozen, 1 short route, 2 long route
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    if (a.done != nullptr && *a.done) {  // the run stopped at an earlier step
      s_state = 0;
      if (blockIdx.x == 0) {
        a.gaps[a.slot] = 0.0f;
        a.coords[a.slot] = -1;
        a.plan->long_route = 0;
      }
    } else {
      const Scalars sc = step_scalars<REPEATS>(a);
      const bool short_route = a.route == ROUTE_SHORT ||
                               (a.route == ROUTE_AUTO && sc.n <= SHORT_ROUTE_MAX_ROWS);
      s_sc = sc;
      s_state = short_route ? 1 : 2;
      if (blockIdx.x == 0) {
        a.gaps[a.slot] = sc.gap;
        a.coords[a.slot] = sc.j;
        a.routes[short_route ? 0 : 1] += 1;
        *a.plan = Plan{short_route ? 0 : 1, sc.j, sc.n, sc.stop ? 1 : 0,
                       sc.wm, sc.gt, sc.wj, sc.repeated ? 1 : 0};
      }
    }
  }
  __syncthreads();
  const int state = s_state;
  if (state == 0) return;
  const Scalars sc = s_sc;
  constexpr int WARPS = ROW_THREADS / 32;
  if (state == 2) {  // long route: a warp per row over the whole grid
    for (int k = blockIdx.x * WARPS + warp; k < sc.n; k += gridDim.x * WARPS)
      row_step<LOSS, REPEATS>(a, sc, k, lane, true);
    return;
  }
  if (blockIdx.x != 0) return;
  // ---- short route, in this block ------------------------------------------
  for (int k = warp; k < sc.n; k += WARPS) row_step<LOSS, REPEATS>(a, sc, k, lane, false);
  __syncthreads();
  // line 26: one row at a time, in lane order; thread r adds entry r of the
  // row, whose column and term it fetched while the previous row was added.
  // A row that lists a column twice is added by thread 0 alone, in order.
  int next_c = -1;
  float next_t = 0.0f;
  bool next_rep = false;
  if (sc.n > 0) fetch_entry<REPEATS>(a, sc, 0, tid, next_c, next_t, next_rep);
  for (int k = 0; k < sc.n; ++k) {
    const int c = next_c;
    const float term = next_t;
    const bool rep = next_rep;
    if (k + 1 < sc.n) fetch_entry<REPEATS>(a, sc, k + 1, tid, next_c, next_t, next_rep);
    if (!rep) {
      if (c >= 0) a.alpha[c] = __fadd_rn(a.alpha[c], term);
      if (a.kr > ROW_THREADS) {  // rows longer than the block
        const int i = sc.rows[k];
        const int* ri = a.ridx + static_cast<long long>(i) * a.kr;
        const float* rv = a.rval + static_cast<long long>(i) * a.kr;
        for (int r = tid + ROW_THREADS, rn = a.rnnz[i]; r < rn; r += ROW_THREADS)
          a.alpha[ri[r]] = __fadd_rn(a.alpha[ri[r]], __fmul_rn(a.gs[k], rv[r]));
      }
    } else if (REPEATS && tid == 0) {
      const int i = sc.rows[k];
      const int* ri = a.ridx + static_cast<long long>(i) * a.kr;
      const float* rv = a.rval + static_cast<long long>(i) * a.kr;
      for (int r = 0, rn = a.rnnz[i]; r < rn; ++r)
        a.alpha[ri[r]] = __fadd_rn(a.alpha[ri[r]], __fmul_rn(a.gs[k], rv[r]));
    }
    __syncthreads();
  }
  for (int k = warp; k < sc.n; k += WARPS) {  // line 29: a warp per row
    const int i = sc.rows[k];
    const int* ri = a.ridx + static_cast<long long>(i) * a.kr;
    for (int r = lane, rn = a.rnnz[i]; r < rn; r += 32) refresh(a, ri[r], a.alpha[ri[r]]);
  }
  const float total = sum_parts(a.parts, sc.n);
  if (tid == 0) finish(a, sc.j, sc.wj, sc.wm, sc.gt, total, sc.stop);
}

// ---- the owners kernel (long route): line 26 by column, line 29, the end --

// A column of more than warp_owner_max rows: warps 1..7 stage PASS rows at a
// time (member flags by ballot, products) into shared memory, OWNER_ITEMS
// rows a thread with their loads issued together, while warp 0 chains the
// previous pass in order.
constexpr int OWNER_ITEMS = 8;
constexpr int DENSE_PASS = 8;  // a pass whose rows are over 1/8 members is chained whole
constexpr int LOADERS = OWNER_THREADS - 32;
constexpr int PASS = LOADERS * OWNER_ITEMS;

// Loader thread tid >= 32 stages entries tid - 32 + LOADERS·u of a pass:
// each warp's 32 lanes hold 32 consecutive entries.  An entry is row lane r
// of column c (its CSC, rows ascending; a member if the row is column j's),
// or, with by_lane, lane r of column j (lanes ascending; a member if that
// row holds c: the rows kernel left its term in lanes[r]).
__device__ __forceinline__ void stage_pass(const Args& a, const int* ri, const float* rv,
                                           const int2* lanes, bool by_lane, int m, int pass,
                                           float* prod, unsigned* mask) {
  const int e0 = static_cast<int>(threadIdx.x) - 32;
  const int base = pass * PASS + e0;
  const int2 none = make_int2(0, a.epoch - 1);
  int2 info[OWNER_ITEMS];
  float x[OWNER_ITEMS];
  if (by_lane) {
#pragma unroll
    for (int u = 0; u < OWNER_ITEMS; ++u) {
      const int r = base + LOADERS * u;
      info[u] = r < m ? lanes[r] : none;
      x[u] = 1.0f;
    }
  } else {
    int row[OWNER_ITEMS];
#pragma unroll
    for (int u = 0; u < OWNER_ITEMS; ++u) {
      const int r = base + LOADERS * u;
      row[u] = r < m ? ri[r] : -1;
      x[u] = r < m ? rv[r] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < OWNER_ITEMS; ++u) info[u] = row[u] < 0 ? none : a.rowinfo[row[u]];
  }
#pragma unroll
  for (int u = 0; u < OWNER_ITEMS; ++u) {
    const bool mem = info[u].y == a.epoch;
    const unsigned bal = __ballot_sync(FULL, mem);
    const int e = e0 + LOADERS * u;
    const float v = __int_as_float(info[u].x);
    prod[e] = !mem ? -0.0f : (by_lane ? v : __fmul_rn(v, x[u]));  // -0.0: see chain32
    if ((threadIdx.x & 31) == 0) mask[e >> 5] = bal;
  }
}

// acc ← acc + g·rv[q] for q in [from, to), `times` times over: the repeats
// of a member row's run of entries (repeat_walk).
__device__ __forceinline__ float replay(float acc, const float* rv, int from, int to,
                                        int times, float g) {
  for (int t = 0; t < times; ++t)
    for (int q = from; q < to; ++q) acc = __fadd_rn(acc, __fmul_rn(g, rv[q]));
  return acc;
}

// α[c]'s chain in a step whose column j lists a row on several lanes, by one
// warp: c's m entries in order (rows ascending, a row's entries in lane
// order), each member row's run of entries added once per lane of j that
// lists the row, run after run — the reference adds lane k's whole row
// before lane k+1's.  Loads go out 32 entries at a time; every lane walks
// the same chain from shuffles.  Sets touched if c has a member.
__device__ float repeat_walk(const Args& a, const int* ri, const float* rv, int m,
                             float acc, bool& touched) {
  const int lane = threadIdx.x & 31;
  int run_from = 0, run_row = -1, run_mult = 0;
  float run_g = 0.0f;
  touched = false;
  for (int base = 0; base < m; base += 32) {
    const int r = base + lane;
    const int row = r < m ? ri[r] : -1;
    const float x = r < m ? rv[r] : 0.0f;
    const int2 info = row < 0 ? make_int2(0, a.epoch - 1) : a.rowinfo[row];
    const bool mem = info.y == a.epoch;
    const int mult = mem ? a.rowmult[row] : 0;
    const float term = mem ? __fmul_rn(__int_as_float(info.x), x) : 0.0f;
    const int count = min(32, m - base);
    for (int l = 0; l < count; ++l) {
      const int row_l = __shfl_sync(FULL, row, l);
      const int mult_l = __shfl_sync(FULL, mult, l);
      const float term_l = __shfl_sync(FULL, term, l);
      const int g_l = __shfl_sync(FULL, info.x, l);
      if (row_l != run_row) {  // a new run: the last one's repeats first
        acc = replay(acc, rv, run_from, base + l, run_mult - 1, run_g);
        run_from = base + l;
        run_row = row_l;
        run_mult = mult_l;
        run_g = __int_as_float(g_l);
      }
      if (mult_l > 0) {
        acc = __fadd_rn(acc, term_l);
        touched = true;
      }
    }
  }
  return replay(acc, rv, run_from, m, run_mult - 1, run_g);
}

template <bool REPEATS>
__device__ __forceinline__ void block_owner(const Args& a, int c, int n, bool repeated) {
  __shared__ __align__(16) float s_prod[2][PASS];
  __shared__ unsigned s_mask[2][PASS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* ri;
  const float* rv;
  int m = a.cols.col(c, ri, rv);
  // one of the longest columns against a shorter column j: walk j's n lanes
  const int slot = a.col_info[c].x;
  const bool by_lane = slot >= 0 && n < m;
  if (REPEATS && repeated && !by_lane) {  // column j lists a row twice: warp 0 walks c's rows
    if (warp == 0) {
      bool touched;
      const float acc = repeat_walk(a, ri, rv, m, a.alpha[c], touched);
      if (lane == 0 && touched) {
        a.alpha[c] = acc;
        refresh(a, c, acc);
      }
    }
    return;
  }
  const int2* lanes = a.lane_terms + static_cast<long long>(max(slot, 0)) * a.lane_stride;
  if (by_lane) m = n;
  const int passes = (m + PASS - 1) / PASS;
  if (warp != 0) stage_pass(a, ri, rv, lanes, by_lane, m, 0, s_prod[0], s_mask[0]);
  __syncthreads();
  float acc = a.alpha[c];
  unsigned touched = 0;
  for (int p = 0; p < passes; ++p) {
    const int buf = p & 1;
    if (warp == 0) {
      const int groups = (min(PASS, m - p * PASS) + 31) / 32;
      int members = 0;
      for (int g = lane; g < groups; g += 32) {
        touched |= s_mask[buf][g];
        members += __popc(s_mask[buf][g]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        touched |= __shfl_xor_sync(FULL, touched, off);
        members += __shfl_xor_sync(FULL, members, off);
      }
      if (members * DENSE_PASS > groups * 32) {
        // most rows are members: add every staged term (-0.0 for the
        // others), four at a time, the loads running ahead of the adds
        const float4* q = reinterpret_cast<const float4*>(s_prod[buf]);
#pragma unroll 4
        for (int v = 0; v < groups * 8; ++v) {
          const float4 t = q[v];
          acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, t.x), t.y), t.z), t.w);
        }
      } else {
        for (int g = 0; g < groups; ++g) {
          const unsigned mask = s_mask[buf][g];
          if (mask) acc = chain32(acc, &s_prod[buf][32 * g], mask);
        }
      }
    } else if (p + 1 < passes) {
      stage_pass(a, ri, rv, lanes, by_lane, m, p + 1, s_prod[buf ^ 1], s_mask[buf ^ 1]);
    }
    __syncthreads();
  }
  if (tid == 0 && touched) {  // a column with no member keeps α and its queue entry
    a.alpha[c] = acc;
    refresh(a, c, acc);
  }
}

// A column of at most warp_owner_max rows: one warp, 32 rows at a time,
// staged in the warp's 32 floats of shared memory; the next chunk's row ids
// go out before this chunk's chain.
__device__ __forceinline__ void warp_owner(const Args& a, int c, int lane, float* terms) {
  const int* ri;
  const float* rv;
  const int m = a.cols.col(c, ri, rv);
  float acc = a.alpha[c];
  int row = lane < m ? ri[lane] : -1;
  float x = lane < m ? rv[lane] : 0.0f;
  for (int base = 0; base < m; base += 32) {
    const int2 info = row < 0 ? make_int2(0, a.epoch - 1) : a.rowinfo[row];
    const float xc = x;
    const int r = base + 32 + lane;
    row = r < m ? ri[r] : -1;
    x = r < m ? rv[r] : 0.0f;
    const bool mem = info.y == a.epoch;
    const unsigned mask = __ballot_sync(FULL, mem);
    terms[lane] = mem ? __fmul_rn(__int_as_float(info.x), xc) : -0.0f;
    __syncwarp();
    if (mask) acc = chain32(acc, terms, mask);
    __syncwarp();
  }
  if (lane == 0) {
    a.alpha[c] = acc;
    refresh(a, c, acc);
  }
}

// Block 0: Δg̃ and the step's last writes; blocks 1..H: one heavy column
// each (longest first); then warps over the other columns.
template <bool REPEATS, bool LANES>
__global__ void __launch_bounds__(OWNER_THREADS) owners_kernel(const Args args) {
  const Args a = lane_args<LANES>(args);
  const Plan plan = *a.plan;
  if (!plan.long_route) return;
  const int b = blockIdx.x;
  if (b == 0) {
    const float total = sum_parts(a.parts, plan.n);
    if (threadIdx.x == 0) finish(a, plan.j, plan.wj, plan.wm, plan.gt, total, plan.stop != 0);
    return;
  }
  if (b <= a.n_heavy) {
    block_owner<REPEATS>(a, a.heavy[b - 1], plan.n, plan.repeated != 0);
    return;
  }
  __shared__ __align__(16) float s_terms[OWNER_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = (b - 1 - a.n_heavy) * OWNER_WARPS + warp;
  for (int c = gw; c < a.d; c += a.light_blocks * OWNER_WARPS) {
    const int m = a.cols.nnz[c];
    if (m == 0 || m > a.warp_owner_max || a.colstamp[c] != a.epoch) continue;
    if (REPEATS && plan.repeated) {
      const int* ri;
      const float* rv;
      a.cols.col(c, ri, rv);
      bool touched;
      const float acc = repeat_walk(a, ri, rv, m, a.alpha[c], touched);
      if (lane == 0 && touched) {
        a.alpha[c] = acc;
        refresh(a, c, acc);
      }
    } else {
      warp_owner(a, c, lane, s_terms[warp]);
    }
  }
}

// REPEATS: the matrix holds a repeated entry (col_repeats/row_repeats not
// null); a matrix without one runs kernels compiled without those paths.
// LANES: the lane form (per-lane tables given); the single-config launch
// runs the kernels compiled without the lane offsets.
template <int LOSS, bool REPEATS, bool LANES>
int launch_as(const Args& a, int max_col_nnz, int lanes, cudaStream_t stream) {
  const int row_blocks = max(1, min((max_col_nnz + 31) / 32, ROW_BLOCKS_MAX));
  rows_kernel<LOSS, REPEATS, LANES><<<dim3(row_blocks, lanes), ROW_THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  owners_kernel<REPEATS, LANES><<<dim3(1 + a.n_heavy + a.light_blocks, lanes), OWNER_THREADS,
                                  0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int LOSS, bool REPEATS>
int launch_lanes(const Args& a, int max_col_nnz, int lanes, cudaStream_t stream) {
  return a.lams != nullptr ? launch_as<LOSS, REPEATS, true>(a, max_col_nnz, lanes, stream)
                           : launch_as<LOSS, REPEATS, false>(a, max_col_nnz, lanes, stream);
}

template <int LOSS>
int launch(const Args& a, int max_col_nnz, int lanes, cudaStream_t stream) {
  return a.col_repeats != nullptr ? launch_lanes<LOSS, true>(a, max_col_nnz, lanes, stream)
                                  : launch_lanes<LOSS, false>(a, max_col_nnz, lanes, stream);
}

}  // namespace

extern "C" int port_coord_update_short_route_max() { return SHORT_ROUTE_MAX_ROWS; }

// lanes >= 1 configs in one launch.  lams/em_scales/gap_tols: (lanes,) device
// tables, or null for one lane with the by-value lam/em_scale/gap_tol; the
// per-config arrays hold lane b's row at b times their stride (n_rows,
// prio_stride, groups, out_stride, terms_stride; d and lane_stride).
extern "C" int port_coord_update(
    int loss, const int* j, const int* cidx, const float* cval, const int* cnnz,
    const int* heavy_slot, const int* hidx, const float* hval, int width, int full,
    const int* ridx, const float* rval, const int* rnnz, int kr, const float* y, float* w,
    float* w_m, float* g_tilde, float* vbar, float* qbar, float* alpha, float* prio,
    float* bound, int* touched, int group_size, float em_scale, float t, float lam,
    float inv_n, int d, float* gaps, int* coords, int slot, bool* done, int* stop_at,
    float gap_tol, float* gs, float* parts, int* rowinfo, int* colstamp, int* plan,
    int* routes, int epoch, int route, const int* heavy, int n_heavy, int warp_owner_max,
    const int* col_info, int* lane_terms, const int* col_repeats, const int* row_repeats,
    int* rowmult, int lane_stride, const float* lams, const float* em_scales,
    const float* gap_tols, int lanes, int n_rows, int prio_stride, int groups,
    int out_stride, int terms_stride, cudaStream_t stream) {
  if (route < ROUTE_AUTO || route > ROUTE_LONG) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes < 1 || lanes > 65535 || (lanes > 1 && lams == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int light_blocks = max(1, min((d + 4 * OWNER_WARPS - 1) / (4 * OWNER_WARPS), 4096));
  const Args a{j, port::Cols{cidx, cval, cnnz, heavy_slot, hidx, hval, width, full},
               ridx, rval, rnnz, kr, y, w, w_m, g_tilde, vbar, qbar, alpha, prio, bound,
               touched, group_size, em_scale, t, lam, inv_n, d, gaps, coords, slot, done,
               stop_at, gap_tol, gs, parts, reinterpret_cast<int2*>(rowinfo), colstamp,
               reinterpret_cast<Plan*>(plan), routes, epoch, route, heavy, n_heavy,
               warp_owner_max, light_blocks, reinterpret_cast<const int2*>(col_info),
               reinterpret_cast<int2*>(lane_terms), col_repeats, row_repeats, rowmult,
               lane_stride, lams, em_scales, gap_tols, n_rows, prio_stride, groups,
               out_stride, terms_stride};
  switch (loss) {
    case LOGISTIC: return launch<LOGISTIC>(a, full, lanes, stream);
    case SQUARED: return launch<SQUARED>(a, full, lanes, stream);
    case LAD: return launch<LAD>(a, full, lanes, stream);
    case HUBER: return launch<HUBER>(a, full, lanes, stream);
    case SMOOTHED_HINGE: return launch<SMOOTHED_HINGE>(a, full, lanes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
