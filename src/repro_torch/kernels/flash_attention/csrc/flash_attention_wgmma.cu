// flash_attention, bfloat16 route: the online-softmax attention forward of the
// LM's bf16 forward on Hopper's warpgroup products (wgmma) fed by TMA, float32
// sums (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (kernel.py:88, pl.pallas_call at :106; body _flash_fwd_kernel at :39, its
// mask at :62-69) for bf16 inputs; float32 inputs keep the CUDA-core kernel of
// flash_attention.cu (TF32 would break the float32 tolerance).  The TPU
// kernel's sequential KV grid axis, carrying m, l and the accumulator in VMEM,
// becomes a loop inside one block with the state in registers.
//
// Design (building blocks in kernels/csrc/sm90.cuh, as the bf16 backward's):
// * a work item is BQ = 128 query rows of one (query head, batch row); items
//   are ordered with the query tiles of the most causal work first, and
//   persistent blocks (one an SM) take them in rounds, the order reversed on
//   odd rounds (so that each block's items add up to about the same work), in
//   a fixed assignment (no counter).  A block is three warpgroups: warpgroup 0
//   gives its registers up (setmaxnreg) and one of its threads is the
//   producer; warpgroups 1 and 2 (the consumers, 240 registers a thread) own
//   64 rows of the item each.  The producer runs ahead across items: the next
//   item's Q (into a second buffer up to hd 128) and first K/V tiles load
//   while the consumers finish the last one and write its output.
// * loads by TMA only, through 4-D maps of the model's layouts (q as (B, S, H,
//   hd), k and v as (B, S, KV, hd) read at kv head h / G): no copies, no
//   transposes.  Q once an item, as 64-column panels with the 128-byte
//   swizzle; K and V tiles of BK keys into a ring of STAGES stages, K and V
//   each under a full mbarrier of its own (S = Q·Kᵀ starts before V lands),
//   the stage freed by an empty mbarrier that every consumer warp arrives on.
//   TMA zero-fills rows past a ragged end.
// * S = Q·Kᵀ: SS wgmma m64n64k16, both operands K-major panels, one product a
//   64-key panel, float32 accumulators.
// * mask and online softmax on the accumulator layout (sm90.cuh), in the log2
//   domain: a hidden score is NEG = -1e30 (not -inf, as the TPU kernel), a key
//   past the end -inf; only tiles that the causal diagonal, the window's edge
//   or the ragged end cut are masked.  A warpgroup visits the key tiles of its
//   own rows (models/flash.py's bounds cut to the live rows, f32_tiles.cuh
//   key_span); a tile of the block's span that none of its rows sees is freed
//   without a product.
// * O += P·V: P rounded to bf16 in registers is the A operand of an RS wgmma
//   (the S accumulator is the A fragment), V the MN-major B operand, O in
//   float32 registers (64 x 256 a warpgroup at hd 256: 128 a thread).  The
//   product of tile j runs while tile j + 1's S is issued; the stage of tile j
//   is freed once S of tile j + 1 has completed (one wait a tile).
// * epilogue: O / max(l, 1e-30) in bf16 at the true v head dim, and on request
//   the log-sum-exp m·ln2 + log(max(l, 1e-30)) in (B, KV, G, Sq) float32.
// * widths: (64, 64), (128, 128), MLA's (192, 128) natively (3 q·k panels, 2 v
//   panels) and (256, 256) (ops.py BF16_WIDTHS); a narrower head dim is read
//   in place, TMA zero-filling the panels' lanes past it (kimi-k2's 112: no
//   copy), padded by the wrapper only to a whole number of 16 bytes.
// * no atomics: a launch gives the same bits every time, and `out` is the same
//   with the log-sum-exp output or without it.  Rounding P to bf16 before P·V
//   is the route's one numerical change against JAX (kernels/flash_attention/
//   ref.py flash_fwd_bf16_plain states the order on the CPU).
//
// Bound on the H100: operations.  The causal (B, S, H, hd) forward needs
// 4·B·H·hd·S(S+1)/2 flops: 68.75 GFLOP at B = 4, S = 2,048, H = 32, hd 64,
// 0.0695 ms at 989 TFLOP/s (bf16, dense); its 75.5 MB of q, k, v and out
// take 0.023 ms at 3.35 TB/s.  The design keeps the tensor cores fed by wgmma
// from shared memory filled by TMA, and overlaps one warpgroup's softmax with
// the other's products.  Neither the overlap of a warpgroup's own softmax with
// its P·V (a first version of it ran slower, PERF.md) nor FA3's ping-pong
// order of the two warpgroups' products is done.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "f32_tiles.cuh"
#include "sm90.cuh"

namespace {

using namespace port::sm90;

constexpr int BQ = 128;             // query rows a block
constexpr int WG_ROWS = 64;         // query rows a consumer warpgroup
constexpr int THREADS = 384;
constexpr int ROW = 128;            // bytes of a panel row (64 bf16)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int CONSUMER_WARPS = 8;   // arrivals that free a stage
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD, int HDV>
struct Shape {
  static constexpr int BK = HD == 256 ? 64 : 128;     // keys a tile
  static constexpr int NP = BK / 64;                  // 64-key panels of S
  static constexpr int PK = HD / 64, PV = HDV / 64;   // 64-column panels of q·k and of v
  static constexpr int STAGES = HD == 64 ? 4 : 2;
  static constexpr int QBUF = HD <= 128 ? 2 : 1;      // Q buffers
  static constexpr int Q_BYTES = PK * BQ * ROW;
  static constexpr int K_BYTES = PK * BK * ROW;
  static constexpr int V_BYTES = PV * BK * ROW;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + QBUF * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * V_BYTES;
  // a Q buffer's full and empty, then a stage's K full, V full and empty
  static constexpr int B_Q = 0, B_Q_EMPTY = QBUF, B_K = 2 * QBUF, B_V = B_K + STAGES,
                       B_EMPTY = B_V + STAGES, N_BAR = B_EMPTY + STAGES;
  static constexpr int BYTES = OFF_BAR + N_BAR * 8 + 1024;   // + the base's alignment
  static_assert(BYTES <= 232448, "shared memory");
};

struct Args {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* out;   // (B, Sq, H, hdv_out)
  float* lse;           // NULL, or (B, H, Sq)
  int b, sq, sk, h, kvh, causal, window, hdv_out, nq, n_items;
  float scale_log2;
};

struct Item {
  int head, bi, q_lo, lo, hi;   // [lo, hi): the key tiles the item's block loads
};

// item t: heads fastest, then batch rows, then the query tiles from the last down
template <int BK>
__device__ __forceinline__ Item item_at(const Args& a, int t) {
  Item m;
  m.head = t % a.h;
  const int r = t / a.h;
  m.bi = r % a.b;
  m.q_lo = (a.nq - 1 - r / a.b) * BQ;
  port::f32::key_span(m.q_lo, min(m.q_lo + BQ, a.sq), BK, a.sk, a.causal, a.window, m.lo, m.hi);
  return m;
}

// this block's item of round k (-1: none); rounds reversed on odd k
__device__ __forceinline__ int item_of_round(const Args& a, int k) {
  const int g = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  const int t = k * g + ((k & 1) ? g - 1 - b : b);
  return t < a.n_items ? t : -1;
}

template <int HD, int HDV>
__device__ __forceinline__ void produce(const Args& a, unsigned char* sm) {
  using S = Shape<HD, HDV>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
  const int groups = a.h / a.kvh;
  int c = 0;   // tiles loaded, over the items
  for (int k = 0, u = 0; k * static_cast<int>(gridDim.x) < a.n_items; ++k) {
    const int t = item_of_round(a, k);
    if (t < 0) continue;
    const Item m = item_at<S::BK>(a, t);
    const int qb = u % S::QBUF, kv_head = m.head / groups;
    mbar_wait(bars + S::B_Q_EMPTY + qb, ((u / S::QBUF) & 1) ^ 1);
    ++u;
    mbar_arrive_tx(bars + S::B_Q + qb, S::Q_BYTES);
#pragma unroll
    for (int p = 0; p < S::PK; ++p)
      tma_load_4d(sm + S::OFF_Q + qb * S::Q_BYTES + p * BQ * ROW, &a.tq, bars + S::B_Q + qb,
                  64 * p, m.head, m.q_lo, m.bi);
    for (int it = m.lo; it < m.hi; ++it, ++c) {
      const int stage = c % S::STAGES;
      mbar_wait(bars + S::B_EMPTY + stage, ((c / S::STAGES) & 1) ^ 1);
      uint64_t* k_full = bars + S::B_K + stage;
      mbar_arrive_tx(k_full, S::K_BYTES);
#pragma unroll
      for (int p = 0; p < S::PK; ++p)
        tma_load_4d(sm + S::OFF_K + stage * S::K_BYTES + p * S::BK * ROW, &a.tk, k_full, 64 * p,
                    kv_head, it * S::BK, m.bi);
      uint64_t* v_full = bars + S::B_V + stage;
      mbar_arrive_tx(v_full, S::V_BYTES);
#pragma unroll
      for (int p = 0; p < S::PV; ++p)
        tma_load_4d(sm + S::OFF_V + stage * S::V_BYTES + p * S::BK * ROW, &a.tv, v_full, 64 * p,
                    kv_head, it * S::BK, m.bi);
    }
  }
}

// Mask (EDGE) and the online softmax of one tile's scores s, rows 16w + l/4 +
// 8r of the warpgroup; P packed to bf16 pairs in pp, O rescaled.  A row's max
// and sum are taken over 4·NP partial chains (a max in any order is exact; the
// sum's order is fixed), so that the chains run side by side.  On a tile no
// mask cuts, the max is taken over the raw scores (the scale is positive) and
// the scale folds into the exponent's FMA: p = 2^(s·scale·log2 e − m).
template <int NP, int PV, bool EDGE>
__device__ __forceinline__ void softmax(const Args& a, float (&s)[NP][32], uint32_t (&pp)[NP][16],
                                        float (&o)[PV][32], float (&m)[2], float (&lsum)[2],
                                        int row0, int k_lo, int l) {
  constexpr int C = 4;   // partial chains a 64-key panel and row
  float part[2][NP][C];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c) part[r][n][c] = EDGE ? NEG : -INFINITY;
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][4 * jb + 2 * r + e];
          if (EDGE) {
            x *= a.scale_log2;
            const int row = row0 + 8 * r, col = k_lo + 64 * n + 8 * jb + 2 * (l & 3) + e;
            if (col >= a.sk)
              x = -INFINITY;
            else if ((a.causal && row < col) || (a.window && row - col >= a.window))
              x = NEG;
            s[n][4 * jb + 2 * r + e] = x;
          }
          float& pm = part[r][n][2 * (jb & 1) + e];
          pm = fmaxf(pm, x);
        }
  float m_new[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = part[r][0][0];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c) mx = fmaxf(mx, part[r][n][c]);
    if (!EDGE) mx *= a.scale_log2;
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    m_new[r] = fmaxf(m[r], mx);
    corr[r] = exp2_approx(m[r] - m_new[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c) part[r][n][c] = 0.0f;
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][4 * jb + 2 * r + e];
          x = EDGE ? exp2_approx(x - m_new[r]) : exp2_approx(fmaf(x, a.scale_log2, -m_new[r]));
          part[r][n][2 * (jb & 1) + e] += x;
        }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      sum += (part[r][n][0] + part[r][n][1]) + (part[r][n][2] + part[r][n][3]);
    lsum[r] = lsum[r] * corr[r] + sum;
    m[r] = m_new[r];
  }
#pragma unroll
  for (int p = 0; p < PV; ++p)
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[p][4 * jb + 2 * r] *= corr[r];
        o[p][4 * jb + 2 * r + 1] *= corr[r];
      }
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int q = 0; q < 16; ++q) pp[n][q] = bf16x2(s[n][2 * q], s[n][2 * q + 1]);
}

template <int HD, int HDV, int CW>
__device__ __forceinline__ void consume(const Args& a, unsigned char* sm) {
  using S = Shape<HD, HDV>;
  constexpr int BK = S::BK, NP = S::NP, PV = S::PV;
  const int tid = threadIdx.x - 128 * (1 + CW), w = tid >> 5, l = tid & 31;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
  auto release = [&](uint64_t* bar) {   // this warp is done with a stage or a Q buffer
    __syncwarp();
    if (l == 0) mbar_arrive(bar);
  };
  int c = 0;   // tiles consumed, over the items
  for (int k = 0, u = 0; k * static_cast<int>(gridDim.x) < a.n_items; ++k) {
    const int t = item_of_round(a, k);
    if (t < 0) continue;
    const Item item = item_at<BK>(a, t);
    const int qb = u % S::QBUF;
    const uint32_t q_parity = (u / S::QBUF) & 1;
    ++u;
    const int w_lo = item.q_lo + CW * WG_ROWS;
    const int row0 = w_lo + 16 * w + (l >> 2);   // this thread's rows: row0, row0 + 8
    int my_lo, my_hi;
    port::f32::key_span(w_lo, min(w_lo + WG_ROWS, a.sq), BK, a.sk, a.causal, a.window, my_lo,
                        my_hi);
    const uint32_t a_q = smem_u32(sm + S::OFF_Q + qb * S::Q_BYTES) + CW * WG_ROWS * ROW;
    float o[PV][32];
#pragma unroll
    for (int p = 0; p < PV; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
    float m[2] = {NEG, NEG}, lsum[2] = {0.0f, 0.0f};
    uint32_t pp[NP][16];
    mbar_wait(bars + S::B_Q + qb, q_parity);
    int pending = -1;   // the stage whose P·V is in flight
    for (int it = item.lo; it < item.hi; ++it, ++c) {
      const int stage = c % S::STAGES;
      const uint32_t parity = (c / S::STAGES) & 1;
      if (it < my_lo || it >= my_hi) {   // none of this warpgroup's rows sees the tile
        if (l == 0) {
          mbar_wait(bars + S::B_K + stage, parity);
          mbar_wait(bars + S::B_V + stage, parity);
          mbar_arrive(bars + S::B_EMPTY + stage);
        }
        continue;
      }
      const uint32_t a_k = smem_u32(sm + S::OFF_K + stage * S::K_BYTES);
      const uint32_t a_v = smem_u32(sm + S::OFF_V + stage * S::V_BYTES);
      mbar_wait(bars + S::B_K + stage, parity);
      // ---- S = Q·Kᵀ, a 64-key panel a product ------------------------------------
      float s[NP][32];
      wg_fence();
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma_ss<0, 0>(s[n], desc(a_q + (kk >> 2) * BQ * ROW + (kk & 3) * 32, 16, 1024),
                       desc(a_k + (kk >> 2) * BK * ROW + 64 * n * ROW + (kk & 3) * 32, 16, 1024),
                       kk > 0);
      wg_commit();
      wg_wait<0>();   // this tile's S and the last tile's P·V
#pragma unroll
      for (int n = 0; n < NP; ++n) pin(s[n]);
#pragma unroll
      for (int p = 0; p < PV; ++p) pin(o[p]);
      if (pending >= 0) release(bars + S::B_EMPTY + pending);
      // ---- mask, online softmax -------------------------------------------------
      const int k_lo = it * BK;
      const bool edge = (a.causal && k_lo + BK - 1 > w_lo) ||
                        (a.window && w_lo + WG_ROWS - 1 - k_lo >= a.window) || k_lo + BK > a.sk;
      if (edge)
        softmax<NP, PV, true>(a, s, pp, o, m, lsum, row0, k_lo, l);
      else
        softmax<NP, PV, false>(a, s, pp, o, m, lsum, row0, k_lo, l);
      // ---- O += P·V ---------------------------------------------------------------
      mbar_wait(bars + S::B_V + stage, parity);
#pragma unroll
      for (int p = 0; p < PV; ++p) pin(o[p]);
      wg_fence();
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < PV; ++p)
            mma_rs<1>(o[p], pp[n][4 * kk], pp[n][4 * kk + 1], pp[n][4 * kk + 2],
                      pp[n][4 * kk + 3],
                      desc(a_v + p * BK * ROW + (64 * n + 16 * kk) * ROW, BK * ROW, 1024), 1);
      wg_commit();
      pending = stage;
    }
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < PV; ++p) pin(o[p]);
    if (pending >= 0) release(bars + S::B_EMPTY + pending);
    release(bars + S::B_Q_EMPTY + qb);

    // ---- O / l in bf16 at the true v head dim; the log-sum-exp ------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = lsum[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = row0 + 8 * r;
      if (row >= a.sq) continue;
      const float inv = 1.0f / fmaxf(sum, 1e-30f);
      // the row's log-sum-exp, natural log (models/flash.py's m + log(max(l, 1e-30))),
      // for the backward; (B, H, Sq) = JAX's (B, KV, G, Sq)
      if (a.lse != nullptr && (l & 3) == 0)
        a.lse[(static_cast<long long>(item.bi) * a.h + item.head) * a.sq + row] =
            m[r] * LN2 + logf(fmaxf(sum, 1e-30f));
      __nv_bfloat16* dst =
          a.out + ((static_cast<long long>(item.bi) * a.sq + row) * a.h + item.head) * a.hdv_out;
#pragma unroll
      for (int p = 0; p < PV; ++p)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int col = 64 * p + 8 * jb + 2 * (l & 3);
          const float x = o[p][4 * jb + 2 * r] * inv, y = o[p][4 * jb + 2 * r + 1] * inv;
          if (a.hdv_out == HDV) {
            *reinterpret_cast<uint32_t*>(dst + col) = bf16x2(x, y);
          } else {   // a padded width: its lanes past hdv_out are not written
            if (col < a.hdv_out) dst[col] = __float2bfloat16_rn(x);
            if (col + 1 < a.hdv_out) dst[col + 1] = __float2bfloat16_rn(y);
          }
        }
    }
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ Args a) {
  using S = Shape<HD, HDV>;
  extern __shared__ __align__(1024) unsigned char raw[];
  // the base rounded up to 1,024 bytes (the swizzle's period), as an offset so
  // that the compiler keeps the pointers in the shared window
  unsigned char* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
    for (int i = 0; i < S::QBUF; ++i) {
      mbar_init(bars + S::B_Q + i, 1);   // the producer's expect_tx
      mbar_init(bars + S::B_Q_EMPTY + i, CONSUMER_WARPS);
    }
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(bars + S::B_K + i, 1);
      mbar_init(bars + S::B_V + i, 1);
      mbar_init(bars + S::B_EMPTY + i, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // the warpgroup, uniform across the warp as the compiler can see (so that each
  // branch is compiled to its own register count)
  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (group == 0) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce<HD, HDV>(a, sm);
  } else {
    regs_inc<CONSUMER_REGS>();
    if (group == 1)
      consume<HD, HDV, 0>(a, sm);
    else
      consume<HD, HDV, 1>(a, sm);
  }
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int sk, int h, int kvh, int qk_w, int v_w, int hdv_out, int causal, int window,
           float scale, cudaStream_t stream) {
  using S = Shape<HD, HDV>;
  Args a;
  // q, k and v at their own widths: TMA zero-fills a panel's lanes past them
  cudaError_t err = map4(&a.tq, q, b, sq, h, qk_w, BQ);
  if (err == cudaSuccess) err = map4(&a.tk, k, b, sk, kvh, qk_w, S::BK);
  if (err == cudaSuccess) err = map4(&a.tv, v, b, sk, kvh, v_w, S::BK);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = lse;
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.kvh = kvh;
  a.causal = causal;
  a.window = window;
  a.hdv_out = hdv_out;
  a.nq = (sq + BQ - 1) / BQ;
  a.n_items = a.nq * b * h;
  // scale (1/sqrt(hd) rounded to float32 as JAX rounds it) times log2(e)
  a.scale_log2 = scale * LOG2E;
  auto kern = flash_fwd_wgmma_kernel<HD, HDV>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.n_items < sm_count() ? a.n_items : sm_count();
  kern<<<grid, THREADS, S::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: (B, Sq|Sk, H|KV, qk_w); v: (B, Sk, KV, v_w), bf16, the widths multiples
// of 8 (a row a whole number of 16 bytes, as TMA reads it), zero-padded by the
// caller where the head dims are not; (hd, hdv), the kernel's panel widths, one
// of (64, 64), (128, 128), (192, 128), (256, 256), with qk_w <= hd, v_w <= hdv;
// out: (B, Sq, H, hdv_out) bf16, hdv_out <= v_w the true v head dim; lse: NULL,
// or (B, H, Sq) float32 that takes each row's log-sum-exp (training's forward),
// `out` the same either way; scale: 1/sqrt(true head dim) rounded to float32.
extern "C" int port_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int b, int sq, int sk, int h, int kvh,
                                         int hd, int hdv, int qk_w, int v_w, int hdv_out,
                                         int causal, int window, float scale,
                                         cudaStream_t stream) {
  if (hdv_out > v_w || hdv_out <= 0 || qk_w > hd || v_w > hdv || qk_w % 8 || v_w % 8)
    return static_cast<int>(cudaErrorInvalidValue);
#define PORT_FA_FWD_WG(HD, HDV)                                                           \
  return launch<HD, HDV>(q, k, v, out, lse, b, sq, sk, h, kvh, qk_w, v_w, hdv_out, causal, \
                         window, scale, stream)
  if (hd == 64 && hdv == 64) PORT_FA_FWD_WG(64, 64);
  if (hd == 128 && hdv == 128) PORT_FA_FWD_WG(128, 128);
  if (hd == 192 && hdv == 128) PORT_FA_FWD_WG(192, 128);
  if (hd == 256 && hdv == 256) PORT_FA_FWD_WG(256, 256);
#undef PORT_FA_FWD_WG
  return static_cast<int>(cudaErrorInvalidValue);
}
