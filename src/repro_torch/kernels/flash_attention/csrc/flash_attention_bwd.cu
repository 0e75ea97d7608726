// flash_attention_bwd: the attention backward of the LM's training step, dq,
// dk and dv from q, k, v, the forward's out, dout and its log-sum-exp, for
// float32 and bfloat16 inputs (float32 sums; gradients in the input dtype).
//
// Replaces no Pallas kernel: the TPU kernel
// (src/repro/kernels/flash_attention/kernel.py:106) is forward-only, and the
// JAX package's training takes the gradient from the custom VJP of
// src/repro/models/flash.py (_flash_bwd, :114-181), which is pure JAX.  Its
// plain version is the port of that VJP, repro_torch/models/flash.py
// _flash_bwd (two passes); this kernel computes its arithmetic in one pass
// (kernels/flash_attention/ref.py flash_bwd_key_major_plain states the order):
//   delta = Σ_d dout·out per query row (float32);
//   P = exp(s·scale − lse), 0 where the causal or window mask hides a key;
//   dq = scale · Σ_k P ⊙ (dout·vᵀ − delta) · k;
//   dv = Σ_q Pᵀ·dout, dk = scale · Σ_q (P ⊙ (dout·vᵀ − delta))ᵀ·q.
//
// Two routes, one contract (float32 sums; P and dS rounded to bf16 on the
// bf16 route as the operands of the products that follow them, as the bf16
// forward rounds P), one key-major order:
// * bf16: one pass on wgmma with TMA (namespace wg, below), dq added into a
//   float32 workspace in a fixed order, then a finish kernel;
// * float32 (namespace cc, after it): one pass on the CUDA cores in exact
//   float32 FMAs (TF32's products round at 2^-11, which the float32 bound of
//   2e-5 · max|plain| does not hold), on the forward's register-blocked tiles
//   fed by cp.async (f32_tiles.cuh), dq added in the same order into dq
//   itself.
// Common design:
// * launches on the stream counted as one by the wrapper: delta (a warp a
//   query row), then the route's kernels.
// * a work item is (key tile, kv head, batch row); it loops over the query
//   tiles that can see its keys and its kv head's G query heads in a fixed
//   order, and computes S and dP once a tile pair: five products, Sᵀ, dPᵀ,
//   dV += Pᵀ·dout, dK += dSᵀ·q and dQ-partial = dS·K; dK and dV stay on chip
//   for the whole item.
// * no atomics on any value: each (batch, head, query tile) has a counter,
//   and an item adds its dQ-partial only when the counter says that every key
//   tile before its own that sees the tile has added; so dq sums its key tiles
//   in ascending order, and a launch gives the same bits every time.
// * keys and queries past a ragged end, and hidden keys, have P = 0, as
//   JAX's exp(NEG − lse) = 0.  Non-causal attention with Sq != Sk
//   (cross-attention) visits every tile.
// * float32 is compiled for head dims 16, 32, 64, 128 and 256, bf16 for
//   (64, 64), (128, 128), MLA's (192, 128) and (256, 256); the wrapper
//   zero-pads other head dims to the next (ops.py) and slices the padded
//   lanes off.
//
// Bound on the H100: operations.  The backward needs about 2.5× the forward's
// 4·B·H·hd·(keys seen) flops (5 products of the forward's 2): 3.44·10^11 at
// tinyllama's training shape (B = 8, S = 2,048, H = 32, hd 64, causal).  The
// bf16 route does them (plus the diagonal tiles' masked halves) at 989 TFLOP/s
// peak, the float32 route at 67 TFLOP/s on the CUDA cores: 5.13 ms.  Both move
// the dq tiles through L2 a tile pair at a time.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tiles.cuh"
#include "port_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BW_THREADS = 128;   // the delta kernel: a warp a query row

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ bool visible(int row, int col, int sq, int sk, int causal,
                                        int window) {
  return row < sq && col < sk && (!causal || row >= col) && (!window || row - col < window);
}

// delta[b, h, s] = Σ_d dout[b, s, h, d] · out[b, s, h, d]: a warp a row, the
// lanes' partial sums then a fixed shuffle tree.
template <typename T>
__global__ void __launch_bounds__(BW_THREADS)
    delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int sq, int h, int hd) {
  const long long r = static_cast<long long>(blockIdx.x) * (BW_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;   // the whole warp leaves together
  const T* o = out + r * hd;
  const T* d = dout + r * hd;
  float s = 0.0f;
  for (int c = lane; c < hd; c += 32) s = fmaf(ld(o + c), ld(d + c), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int head = static_cast<int>(r % h);
    const long long bs = r / h;
    delta[(bs / sq * h + head) * sq + bs % sq] = s;
  }
}

// ---- bf16: one key-major pass on wgmma with TMA (sm_90a) -----------------------------
//
// A work item is (key tile, kv head, batch row); persistent blocks (one an SM)
// take items in order from an atomic counter, so an item only ever waits on an
// item already taken.  A block is three warpgroups:
// * warpgroup 0, warp 0 (the producer): takes the item, loads its K and V once
//   by TMA, then for each step (a query tile of 64 rows of one of the G query
//   heads) its q and dout boxes by TMA and its lse (log2 domain) and delta
//   rows into a ring of STAGES stages under mbarriers;
// * warpgroup 0, warps 1 and 2, a thread each (the dq loader and storer): for
//   each step, the step's float32 dq_acc tile by TMA into one of SLOTS buffers
//   once the tile's counter allows, and back after the consumers have added
//   into it;
// * warpgroups 1 and 2 (the consumers, setmaxnreg to 240 registers): the five
//   products of a step on wgmma, m64n64k16, float32 sums:
//     Sᵀ = K·qᵀ and dPᵀ = V·doutᵀ (both operands K-major in shared memory),
//     P = exp2(Sᵀ·scale·log2e − lse·log2e), dSᵀ = P ⊙ (dPᵀ − delta) (P and dS
//     rounded to bf16 as the A operands of what follows, as the forward rounds P),
//     dV += Pᵀ·dout and dK += dSᵀ·q (A from registers, B MN-major),
//     dQ-partial = dS·K (dSᵀ staged in a swizzled panel, both operands MN-major),
//   then add the dQ-partial into the step's dq buffer.  dK and dV stay in
//   registers for the whole item.  S and dP are computed once (the mma.sync
//   kernels computed them in both of their passes).
//   Head dim 64: an item holds 128 keys, each consumer its own 64 (the key
//   split), with all of dK's and dV's columns; each adds the dQ-partial over
//   its own keys, consumer 1 after consumer 0.  Wider (128, MLA's (192, 128),
//   256): 64 keys, the consumers split the 64-column panels of dK, dV and dQ
//   (the column split: registers for dK and dV, and twice the items at the
//   narrow grids of kimi-k2 and recurrentgemma); consumer 1 computes Sᵀ and
//   consumer 2 dPᵀ, each forms P and dS for half of the query columns, and they
//   trade the halves through shared memory, so nothing is computed twice.
// The mask is applied only on tiles that a causal or window edge, or a ragged
// end, cuts.  Query tiles are walked from the last down and the G heads inside,
// so an item trails the one before it by about one step.
// dq without atomics on any value: the loader loads a (batch, head, query tile)
// of dq_acc only when the tile's counter equals the number of key tiles
// before this one that see the tile (acquire), and the storer bumps the
// counter after its store has landed (release); so each dq element sums its
// key tiles in ascending order and every launch gives the same bits.  Items
// are taken in chunks of up to four key tiles of each (batch, kv head), so that
// the adds into a tile follow each other closely (it stays in L2).  A finish
// kernel writes dq = bf16(dq_acc · scale) at the true head dim.
namespace wg {

using namespace port::sm90;

constexpr int BM = 64;            // queries a step
constexpr int KW = 64;            // keys a consumer warpgroup in Sᵀ and dPᵀ
constexpr int THREADS = 384;
constexpr int ROW = 128;          // bytes of a panel row (64 bf16, 32 float32)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int HEADERS = 8;        // the ring of step headers, producer to the dq loader
constexpr float LOG2E = 1.4426950408889634f;
enum : int { BAR_WG1 = 1, BAR_WG2 = 2, BAR_CONSUMERS = 3 };

template <int HD, int HDV>
struct Shape {
  static constexpr bool KEYSPLIT = HD == 64 && HDV == 64;
  static constexpr int BN = KEYSPLIT ? 2 * KW : KW;   // keys an item
  static constexpr int PK = HD / 64, PV = HDV / 64;   // 64-column bf16 panels
  // as many stages and dq buffers as the 227 KB of shared memory hold
  static constexpr int STAGES = HD == 64 ? 4 : HD == 128 ? 3 : 1;
  static constexpr int SLOTS = HD == 64 ? 3 : HD == 256 ? 1 : 2;
  static constexpr int K_BYTES = PK * BN * ROW;
  static constexpr int V_BYTES = PV * BN * ROW;
  static constexpr int Q_BYTES = PK * BM * ROW;
  static constexpr int DO_BYTES = PV * BM * ROW;
  static constexpr int STAGE_BYTES = Q_BYTES + DO_BYTES;
  static constexpr int DS_BYTES = (KEYSPLIT ? 2 : 1) * KW * ROW;   // dSᵀ panels
  static constexpr int XCH_BYTES = KEYSPLIT ? 0 : 2 * 128 * 64;
  static constexpr int DQ_BYTES = BM * HD * 4;        // HD / 32 float32 panels
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + K_BYTES;
  static constexpr int OFF_STAGE = OFF_V + V_BYTES;
  static constexpr int OFF_DS = OFF_STAGE + STAGES * STAGE_BYTES;
  static constexpr int OFF_XCH = OFF_DS + DS_BYTES;
  static constexpr int OFF_DQ = OFF_XCH + XCH_BYTES;
  static constexpr int OFF_ROWS = OFF_DQ + SLOTS * DQ_BYTES;   // lse2, delta a stage
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BM * 4;
  // full[STAGES], empty[STAGES], kv_full, kv_empty, the step headers' ring
  // (full, empty), then a dq buffer's ready (its TMA load), half (consumer 1
  // has added: the key split), full (every consumer has) and free (its TMA
  // store has read it out)
  static constexpr int B_FULL = 0, B_EMPTY = STAGES, B_KV_FULL = 2 * STAGES,
                       B_KV_EMPTY = B_KV_FULL + 1, B_HDR = B_KV_FULL + 2,
                       B_HDR_EMPTY = B_HDR + HEADERS, B_READY = B_HDR_EMPTY + HEADERS,
                       B_HALF = B_READY + SLOTS, B_DQ_FULL = B_HALF + SLOTS,
                       B_FREE = B_DQ_FULL + SLOTS, N_BAR = B_FREE + SLOTS;
  static constexpr int HDR = 8;                       // ints a step header (and a buffer's tile)
  static constexpr int OFF_HDR = OFF_BAR + N_BAR * 8;
  static constexpr int OFF_TILES = OFF_HDR + HEADERS * HDR * 4;
  static constexpr int OFF_ITEM = OFF_TILES + SLOTS * HDR * 4;   // the item; the step count
  static constexpr int BYTES = OFF_ITEM + 16 + 1024;  // + the base's alignment
  static_assert(BYTES <= 232448, "shared memory");
};

// the dK, dV and dQ panels [lo, hi) of consumer CW
template <int HD, int HDV, int CW>
struct Panels {
  using S = Shape<HD, HDV>;
  static constexpr int K_LO = S::KEYSPLIT ? 0 : (CW ? (S::PK + 1) / 2 : 0);
  static constexpr int K_HI = S::KEYSPLIT ? S::PK : (CW ? S::PK : (S::PK + 1) / 2);
  static constexpr int V_LO = S::KEYSPLIT ? 0 : (CW ? (S::PV + 1) / 2 : 0);
  static constexpr int V_HI = S::KEYSPLIT ? S::PV : (CW ? S::PV : (S::PV + 1) / 2);
  static constexpr int Q_LO = S::KEYSPLIT ? 0 : (CW ? S::PK / 2 : 0);
  static constexpr int Q_HI = S::KEYSPLIT ? S::PK : (CW ? S::PK : S::PK / 2);
  static constexpr int NK = K_HI - K_LO, NV = V_HI - V_LO, NQ = Q_HI - Q_LO;
  // dQ's product joins dV's and dK's in one wgmma group when the registers allow
  static constexpr bool ONE_GROUP = NK + NV + NQ <= 4;
};

struct Args {
  CUtensorMap tq, tk, tv, tdo, tdq;
  const float* lse;
  const float* delta;
  int* counters;        // [0]: the work counter; then (B, H, query tiles), zeroed
  __nv_bfloat16* dk;    // (B, Sk, KV, HD)
  __nv_bfloat16* dv;    // (B, Sk, KV, HDV)
  int b, sq, sk, h, kvh, causal, window, n_items, nq, nk, chunk;
  float scale, scale_log2;
};

struct Item {
  int n, bi, kvh;
};

// items in order: chunks of `chunk` key tiles, each chunk over every (batch,
// kv head) group, the key tiles of a group's chunk in a row; so the key tiles
// that add into a dq tile one after another run close in time (its tile stays
// in L2), and an item's predecessor (the key tile before, same group) is
// always taken before it
__device__ __forceinline__ Item decode(int item, const Args& a) {
  const int per_chunk = a.b * a.kvh * a.chunk;
  const int r = item % per_chunk, g = r / a.chunk;
  return Item{item / per_chunk * a.chunk + r % a.chunk, g / a.kvh, g % a.kvh};
}

// the query tiles [t_lo, t_hi) that can see keys [k_lo, k_lo + bn)
__device__ __forceinline__ void span(const Args& a, int k_lo, int bn, int& t_lo, int& t_hi) {
  const int q_begin = a.causal ? k_lo : 0;
  const int q_end = a.window ? min(a.sq, k_lo + bn - 1 + a.window) : a.sq;
  t_lo = q_begin / BM;
  t_hi = q_end > q_begin ? (q_end + BM - 1) / BM : t_lo;
}

// the first key tile that sees query tile t (the tiles that do are consecutive)
__device__ __forceinline__ int first_key_tile(const Args& a, int t, int bn) {
  if (!a.window) return 0;
  const int x = t * BM - bn + 1 - a.window;
  return x < 0 ? 0 : x / bn + 1;
}

__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  return (row < a.sq) & (col < a.sk) & (!a.causal | (row >= col)) &
         (!a.window | (row - col < a.window));
}

// P and dS of the accumulator elements in column blocks [J0, J0 + NJ) (query
// columns 8·J0 ..), packed to bf16 pairs: pp[m] = (P[2m], P[2m + 1]).
template <int J0, int NJ, bool MASK>
__device__ __forceinline__ void softmax_grad(const Args& a, const float (&s)[32],
                                             const float (&dp)[32], uint32_t (&pp)[16],
                                             uint32_t (&ps)[16], const float* lse2,
                                             const float* del, int q_lo, int key0, int l) {
#pragma unroll
  for (int j = J0; j < J0 + NJ; ++j) {
    const int c = 8 * j + 2 * (l & 3);
    const float2 lse_c = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 del_c = *reinterpret_cast<const float2*>(del + c);
    float p[4], d[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * j + 2 * i + e;
        float v = exp2_approx(s[r] * a.scale_log2 - (e ? lse_c.y : lse_c.x));
        if (MASK) v = visible(a, q_lo + c + e, key0 + 8 * i) ? v : 0.0f;
        p[2 * i + e] = v;
        d[2 * i + e] = v * (dp[r] - (e ? del_c.y : del_c.x));
      }
    pp[2 * j] = bf16x2(p[0], p[1]);
    pp[2 * j + 1] = bf16x2(p[2], p[3]);
    ps[2 * j] = bf16x2(d[0], d[1]);
    ps[2 * j + 1] = bf16x2(d[2], d[3]);
  }
}

template <int J0, int NJ>
__device__ __forceinline__ void softmax_grad(const Args& a, bool edge, const float (&s)[32],
                                             const float (&dp)[32], uint32_t (&pp)[16],
                                             uint32_t (&ps)[16], const float* lse2,
                                             const float* del, int q_lo, int key0, int l) {
  if (edge)
    softmax_grad<J0, NJ, true>(a, s, dp, pp, ps, lse2, del, q_lo, key0, l);
  else
    softmax_grad<J0, NJ, false>(a, s, dp, pp, ps, lse2, del, q_lo, key0, l);
}

// dSᵀ pairs [M0, M0 + NM) into the swizzled panel at `panel` (rows keys)
template <int M0, int NM>
__device__ __forceinline__ void stage_ds(unsigned char* panel, const uint32_t (&ps)[16], int w,
                                         int l) {
#pragma unroll
  for (int m = M0; m < M0 + NM; ++m) {
    const int row = 16 * w + (l >> 2) + 8 * (m & 1), col = 8 * (m >> 1) + 2 * (l & 3);
    *reinterpret_cast<uint32_t*>(panel + swizzled(row, col)) = ps[m];
  }
}

// buf[row][col .. col + 1] += (x, y) in a dq buffer (32-float panels, swizzled)
__device__ __forceinline__ void add_dq(unsigned char* buf, int row, int col, float x, float y) {
  float2* p = reinterpret_cast<float2*>(buf + (col >> 5) * (BM * ROW) + row * ROW +
                                        ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4);
  const float2 v = *p;
  *p = make_float2(v.x + x, v.y + y);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][32]) {
#pragma unroll
  for (int p = 0; p < N; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) d[p][r] = 0.0f;
}

// rows 16w + l/4 + 8i, columns 64·(p0 + p) + 8j + 2(l % 4) of accumulators d
// into bf16 rows of `dst` (row stride `stride`), times `mul`, rows < `live`
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long stride, int p0,
                                           const float (&d)[N][32], float mul, int live, int w,
                                           int l) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * w + (l >> 2) + 8 * i;
    if (row >= live) continue;
    __nv_bfloat16* o = dst + row * stride;
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 64 * (p0 + p) + 8 * j + 2 * (l & 3)) =
            bf16x2(d[p][4 * j + 2 * i] * mul, d[p][4 * j + 2 * i + 1] * mul);
  }
}

template <int HD, int HDV>
__device__ __forceinline__ void produce(const Args& a, unsigned char* sm) {
  using S = Shape<HD, HDV>;
  const int lane = threadIdx.x & 31;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
  int* item_slot = reinterpret_cast<int*>(sm + S::OFF_ITEM);
  int* hdr = reinterpret_cast<int*>(sm + S::OFF_HDR);
  float* rows = reinterpret_cast<float*>(sm + S::OFF_ROWS);
  const int groups = a.h / a.kvh;
  int stage = 0, phase = 0, u = 0;
  // step u's dq tile to the dq loader (counter < 0: no more steps)
  auto post = [&](int counter, int expected, int head, int q_lo, int bi) {
    if (lane == 0) {
      const int r = u % HEADERS;
      mbar_wait(bars + S::B_HDR_EMPTY + r, ((u / HEADERS) & 1) ^ 1);
      int* h_ = hdr + r * S::HDR;
      h_[0] = counter;
      h_[1] = expected;
      h_[2] = head;
      h_[3] = q_lo;
      h_[4] = bi;
      mbar_arrive(bars + S::B_HDR + r);
    }
    ++u;
  };
  for (int it = 0;; ++it) {
    int item = 0;
    Item m{0, 0, 0};
    do {   // past the last key tile in the last chunk: no item
      if (lane == 0) item = atomicAdd(a.counters, 1);
      item = __shfl_sync(0xffffffffu, item, 0);
      if (item >= a.n_items) item = -1;
      if (item >= 0) m = decode(item, a);
    } while (item >= 0 && m.n >= a.nk);
    mbar_wait(bars + S::B_KV_EMPTY, (it & 1) ^ 1);
    if (lane == 0) {
      *item_slot = item;
      if (item < 0) {
        mbar_arrive(bars + S::B_KV_FULL);
      } else {
        mbar_arrive_tx(bars + S::B_KV_FULL, S::K_BYTES + S::V_BYTES);
#pragma unroll
        for (int p = 0; p < S::PK; ++p)
          tma_load_4d(sm + S::OFF_K + p * S::BN * ROW, &a.tk, bars + S::B_KV_FULL, 64 * p, m.kvh,
                      m.n * S::BN, m.bi);
#pragma unroll
        for (int p = 0; p < S::PV; ++p)
          tma_load_4d(sm + S::OFF_V + p * S::BN * ROW, &a.tv, bars + S::B_KV_FULL, 64 * p, m.kvh,
                      m.n * S::BN, m.bi);
      }
    }
    if (item < 0) {
      post(-1, 0, 0, 0, 0);
      return;
    }
    int t_lo, t_hi;
    span(a, m.n * S::BN, S::BN, t_lo, t_hi);
    const int steps = (t_hi - t_lo) * groups;
    for (int j = 0; j < steps; ++j) {
      const int t = t_hi - 1 - j / groups, head = m.kvh * groups + j % groups, q_lo = t * BM;
      // the rows' loads are in flight while the stage drains
      const long long row0 = (static_cast<long long>(m.bi) * a.h + head) * a.sq;
      float lse_r[2], del_r[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = q_lo + lane + 32 * u;
        lse_r[u] = q < a.sq ? a.lse[row0 + q] * LOG2E : 0.0f;
        del_r[u] = q < a.sq ? a.delta[row0 + q] : 0.0f;
      }
      mbar_wait(bars + S::B_EMPTY + stage, phase ^ 1);
      float* lse_s = rows + stage * 2 * BM;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        lse_s[lane + 32 * u] = lse_r[u];
        lse_s[BM + lane + 32 * u] = del_r[u];
      }
      __syncwarp();
      if (lane == 0) {
        unsigned char* st = sm + S::OFF_STAGE + stage * S::STAGE_BYTES;
        uint64_t* full = bars + S::B_FULL + stage;
        mbar_arrive_tx(full, S::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < S::PK; ++p)
          tma_load_4d(st + p * BM * ROW, &a.tq, full, 64 * p, head, q_lo, m.bi);
#pragma unroll
        for (int p = 0; p < S::PV; ++p)
          tma_load_4d(st + S::Q_BYTES + p * BM * ROW, &a.tdo, full, 64 * p, head, q_lo, m.bi);
      }
      post(1 + (m.bi * a.h + head) * a.nq + t, m.n - first_key_tile(a, t, S::BN), head, q_lo,
           m.bi);
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The dq writers, two threads.  The loader: step u's float32 dq_acc tile into
// buffer u % SLOTS, once the storer has read the buffer's last tile out and
// the tile's counter says every earlier key tile has added.  The storer: each
// buffer back to dq_acc once the consumers have added into it, then the
// tile's counter bumped once the store has landed.  The loader waits on other
// blocks' counters, the storer only on this block's consumers, so no item
// (this block's own earlier one among them) waits on a tile this block keeps.
template <int HD, int HDV>
__device__ __forceinline__ void load_dq(const Args& a, unsigned char* sm) {
  using S = Shape<HD, HDV>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
  const volatile int* hdr = reinterpret_cast<const volatile int*>(sm + S::OFF_HDR);
  int* tiles = reinterpret_cast<int*>(sm + S::OFF_TILES);
  volatile int* total = reinterpret_cast<volatile int*>(sm + S::OFF_ITEM) + 1;
  for (int u = 0;; ++u) {
    const int r = u % HEADERS;
    mbar_wait(bars + S::B_HDR + r, (u / HEADERS) & 1);
    const volatile int* h_ = hdr + r * S::HDR;
    const int cur[5] = {h_[0], h_[1], h_[2], h_[3], h_[4]};
    mbar_arrive(bars + S::B_HDR_EMPTY + r);
    if (cur[0] < 0) {   // no more steps: the storer stops after step u - 1
      *total = u;
      return;
    }
    const int slot = u % S::SLOTS;
    if (u >= S::SLOTS) mbar_wait(bars + S::B_FREE + slot, ((u / S::SLOTS) - 1) & 1);
#pragma unroll
    for (int i = 0; i < 5; ++i) tiles[slot * S::HDR + i] = cur[i];
    while (ld_acquire(a.counters + cur[0]) != cur[1]) {
    }
    fence_proxy_async_global();
    unsigned char* buf = sm + S::OFF_DQ + slot * S::DQ_BYTES;
    mbar_arrive_tx(bars + S::B_READY + slot, S::DQ_BYTES);
#pragma unroll
    for (int p = 0; p < HD / 32; ++p)
      tma_load_4d(buf + p * BM * ROW, &a.tdq, bars + S::B_READY + slot, 32 * p, cur[2], cur[3],
                  cur[4]);
  }
}

template <int HD, int HDV>
__device__ __forceinline__ void store_dq(const Args& a, unsigned char* sm) {
  using S = Shape<HD, HDV>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
  const volatile int* tiles = reinterpret_cast<const volatile int*>(sm + S::OFF_TILES);
  const volatile int* total = reinterpret_cast<const volatile int*>(sm + S::OFF_ITEM) + 1;
  for (int v = 0;; ++v) {
    const int slot = v % S::SLOTS;
    const uint32_t full = smem_u32(bars + S::B_DQ_FULL + slot);
    while (!mbar_try_wait(full, (v / S::SLOTS) & 1)) {
      if (v >= *total) {
        return;
      }
    }
    const volatile int* t_ = tiles + slot * S::HDR;
    const int counter = t_[0], expected = t_[1], head = t_[2], q_lo = t_[3], bi = t_[4];
    const unsigned char* buf = sm + S::OFF_DQ + slot * S::DQ_BYTES;
#pragma unroll
    for (int p = 0; p < HD / 32; ++p) tma_store_4d(&a.tdq, buf + p * BM * ROW, 32 * p, head, q_lo, bi);
    tma_store_commit_read();
    mbar_arrive(bars + S::B_FREE + slot);
    tma_store_wait();
    fence_proxy_async_global();
    st_release(a.counters + counter, expected + 1);
  }
}

template <int HD, int HDV, int CW>
__device__ __forceinline__ void consume(const Args& a, unsigned char* sm) {
  using S = Shape<HD, HDV>;
  using P = Panels<HD, HDV, CW>;
  constexpr bool KS = S::KEYSPLIT;
  const int tid = threadIdx.x - 128 * (1 + CW), w = tid >> 5, l = tid & 31;
  const int bar_wg = CW ? BAR_WG2 : BAR_WG1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
  const volatile int* item_slot = reinterpret_cast<const volatile int*>(sm + S::OFF_ITEM);
  const float* rows = reinterpret_cast<const float*>(sm + S::OFF_ROWS);
  const uint32_t a_k = smem_u32(sm + S::OFF_K), a_v = smem_u32(sm + S::OFF_V);
  const int key_row = KS ? CW * KW : 0;   // this consumer's first row of the K and V tiles
  const int groups = a.h / a.kvh;
  int stage = 0, phase = 0, u = 0;

  for (int it = 0;; ++it) {
    mbar_wait(bars + S::B_KV_FULL, it & 1);
    const int item = *item_slot;
    if (item < 0) break;
    const Item m = decode(item, a);
    const int k_lo = m.n * S::BN, kb = k_lo + key_row;
    int t_lo, t_hi;
    span(a, k_lo, S::BN, t_lo, t_hi);
    const int steps = (t_hi - t_lo) * groups;
    float dk[P::NK][32], dv[P::NV][32];
    zero(dk);
    zero(dv);

    for (int j = 0; j < steps; ++j, ++u) {
      const int q_lo = (t_hi - 1 - j / groups) * BM;
      const bool edge = !(q_lo + BM <= a.sq && kb + KW <= a.sk &&
                          (!a.causal || q_lo >= kb + KW - 1) &&
                          (!a.window || q_lo + BM - 1 - kb < a.window));
      mbar_wait(bars + S::B_FULL + stage, phase);
      const uint32_t a_q = smem_u32(sm + S::OFF_STAGE + stage * S::STAGE_BYTES);
      const uint32_t a_do = a_q + S::Q_BYTES;
      const float* lse2 = rows + stage * 2 * BM;
      const float* del = lse2 + BM;
      const int key0 = kb + 16 * w + (l >> 2);
      // this consumer's dSᵀ panel (the key split: one each)
      unsigned char* ds_panel = sm + S::OFF_DS + (KS ? CW * KW * ROW : 0);
      const uint32_t a_ds = smem_u32(ds_panel);
      uint32_t pp[16], ps[16];

      if constexpr (KS) {
        float s[32], dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma_ss<0, 0>(s, desc(a_k + (kk >> 2) * S::BN * ROW + key_row * ROW + (kk & 3) * 32, 16, 1024),
                       desc(a_q + (kk >> 2) * BM * ROW + (kk & 3) * 32, 16, 1024), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HDV / 16; ++kk)
          mma_ss<0, 0>(dp, desc(a_v + (kk >> 2) * S::BN * ROW + key_row * ROW + (kk & 3) * 32, 16, 1024),
                       desc(a_do + (kk >> 2) * BM * ROW + (kk & 3) * 32, 16, 1024), kk > 0);
        wg_commit();
        wg_wait<0>();
        pin(s);
        pin(dp);
        softmax_grad<0, 8>(a, edge, s, dp, pp, ps, lse2, del, q_lo, key0, l);
        stage_ds<0, 16>(ds_panel, ps, w, l);
        fence_proxy_async();
      } else {
        // consumer 0 computes Sᵀ, consumer 1 dPᵀ; each forms P and dS for its half
        // of the query columns (consumer 0: 0-31, registers 0-15) and trades
        float x[32];
        wg_fence();
        if constexpr (CW == 0) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            mma_ss<0, 0>(x, desc(a_k + (kk >> 2) * S::BN * ROW + (kk & 3) * 32, 16, 1024),
                         desc(a_q + (kk >> 2) * BM * ROW + (kk & 3) * 32, 16, 1024), kk > 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < HDV / 16; ++kk)
            mma_ss<0, 0>(x, desc(a_v + (kk >> 2) * S::BN * ROW + (kk & 3) * 32, 16, 1024),
                         desc(a_do + (kk >> 2) * BM * ROW + (kk & 3) * 32, 16, 1024), kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        pin(x);
        constexpr int KEEP = CW ? 16 : 0, GIVE = 16 - KEEP;
        float4* mine = reinterpret_cast<float4*>(sm + S::OFF_XCH + CW * 128 * 64);
        float4* theirs = reinterpret_cast<float4*>(sm + S::OFF_XCH + (1 - CW) * 128 * 64);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mine[i * 128 + tid] =
              make_float4(x[GIVE + 4 * i], x[GIVE + 4 * i + 1], x[GIVE + 4 * i + 2], x[GIVE + 4 * i + 3]);
        bar_sync(BAR_CONSUMERS, 256);
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 y = theirs[i * 128 + tid];
          const float other[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = KEEP + 4 * i + c;
            s[r] = CW ? other[c] : x[r];
            dp[r] = CW ? x[r] : other[c];
          }
        }
        softmax_grad<KEEP / 4, 4>(a, edge, s, dp, pp, ps, lse2, del, q_lo, key0, l);
        // the packed half to the other consumer, through the buffer it filled
        uint4* out4 = reinterpret_cast<uint4*>(theirs);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          out4[i * 128 + tid] = make_uint4(pp[KEEP / 2 + 4 * i], pp[KEEP / 2 + 4 * i + 1],
                                           pp[KEEP / 2 + 4 * i + 2], pp[KEEP / 2 + 4 * i + 3]);
          out4[(2 + i) * 128 + tid] = make_uint4(ps[KEEP / 2 + 4 * i], ps[KEEP / 2 + 4 * i + 1],
                                                 ps[KEEP / 2 + 4 * i + 2], ps[KEEP / 2 + 4 * i + 3]);
        }
        stage_ds<KEEP / 2, 8>(ds_panel, ps, w, l);
        fence_proxy_async();
        bar_sync(BAR_CONSUMERS, 256);
        const uint4* in4 = reinterpret_cast<const uint4*>(mine);
        constexpr int OTHER = 8 - KEEP / 2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 y = in4[i * 128 + tid], z = in4[(2 + i) * 128 + tid];
          pp[OTHER + 4 * i] = y.x;
          pp[OTHER + 4 * i + 1] = y.y;
          pp[OTHER + 4 * i + 2] = y.z;
          pp[OTHER + 4 * i + 3] = y.w;
          ps[OTHER + 4 * i] = z.x;
          ps[OTHER + 4 * i + 1] = z.y;
          ps[OTHER + 4 * i + 2] = z.z;
          ps[OTHER + 4 * i + 3] = z.w;
        }
      }
      if constexpr (KS) bar_sync(bar_wg, 128);   // this consumer's dSᵀ panel is written

      // dV += Pᵀ·dout, dK += dSᵀ·q over this consumer's panels
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int p = 0; p < P::NV; ++p)
          mma_rs<1>(dv[p], pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2], pp[4 * kk + 3],
                    desc(a_do + (P::V_LO + p) * BM * ROW + kk * 16 * ROW, BM * ROW, 1024), 1);
#pragma unroll
        for (int p = 0; p < P::NK; ++p)
          mma_rs<1>(dk[p], ps[4 * kk], ps[4 * kk + 1], ps[4 * kk + 2], ps[4 * kk + 3],
                    desc(a_q + (P::K_LO + p) * BM * ROW + kk * 16 * ROW, BM * ROW, 1024), 1);
      }
      wg_commit();
      // dQ-partial = dS·K over this consumer's dQ panels, added into the step's
      // dq tile
      const int slot = u % S::SLOTS;
      unsigned char* buf = sm + S::OFF_DQ + slot * S::DQ_BYTES;
      auto dq_product = [&](float (&d)[32], int p) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<1, 1>(d, desc(a_ds + kk * 16 * ROW, KW * ROW, 1024),
                       desc(a_k + (P::Q_LO + p) * S::BN * ROW + (key_row + 16 * kk) * ROW,
                            S::BN * ROW, 1024),
                       kk > 0);
      };
      auto add = [&](const float (&d)[32], int p) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jb = 0; jb < 8; ++jb)
            add_dq(buf, 16 * w + (l >> 2) + 8 * i, 64 * (P::Q_LO + p) + 8 * jb + 2 * (l & 3),
                   d[4 * jb + 2 * i], d[4 * jb + 2 * i + 1]);
      };
      auto release_stage = [&]() {   // dV and dK are done: the stage is read out
#pragma unroll
        for (int p = 0; p < P::NV; ++p) pin(dv[p]);
#pragma unroll
        for (int p = 0; p < P::NK; ++p) pin(dk[p]);
        bar_sync(bar_wg, 128);
        if (tid == 0) mbar_arrive(bars + S::B_EMPTY + stage);
        if (++stage == S::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      };
      auto ready = [&]() {   // the tile is loaded (and, key split, consumer 0 has added)
        mbar_wait(bars + S::B_READY + slot, (u / S::SLOTS) & 1);
        if (KS && CW == 1) mbar_wait(bars + S::B_HALF + slot, (u / S::SLOTS) & 1);
      };
      if constexpr (P::ONE_GROUP) {
        float dq[P::NQ][32];
#pragma unroll
        for (int p = 0; p < P::NQ; ++p) dq_product(dq[p], p);
        wg_commit();
        wg_wait<1>();
        release_stage();
        wg_wait<0>();
        ready();
#pragma unroll
        for (int p = 0; p < P::NQ; ++p) {
          pin(dq[p]);
          add(dq[p], p);
        }
      } else {   // a panel at a time, for the registers
        wg_wait<0>();
        release_stage();
        ready();
#pragma unroll
        for (int p = 0; p < P::NQ; ++p) {
          float dq[32];
          wg_fence();
          dq_product(dq, p);
          wg_commit();
          wg_wait<0>();
          pin(dq);
          add(dq, p);
        }
      }
      fence_proxy_async();
      bar_sync(bar_wg, 128);
      if (tid == 0) mbar_arrive(bars + ((KS && CW == 0) ? S::B_HALF : S::B_DQ_FULL) + slot);
    }
    if (tid == 0) mbar_arrive(bars + S::B_KV_EMPTY);

    // dK = scale·Σ dSᵀ·q, dV = Σ Pᵀ·dout, this consumer's keys and columns
    const long long k_off = (static_cast<long long>(m.bi) * a.sk + kb) * a.kvh + m.kvh;
    store_rows(a.dk + k_off * HD, static_cast<long long>(a.kvh) * HD, P::K_LO, dk, a.scale,
               a.sk - kb, w, l);
    store_rows(a.dv + k_off * HDV, static_cast<long long>(a.kvh) * HDV, P::V_LO, dv, 1.0f,
               a.sk - kb, w, l);
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS, 1) bwd_kernel(const __grid_constant__ Args a) {
  using S = Shape<HD, HDV>;
  extern __shared__ __align__(1024) unsigned char raw[];
  // the base rounded up to 1,024 bytes (the swizzle's period), as an offset so
  // that the compiler keeps the pointers in the shared window
  unsigned char* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::OFF_BAR);
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(bars + S::B_FULL + i, 1);    // the producer's expect_tx
      mbar_init(bars + S::B_EMPTY + i, 2);   // one arrival a consumer
    }
    mbar_init(bars + S::B_KV_FULL, 1);
    mbar_init(bars + S::B_KV_EMPTY, 2);
    for (int i = 0; i < HEADERS; ++i) {
      mbar_init(bars + S::B_HDR + i, 1);
      mbar_init(bars + S::B_HDR_EMPTY + i, 1);
    }
    for (int i = 0; i < S::SLOTS; ++i) {
      mbar_init(bars + S::B_READY + i, 1);
      mbar_init(bars + S::B_HALF + i, 1);
      mbar_init(bars + S::B_DQ_FULL + i, S::KEYSPLIT ? 1 : 2);
      mbar_init(bars + S::B_FREE + i, 1);
    }
    reinterpret_cast<volatile int*>(sm + S::OFF_ITEM)[1] = 0x7fffffff;   // the step count
    fence_barrier_init();
  }
  __syncthreads();
  // the warpgroup, uniform across the warp as the compiler can see (so that each
  // branch is compiled to its own register count)
  const int group = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (group == 0) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32)
      produce<HD, HDV>(a, sm);
    else if (threadIdx.x == 32)
      load_dq<HD, HDV>(a, sm);
    else if (threadIdx.x == 64)
      store_dq<HD, HDV>(a, sm);
  } else {
    regs_inc<CONSUMER_REGS>();
    if (group == 1)
      consume<HD, HDV, 0>(a, sm);
    else
      consume<HD, HDV, 1>(a, sm);
  }
}

// dq (B, Sq, H, hd_out) = bf16(dq_acc · scale), the padded lanes sliced off;
// four elements a thread where no lane is sliced off
__global__ void dq_finish_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                                 long long rows, int hd_acc, int hd_out, float scale) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (hd_acc == hd_out) {
    const long long n4 = rows * hd_out / 4;
    for (long long i = first; i < n4; i += step) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(acc) + i);
      const uint2 o = make_uint2(bf16x2(v.x * scale, v.y * scale), bf16x2(v.z * scale, v.w * scale));
      *reinterpret_cast<uint2*>(dq + 4 * i) = o;
    }
    return;
  }
  const long long n = rows * hd_out;
  for (long long i = first; i < n; i += step) {
    const long long r = i / hd_out;
    dq[i] = __float2bfloat16_rn(acc[r * hd_acc + i % hd_out] * scale);
  }
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq_acc, int* counters, void* dq, void* dk, void* dv, int b,
           int sq, int sk, int h, int kvh, int hd_out, int causal, int window, float scale,
           cudaStream_t stream) {
  using S = Shape<HD, HDV>;
  Args a;
  cudaError_t err = map4(&a.tq, q, b, sq, h, HD, BM);
  if (err == cudaSuccess) err = map4(&a.tk, k, b, sk, kvh, HD, S::BN);
  if (err == cudaSuccess) err = map4(&a.tv, v, b, sk, kvh, HDV, S::BN);
  if (err == cudaSuccess) err = map4(&a.tdo, dout, b, sq, h, HDV, BM);
  if (err == cudaSuccess) err = map4(&a.tdq, dq_acc, b, sq, h, HD, BM, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.lse = lse;
  a.delta = delta;
  a.counters = counters;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.kvh = kvh;
  a.causal = causal;
  a.window = window;
  a.nq = (sq + BM - 1) / BM;
  a.nk = (sk + S::BN - 1) / S::BN;
  // a wave of items (one an SM) holds about four key tiles of each group
  const int groups = b * kvh, wave = sm_count() / 4;
  a.chunk = groups <= wave ? 1 : (groups + wave - 1) / wave < 4 ? (groups + wave - 1) / wave : 4;
  a.n_items = (a.nk + a.chunk - 1) / a.chunk * a.chunk * groups;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  auto kern = bwd_kernel<HD, HDV>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.n_items < sm_count() ? a.n_items : sm_count();
  kern<<<grid, THREADS, S::BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * sq * h;
  const long long n = rows * hd_out;
  const long long want = (n + 255) / 256, cap = 8LL * sm_count();
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  dq_finish_kernel<<<blocks, 256, 0, stream>>>(dq_acc, static_cast<__nv_bfloat16*>(dq), rows, HD,
                                               hd_out, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---- float32: one key-major pass on the CUDA cores ------------------------------------
//
// The bf16 route's order (namespace wg, above) on register-blocked float32
// tiles fed by cp.async (f32_tiles.cuh, the forward's).  A work item is (key
// tile of BN keys, kv head, batch row); persistent blocks (as many as fit on
// the card) take items in order from an atomic counter, in wg's order (chunks
// of up to four key tiles of each group), so an item only ever waits on an
// item already taken.  An item copies its K and V tiles once, then walks its
// steps: the query tiles of BM = 64 rows that see its keys (f32_tiles.cuh
// query_span), from the last down, and the G query heads inside each.  A
// step's q, dout, lse and delta are copied into the one stage under the step
// before's dQ product (the only product that does not read them).  A step is
// five products, all exact float32 FMAs:
//   Sᵀ = K·qᵀ and dPᵀ = V·doutᵀ: a thread holds RK consecutive keys × BM/LC
//     queries; P = exp2(Sᵀ·scale·log2e − lse·log2e), 0 where the mask hides
//     the pair (tested only on tiles a causal or window edge, or a ragged end,
//     cuts), dSᵀ = P ⊙ (dPᵀ − delta);
//   dV += Pᵀ·dout and dK += dSᵀ·q: Pᵀ, then dSᵀ, go to the warp's rows of a
//     shared tile behind __syncwarp, and a thread adds RK keys × hd/LC columns,
//     which stay in registers for the whole item;
//   dQ-partial = dS·K over the item's keys: after one block barrier (every
//     dSᵀ row written), a thread holds BM/(LK·WARPS) consecutive queries × a
//     64-column panel's 64/LC columns, and adds the partial · scale into dq in
//     device memory.
// The lanes of a warp are LK row groups × LC = 32/LK column groups.  With
// LK = 2 every product reads one operand as one 16-byte chunk a quarter-warp
// (an LDS.128 the H100 serves in ~2.5 SM cycles, against ~4.1 for 8 chunks:
// tools/time_flash_bwd.py --smem) and holds 8 × 4 tiles, so shared memory
// keeps up with the FMA pipes.  At hd 128 and 256 the warps pair up (SPLIT =
// 2): both warps of a pair hold the same keys, one computes Sᵀ and P, the
// other dPᵀ and dS, and each adds dK and dV for half of the columns, so the
// accumulators fit in registers.
// S and dP are computed once a step (the two-pass route this replaced
// computed them in both passes: 7 products, not 5).  dq without atomics on
// any value: one thread waits (acquire) until the tile's counter equals the
// number of key tiles before this one that see the tile, a block barrier
// passes that on, the threads read, add and write their dq elements (past L1),
// and after the next barrier one thread bumps the counter (release); so each
// dq element sums its key tiles in ascending order, and every launch gives
// the same bits.  dq (B, Sq, H, hd) is the zeroed workspace itself: no finish
// kernel.  A key group that the step's queries cannot see skips its products
// and writes zeros to its dSᵀ rows.
// Shapes (by_head_dim): hd <= 64: 4 warps, RK = 8, BN = 64, two blocks an SM
// (80 KB of shared memory each at hd 64); hd 128: 8 warps in pairs, RK = 8,
// BN = 64; hd 256: 8 warps in pairs, RK = 4, BN = 32.
namespace cc {

using namespace port::f32;
using port::sm90::ld_acquire;
using port::sm90::st_release;

template <int HD, int LK, int RK, int WARPS, int BM, int SPLIT>
struct Shape {
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LC = 32 / LK;                 // lanes: LK row groups × LC column groups
  static constexpr int KG = WARPS / SPLIT;           // key groups: SPLIT warps share one
  static constexpr int BN = KG * LK * RK;            // keys an item
  static constexpr int C = HD / 4;                   // 16-byte chunks of a row of q, k, v, dout
  static constexpr int QJ = BM / LC;                 // Sᵀ queries of a thread: 4·LC·u + 4tc + j
  static constexpr int CB = BM / 4;                  // chunks of a dSᵀ row
  static constexpr int DM = HD / (SPLIT * LC);       // dK, dV columns of a thread
  static constexpr int VW = DM < 4 ? DM : 4;         // columns of a load: LC·VW·n + VW·tc
  static constexpr int NV = DM / VW;
  static constexpr int QR = BM / (WARPS * LK);       // dQ rows of a thread, consecutive
  static constexpr int RV = QR < 4 ? QR : 4;         // their dSᵀ loads
  static constexpr int PW = HD < 64 ? HD : 64;       // dQ columns a panel
  static constexpr int PD = PW / LC;                 // of a thread
  static constexpr int PV = PD < 4 ? PD : 4;         // their loads: LC·PV·n + PV·tc
  static constexpr int NPV = PD / PV;
  static constexpr int NP = HD / PW;                 // dQ panels
  static constexpr int KV_FLOATS = BN * HD;
  static constexpr int STAGE_FLOATS = 2 * BM * HD + 2 * BM;   // q, dout, lse, delta
  static constexpr int DS_FLOATS = BN * BM;
  static constexpr int FLOATS = 2 * KV_FLOATS + STAGE_FLOATS + SPLIT * DS_FLOATS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static constexpr int MIN_BLOCKS = 233472 / (static_cast<int>(BYTES) + 1024) >= 2 ? 2 : 1;
  static_assert(BYTES <= 232448, "shared memory");
  static_assert(QJ % 4 == 0 && QR % RV == 0 && DM >= 1 && PD >= 1 && (SPLIT == 1 || SPLIT == 2)
                && WARPS % SPLIT == 0, "tile shape");
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;            // (B, Sq, H, HD), zeroed: the workspace of the ordered adds
  float* dk;            // (B, Sk, KV, HD)
  float* dv;
  int* counters;        // [0]: the work counter; then (B, H, query tiles), zeroed
  int b, sq, sk, h, kvh, causal, window, nq, nk, chunk, n_items;
  float scale, scale_log2;
};

struct Item {
  int n, bi, kvh;
};

// wg::decode's order: chunks of `chunk` key tiles, each over every (batch,
// kv head) group, a group's key tiles of a chunk in a row
__device__ __forceinline__ Item decode(int item, const Args& a) {
  const int per_chunk = a.b * a.kvh * a.chunk;
  const int r = item % per_chunk, g = r / a.chunk;
  return Item{item / per_chunk * a.chunk + r % a.chunk, g / a.kvh, g % a.kvh};
}

// VW consecutive floats at `p` into x[0 .. VW)
template <int VW>
__device__ __forceinline__ void ldv(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 y = *reinterpret_cast<const float4*>(p);
    x[0] = y.x;
    x[1] = y.y;
    x[2] = y.z;
    x[3] = y.w;
  } else if constexpr (VW == 2) {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x;
    x[1] = y.y;
  } else {
    x[0] = *p;
  }
}

// the same from device memory, past L1
template <int VW>
__device__ __forceinline__ void ldv_cg(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 y = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = y.x;
    x[1] = y.y;
    x[2] = y.z;
    x[3] = y.w;
  } else if constexpr (VW == 2) {
    const float2 y = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = y.x;
    x[1] = y.y;
  } else {
    x[0] = __ldcg(p);
  }
}

template <int VW>
__device__ __forceinline__ void stv_cg(float* p, const float* x) {
  if constexpr (VW == 4)
    __stcg(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  else if constexpr (VW == 2)
    __stcg(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  else
    __stcg(p, x[0]);
}

// element (r, col) of a swizzled tile of C chunks a row, G rows a swizzle group
template <int C, int G>
__device__ __forceinline__ const float* elem(const float* tile, int r, int col) {
  return tile + 4 * chunk_at<C, G>(r, col >> 2) + (col & 3);
}

template <int HD, int LK, int RK, int WARPS, int BM, int SPLIT>
__global__ void __launch_bounds__(32 * WARPS, (Shape<HD, LK, RK, WARPS, BM, SPLIT>::MIN_BLOCKS))
    bwd_kernel(const __grid_constant__ Args a) {
  using S = Shape<HD, LK, RK, WARPS, BM, SPLIT>;
  constexpr int THREADS = S::THREADS, LC = S::LC, BN = S::BN, C = S::C, QJ = S::QJ,
                CB = S::CB, DM = S::DM, VW = S::VW, NV = S::NV, QR = S::QR, RV = S::RV,
                PW = S::PW, PD = S::PD, PV = S::PV, NPV = S::NPV, WK = LK * RK, KG = S::KG;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BN][HD] K, swizzled by RK rows
  float* vs = ks + S::KV_FLOATS;                 // [BN][HD] V
  float* qs = vs + S::KV_FLOATS;   // the step's q [BM][HD], dout [BM][HD], lse, delta [BM]
  const float* dos = qs + BM * HD;
  const float* lse_s = dos + BM * HD;
  const float* del_s = lse_s + BM;
  float* ds = qs + S::STAGE_FLOATS;              // [BN][BM] Pᵀ, then (SPLIT 1) dSᵀ
  float* ds2 = ds + (SPLIT - 1) * S::DS_FLOATS;  // [BN][BM] dSᵀ (SPLIT 2)
  // the item, between items (the tile is read out then, and written only after
  // the step's first barrier)
  int* item_slot = reinterpret_cast<int*>(ds);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, tk = lane / LC, tc = lane % LC;
  // the warp's key group, and which of its SPLIT column ranges of dK and dV it owns
  const int kg = w % KG, half = w / KG, col0 = half * (HD / SPLIT);
  const int groups = a.h / a.kvh;
  const long long q_stride = static_cast<long long>(a.h) * HD;
  const long long k_stride = static_cast<long long>(a.kvh) * HD;
  // this thread's keys (rows of K, V, dSᵀ) and Sᵀ queries in the tiles: a key
  // group is WK keys, a thread's RK consecutive ones
  auto kr = [&](int i) { return kg * WK + tk * RK + i; };
  auto qc = [&](int j) { return 4 * LC * (j >> 2) + 4 * tc + (j & 3); };

  for (;;) {
    if (tid == 0) {   // past the last key tile in the last chunk: no item
      int item;
      Item m;
      do {
        item = atomicAdd(a.counters, 1);
        if (item >= a.n_items) item = -1;
        if (item >= 0) m = decode(item, a);
      } while (item >= 0 && m.n >= a.nk);
      *item_slot = item;
    }
    __syncthreads();
    const int item = *item_slot;
    if (item < 0) return;
    const Item m = decode(item, a);
    const int k_lo = m.n * BN, kw0 = k_lo + kg * WK;   // the item's, this warp's first key
    int t_lo, t_hi;
    query_span(k_lo, min(k_lo + BN, a.sk), BM, a.sq, a.causal, a.window, t_lo, t_hi);
    const int steps = (t_hi - t_lo) * groups;
    const long long kv_off = static_cast<long long>(m.bi) * a.sk * k_stride + m.kvh * HD;
    load_tile<BN, C, RK, THREADS>(ks, a.k + kv_off, k_stride, k_lo, a.sk);
    load_tile<BN, C, RK, THREADS>(vs, a.v + kv_off, k_stride, k_lo, a.sk);
    // step j: query tile t_hi - 1 - j / G of head kvh·G + j % G
    auto head_of = [&](int j) { return m.kvh * groups + j % groups; };
    auto tile_of = [&](int j) { return t_hi - 1 - j / groups; };
    auto load_step = [&](int j) {
      const int q_lo = tile_of(j) * BM;
      const long long off = static_cast<long long>(m.bi) * a.sq * q_stride + head_of(j) * HD;
      load_tile<BM, C, 4, THREADS>(qs, a.q + off, q_stride, q_lo, a.sq);
      load_tile<BM, C, 4, THREADS>(qs + BM * HD, a.dout + off, q_stride, q_lo, a.sq);
      // the rows' lse and delta, 4 bytes a thread (zeros past Sq)
      const long long row0 = (static_cast<long long>(m.bi) * a.h + head_of(j)) * a.sq;
      for (int e = tid; e < 2 * BM; e += THREADS) {
        const int r = e % BM;
        const bool live = q_lo + r < a.sq;
        cp4(qs + 2 * BM * HD + e, (e < BM ? a.lse : a.delta) + row0 + (live ? q_lo + r : 0), live);
      }
    };
    if (steps > 0) load_step(0);
    cp_commit();

    float dka[RK][DM], dva[RK][DM];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < DM; ++c) dka[i][c] = dva[i][c] = 0.0f;
    int* held = nullptr;   // the counter of the step whose adds are in flight
    int held_to = 0;

    for (int j = 0; j < steps; ++j) {
      const int head = head_of(j), t = tile_of(j), q_lo = t * BM;
      cp_wait_all();
      __syncthreads();   // step j's tiles landed; step j - 1's dq adds done, dSᵀ read out
      if (tid == 0 && held != nullptr) st_release(held, held_to);

      const bool hidden = kw0 >= a.sk || (a.causal && kw0 > q_lo + BM - 1) ||
                          (a.window && q_lo - (kw0 + WK - 1) >= a.window);
      const bool edge = q_lo + BM > a.sq || kw0 + WK > a.sk ||
                        (a.causal && kw0 + WK - 1 > q_lo) ||
                        (a.window && q_lo + BM - 1 - kw0 >= a.window);
      // acc += rows(kr)·cols(qc)ᵀ over the head dim: Sᵀ = K·qᵀ or dPᵀ = V·doutᵀ; the
      // queries' chunks held, the keys' streamed
      auto product = [&](const float* keys, const float* queries, float (&acc)[RK][QJ]) {
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int jq = 0; jq < QJ; ++jq) acc[i][jq] = 0.0f;
#pragma unroll 2
        for (int dc = 0; dc < C; ++dc) {
          float4 qq[QJ];
#pragma unroll
          for (int jq = 0; jq < QJ; ++jq) qq[jq] = ld4<C, 4>(queries, qc(jq), dc);
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            const float4 kk = ld4<C, RK>(keys, kr(i), dc);
#pragma unroll
            for (int jq = 0; jq < QJ; ++jq) acc[i][jq] = dot4(kk, qq[jq], acc[i][jq]);
          }
        }
      };
      // P = exp2(Sᵀ·scale·log2e − lse·log2e), 0 where the mask hides the pair
      // (tested only on a tile an edge cuts); with_ds: dS = P ⊙ (dPᵀ − delta) into dp
      auto probs = [&](auto masked, auto with_ds, float (&x)[RK][QJ], float (&dp)[RK][QJ]) {
#pragma unroll
        for (int u = 0; u < QJ / 4; ++u) {
          const float4 l4 = reinterpret_cast<const float4*>(lse_s)[LC * u + tc];
          const float4 d4 = reinterpret_cast<const float4*>(del_s)[LC * u + tc];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jq = 4 * u + e;
            const float lse2 = at(l4, e) * LOG2E, del = at(d4, e);
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              float p = ex2(x[i][jq] * a.scale_log2 - lse2);
              if constexpr (decltype(masked)::value)
                p = visible(q_lo + qc(jq), k_lo + kr(i), a.sq, a.sk, a.causal, a.window) ? p
                                                                                       : 0.0f;
              x[i][jq] = p;
              if constexpr (decltype(with_ds)::value) dp[i][jq] = p * (dp[i][jq] - del);
            }
          }
        }
      };
      // this thread's rows of a [BN][BM] tile
      auto store_rows = [&](float* buf, const float (&x)[RK][QJ]) {
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int u = 0; u < QJ / 4; ++u)
            st4<CB, RK>(buf, kr(i), LC * u + tc, make_float4(x[i][4 * u], x[i][4 * u + 1],
                                                             x[i][4 * u + 2], x[i][4 * u + 3]));
      };
      // acc += rows(kr) of buf · rhs[:, c0 + the thread's columns], over the step's queries
      auto contract = [&](const float* buf, const float* rhs, int c0, float (&acc)[RK][DM]) {
#pragma unroll 2
        for (int c4 = 0; c4 < CB; ++c4) {
          float4 pa[RK];
#pragma unroll
          for (int i = 0; i < RK; ++i) pa[i] = ld4<CB, RK>(buf, kr(i), c4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float y[DM];
#pragma unroll
            for (int n = 0; n < NV; ++n)
              ldv<VW>(elem<C, 4>(rhs, 4 * c4 + e, c0 + LC * VW * n + VW * tc), y + VW * n);
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              const float pv = at(pa[i], e);
#pragma unroll
              for (int d = 0; d < DM; ++d) acc[i][d] = fmaf(pv, y[d], acc[i][d]);
            }
          }
        }
      };
      const float zero[RK][QJ] = {};
      if constexpr (SPLIT == 1) {   // a warp: Sᵀ, dPᵀ, P, dS, dV, dK for its keys
        if (hidden) {
          store_rows(ds, zero);
        } else {
          float s[RK][QJ], dp[RK][QJ];
          product(ks, qs, s);
          product(vs, dos, dp);
          if (edge)
            probs(std::true_type{}, std::true_type{}, s, dp);
          else
            probs(std::false_type{}, std::true_type{}, s, dp);
          store_rows(ds, s);
          __syncwarp();
          contract(ds, dos, 0, dva);
          __syncwarp();   // Pᵀ is read out
          store_rows(ds, dp);
          __syncwarp();
          contract(ds, qs, 0, dka);
        }
      } else {   // a warp pair: Sᵀ → P and dPᵀ → dS, then dV and dK a column half each
        float x[RK][QJ];
        if (!hidden && half == 0) {
          product(ks, qs, x);
          if (edge)
            probs(std::true_type{}, std::false_type{}, x, x);
          else
            probs(std::false_type{}, std::false_type{}, x, x);
          store_rows(ds, x);
        } else if (!hidden) {
          product(vs, dos, x);
        } else if (half == 1) {
          store_rows(ds2, zero);
        }
        __syncthreads();   // Pᵀ is in ds
        if (!hidden && half == 1) {   // dS = P ⊙ (dPᵀ − delta)
#pragma unroll
          for (int u = 0; u < QJ / 4; ++u) {
            const float4 d4 = reinterpret_cast<const float4*>(del_s)[LC * u + tc];
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              const float4 p4 = ld4<CB, RK>(ds, kr(i), LC * u + tc);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                x[i][4 * u + e] = at(p4, e) * (x[i][4 * u + e] - at(d4, e));
            }
          }
          store_rows(ds2, x);
        } else if (!hidden) {
          contract(ds, dos, col0, dva);
        }
        __syncthreads();   // dSᵀ is in ds2
        if (!hidden) {
          if (half == 1) contract(ds, dos, col0, dva);
          contract(ds2, qs, col0, dka);
        }
      }

      int* counter = a.counters + 1 + (static_cast<long long>(m.bi) * a.h + head) * a.nq + t;
      const int before = m.n - first_key_tile(t, BM, BN, a.window);
      if (tid == 0)   // a wait past ~10^7 reads is a broken order: fail the launch, not hang
        for (int spins = 0; ld_acquire(counter) != before;)
          if (++spins > (1 << 24)) __trap();
      __syncthreads();   // every warp's dSᵀ rows are written; the earlier key tiles have added
      held = counter;
      held_to = before + 1;
      if (j + 1 < steps) {   // q, dout, lse and delta are read out: the next step's, under dQ
        load_step(j + 1);
        cp_commit();
      }

      // dq += scale · dS·K, a panel of PW columns at a time; a thread's QR rows
      // are consecutive
      const int qd0 = w * LK * QR + tk * QR;
      float* dqb = a.dq + (static_cast<long long>(m.bi) * a.sq * a.h + head) * HD;
      // dq's elements of panel p, read past L1 (a panel ahead when there are several)
      auto read_dq = [&](int p, float (&z)[QR][PD]) {
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const int qrow = min(q_lo + qd0 + r, a.sq - 1);
#pragma unroll
          for (int n = 0; n < NPV; ++n)
            ldv_cg<PV>(dqb + qrow * q_stride + p * PW + LC * PV * n + PV * tc, z[r] + PV * n);
        }
      };
      float next[QR][PD];
      if constexpr (S::NP > 1) read_dq(0, next);
#pragma unroll
      for (int p = 0; p < S::NP; ++p) {
        float part[QR][PD];
#pragma unroll
        for (int r = 0; r < QR; ++r)
#pragma unroll
          for (int d = 0; d < PD; ++d) part[r][d] = 0.0f;
#pragma unroll 4
        for (int key = 0; key < BN; ++key) {
          float x[QR], y[PD];
#pragma unroll
          for (int r = 0; r < QR; r += RV) ldv<RV>(elem<CB, RK>(ds2, key, qd0 + r), x + r);
#pragma unroll
          for (int n = 0; n < NPV; ++n)
            ldv<PV>(elem<C, RK>(ks, key, p * PW + LC * PV * n + PV * tc), y + PV * n);
#pragma unroll
          for (int r = 0; r < QR; ++r)
#pragma unroll
            for (int d = 0; d < PD; ++d) part[r][d] = fmaf(x[r], y[d], part[r][d]);
        }
        float old[QR][PD];
        if constexpr (S::NP > 1) {
#pragma unroll
          for (int r = 0; r < QR; ++r)
#pragma unroll
            for (int d = 0; d < PD; ++d) old[r][d] = next[r][d];
          if (p + 1 < S::NP) read_dq(p + 1, next);
        } else {
          read_dq(p, old);
        }
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const int qrow = q_lo + qd0 + r;
          if (qrow >= a.sq) continue;
#pragma unroll
          for (int n = 0; n < NPV; ++n) {
            float z[PV];
#pragma unroll
            for (int e = 0; e < PV; ++e)
              z[e] = __fadd_rn(old[r][PV * n + e], __fmul_rn(part[r][PV * n + e], a.scale));
            stv_cg<PV>(dqb + qrow * q_stride + p * PW + LC * PV * n + PV * tc, z);
          }
        }
      }
    }
    __syncthreads();   // the last step's dq adds are done (and the tiles read out)
    if (tid == 0 && held != nullptr) st_release(held, held_to);

    // dK = scale·Σ dSᵀ·q, dV = Σ Pᵀ·dout, this thread's keys
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int key = k_lo + kr(i);
      if (key >= a.sk) continue;
      const long long off = (static_cast<long long>(m.bi) * a.sk + key) * k_stride + m.kvh * HD;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int col = col0 + LC * VW * n + VW * tc;
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          a.dk[off + col + e] = dka[i][VW * n + e] * a.scale;
          a.dv[off + col + e] = dva[i][VW * n + e];
        }
      }
    }
  }
}

template <int HD, int LK, int RK, int WARPS, int BM, int SPLIT>
int launch(Args a, cudaStream_t stream) {
  using S = Shape<HD, LK, RK, WARPS, BM, SPLIT>;
  auto kern = bwd_kernel<HD, LK, RK, WARPS, BM, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::BYTES));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, S::THREADS, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.nq = (a.sq + BM - 1) / BM;
  a.nk = (a.sk + S::BN - 1) / S::BN;
  // as wg::launch: a wave of items holds about four key tiles of each group
  const int groups = a.b * a.kvh, resident = per_sm * port::sm90::sm_count();
  const int wave = resident / 4 > 0 ? resident / 4 : 1;
  a.chunk = groups <= wave ? 1 : (groups + wave - 1) / wave < 4 ? (groups + wave - 1) / wave : 4;
  a.n_items = (a.nk + a.chunk - 1) / a.chunk * a.chunk * groups;
  const int grid = a.n_items < resident ? a.n_items : resident;
  kern<<<grid, S::THREADS, S::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int by_head_dim(int hd, const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                int* counters, int b, int sq, int sk, int h, int kvh, int causal, int window,
                float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * sq * h;
  delta_kernel<float><<<static_cast<unsigned>((rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32)),
                        BW_THREADS, 0, stream>>>(static_cast<const float*>(out),
                                                 static_cast<const float*>(dout), delta, rows, sq,
                                                 h, hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.counters = counters;
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.kvh = kvh;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  // <HD, LK, RK, WARPS, BM, SPLIT>: keys an item WARPS / SPLIT · LK · RK, query
  // rows a step BM; hd 128 and 256 split dK and dV's columns between the warps
  // of a pair
  switch (hd) {
    case 16: return launch<16, 2, 8, 4, 64, 1>(a, stream);
    case 32: return launch<32, 2, 8, 4, 64, 1>(a, stream);
    case 64: return launch<64, 2, 8, 4, 64, 1>(a, stream);
    case 128: return launch<128, 2, 8, 8, 64, 2>(a, stream);
    case 256: return launch<256, 2, 4, 8, 64, 2>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace cc

}  // namespace

// q, k: (B, S, heads, hd); v, out, dout: (.., hdv); lse: (B, H, Sq) float32 from
// the forward; delta: (B, H, Sq) float32 scratch; scale: 1/sqrt(true head dim)
// rounded to float32.  bf16 = 0: float32 inputs on the CUDA cores, hd == hdv
// one padded width, dq, dk, dv at it; dq zeroed by the caller (the ordered
// adds' workspace), counters (1 + B·H·ceil(Sq/64)) int32 zeroed; dq_acc
// unused.  bf16 = 1: bfloat16 inputs on wgmma,
// (hd, hdv) one of (64, 64), (128, 128), (192, 128), (256, 256); dq_acc
// (B, Sq, H, hd) float32 and counters (1 + B·H·ceil(Sq/64)) int32, zeroed by
// the caller; dq written at hd_out (<= hd), dk and dv at hd and hdv.
extern "C" int port_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk, void* dv,
                                        float* dq_acc, int* counters, int b, int sq, int sk,
                                        int h, int kvh, int hd, int hdv, int hd_out, int causal,
                                        int window, float scale, int bf16,
                                        cudaStream_t stream) {
  if (!bf16) {
    if (hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
    return cc::by_head_dim(hd, q, k, v, out, dout, lse, delta, dq, dk, dv, counters, b, sq, sk,
                           h, kvh, causal, window, scale, stream);
  }
  using B = __nv_bfloat16;
  const long long rows = static_cast<long long>(b) * sq * h;
  delta_kernel<B><<<static_cast<unsigned>((rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32)),
                    BW_THREADS, 0, stream>>>(static_cast<const B*>(out), static_cast<const B*>(dout),
                                             delta, rows, sq, h, hdv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define PORT_FA_BWD_WG(HD, HDV)                                                              \
  return wg::launch<HD, HDV>(q, k, v, dout, lse, delta, dq_acc, counters, dq, dk, dv, b, sq, sk, \
                             h, kvh, hd_out, causal, window, scale, stream)
  if (hd == 64 && hdv == 64) PORT_FA_BWD_WG(64, 64);
  if (hd == 128 && hdv == 128) PORT_FA_BWD_WG(128, 128);
  if (hd == 192 && hdv == 128) PORT_FA_BWD_WG(192, 128);
  if (hd == 256 && hdv == 256) PORT_FA_BWD_WG(256, 256);
#undef PORT_FA_BWD_WG
  return static_cast<int>(cudaErrorInvalidValue);
}
