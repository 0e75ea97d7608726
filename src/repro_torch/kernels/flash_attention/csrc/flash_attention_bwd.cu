// flash_attention_bwd: the attention backward of the LM's training step, dq,
// dk and dv from q, k, v, the forward's out, dout and its log-sum-exp, for
// float32 and bfloat16 inputs (float32 sums; gradients in the input dtype).
//
// Replaces no Pallas kernel: the TPU kernel
// (src/repro/kernels/flash_attention/kernel.py:106) is forward-only, and the
// JAX package's training takes the gradient from the custom VJP of
// src/repro/models/flash.py (_flash_bwd, :114-181), which is pure JAX.  Its
// plain version is the port of that VJP, repro_torch/models/flash.py
// _flash_bwd; this kernel follows its two passes and its arithmetic:
//   delta = Σ_d dout·out per query row (float32);
//   P = exp(s·scale − lse), 0 where the causal or window mask hides a key;
//   pass 1, by q tile:  dq = scale · Σ_k P ⊙ (dout·vᵀ − delta) · k;
//   pass 2, by kv tile: dv = Σ_q Pᵀ·dout, dk = scale · Σ_q (P ⊙ (dout·vᵀ − delta))ᵀ·q.
//
// Two routes, one contract:
// * bf16: the tensor cores (mma.sync, float32 sums; P and dS rounded to bf16 as
//   the operands of the products that follow them, as the bf16 forward rounds
//   P), below;
// * float32: the CUDA cores, float32 throughout (TF32 would break the float32
//   tolerance, as in the forward).
// Common design:
// * three launches on the stream, counted as one by the wrapper: delta (a warp
//   a query row), dq (a block per (query tile, head, batch row)) and dk/dv (a
//   block per (key tile, kv head, batch row)).
// * GQA without atomics: the dk/dv block loops over the G query heads of its
//   kv head inside the block, then over the query tiles that can see its keys
//   (causal: from its first key; window: up to its last key + window), so a
//   key's sums are made by one thread in a fixed order and a step gives the
//   same bits every time.
// * tiles are visited over the forward's bounds (flash_attention.cu); keys
//   and queries past a ragged end, and hidden keys, have P = 0, as JAX's
//   exp(NEG − lse) = 0.  Non-causal attention with Sq != Sk (cross-attention)
//   visits every tile.
// * compiled for head dims 16, 32, 64, 128 and 256; the wrapper zero-pads any
//   other head dim (and a v head dim of its own) as the forward does and
//   slices the padded lanes of dq and dk off.
// CUDA-core route (float32 only): tiles are staged in shared memory,
// d-major, with padded strides; thread (ty, tx) of 16 × 8 owns rows ty + 16i
// and columns tx + 8j of each score tile, and rows ty + 16i, columns tx + 8d
// of each accumulator, so every shared-memory read is free of bank conflicts
// or a broadcast.  dS (or Pᵀ, then dSᵀ) goes through shared memory to the
// products that contract over the score tile.
//
// Bound on the H100: operations.  The backward needs about 2.5× the forward's
// 4·B·H·hd·(keys seen) flops (5 products of the forward's 2); this kernel
// does 7 (S and dP are recomputed in both passes; at head dim 256, 10 in the
// dk/dv pass's two column ranges).  The tensor-core route is bounded at 989
// TFLOP/s (bf16) and reaches a part of it with mma.sync (wgmma with TMA is the
// step after); the float32 route runs at 67 TFLOP/s peak.
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "port_common.cuh"

namespace {

using namespace port::tc;

constexpr int BW_THREADS = 128;   // 16 × 8 threads

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

// ---- pass 1: dq, a block per (query tile, head, batch row) -----------------

template <int HD>
struct DqShape {
  static constexpr int RM = HD <= 64 ? 4 : 2;   // query rows per thread
  static constexpr int BQ = 16 * RM;
  static constexpr int BK = 64;
  static constexpr int QS = BQ + 1;
  static constexpr int KS = BK + 1;
  static constexpr int FLOATS = 2 * HD * QS + 2 * HD * KS + BQ * KS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(BW_THREADS)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int sq, int sk, int h, int kvh, int causal, int window,
              float scale) {
  using S = DqShape<HD>;
  constexpr int RM = S::RM, BQ = S::BQ, BK = S::BK, QS = S::QS, KS = S::KS, DM = HD / 8;
  extern __shared__ float smem[];
  float* qt = smem;             // [HD][QS] q, d-major
  float* dot = qt + HD * QS;    // [HD][QS] dout, d-major
  float* kt = dot + HD * QS;    // [HD][KS] k, d-major
  float* vt = kt + HD * KS;     // [HD][KS] v, d-major
  float* dss = vt + HD * KS;    // [BQ][KS] dS

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int iq = gridDim.x - 1 - blockIdx.x;   // the most causal work first
  const int head = blockIdx.y, bi = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int q_lo = iq * BQ;
  const long long q_stride = static_cast<long long>(h) * HD;
  const long long k_stride = static_cast<long long>(kvh) * HD;
  const float* qb = q + static_cast<long long>(bi) * sq * q_stride + head * HD;
  const float* dob = dout + static_cast<long long>(bi) * sq * q_stride + head * HD;
  const float* kb = k + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const float* vb = v + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const long long row0 = (static_cast<long long>(bi) * h + head) * sq;

  for (int e = tid; e < BQ * HD; e += BW_THREADS) {
    const int r = e / HD, d = e % HD;
    const bool live = q_lo + r < sq;
    const long long off = (q_lo + r) * q_stride + d;
    qt[d * QS + r] = live ? ld(qb + off) : 0.0f;
    dot[d * QS + r] = live ? ld(dob + off) : 0.0f;
  }
  float lse_r[RM], del_r[RM], acc[RM][DM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q_lo + ty + 16 * i;
    lse_r[i] = row < sq ? lse[row0 + row] : 0.0f;
    del_r[i] = row < sq ? delta[row0 + row] : 0.0f;
#pragma unroll
    for (int c = 0; c < DM; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (sk + BK - 1) / BK;
  const int hi = causal ? min((q_lo + BQ + BK - 1) / BK, nk) : nk;
  const int lo = window ? max(q_lo - window + 1, 0) / BK : 0;
  for (int it = lo; it < hi; ++it) {
    const int k_lo = it * BK;
    __syncthreads();   // the previous tile is read out of kt, vt and dss
    for (int e = tid; e < BK * HD; e += BW_THREADS) {
      const int r = e / HD, d = e % HD;
      const bool live = k_lo + r < sk;
      const long long off = (k_lo + r) * k_stride + d;
      kt[d * KS + r] = live ? ld(kb + off) : 0.0f;
      vt[d * KS + r] = live ? ld(vb + off) : 0.0f;
    }
    __syncthreads();

    float s[RM][8], dp[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RM], o[RM], b[8], c[8];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = qt[d * QS + ty + 16 * i];
        o[i] = dot[d * QS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = kt[d * KS + tx + 8 * j];
        c[j] = vt[d * KS + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(o[i], c[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q_lo + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k_lo + tx + 8 * j;
        const float p = visible(row, col, sq, sk, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        dss[(ty + 16 * i) * KS + tx + 8 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RM], w[DM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = dss[(ty + 16 * i) * KS + c];
#pragma unroll
      for (int d = 0; d < DM; ++d) w[d] = kt[(tx + 8 * d) * KS + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int d = 0; d < DM; ++d) acc[i][d] = fmaf(p[i], w[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q_lo + ty + 16 * i;
    if (row >= sq) continue;
    float* o = dq + (static_cast<long long>(bi) * sq + row) * q_stride + head * HD;
#pragma unroll
    for (int d = 0; d < DM; ++d) o[tx + 8 * d] = acc[i][d] * scale;
  }
}

// ---- pass 2: dk, dv, a block per (key tile, kv head, batch row) -------------

template <int HD>
struct DkvShape {
  static constexpr int RK = HD <= 64 ? 4 : 2;    // keys per thread
  static constexpr int QJ = HD <= 128 ? 8 : 4;   // queries per thread in a tile
  static constexpr int BK = 16 * RK;
  static constexpr int BQ = 8 * QJ;
  static constexpr int QS = BQ + 1;
  static constexpr int KS = BK + 1;
  static constexpr int FLOATS = 2 * HD * QS + 2 * HD * KS + BK * QS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(BW_THREADS)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int h, int kvh,
               int causal, int window, float scale) {
  using S = DkvShape<HD>;
  constexpr int RK = S::RK, QJ = S::QJ, BK = S::BK, BQ = S::BQ, QS = S::QS, KS = S::KS;
  constexpr int DM = HD / 8;
  extern __shared__ float smem[];
  float* qt = smem;             // [HD][QS] q, d-major
  float* dot = qt + HD * QS;    // [HD][QS] dout, d-major
  float* kt = dot + HD * QS;    // [HD][KS] k, d-major
  float* vt = kt + HD * KS;     // [HD][KS] v, d-major
  float* pt = vt + HD * KS;     // [BK][QS] Pᵀ, then dSᵀ

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int ik = blockIdx.x, kv_head = blockIdx.y, bi = blockIdx.z;
  const int groups = h / kvh;
  const int k_lo = ik * BK;
  const long long q_stride = static_cast<long long>(h) * HD;
  const long long k_stride = static_cast<long long>(kvh) * HD;
  const float* kb = k + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const float* vb = v + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;

  for (int e = tid; e < BK * HD; e += BW_THREADS) {
    const int r = e / HD, d = e % HD;
    const bool live = k_lo + r < sk;
    const long long off = (k_lo + r) * k_stride + d;
    kt[d * KS + r] = live ? ld(kb + off) : 0.0f;
    vt[d * KS + r] = live ? ld(vb + off) : 0.0f;
  }
  float dka[RK][DM], dva[RK][DM];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DM; ++c) dka[i][c] = dva[i][c] = 0.0f;

  // the query tiles that can see keys [k_lo, k_lo + BK)
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window ? min(sq, k_lo + BK - 1 + window) : sq;
  const int t_lo = q_begin / BQ;
  const int t_hi = q_end > q_begin ? (q_end + BQ - 1) / BQ : t_lo;

  for (int g = 0; g < groups; ++g) {
    const int head = kv_head * groups + g;
    const float* qb = q + static_cast<long long>(bi) * sq * q_stride + head * HD;
    const float* dob = dout + static_cast<long long>(bi) * sq * q_stride + head * HD;
    const long long row0 = (static_cast<long long>(bi) * h + head) * sq;
    for (int it = t_lo; it < t_hi; ++it) {
      const int q_lo = it * BQ;
      __syncthreads();   // the previous tile is read out of qt, dot and pt
      for (int e = tid; e < BQ * HD; e += BW_THREADS) {
        const int r = e / HD, d = e % HD;
        const bool live = q_lo + r < sq;
        const long long off = (q_lo + r) * q_stride + d;
        qt[d * QS + r] = live ? ld(qb + off) : 0.0f;
        dot[d * QS + r] = live ? ld(dob + off) : 0.0f;
      }
      float lse_q[QJ], del_q[QJ];
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int row = q_lo + tx + 8 * j;
        lse_q[j] = row < sq ? lse[row0 + row] : 0.0f;
        del_q[j] = row < sq ? delta[row0 + row] : 0.0f;
      }
      __syncthreads();

      // Sᵀ and dPᵀ: keys ty + 16i against queries tx + 8j
      float sp[RK][QJ], dpt[RK][QJ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) sp[i][j] = dpt[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[RK], c[RK], b[QJ], o[QJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          a[i] = kt[d * KS + ty + 16 * i];
          c[i] = vt[d * KS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          b[j] = qt[d * QS + tx + 8 * j];
          o[j] = dot[d * QS + tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < QJ; ++j) {
            sp[i][j] = fmaf(a[i], b[j], sp[i][j]);
            dpt[i][j] = fmaf(c[i], o[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int col = k_lo + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          const int row = q_lo + tx + 8 * j;
          const float p = visible(row, col, sq, sk, causal, window)
                              ? expf(sp[i][j] * scale - lse_q[j]) : 0.0f;
          sp[i][j] = p;
          pt[(ty + 16 * i) * QS + tx + 8 * j] = p;
        }
      }
      __syncthreads();

      // dV += Pᵀ·dout
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float p[RK], w[DM];
#pragma unroll
        for (int i = 0; i < RK; ++i) p[i] = pt[(ty + 16 * i) * QS + c];
#pragma unroll
        for (int d = 0; d < DM; ++d) w[d] = dot[(tx + 8 * d) * QS + c];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int d = 0; d < DM; ++d) dva[i][d] = fmaf(p[i], w[d], dva[i][d]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j)
          pt[(ty + 16 * i) * QS + tx + 8 * j] = sp[i][j] * (dpt[i][j] - del_q[j]);
      __syncthreads();

      // dK += dSᵀ·q
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float p[RK], w[DM];
#pragma unroll
        for (int i = 0; i < RK; ++i) p[i] = pt[(ty + 16 * i) * QS + c];
#pragma unroll
        for (int d = 0; d < DM; ++d) w[d] = qt[(tx + 8 * d) * QS + c];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int d = 0; d < DM; ++d) dka[i][d] = fmaf(p[i], w[d], dka[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k_lo + ty + 16 * i;
    if (key >= sk) continue;
    const long long off = (static_cast<long long>(bi) * sk + key) * k_stride + kv_head * HD;
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      dk[off + tx + 8 * d] = dka[i][d] * scale;
      dv[off + tx + 8 * d] = dva[i][d];
    }
  }
}

// ---- bf16 on the tensor cores --------------------------------------------------
//
// The same two passes with mma.sync.m16n8k16 (bf16 in, float32 sums): a block of
// 4 warps owns 64 query rows (dq) or 64 keys (dk, dv), a warp 16 of them; tiles of
// 64 keys (dq) or 64 queries (dk, dv) stream through a 2-stage cp.async ring in
// bf16.  S and dP come out of the MMAs as C fragments; P and dS are formed there
// in float32 and rounded to bf16 as the A fragments of the next products
// (dq += dS·K; dv += Pᵀ·dout, dk += dSᵀ·q), with K, dout and q read through
// ldmatrix.trans.  The dk/dv pass computes Sᵀ = K·qᵀ and dPᵀ = V·doutᵀ, so its
// rows are keys and no fragment is transposed in registers.

constexpr int TB_THREADS = 128;   // 4 warps of 16 rows
constexpr int TB_ROWS = 64;       // a tile's rows: query rows, keys or queries
constexpr float TB_LOG2E = 1.4426950408889634f;

template <int HD>
struct TbShape {
  static constexpr int LD = HD + 8;   // padded row, in bf16 (conflict-free ldmatrix)
  static constexpr int CH = HD / 8;   // 16-byte chunks per row
  static constexpr int KD = HD / 16;  // k-steps over the head dim
  static constexpr int NO = HD / 8;   // n-tiles over the head dim
  // the dk/dv pass's blocks split the head dim in SPLIT column ranges (each
  // block recomputes Sᵀ and dPᵀ): at 256, dk and dv of 16 keys a warp would
  // hold 256 registers a thread
  static constexpr int SPLIT = HD > 128 ? 2 : 1;
  static constexpr int NACC = NO / SPLIT;
  static constexpr int TILE = TB_ROWS * LD;
  // two tiles of the block's own rows and a 2-stage ring of two streamed tiles
  static constexpr size_t BYTES = static_cast<size_t>(6 * TILE) * 2;
  // the dk/dv pass also stages each query tile's lse and delta
  static constexpr size_t DKV_BYTES = BYTES + 2 * 2 * TB_ROWS * sizeof(float);
};

// A (64, HD) bf16 tile at `src` (row stride `stride`; rows >= live zero-filled).
template <int HD>
__device__ __forceinline__ void tb_load(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        long long stride, int live) {
  using S = TbShape<HD>;
  for (int e = threadIdx.x; e < TB_ROWS * S::CH; e += TB_THREADS) {
    const int r = e / S::CH, c = e % S::CH;
    const bool ok = r < live;
    cp_async16(dst + r * S::LD + c * 8, src + (ok ? r * stride + c * 8 : 0), ok);
  }
}

// s (16 x 64) = rows warp·16.. of tile `a` times tile `b`ᵀ, over the head dim.
template <int HD>
__device__ __forceinline__ void tb_scores(float (&s)[8][4], const __nv_bfloat16* a,
                                          const __nv_bfloat16* b, int warp, int lane) {
  using S = TbShape<HD>;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < S::KD; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (warp * 16 + (lane & 15)) * S::LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (p * 16 + (lane & 7) + (lane >> 4) * 8) * S::LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma(s[2 * p], af, bf[0], bf[1]);
      mma(s[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8·NACC) += p (16 x 64, C fragments rounded to bf16) times columns
// [col0, col0 + 8·NACC) of tile `b` (64 x HD).
template <int HD, int NACC>
__device__ __forceinline__ void tb_accumulate(float (&acc)[NACC][4], const float (&p)[8][4],
                                              const __nv_bfloat16* b, int col0, int lane) {
  using S = TbShape<HD>;
  b += col0;
#pragma unroll
  for (int kk = 0; kk < TB_ROWS / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int q = 0; q < NACC / 2; ++q) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::LD + q * 16 +
                        (lane >> 4) * 8);
      mma(acc[2 * q], pa, bf[0], bf[1]);
      mma(acc[2 * q + 1], pa, bf[2], bf[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(TB_THREADS)
    dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int sq, int sk, int h, int kvh, int causal,
                  int window, float scale, float scale_log2) {
  using S = TbShape<HD>;
  constexpr int NO = S::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][LD]
  __nv_bfloat16* dos = qs + S::TILE;                                 // [64][LD]
  __nv_bfloat16* kvs = dos + S::TILE;                                // [stage][K, V][64][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int head = blockIdx.y, bi = blockIdx.z;
  const int iq = gridDim.x - 1 - blockIdx.x;   // the most causal work first
  const int kv_head = head / (h / kvh);
  const int q_lo = iq * TB_ROWS, w_lo = q_lo + warp * 16;
  const long long q_stride = static_cast<long long>(h) * HD;
  const long long k_stride = static_cast<long long>(kvh) * HD;
  const long long qoff = (static_cast<long long>(bi) * sq + q_lo) * q_stride + head * HD;
  const __nv_bfloat16* kb = k + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const __nv_bfloat16* vb = v + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const long long row0 = (static_cast<long long>(bi) * h + head) * sq;

  const int nk = (sk + TB_ROWS - 1) / TB_ROWS;
  const int hi = causal ? min((q_lo + 2 * TB_ROWS - 1) / TB_ROWS, nk) : nk;
  const int lo = window ? max(q_lo - window + 1, 0) / TB_ROWS : 0;

  tb_load<HD>(qs, q + qoff, q_stride, sq - q_lo);
  tb_load<HD>(dos, dout + qoff, q_stride, sq - q_lo);
  if (lo < hi) {
    const int at = lo * TB_ROWS;
    tb_load<HD>(kvs, kb + at * k_stride, k_stride, sk - at);
    tb_load<HD>(kvs + S::TILE, vb + at * k_stride, k_stride, sk - at);
  }
  cp_async_commit();

  float lse2[2], dl[2], acc[NO][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_lo + g + 8 * r;
    lse2[r] = row < sq ? lse[row0 + row] * TB_LOG2E : 0.0f;
    dl[r] = row < sq ? delta[row0 + row] : 0.0f;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;

  for (int it = lo; it < hi; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed, and every warp is done with tile it - 1
    if (it + 1 < hi) {
      const int at = (it + 1) * TB_ROWS;
      __nv_bfloat16* dst = kvs + ((it + 1 - lo) & 1) * 2 * S::TILE;
      tb_load<HD>(dst, kb + at * k_stride, k_stride, sk - at);
      tb_load<HD>(dst + S::TILE, vb + at * k_stride, k_stride, sk - at);
    }
    cp_async_commit();
    const __nv_bfloat16* ks = kvs + ((it - lo) & 1) * 2 * S::TILE;
    const __nv_bfloat16* vs = ks + S::TILE;
    const int k_lo = it * TB_ROWS;

    float s[8][4], dp[8][4];
    tb_scores<HD>(s, qs, ks, warp, lane);
    tb_scores<HD>(dp, dos, vs, warp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w_lo + g + 8 * r;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k_lo + n * 8 + 2 * t4 + e;
          const float p = visible(row, col, sq, sk, causal, window)
                              ? exp2_approx(s[n][2 * r + e] * scale_log2 - lse2[r]) : 0.0f;
          s[n][2 * r + e] = p * (dp[n][2 * r + e] - dl[r]);   // dS
        }
    }
    tb_accumulate<HD, NO>(acc, s, ks, 0, lane);   // dq += dS·K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_lo + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dst = dq + (static_cast<long long>(bi) * sq + row) * q_stride + head * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t4) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(TB_THREADS)
    dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                   int sk, int h, int kvh, int causal, int window, float scale,
                   float scale_log2) {
  using S = TbShape<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][LD] this block's keys
  __nv_bfloat16* vs = ks + S::TILE;                                  // [64][LD]
  __nv_bfloat16* ring = vs + S::TILE;                                // [stage][q, dout][64][LD]
  float* lse_s = reinterpret_cast<float*>(ring + 4 * S::TILE);       // [stage][64], log2 domain
  float* del_s = lse_s + 2 * TB_ROWS;                                // [stage][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int NACC = S::NACC;
  const int ik = blockIdx.x, kv_head = blockIdx.y / S::SPLIT, bi = blockIdx.z;
  const int col0 = (blockIdx.y % S::SPLIT) * NACC * 8;   // this block's dk/dv columns
  const int groups = h / kvh;
  const int k_lo = ik * TB_ROWS, w_lo = k_lo + warp * 16;
  const long long q_stride = static_cast<long long>(h) * HD;
  const long long k_stride = static_cast<long long>(kvh) * HD;
  const long long koff = (static_cast<long long>(bi) * sk + k_lo) * k_stride + kv_head * HD;

  // the query tiles that can see keys [k_lo, k_lo + 64), for each of the G heads
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window ? min(sq, k_lo + TB_ROWS - 1 + window) : sq;
  const int t_lo = q_begin / TB_ROWS;
  const int nt = q_end > q_begin ? (q_end + TB_ROWS - 1) / TB_ROWS - t_lo : 0;
  const int total = groups * nt;

  // tile j = (head g, query tile t_lo + j % nt) into stage `stage`
  auto issue = [&](int j, int stage) {
    const int head = kv_head * groups + j / nt;
    const int q_lo = (t_lo + j % nt) * TB_ROWS;
    const long long qoff = (static_cast<long long>(bi) * sq + q_lo) * q_stride + head * HD;
    __nv_bfloat16* dst = ring + stage * 2 * S::TILE;
    tb_load<HD>(dst, q + qoff, q_stride, sq - q_lo);
    tb_load<HD>(dst + S::TILE, dout + qoff, q_stride, sq - q_lo);
    const long long row0 = (static_cast<long long>(bi) * h + head) * sq;
    for (int t = threadIdx.x; t < TB_ROWS; t += TB_THREADS) {
      const int row = q_lo + t;
      lse_s[stage * TB_ROWS + t] = row < sq ? lse[row0 + row] * TB_LOG2E : 0.0f;
      del_s[stage * TB_ROWS + t] = row < sq ? delta[row0 + row] : 0.0f;
    }
  };

  tb_load<HD>(ks, k + koff, k_stride, sk - k_lo);
  tb_load<HD>(vs, v + koff, k_stride, sk - k_lo);
  if (total > 0) issue(0, 0);
  cp_async_commit();

  float dka[NACC][4], dva[NACC][4];
#pragma unroll
  for (int n = 0; n < NACC; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.0f;

  for (int j = 0; j < total; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // tile j has landed, and every warp is done with tile j - 1
    if (j + 1 < total) issue(j + 1, (j + 1) & 1);
    cp_async_commit();
    const int stage = j & 1;
    const __nv_bfloat16* qs = ring + stage * 2 * S::TILE;
    const __nv_bfloat16* dos = qs + S::TILE;
    const float* ls = lse_s + stage * TB_ROWS;
    const float* ds = del_s + stage * TB_ROWS;
    const int q_lo = (t_lo + j % nt) * TB_ROWS;

    float st[8][4], dpt[8][4];
    tb_scores<HD>(st, ks, qs, warp, lane);    // Sᵀ: this warp's 16 keys against 64 queries
    tb_scores<HD>(dpt, vs, dos, warp, lane);  // dPᵀ
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = w_lo + g + 8 * r;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t4 + e;
          const float p = visible(q_lo + c, key, sq, sk, causal, window)
                              ? exp2_approx(st[n][2 * r + e] * scale_log2 - ls[c]) : 0.0f;
          st[n][2 * r + e] = p;                                 // Pᵀ
          dpt[n][2 * r + e] = p * (dpt[n][2 * r + e] - ds[c]);  // dSᵀ
        }
    }
    tb_accumulate<HD, NACC>(dva, st, dos, col0, lane);    // dv += Pᵀ·dout
    tb_accumulate<HD, NACC>(dka, dpt, qs, col0, lane);    // dk += dSᵀ·q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = w_lo + g + 8 * r;
    if (key >= sk) continue;
    const long long off =
        (static_cast<long long>(bi) * sk + key) * k_stride + kv_head * HD + col0;
#pragma unroll
    for (int n = 0; n < NACC; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t4) =
          pack_bf16(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t4) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq,
               int sk, int h, int kvh, int causal, int window, float scale,
               cudaStream_t stream) {
  using S = TbShape<HD>;
  using B = __nv_bfloat16;
  const long long rows = static_cast<long long>(b) * sq * h;
  delta_kernel<B><<<static_cast<unsigned>((rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32)),
                    BW_THREADS, 0, stream>>>(static_cast<const B*>(out),
                                             static_cast<const B*>(dout), delta, rows, sq, h,
                                             HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dq_k = dq_mma_kernel<HD>;
  err = cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_k<<<dim3((sq + TB_ROWS - 1) / TB_ROWS, h, b), TB_THREADS, S::BYTES, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(dout), lse, delta, static_cast<B*>(dq), sq, sk, h, kvh, causal,
      window, scale, scale * TB_LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dkv_k = dkv_mma_kernel<HD>;
  err = cudaFuncSetAttribute(dkv_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::DKV_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_k<<<dim3((sk + TB_ROWS - 1) / TB_ROWS, kvh * S::SPLIT, b), TB_THREADS, S::DKV_BYTES,
          stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(dout), lse, delta, static_cast<B*>(dk), static_cast<B*>(dv), sq,
      sk, h, kvh, causal, window, scale, scale * TB_LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q_, const void* k_, const void* v_, const void* out_, const void* dout_,
           const float* lse, float* delta, void* dq_, void* dk_, void* dv_, int b, int sq,
           int sk, int h, int kvh, int causal, int window, float scale, cudaStream_t stream) {
  const float* q = static_cast<const float*>(q_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  const float* dout = static_cast<const float*>(dout_);
  const long long rows = static_cast<long long>(b) * sq * h;
  delta_kernel<float><<<static_cast<unsigned>((rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32)),
                        BW_THREADS, 0, stream>>>(static_cast<const float*>(out_), dout, delta,
                                                 rows, sq, h, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using Q = DqShape<HD>;
  auto dq_k = dq_kernel<HD>;
  err = cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Q::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_k<<<dim3((sq + Q::BQ - 1) / Q::BQ, h, b), BW_THREADS, Q::BYTES, stream>>>(
      q, k, v, dout, lse, delta, static_cast<float*>(dq_), sq, sk, h, kvh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using K = DkvShape<HD>;
  auto dkv_k = dkv_kernel<HD>;
  err = cudaFuncSetAttribute(dkv_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(K::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_k<<<dim3((sk + K::BK - 1) / K::BK, kvh, b), BW_THREADS, K::BYTES, stream>>>(
      q, k, v, dout, lse, delta, static_cast<float*>(dk_), static_cast<float*>(dv_), sq, sk, h,
      kvh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int by_head_dim(int hd, const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                int b, int sq, int sk, int h, int kvh, int causal, int window, float scale,
                cudaStream_t stream) {
#define PORT_FA_BWD(HD)                                                                    \
  return launch<HD>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kvh, causal, \
                       window, scale, stream)
  switch (hd) {
    case 16: PORT_FA_BWD(16);
    case 32: PORT_FA_BWD(32);
    case 64: PORT_FA_BWD(64);
    case 128: PORT_FA_BWD(128);
    case 256: PORT_FA_BWD(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PORT_FA_BWD
}

}  // namespace

// q, out, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Sk, KV, hd), one padded
// head dim for all; lse: (B, H, Sq) float32 from the forward; delta: (B, H,
// Sq) float32 scratch; bf16: 1 for bfloat16 tensors, 0 for float32; scale:
// 1/sqrt(true head dim) rounded to float32.
extern "C" int port_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk, void* dv, int b,
                                        int sq, int sk, int h, int kvh, int hd, int causal,
                                        int window, float scale, int bf16,
                                        cudaStream_t stream) {
#define PORT_FA_BWD_MMA(HD)                                                                 \
  return launch_mma<HD>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kvh, causal, \
                        window, scale, stream)
  if (bf16) {   // the tensor cores
    switch (hd) {
      case 16: PORT_FA_BWD_MMA(16);
      case 32: PORT_FA_BWD_MMA(32);
      case 64: PORT_FA_BWD_MMA(64);
      case 128: PORT_FA_BWD_MMA(128);
      case 256: PORT_FA_BWD_MMA(256);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef PORT_FA_BWD_MMA
  return by_head_dim(hd, q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kvh,
                            causal, window, scale, stream);
}
