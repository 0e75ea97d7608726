// flash_attention, bfloat16 route: the online-softmax attention forward of the
// LM's bf16 forward on the tensor cores (mma.sync.m16n8k16, float32 sums).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (kernel.py:88, pl.pallas_call at :106; body _flash_fwd_kernel at :39) for
// bf16 inputs; float32 inputs keep the CUDA-core kernel of flash_attention.cu
// (TF32 would break the float32 tolerance).  The TPU kernel's sequential KV
// grid axis, carrying m, l and the accumulator in VMEM, becomes a loop inside
// one block with the state in registers.
//
// Design:
// * a block of 4 warps owns 64 query rows of one (query head, batch row),
//   16 rows a warp.  Blocks with the most causal work are scheduled first
//   (the query tile is the slowest grid axis, walked from the last tile
//   down).
// * K and V tiles of 64 keys stay bf16 (never widened) in a 2-stage ring of
//   shared memory, the next tile's cp.async in flight while one is computed,
//   with one barrier per tile; rows past the sequence end are zero-filled.
//   At hd <= 64 ptxas is held to 128 registers, so that four blocks share an
//   SM (16 warps to hide the latency of the MMA, softmax and load chains).  Rows are padded by 16 B so
//   that every ldmatrix is free of bank conflicts.  GQA: K/V are read in
//   place at kv head h / G from the model's (B, S, KV, hd) layout, q/out from
//   (B, S, H, hd): no copies, no transposes.
// * S = Q·Kᵀ: Q fragments stay in registers (hd <= 128; loaded per use from
//   shared memory at hd 256), K fragments by ldmatrix; float32 accumulators.
// * masking and the online softmax in registers, in the log2 domain; the
//   four threads of a fragment row reduce its max by shuffles, the row sum is
//   kept per thread and reduced once at the end.  Masking follows the TPU
//   kernel (kernel.py:62-69): a hidden score is NEG = -1e30, not -inf, so a
//   row whose first visited tile is hidden for it adds exp(0) = 1 per key
//   until its first visible key wipes it with corr = 0, as in JAX; keys past
//   a ragged end score -inf.  Tiles are visited over models/flash.py's
//   bounds.
// * P is rounded to bf16 in registers and is the A operand of O += P·V
//   (the S accumulator fragment is the P·V A fragment); V fragments by
//   ldmatrix.trans.  O accumulates in float32, is divided by max(l, 1e-30)
//   and written in bf16.  The JAX kernel keeps P in float32: rounding P to
//   bf16 is this route's one numerical change (its error against the plain
//   version, per case, is in PERF.md, under the bf16 tolerance of 0.06).
// * no atomics: the same inputs give the same bits on every launch.
//
// Bound on the H100: operations.  The causal (B, S, H, hd) forward needs
// 4·B·H·hd·S(S+1)/2 flops: 68.75 GFLOP at B = 4, S = 2,048, H = 32, hd 64,
// 0.0695 ms at 989 TFLOP/s (bf16, dense); its 75.5 MB of q, k, v and out
// take 0.023 ms at 3.35 TB/s.  The design moves the products to the tensor
// cores and keeps K/V tiles in bf16; mma.sync reaches a part of Hopper's
// rate only (wgmma with TMA is the next step, ROADMAP B5).
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "port_common.cuh"

namespace {

using namespace port::tc;

constexpr int TC_THREADS = 128;   // 4 warps of 16 query rows
constexpr int TC_BQ = 64;
constexpr int TC_BK = 64;
constexpr float TC_NEG = -1e30f;
constexpr float TC_LOG2E = 1.4426950408889634f;
constexpr float TC_LN2 = 0.6931471805599453f;

template <int HD>
struct TcShape {
  static constexpr int LD = HD + 8;                   // padded row, in bf16
  static constexpr int CH = HD / 8;                   // 16-byte chunks per row
  static constexpr bool QREG = HD <= 128;             // Q fragments in registers
  static constexpr int TILE = TC_BK * LD;             // one K or V tile
  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : 1; // resident blocks asked of ptxas
  static constexpr size_t BYTES = static_cast<size_t>(TC_BQ * LD + 4 * TILE) * 2;
};

// A (rows, HD) bf16 tile at `src` (row stride
// `stride` elements, rows >= live zero-filled) into shared memory.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int rows, int live) {
  using S = TcShape<HD>;
  for (int e = threadIdx.x; e < rows * S::CH; e += TC_THREADS) {
    const int r = e / S::CH, c = e % S::CH;
    const bool ok = r < live;
    cp_async16(dst + r * S::LD + c * 8, src + (ok ? r * stride + c * 8 : 0), ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, TcShape<HD>::MIN_BLOCKS)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int sq, int sk, int h, int kvh, int causal,
                         int window, float scale_log2) {
  using S = TcShape<HD>;
  constexpr int LD = S::LD;
  constexpr int NS = TC_BK / 8;   // score n-tiles per KV tile
  constexpr int KD = HD / 16;     // k-steps over the head dim
  constexpr int NO = HD / 8;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][LD]
  __nv_bfloat16* kvs = qs + TC_BQ * LD;                              // [stage][K, V][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int head = blockIdx.x, bi = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int q_lo = iq * TC_BQ;
  const int w_lo = q_lo + warp * 16;                  // this warp's first row
  const long long q_stride = static_cast<long long>(h) * HD;
  const long long k_stride = static_cast<long long>(kvh) * HD;
  const __nv_bfloat16* qb = q + (static_cast<long long>(bi) * sq + q_lo) * q_stride + head * HD;
  const __nv_bfloat16* kb = k + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const __nv_bfloat16* vb = v + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;

  const int nk = (sk + TC_BK - 1) / TC_BK;
  const int hi = causal ? min((q_lo + TC_BQ + TC_BK - 1) / TC_BK, nk) : nk;
  const int lo = window ? max(q_lo - window + 1, 0) / TC_BK : 0;

  // Q and the first K/V tile: one cp.async group
  load_tile<HD>(qs, qb, q_stride, TC_BQ, sq - q_lo);
  if (lo < hi) {
    const int at = lo * TC_BK;
    load_tile<HD>(kvs, kb + at * k_stride, k_stride, TC_BK, sk - at);
    load_tile<HD>(kvs + S::TILE, vb + at * k_stride, k_stride, TC_BK, sk - at);
  }
  cp_async_commit();

  float o[NO][4];
  float m[2] = {TC_NEG, TC_NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  uint32_t qf[S::QREG ? KD : 1][4];

  for (int it = lo; it < hi; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed, and every warp is done with tile it - 1
    if (it + 1 < hi) {   // refill the stage that tile it - 1 used
      const int at = (it + 1) * TC_BK;
      __nv_bfloat16* dst = kvs + ((it + 1 - lo) & 1) * 2 * S::TILE;
      load_tile<HD>(dst, kb + at * k_stride, k_stride, TC_BK, sk - at);
      load_tile<HD>(dst + S::TILE, vb + at * k_stride, k_stride, TC_BK, sk - at);
    }
    cp_async_commit();
    const __nv_bfloat16* ks = kvs + ((it - lo) & 1) * 2 * S::TILE;
    const __nv_bfloat16* vs = ks + S::TILE;
    const int k_lo = it * TC_BK;

    if constexpr (S::QREG) {
      if (it == lo) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }

    // ---- S = Q·Kᵀ ------------------------------------------------------------
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[NS / 2][4];
#pragma unroll
      for (int p = 0; p < NS / 2; ++p)
        ldsm_x4(kf[p], ks + (p * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
      uint32_t a[4];
      if constexpr (S::QREG) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = qf[kk][c];
      } else {
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        mma(s[2 * p], a, kf[p][0], kf[p][1]);
        mma(s[2 * p + 1], a, kf[p][2], kf[p][3]);
      }
    }

    // ---- mask, online softmax (log2 domain) ------------------------------------
    const bool edge = (causal && k_lo + TC_BK - 1 > w_lo) ||
                      (window && w_lo + 15 - k_lo >= window) || k_lo + TC_BK > sk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w_lo + g + 8 * r;
      float mx = TC_NEG;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * r + e] * scale_log2;
          if (edge) {
            const int col = k_lo + n * 8 + 2 * t4 + e;
            if (col >= sk)
              x = -INFINITY;
            else if ((causal && row < col) || (window && row - col >= window))
              x = TC_NEG;
          }
          s[n][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2_approx(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx(s[n][2 * r + e] - m_new);
          s[n][2 * r + e] = p;
          sum += p;
        }
      }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // ---- O += P·V (the S accumulator fragment is the P·V A fragment) ----------
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + p * 16 +
                          (lane >> 4) * 8);
        mma(o[2 * p], pa, vf[0], vf[1]);
        mma(o[2 * p + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // ---- O / l, bf16 out --------------------------------------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    const int row = w_lo + g + 8 * r;
    if (row >= sq) continue;
    // the log-sum-exp of the row's scaled scores, natural log (models/flash.py's
    // m + log(max(l, 1e-30))), for the backward; (B, H, Sq) = JAX's (B, KV, G, Sq)
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<long long>(bi) * h + head) * sq + row] =
          m[r] * TC_LN2 + logf(fmaxf(sum, 1e-30f));
    __nv_bfloat16* dst = out + (static_cast<long long>(bi) * sq + row) * q_stride + head * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t4) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int sk, int h, int kvh, int causal, int window, float scale, cudaStream_t stream) {
  using S = TcShape<HD>;
  auto kernel = flash_fwd_mma_kernel<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b, (sq + TC_BQ - 1) / TC_BQ);
  // scale (1/sqrt(hd) rounded to float32 as JAX rounds it) times log2(e)
  kernel<<<grid, TC_THREADS, S::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, sq, sk, h,
      kvh, causal, window, scale * TC_LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse: NULL, or (B, H, Sq) float32 that takes each row's log-sum-exp (training's
// forward); `out` is the same either way.
extern "C" int port_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int b, int sq, int sk, int h, int kvh,
                                         int hd, int causal, int window, float scale,
                                         cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 32: return launch<32>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 64: return launch<64>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 128: return launch<128>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 256: return launch<256>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
