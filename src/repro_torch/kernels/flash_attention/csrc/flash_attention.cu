// flash_attention, float32 route: the online-softmax attention forward of
// every attention layer of the LM's token-parallel forward (models/common.py
// attn_apply) in float32.  bf16 inputs go to flash_attention_wgmma.cu (wgmma
// with TMA); float32 stays on the CUDA cores in exact float32 fused multiply-
// adds, as the JAX kernel computes in float32 (TF32's products round at 2^-11,
// which the float32 bound of 2e-5 does not hold).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (kernel.py:88, pl.pallas_call at :106; body _flash_fwd_kernel at :39).  The
// TPU kernel walks a (B·H, nq, nk) grid in order, carrying the running max m,
// the normaliser l and the float32 accumulator in VMEM scratch across the KV
// axis, skipping tiles that the causal or window mask hides wholly, and
// writes acc / max(l, 1e-30) in q's dtype on the last KV step.  Here the
// sequential KV axis becomes a loop inside one block, and the state lives in
// registers.
//
// Design (register-blocked tiles fed by cp.async; helpers in
// kernels/csrc/f32_tiles.cuh):
// * a block per (query head, batch row, query tile of BQ rows), the tiles with
//   the most causal work first (blockIdx.z runs from the last tile down); a warp
//   owns 4·RM of the rows, its lanes 4 row groups × 8 column groups.  hd <= 64:
//   4 warps, RM = 8, BQ = 128, two blocks an SM; hd 128: 8 warps, RM = 4,
//   BQ = 128; hd 256: 4 warps, RM = 4, BQ = 64, key tiles of 32.
// * GQA: the kv head is h / G, as the TPU kernel's index map (kernel.py:117);
//   q, K and V are read in place, by stride, from the model's (B, S, heads, hd)
//   layouts, never duplicated or transposed.
// * q once, then K and V key tile by key tile, are copied by cp.async into
//   row-major shared tiles (16-byte chunks swizzled, f32_tiles.cuh); the K/V
//   tiles are double-buffered, so the next tile's copy runs under this tile's
//   products, one block barrier a tile.
// * S = q·Kᵀ: a thread holds RM rows × BK/8 keys of scores, and for each
//   chunk of 4 head-dim columns reads its rows' and its keys' float4s: at
//   RM = 8, 16 loads of 16 bytes feed 256 fused multiply-adds (4 a float).
//   The rows' loads are one 16-byte chunk a quarter-warp, which shared memory
//   serves in ~2.5 SM cycles against ~4.1 for the keys' 8 chunks
//   (tools/time_flash_bwd.py --smem), so the 8 × 8 tiles keep that pipe ~80%
//   busy at the full FMA rate (4 × 8 tiles would need 133%).
// * softmax in the log2 domain: x = s·scale·log2(e), p = exp2(x − m); the eight
//   lanes of a row group reduce its max and sum by shuffles.
// * P·V: the warp writes P to its own slice of shared memory, 32 keys at a
//   time, behind __syncwarp only (no block barrier), and each thread adds
//   RM rows × hd/8 columns from float4s of P and of V (4 multiply-adds a float
//   at hd 64).
// * masking as the TPU kernel (kernel.py:62-68): a hidden score is NEG =
//   -1e30, not -inf, so a row whose first visited tile is hidden for it adds
//   exp2(NEG − NEG) = 1 per key until its first visible key arrives, and then
//   exp2(NEG − m) = 0 wipes it, exactly as in JAX.  Keys past the end of the
//   sequence (the ragged last tile) score -inf and add nothing.  Only a warp
//   whose tile a causal or window edge, or the ragged end, cuts tests keys.
// * tile skipping: the block visits key tiles [lo, hi) of its rows
//   (f32_tiles.cuh key_span: models/flash.py's _bounds, the TPU kernel's
//   visibility test, kernel.py:47-53), and a warp computes only the tiles its
//   own rows see (a wholly hidden tile adds exactly nothing to a row that has
//   seen a key, and what it adds before one is wiped).
// * compiled for head dims 16, 32, 64, 128 and 256; the wrapper zero-pads any
//   other head dim, and a v head dim of its own, to the next of them and
//   passes the true softmax scale (padded lanes add exact zeros).
//
// Bound on the H100: operations.  A causal (B, S, H, hd) forward needs
// 4·B·H·hd·S(S+1)/2 flops, which float32 on the CUDA cores does at 67 TFLOP/s:
// 1.026 ms at tinyllama's B = 4, S = 2,048, H = 32, hd 64.  The bytes (q, K,
// V and out once, 0.13 GB at 3.35 TB/s: 0.04 ms) are far below it, so the
// design feeds the FMA pipes: 4 multiply-adds a loaded float, both products
// under the next tile's copy.
#include <type_traits>

#include "f32_tiles.cuh"
#include "port_common.cuh"

namespace {

using namespace port::f32;

template <int HD, int RM, int BK, int WARPS>
struct Fwd {
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WR = 4 * RM;              // rows of a warp: ty·RM + i
  static constexpr int BQ = WARPS * WR;          // rows of a block
  static constexpr int C = HD / 4;               // 16-byte chunks of a row
  static constexpr int KJ = BK / 8;              // keys of a thread: 32u + 4tx + jj
  static constexpr int VW = HD >= 32 ? 4 : HD / 8;   // output columns of a load
  static constexpr int DM = HD / 8;              // output columns of a thread
  static constexpr int NV = DM / VW;             // their loads: 8·VW·n + VW·tx
  static constexpr int Q_FLOATS = BQ * HD;
  static constexpr int KV_FLOATS = BK * HD;      // one of K, V
  static constexpr int P_FLOATS = WR * 32;       // a warp's P: its rows × 32 keys
  static constexpr int FLOATS = Q_FLOATS + 4 * KV_FLOATS + WARPS * P_FLOATS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static constexpr int MIN_BLOCKS = 233472 / (static_cast<int>(BYTES) + 1024) >= 2 ? 2 : 1;
  static_assert(BYTES <= 232448, "shared memory");
  static_assert(BK % 32 == 0 && HD % 16 == 0, "tile shape");
};

template <int HD, int RM, int BK, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, (Fwd<HD, RM, BK, WARPS>::MIN_BLOCKS))
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int h, int kvh, int causal,
                     int window, float scale_log2) {
  using S = Fwd<HD, RM, BK, WARPS>;
  constexpr int THREADS = S::THREADS, WR = S::WR, BQ = S::BQ, C = S::C, KJ = S::KJ,
                VW = S::VW, DM = S::DM, NV = S::NV;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][HD] q, swizzled by RM rows
  float* kvs = qs + S::Q_FLOATS;                 // two stages of K [BK][HD], V [BK][HD]
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, ty = lane >> 3, tx = lane & 7;
  float* ps = kvs + 4 * S::KV_FLOATS + w * S::P_FLOATS;   // this warp's P [WR][32]

  const int iq = gridDim.z - 1 - blockIdx.z;   // the most causal work first
  const int head = blockIdx.x, bi = blockIdx.y;
  const int kv_head = head / (h / kvh);
  const int q_lo = iq * BQ;
  const long long q_stride = static_cast<long long>(h) * HD;
  const long long k_stride = static_cast<long long>(kvh) * HD;
  const float* qb = q + static_cast<long long>(bi) * sq * q_stride + head * HD;
  const float* kb = k + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const float* vb = v + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;

  int lo, hi, w_lo, w_hi;
  key_span(q_lo, min(q_lo + BQ, sq), BK, sk, causal, window, lo, hi);
  const int r0 = q_lo + w * WR, r1 = min(r0 + WR, sq);   // this warp's live rows
  key_span(r0, r1, BK, sk, causal, window, w_lo, w_hi);

  load_tile<BQ, C, RM, THREADS>(qs, qb, q_stride, q_lo, sq);
  if (lo < hi) {
    load_tile<BK, C, 4, THREADS>(kvs, kb, k_stride, lo * BK, sk);
    load_tile<BK, C, 4, THREADS>(kvs + S::KV_FLOATS, vb, k_stride, lo * BK, sk);
  }
  cp_commit();

  float m[RM], l[RM], acc[RM][DM], s[RM][KJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DM; ++c) acc[i][c] = 0.0f;
  }
  const int row0 = w * WR + ty * RM;   // this thread's rows in the tile: row0 + i

  // the online softmax over this tile's scores s (log2 domain), masking each
  // key only when the tile is cut by an edge
  auto softmax = [&](auto masked, int k_lo) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qrow = q_lo + row0 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float x = s[i][j] * scale_log2;
        if constexpr (decltype(masked)::value) {
          const int col = k_lo + 32 * (j >> 2) + 4 * tx + (j & 3);
          if (col >= sk)
            x = -INFINITY;
          else if ((causal && qrow < col) || (window && qrow - col >= window))
            x = NEG;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = ex2(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = ex2(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DM; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
  };

  for (int it = lo; it < hi; ++it) {
    cp_wait_all();
    __syncthreads();   // tile it has landed for every thread; tile it - 1 is read out
    const int stage = (it - lo) & 1;
    if (it + 1 < hi) {
      float* nxt = kvs + 2 * (stage ^ 1) * S::KV_FLOATS;
      load_tile<BK, C, 4, THREADS>(nxt, kb, k_stride, (it + 1) * BK, sk);
      load_tile<BK, C, 4, THREADS>(nxt + S::KV_FLOATS, vb, k_stride, (it + 1) * BK, sk);
    }
    cp_commit();
    if (it < w_lo || it >= w_hi) continue;   // wholly hidden from this warp's rows
    const float* ks = kvs + 2 * stage * S::KV_FLOATS;
    const float* vs = ks + S::KV_FLOATS;
    const int k_lo = it * BK;

    // S = q·Kᵀ: rows row0 + i, keys 32u + 4tx + jj (j = 4u + jj)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int dc = 0; dc < C; ++dc) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ld4<C, RM>(qs, row0 + i, dc);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 b = ld4<C, 4>(ks, 32 * (j >> 2) + 4 * tx + (j & 3), dc);
#pragma unroll
        for (int i = 0; i < RM; ++i) s[i][j] = dot4(a[i], b, s[i][j]);
      }
    }

    if (k_lo + BK > sk || (causal && k_lo + BK - 1 > r0) || (window && r1 - 1 - k_lo >= window))
      softmax(std::true_type{}, k_lo);
    else
      softmax(std::false_type{}, k_lo);

    // acc += P·V, 32 keys at a time through this warp's slice
#pragma unroll
    for (int u = 0; u < BK / 32; ++u) {
      if (u) __syncwarp();   // the slice's last keys are read out
#pragma unroll
      for (int i = 0; i < RM; ++i)
        st4<8, RM>(ps, ty * RM + i, tx,
                   make_float4(s[i][4 * u], s[i][4 * u + 1], s[i][4 * u + 2], s[i][4 * u + 3]));
      __syncwarp();
#pragma unroll 2
      for (int kc = 0; kc < 8; ++kc) {
        float4 pa[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) pa[i] = ld4<8, RM>(ps, ty * RM + i, kc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int key = 32 * u + 4 * kc + kk;
          float vv[DM];
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const int col = 8 * VW * n + VW * tx;
            const float* src = vs + 4 * chunk_at<C, 4>(key, col >> 2) + (col & 3);
            if constexpr (VW == 4) {
              const float4 x = *reinterpret_cast<const float4*>(src);
              vv[4 * n] = x.x;
              vv[4 * n + 1] = x.y;
              vv[4 * n + 2] = x.z;
              vv[4 * n + 3] = x.w;
            } else {
              const float2 x = *reinterpret_cast<const float2*>(src);
              vv[2 * n] = x.x;
              vv[2 * n + 1] = x.y;
            }
          }
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = at(pa[i], kk);
#pragma unroll
            for (int d = 0; d < DM; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qrow = q_lo + row0 + i;
    if (qrow >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp (models/flash.py's m + log(max(l, 1e-30))) for the
    // backward, (B, H, Sq) = JAX's (B, KV, G, Sq); m is in the log2 domain
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(bi) * h + head) * sq + qrow] =
          (m[i] == NEG ? NEG : m[i] * LN2) + logf(den);
    float* o = out + (static_cast<long long>(bi) * sq + qrow) * q_stride + head * HD;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = 8 * VW * n + VW * tx;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(o + col) =
            make_float4(acc[i][4 * n] / den, acc[i][4 * n + 1] / den, acc[i][4 * n + 2] / den,
                        acc[i][4 * n + 3] / den);
      } else {
        *reinterpret_cast<float2*>(o + col) = make_float2(acc[i][2 * n] / den,
                                                          acc[i][2 * n + 1] / den);
      }
    }
  }
}

template <int HD, int RM, int BK, int WARPS>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int sk, int h, int kvh, int causal, int window, float scale, cudaStream_t stream) {
  using S = Fwd<HD, RM, BK, WARPS>;
  auto kernel = flash_fwd_kernel<HD, RM, BK, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the query tile slowest, so that every head's heaviest tiles start first
  const dim3 grid(h, b, (sq + S::BQ - 1) / S::BQ);
  kernel<<<grid, S::THREADS, S::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, sq, sk, h, kvh, causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scale: the softmax scale 1/sqrt(true head dim) rounded to float32, as JAX
// rounds it; the wrapper pads a head dim outside the table with zeros, which
// add nothing to q·k, so the scale is the true one, not 1/sqrt(hd).  lse: NULL,
// or (B, H, Sq) float32 that takes each row's log-sum-exp (training's forward).
extern "C" int port_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    float* lse, int b, int sq, int sk, int h, int kvh, int hd,
                                    int causal, int window, float scale, cudaStream_t stream) {
#define PORT_FA(HD, RM, BK, WARPS)                                                          \
  return launch<HD, RM, BK, WARPS>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, \
                                   stream)
  switch (hd) {
    case 16: PORT_FA(16, 8, 64, 4);
    case 32: PORT_FA(32, 8, 64, 4);
    case 64: PORT_FA(64, 8, 64, 4);
    case 128: PORT_FA(128, 4, 64, 8);
    case 256: PORT_FA(256, 4, 32, 4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PORT_FA
}
