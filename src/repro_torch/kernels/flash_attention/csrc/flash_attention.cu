// flash_attention, float32 route: the online-softmax attention forward of
// every attention layer of the LM's token-parallel forward (models/common.py
// attn_apply) in float32.  bf16 inputs go to flash_attention_mma.cu (tensor
// cores); float32 stays on the CUDA cores, as the JAX kernel computes in
// float32 and TF32 would break the float32 tolerance.
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
// Design (a first, simple kernel on the CUDA cores):
// * one block of 128 threads per (query tile of BQ rows, query head, batch
//   row); BQ = 64 (32 for hd = 256).  Tiles with the most causal work are
//   scheduled first (blockIdx.x runs from the last tile down).
// * GQA: the kv head is h / G, as the TPU kernel's index map (kernel.py:117);
//   K and V are read in place, by stride, from the model's (B, S, KV, hd)
//   layout, never duplicated, and q/out from (B, S, H, hd) with no transpose.
// * per KV tile of 64 keys: K (d-major) and V (row-major) are staged in
//   shared memory, widened to float32; thread (ty, tx) computes the scores of
//   rows ty + 16i and keys tx + 8j, so the reads of both staged tiles are free
//   of bank conflicts; the eight threads of a row reduce its max and sum with
//   warp shuffles; the probabilities go through shared memory to the P·V
//   product, where the thread owns columns tx + 8d of the same rows.
// * masking as the TPU kernel (kernel.py:62-68): a hidden score is NEG =
//   -1e30, not -inf, so a row whose first visited tile is hidden for it adds
//   exp(NEG - NEG) = 1 per key until its first visible key arrives, and then
//   corr = exp(NEG - m) = 0 wipes it, exactly as in JAX.  Keys past the end
//   of the sequence (the ragged last tile) score -inf and add nothing.
// * tile skipping: the visited tiles are [lo, hi) of models/flash.py's
//   _bounds, which is the TPU kernel's visibility test (kernel.py:47-53).
// * compiled for head dims 16, 32, 64, 128 and 256; the wrapper zero-pads any
//   other head dim, and a v head dim of its own, to the next of them and
//   passes the true softmax scale (padded lanes add exact zeros).
//
// Bound on the H100: operations.  A causal (B, S, H, hd) forward needs
// 4·B·H·hd·S(S+1)/2 flops, which the tensor cores could do at 989 TFLOP/s
// (bf16); this kernel runs them on the CUDA cores in float32 (67 TFLOP/s
// peak), with two shared-memory loads per four to eight fused multiply-adds,
// so it is expected to run one to two orders above the bound.  Tensor cores
// (mma.sync or wgmma) are the lever of a later change.
#include "port_common.cuh"

namespace {

constexpr int FA_THREADS = 128;
constexpr int FA_BK = 64;
constexpr float FA_NEG = -1e30f;

template <int HD, int RM>
struct FaShape {
  static constexpr int BQ = 16 * RM;  // query rows of a block: RM per thread
  static constexpr int QS = BQ + 1;   // padded strides of the d-major tiles
  static constexpr int KS = FA_BK + 1;
  static constexpr int FLOATS = HD * QS + HD * KS + FA_BK * HD + BQ * KS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, int HD, int RM>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int h,
                     int kvh, int causal, int window, float scale) {
  using S = FaShape<HD, RM>;
  constexpr int BQ = S::BQ, QS = S::QS, KS = S::KS, DM = HD / 8;
  extern __shared__ float smem[];
  float* qt = smem;             // [HD][QS] the q tile, d-major
  float* kt = qt + HD * QS;     // [HD][KS] the k tile, d-major
  float* vs = kt + HD * KS;     // [BK][HD] the v tile
  float* ps = vs + FA_BK * HD;  // [BQ][KS] probabilities

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y, bi = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int q_lo = iq * BQ;
  const long long q_stride = static_cast<long long>(h) * HD;
  const long long k_stride = static_cast<long long>(kvh) * HD;
  const T* qb = q + static_cast<long long>(bi) * sq * q_stride + head * HD;
  const T* kb = k + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;
  const T* vb = v + static_cast<long long>(bi) * sk * k_stride + kv_head * HD;

  for (int e = tid; e < BQ * HD; e += FA_THREADS) {
    const int r = e / HD, d = e % HD;
    qt[d * QS + r] = q_lo + r < sq ? qb[(q_lo + r) * q_stride + d] : 0.0f;
  }

  float m[RM], l[RM], acc[RM][DM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DM; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (sk + FA_BK - 1) / FA_BK;
  const int hi = causal ? min((q_lo + BQ + FA_BK - 1) / FA_BK, nk) : nk;
  const int lo = window ? max(q_lo - window + 1, 0) / FA_BK : 0;
  for (int it = lo; it < hi; ++it) {
    const int k_lo = it * FA_BK;
    __syncthreads();  // the previous tile is read out of kt, vs and ps
    for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
      const int r = e / HD, d = e % HD;
      const bool live = k_lo + r < sk;
      const long long off = (k_lo + r) * k_stride + d;
      kt[d * KS + r] = live ? kb[off] : 0.0f;
      vs[r * HD + d] = live ? vb[off] : 0.0f;
    }
    __syncthreads();

    float s[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RM], b[8];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qt[d * QS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = kt[d * KS + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q_lo + ty + 16 * i;
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k_lo + tx + 8 * j;
        float x = s[i][j] * scale;
        if (col >= sk)
          x = -INFINITY;
        else if ((causal && row < col) || (window && row - col >= window))
          x = FA_NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * KS + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DM; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      float p[RM], w[DM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ps[(ty + 16 * i) * KS + c];
#pragma unroll
      for (int d = 0; d < DM; ++d) w[d] = vs[c * HD + tx + 8 * d];
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
    const float den = fmaxf(l[i], 1e-30f);
    // the row's log-sum-exp (models/flash.py's m + log(max(l, 1e-30))) for the
    // backward, (B, H, Sq) = JAX's (B, KV, G, Sq); l is the whole row's sum here
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(bi) * h + head) * sq + row] = m[i] + logf(den);
    T* o = out + (static_cast<long long>(bi) * sq + row) * q_stride + head * HD;
#pragma unroll
    for (int d = 0; d < DM; ++d) o[tx + 8 * d] = acc[i][d] / den;
  }
}

template <typename T, int HD, int RM>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int sk, int h, int kvh, int causal, int window, float scale, cudaStream_t stream) {
  using S = FaShape<HD, RM>;
  auto kernel = flash_fwd_kernel<T, HD, RM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + S::BQ - 1) / S::BQ, h, b);
  kernel<<<grid, FA_THREADS, S::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, h, kvh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* k, const void* v, void* out, float* lse,
                int b, int sq, int sk, int h, int kvh, int causal, int window, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, 4>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 32: return launch<T, 32, 4>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 64: return launch<T, 64, 4>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 128:
      return launch<T, 128, 4>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    case 256:
      return launch<T, 256, 2>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scale: the softmax scale 1/sqrt(true head dim) rounded to float32, as JAX
// rounds it; the wrapper pads a head dim outside the table with zeros, which
// add nothing to q·k, so the scale is the true one, not 1/sqrt(hd).  lse: NULL,
// or (B, H, Sq) float32 that takes each row's log-sum-exp (training's forward).
extern "C" int port_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    float* lse, int b, int sq, int sk, int h, int kvh, int hd,
                                    int causal, int window, float scale, cudaStream_t stream) {
  return by_head_dim<float>(hd, q, k, v, out, lse, b, sq, sk, h, kvh, causal, window, scale,
                            stream);
}
