// scatter_add_ordered: out = dst with src[i] added at idx[i] for every live
// lane, each target's terms in input order.
//
// No Pallas counterpart: this is the port's repair of the scatter-adds that
// the JAX package writes as `.at[idx].add(src)` (fw_jax's v̄/q̄/α updates,
// the eager oracles' setup Xᵀq, distributed/fw_shard.py's α scatters).  XLA
// on the CPU adds each target's terms one at a time in input order, and so
// does the plain version (scatter/ref.py).  Float atomics, and PyTorch's
// CUDA `index_put_(accumulate=True)` (a sort by target, then its own sums),
// add in another order, so α drifted from the CPU's in the last bits and a
// near-tie of two coordinates went the other way.
//
// Contract: out[t] = ((dst[t] + s_a) + s_b) + ... over the live lanes
// a < b < ... with idx = t, every add __fadd_rn; a target without live
// lanes keeps dst[t] (-0.0 included: no +0 padding is ever added).
//
// Design: every kernel here is hand-written; the wrapper only allocates
// `out` and one scratch buffer, and never reads the device.  A dead lane
// costs its flag's byte; only a live lane's index and term are read.
//  1. `flag_count`: a block a tile of 4,096 lanes (more past 4 M lanes, so
//     that there are at most 1,024 tiles) reads the flags 16 bytes a thread
//     and writes its tile's live count; it also copies dst into out and
//     zeroes the call's counters.
//  2. `compact`: each block sums the tile counts before its own (at most
//     1,024 tiles), reads its flags again, finds each live lane's stable
//     position (a thread's 16 flags, then a block scan) and writes the live
//     lanes' (target, term) pairs to a compact list in input order, reading
//     the index as passed (int32 or int64).  A live index outside [0, n) is
//     keyed n and dropped.
//  3. `small_route`: when the live lanes number at most SMALL_MAX (8,192),
//     one block loads them into shared memory, groups them by target with a
//     stable LSD split on 8-bit digits of the target (eight ballots match a
//     warp's equal digits and rank its lanes, a block scan places the
//     warps), finds the runs and adds each run as one chain, a thread a
//     target.
//  4. Otherwise the same stable 8-bit split runs over the card, a pass a
//     digit of the target (two passes below 65,536 targets): `digit_count`
//     counts each 4,096-pair tile's digits, and the last block to arrive
//     sums them by groups of 16 tiles into each group's first places;
//     `digit_move` adds the tiles before its own in the group, ranks its
//     pairs as in 3, puts them in the tile's digit order in shared memory
//     and writes them out in that order (a digit's pairs contiguous).  Then
//     `chains`: each warp takes 32 sorted positions at a time; a run that
//     starts and ends there is added by its first lane from the others'
//     terms (shuffles, in order), and the run that goes on past them is
//     walked by the warp: 32 pairs, then 1,024 at a time into shared memory
//     while its first lane adds the previous 1,024 in order, 16 terms read
//     ahead of the adds (a long chain costs about one dependent add a term).
// The route is chosen on the card: each kernel of the route that does not
// apply reads the live count and returns at once.  The launches are fixed
// by (k, n): 3, or 4 + 2 · passes when k > SMALL_MAX.  There is no
// comparison sort, no float atomic and no host read; the result does not
// depend on the order in which blocks run (the counts are integers).
//
// Bound on the H100: the larger of (a) bytes, lanes × 1 (the flags) + live ×
// (index bytes + 4) + 8 · n (dst read, out written) at 3.35 TB/s, and (b) the
// longest chain's dependent adds at ~4 cycles each at the SM's clock: the
// head column's 20,242 terms at the rcv1.binary shape, ~0.04 ms.  An empty
// kernel takes 0.0016-0.0019 ms, so a call whose live lanes are few is held
// by its launches.
#include <stdint.h>

#include <algorithm>

#include "port_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int DIGITS = 256;                      // an 8-bit digit of the target
constexpr int FLAG_THREADS = 256;
constexpr int FLAG_LANES = 16;                   // lanes a thread reads at once
constexpr int FLAG_CHUNK = FLAG_THREADS * FLAG_LANES;   // lanes a block reads at once
constexpr int FLAG_TILE = FLAG_CHUNK;            // lanes a block counts, at least
constexpr int MAX_FLAG_TILES = 1024;             // a block sums the tile counts before it
constexpr int ROUNDS = 8;                        // 32-pair rounds a warp ranks in a tile
constexpr int SMALL_THREADS = 1024;
constexpr int SMALL_WARPS = SMALL_THREADS / 32;
constexpr int SMALL_MAX = SMALL_WARPS * 32 * ROUNDS;   // 8,192 live lanes
// two (keys, terms) buffers and a warp's digit counts, in shared memory
constexpr int SMALL_SMEM = (4 * SMALL_MAX + SMALL_WARPS * DIGITS) * 4;
constexpr int SORT_THREADS = 512;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_TILE = SORT_WARPS * 32 * ROUNDS;    // 4,096 pairs
constexpr int GROUP = 16;   // tiles whose digit counts `digit_count` sums together
// a warp's digit counts and a tile's (keys, terms), in shared memory
constexpr int MOVE_SMEM = (SORT_WARPS * DIGITS + 2 * SORT_TILE) * 4;
constexpr int CHAIN_THREADS = 256;   // 8 warps
constexpr int CHAIN_UNROLL = 32;     // 32-term groups a walking warp loads at once
constexpr int CHAIN_SPAN = 32 * CHAIN_UNROLL;

// the call's counters, at the front of the scratch buffer
constexpr int TOTAL = 0;    // live lanes (written by `compact`)
constexpr int ARRIVE = 1;   // blocks of `digit_count` done (0 between launches)
constexpr int MISC_WORDS = 4;

// Exclusive prefix of v over the block's threads in thread order; *total
// (if given) gets the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int ws[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < warps ? ws[lane] : 0;
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    ws[lane] = incl - s;
    if (lane == 31) ws[32] = incl;
  }
  __syncthreads();
  const int r = ws[warp] + x - v;
  if (total != nullptr) *total = ws[32];
  __syncthreads();   // ws is reused by the next call
  return r;
}

// Bit j set where byte j of w is not 0.
__device__ __forceinline__ uint32_t byte_flags(uint32_t w) {
  const uint32_t x = __vcmpne4(w, 0u);
  return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}

// Bit j set where lane p + j (< end) is live; live == nullptr: every lane.
__device__ __forceinline__ uint32_t live_mask(const uint8_t* __restrict__ live, long long p,
                                              long long end, bool aligned) {
  if (p >= end) return 0u;
  const long long left = end - p;
  if (live == nullptr) return left >= 16 ? 0xffffu : (1u << left) - 1u;
  if (aligned && left >= 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(live + p));
    return byte_flags(v.x) | (byte_flags(v.y) << 4) | (byte_flags(v.z) << 8) |
           (byte_flags(v.w) << 12);
  }
  uint32_t m = 0u;
  for (int j = 0; j < 16 && j < left; ++j) m |= live[p + j] != 0 ? 1u << j : 0u;
  return m;
}

__global__ void __launch_bounds__(FLAG_THREADS)
flag_count(const uint8_t* __restrict__ live, bool aligned, long long k, long long tile, int tiles,
           const float* __restrict__ dst, float* __restrict__ out, int n,
           int* __restrict__ tile_live, int* __restrict__ misc) {
  const int b = blockIdx.x;
  for (long long i = static_cast<long long>(b) * FLAG_THREADS + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * FLAG_THREADS)
    out[i] = dst[i];
  if (b == 0 && threadIdx.x < MISC_WORDS) misc[threadIdx.x] = 0;
  if (b >= tiles) return;   // a copying block only
  const long long base = b * tile, end = min(base + tile, k);
  int cnt = 0;
  for (long long p = base + FLAG_LANES * threadIdx.x; p < end; p += FLAG_CHUNK)
    cnt += __popc(live_mask(live, p, end, aligned));
  int total;
  block_exclusive_scan(cnt, &total);
  if (threadIdx.x == 0) tile_live[b] = total;
}

template <typename Index>
__global__ void __launch_bounds__(FLAG_THREADS)
compact(const uint8_t* __restrict__ live, bool aligned, const Index* __restrict__ idx,
        const float* __restrict__ src, long long k, long long tile, int tiles, int n,
        const int* __restrict__ tile_live, int* __restrict__ keys, float* __restrict__ vals,
        int* __restrict__ misc) {
  const int b = blockIdx.x;
  const long long base = b * tile, end = min(base + tile, k);
  // the first chunk's flags are in flight while the tile counts are summed
  uint32_t m = live_mask(live, base + FLAG_LANES * threadIdx.x, end, aligned);
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < tiles; i += FLAG_THREADS) {
    const int c = tile_live[i];
    all += c;
    before += i < b ? c : 0;
  }
  int total;
  block_exclusive_scan(before, &before);
  block_exclusive_scan(all, &total);
  if (b == 0 && threadIdx.x == 0) misc[TOTAL] = total;
  __shared__ int first[FLAG_THREADS];        // a thread's first compact position
  __shared__ uint32_t flags[FLAG_THREADS];   // its 16 lanes' flags
  int run = before;
  for (long long c0 = base; c0 < end; c0 += FLAG_CHUNK) {
    if (c0 != base) m = live_mask(live, c0 + FLAG_LANES * threadIdx.x, end, aligned);
    int chunk;
    first[threadIdx.x] = run + block_exclusive_scan(__popc(m), &chunk);
    flags[threadIdx.x] = m;
    __syncthreads();
    // round j reads lane c0 + 256 j + threadIdx.x: only a live lane's index
    // and term are read, a warp's reads and writes each contiguous; the 16
    // rounds' loads are in flight at once
    int tk[FLAG_LANES], at[FLAG_LANES];
    float tv[FLAG_LANES];
#pragma unroll
    for (int j = 0; j < FLAG_LANES; ++j) {
      const int off = FLAG_THREADS * j + threadIdx.x, owner = off / FLAG_LANES,
                bit = off % FLAG_LANES;
      const uint32_t om = flags[owner];
      at[j] = -1;
      if ((om >> bit) & 1u) {
        const long long t = static_cast<long long>(idx[c0 + off]);
        tk[j] = t >= 0 && t < n ? static_cast<int>(t) : n;
        tv[j] = src[c0 + off];
        at[j] = first[owner] + __popc(om & ((1u << bit) - 1u));
      }
    }
#pragma unroll
    for (int j = 0; j < FLAG_LANES; ++j) {
      if (at[j] >= 0) {
        keys[at[j]] = tk[j];
        vals[at[j]] = tv[j];
      }
    }
    __syncthreads();   // first and flags are reused by the next chunk
    run += chunk;
  }
}

// The lanes of the warp whose 8-bit digit equals this lane's (eight
// ballots; a lane past the end, !valid, matches none of the others).
__device__ __forceinline__ unsigned match_digit(int d, bool valid) {
  unsigned m = __ballot_sync(FULL, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned set = __ballot_sync(FULL, bit);
    m &= bit ? set : ~set;
  }
  return m;
}

// A warp's ranks of its R·32 pairs from keys[wbase:] (those below total) by
// the digit at `shift`: loc[r] counts the warp's earlier pairs of the same
// digit, and wcnt (the warp's 256 counters) ends with each digit's count.
// Rounds past total are skipped.
template <int R>
__device__ __forceinline__ void warp_ranks(const int* keys, long long wbase, long long total,
                                           int shift, int* wcnt, int (&loc)[R]) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < DIGITS; i += 32) wcnt[i] = 0;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  int key[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {   // every round's load in flight at once
    const long long p = wbase + 32 * r + lane;
    key[r] = p < total ? keys[p] : 0;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (wbase + 32 * r >= total) break;   // warp-uniform
    const long long p = wbase + 32 * r + lane;
    const bool valid = p < total;
    const int d = (key[r] >> shift) & (DIGITS - 1);
    const unsigned peers = match_digit(d, valid);
    const int base = valid ? wcnt[d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) wcnt[d] = base + __popc(peers);
    __syncwarp();
    loc[r] = base + __popc(peers & lt);
  }
}

// One stable pass of the small route: (ak, av)[0:total] into (bk, bv) by the
// digit at `shift`; warp w ranks positions [256 w, 256 w + 256).
__device__ __forceinline__ void small_split(const int* ak, const float* av, int* bk, float* bv,
                                            int* cnt, int total, int shift) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wbase = warp * 32 * ROUNDS;
  int* wcnt = cnt + warp * DIGITS;
  int loc[ROUNDS];
  warp_ranks<ROUNDS>(ak, wbase, total, shift, wcnt, loc);
  __syncthreads();
  const int warps = (total + 32 * ROUNDS - 1) / (32 * ROUNDS);   // holding pairs
  int digit_total = 0;
  if (threadIdx.x < DIGITS) {
    for (int w = 0; w < warps; ++w) {
      const int c = cnt[w * DIGITS + threadIdx.x];
      cnt[w * DIGITS + threadIdx.x] = digit_total;
      digit_total += c;
    }
  }
  const int digit_base = block_exclusive_scan(digit_total, nullptr);
  if (threadIdx.x < DIGITS)
    for (int w = 0; w < warps; ++w) cnt[w * DIGITS + threadIdx.x] += digit_base;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int p = wbase + 32 * r + lane;
    if (p < total) {
      const int key = ak[p];
      const int dest = wcnt[(key >> shift) & (DIGITS - 1)] + loc[r];
      bk[dest] = key;
      bv[dest] = av[p];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SMALL_THREADS, 1)
small_route(const int* __restrict__ keys, const float* __restrict__ vals,
            float* __restrict__ out, int n, int passes, const int* __restrict__ misc) {
  const int total = misc[TOTAL];
  if (total == 0 || total > SMALL_MAX) return;
  extern __shared__ __align__(16) int smem[];
  int* ak = smem;
  float* av = reinterpret_cast<float*>(smem + SMALL_MAX);
  int* bk = smem + 2 * SMALL_MAX;
  float* bv = reinterpret_cast<float*>(smem + 3 * SMALL_MAX);
  int* cnt = smem + 4 * SMALL_MAX;
  for (int i = threadIdx.x; i < total; i += SMALL_THREADS) {
    ak[i] = keys[i];
    av[i] = vals[i];
  }
  __syncthreads();
  for (int pass = 0; pass < passes; ++pass) {
    small_split(ak, av, bk, bv, cnt, total, 8 * pass);
    int* tk = ak;
    ak = bk;
    bk = tk;
    float* tv = av;
    av = bv;
    bv = tv;
  }
  // the runs: a thread's 8 positions; a run's first position goes to bk[run]
  constexpr int PER = SMALL_MAX / SMALL_THREADS;
  const int p0 = threadIdx.x * PER;
  int heads = 0, dropped = 0;
  for (int i = 0; i < PER; ++i) {
    const int p = p0 + i;
    if (p >= total) break;
    const int key = ak[p];
    if (key >= n) ++dropped;
    else if (p == 0 || ak[p - 1] != key) ++heads;
  }
  int runs, dropped_all;
  int r = block_exclusive_scan(heads, &runs);
  block_exclusive_scan(dropped, &dropped_all);
  for (int i = 0; i < PER; ++i) {
    const int p = p0 + i;
    if (p >= total) break;
    const int key = ak[p];
    if (key < n && (p == 0 || ak[p - 1] != key)) bk[r++] = p;
  }
  __syncthreads();
  const int end = total - dropped_all;   // the dropped lanes (key n) sort last
  // a thread's runs q = threadIdx.x + SMALL_THREADS · i: every dst read is
  // in flight before the first add
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int q = threadIdx.x + SMALL_THREADS * i;
    if (q < runs) acc[i] = out[ak[bk[q]]];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int q = threadIdx.x + SMALL_THREADS * i;
    if (q < runs) {
      const int h = bk[q], e = q + 1 < runs ? bk[q + 1] : end;
      float a = acc[i];
      for (int j = h; j < e; ++j) a = __fadd_rn(a, av[j]);
      out[ak[h]] = a;
    }
  }
}

__device__ __forceinline__ int sort_tiles(int total) {
  return (total + SORT_TILE - 1) / SORT_TILE;
}

// hist[tile · 256 + d] = the count of digit d in the tile.  The last block
// to arrive turns the counts into each group of GROUP tiles' first places:
// group[g · 256 + d] = the pairs of digits below d, plus those of digit d in
// the tiles before group g (`digit_move` adds the tiles before its own in
// the group).
__global__ void __launch_bounds__(SORT_THREADS)
digit_count(const int* __restrict__ keys, int shift, int* __restrict__ hist,
            int* __restrict__ group, int* __restrict__ misc) {
  const int total = misc[TOTAL];
  if (total <= SMALL_MAX) return;   // the small route's call
  const int tiles = sort_tiles(total);
  __shared__ int cnt[SORT_WARPS * DIGITS];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) >= tiles) return;   // a block past the tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int loc[ROUNDS];
    warp_ranks<ROUNDS>(keys, static_cast<long long>(tile) * SORT_TILE + warp * 32 * ROUNDS,
                       total, shift, cnt + warp * DIGITS, loc);
    __syncthreads();
    if (threadIdx.x < DIGITS) {
      int s = 0;
      for (int w = 0; w < SORT_WARPS; ++w) s += cnt[w * DIGITS + threadIdx.x];
      hist[static_cast<long long>(tile) * DIGITS + threadIdx.x] = s;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  const int blocks = min(static_cast<int>(gridDim.x), tiles);
  if (threadIdx.x == 0) last = atomicAdd(&misc[ARRIVE], 1) == blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each group's sums, the two halves of the block taking half the groups
  // each, a group's GROUP loads in flight at once
  const int groups = (tiles + GROUP - 1) / GROUP;
  const int d = threadIdx.x % DIGITS, half = threadIdx.x / DIGITS;
  for (int g = half; g < groups; g += SORT_THREADS / DIGITS) {
    int c[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int t = g * GROUP + i;
      c[i] = t < tiles ? __ldcg(hist + static_cast<long long>(t) * DIGITS + d) : 0;
    }
    int s = 0;
#pragma unroll
    for (int i = 0; i < GROUP; ++i) s += c[i];
    group[g * DIGITS + d] = s;
  }
  __syncthreads();
  int digit_total = 0;
  if (half == 0)
    for (int g = 0; g < groups; ++g) {
      const int c = group[g * DIGITS + d];
      group[g * DIGITS + d] = digit_total;
      digit_total += c;
    }
  const int below = block_exclusive_scan(digit_total, nullptr);   // threads past 256 add 0
  if (half == 0)
    for (int g = 0; g < groups; ++g) group[g * DIGITS + d] += below;
  if (threadIdx.x == 0) misc[ARRIVE] = 0;
}

// Each tile's pairs go first to their places in the tile's own digit order
// in shared memory, then out in that order, so that a warp's writes of one
// digit are contiguous.  Dynamic shared memory: MOVE_SMEM bytes.
__global__ void __launch_bounds__(SORT_THREADS)
digit_move(const int* __restrict__ keys_in, const float* __restrict__ vals_in,
           int* __restrict__ keys_out, float* __restrict__ vals_out, int shift,
           const int* __restrict__ hist, const int* __restrict__ group,
           const int* __restrict__ misc) {
  const int total = misc[TOTAL];
  if (total <= SMALL_MAX) return;
  const int tiles = sort_tiles(total);
  extern __shared__ __align__(16) int move_smem[];
  int* cnt = move_smem;                            // [SORT_WARPS][DIGITS]
  int* sk = move_smem + SORT_WARPS * DIGITS;       // [SORT_TILE] keys in tile order
  float* sv = reinterpret_cast<float*>(sk + SORT_TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* wcnt = cnt + warp * DIGITS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long tbase = static_cast<long long>(tile) * SORT_TILE;
    const long long wbase = tbase + warp * 32 * ROUNDS;
    const int size = static_cast<int>(min(static_cast<long long>(SORT_TILE), total - tbase));
    int loc[ROUNDS];
    warp_ranks<ROUNDS>(keys_in, wbase, total, shift, wcnt, loc);
    __syncthreads();
    // cnt[w][d]: the tile position of warp w's first pair of digit d
    int digit_total = 0;
    if (threadIdx.x < DIGITS) {
      for (int w = 0; w < SORT_WARPS; ++w) {
        const int c = cnt[w * DIGITS + threadIdx.x];
        cnt[w * DIGITS + threadIdx.x] = digit_total;
        digit_total += c;
      }
    }
    const int start = block_exclusive_scan(digit_total, nullptr);
    if (threadIdx.x < DIGITS)
      for (int w = 0; w < SORT_WARPS; ++w) cnt[w * DIGITS + threadIdx.x] += start;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const long long p = wbase + 32 * r + lane;
      if (p < total) {
        const int key = keys_in[p];
        const int at = wcnt[(key >> shift) & (DIGITS - 1)] + loc[r];
        sk[at] = key;
        sv[at] = vals_in[p];
      }
    }
    __syncthreads();
    // cnt[d] now: digit d's place in the output less its first tile position
    if (threadIdx.x < DIGITS) {
      const int g = tile / GROUP;
      int place = group[g * DIGITS + threadIdx.x];
      for (int t = g * GROUP; t < tile; ++t)
        place += hist[static_cast<long long>(t) * DIGITS + threadIdx.x];
      cnt[threadIdx.x] = place - start;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < size; i += SORT_THREADS) {
      const int key = sk[i];
      const int dest = cnt[(key >> shift) & (DIGITS - 1)] + i;
      keys_out[dest] = key;
      vals_out[dest] = sv[i];
    }
    __syncthreads();
  }
}

// acc + buf[0], + buf[1], ... + buf[cnt - 1], one add at a time; the next
// 16 terms are read from shared memory while the current 16 are added, and
// the tail is added term by term (dst may be -0.0, so no +0 padding may be
// added).  buf holds CHAIN_SPAN floats, 16-byte aligned.
__device__ __forceinline__ float add_staged(float acc, const float* buf, int cnt) {
  const float4* v = reinterpret_cast<const float4*>(buf);
  const int full = cnt >> 4;
  float4 cur[4], nxt[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) cur[u] = v[u];
  for (int g = 0; g < full; ++g) {
    const int at = g + 1 < CHAIN_SPAN / 16 ? 4 * (g + 1) : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) nxt[u] = v[at + u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, cur[u].x), cur[u].y), cur[u].z),
                      cur[u].w);
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
  }
  for (int i = full << 4; i < cnt; ++i) acc = __fadd_rn(acc, buf[i]);
  return acc;
}

__device__ __forceinline__ void load_group(int (&kk)[CHAIN_UNROLL], float (&vv)[CHAIN_UNROLL],
                                           long long base, long long total, int lane,
                                           const int* __restrict__ keys,
                                           const float* __restrict__ vals) {
#pragma unroll
  for (int u = 0; u < CHAIN_UNROLL; ++u) {
    const long long p = base + 32 * u + lane;
    kk[u] = p < total ? keys[p] : -1;
    vv[u] = p < total ? vals[p] : 0.0f;
  }
}

// The warp adds target t's run, which starts at sorted position h, onto
// out[t] in order.  The pairs are sorted by target, so a group's pairs of t
// are its first ones: their count is where the run stops.
__device__ __forceinline__ void walk(const int* __restrict__ keys, const float* __restrict__ vals,
                                     long long total, long long h, int t, float* __restrict__ out,
                                     float* buf, int lane) {
  float acc = 0.0f;
  if (lane == 0) acc = out[t];
  const long long q = h + lane;
  const int k0 = q < total ? keys[q] : -1;
  buf[lane] = q < total ? vals[q] : 0.0f;
  int cnt = __popc(__ballot_sync(FULL, k0 == t));
  __syncwarp();
  if (lane == 0) acc = add_staged(acc, buf, cnt);
  __syncwarp();
  if (cnt == 32) {
    long long base = h + 32;
    int kk[CHAIN_UNROLL];
    float vv[CHAIN_UNROLL];
    load_group(kk, vv, base, total, lane, keys, vals);
    for (;;) {
      unsigned mine = 0;
#pragma unroll
      for (int u = 0; u < CHAIN_UNROLL; ++u) {
        buf[32 * u + lane] = vv[u];
        mine += kk[u] == t;
      }
      cnt = static_cast<int>(__reduce_add_sync(FULL, mine));
      __syncwarp();
      if (cnt == CHAIN_SPAN)   // the next group, in flight during the adds
        load_group(kk, vv, base + CHAIN_SPAN, total, lane, keys, vals);
      if (lane == 0) acc = add_staged(acc, buf, cnt);
      __syncwarp();
      if (cnt < CHAIN_SPAN) break;
      base += CHAIN_SPAN;
    }
  }
  if (lane == 0) out[t] = acc;
}

// Warps take the sorted positions 32 at a time (warp w: chunks w, w + warps,
// ...).  A run that starts and ends in the chunk is added by its first lane
// from the other lanes' terms (shuffles, in order); the chunk's last run, if
// it goes on past the chunk, is walked by the whole warp.
__global__ void __launch_bounds__(CHAIN_THREADS)
chains(const int* __restrict__ keys, const float* __restrict__ vals, float* __restrict__ out,
       int n, const int* __restrict__ misc) {
  const int total = misc[TOTAL];
  if (total <= SMALL_MAX) return;
  __shared__ __align__(16) float stage[CHAIN_THREADS / 32][CHAIN_SPAN];
  float* buf = stage[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (CHAIN_THREADS / 32);
  for (long long c = static_cast<long long>(blockIdx.x) * (CHAIN_THREADS / 32) +
                     (threadIdx.x >> 5);
       32 * c < total; c += warps) {
    const long long p = 32 * c + lane;
    const bool in = p < total;
    const int key = in ? keys[p] : -1;
    const int before = in && p > 0 ? keys[p - 1] : -1;
    const int after = p + 1 < total ? keys[p + 1] : -1;
    const float v = in ? vals[p] : 0.0f;
    const bool head = in && key < n && (p == 0 || before != key);
    const unsigned lasts = __ballot_sync(FULL, in && after != key);
    const unsigned rest = lasts >> lane;
    const bool closed = head && rest != 0u;   // the run ends in this chunk, at lane `stop`
    const int stop = closed ? lane + __ffs(rest) - 1 : -1;
    float acc = closed ? out[key] : 0.0f;
    for (int i = 0; i < 32; ++i) {
      const float x = __shfl_sync(FULL, v, i);
      if (i >= lane && i <= stop) acc = __fadd_rn(acc, x);
    }
    if (closed) out[key] = acc;
    const unsigned open = __ballot_sync(FULL, head && !closed);   // at most one
    if (open != 0u) {
      const int from = __ffs(open) - 1;
      walk(keys, vals, total, 32 * c + from, __shfl_sync(FULL, key, from), out, buf, lane);
    }
  }
}

struct Layout {
  long long tile;      // lanes a flag tile
  int tiles;           // flag tiles
  long long sort_cap;  // the most sort tiles (k live lanes)
  long long tile_live, hist, group, keys_a, vals_a, keys_b, vals_b, words;
};

Layout layout(int k) {
  Layout L;
  const long long kk = k;
  long long tile = FLAG_TILE;
  while ((kk + tile - 1) / tile > MAX_FLAG_TILES) tile += FLAG_TILE;
  L.tile = tile;
  L.tiles = static_cast<int>((kk + tile - 1) / tile);
  L.sort_cap = (kk + SORT_TILE - 1) / SORT_TILE;
  L.tile_live = MISC_WORDS;
  L.hist = L.tile_live + L.tiles;
  L.group = L.hist + DIGITS * L.sort_cap;
  L.keys_a = L.group + DIGITS * ((L.sort_cap + GROUP - 1) / GROUP);
  L.vals_a = L.keys_a + kk;
  L.keys_b = L.vals_a + kk;
  L.vals_b = L.keys_b + kk;
  L.words = L.vals_b + kk;
  return L;
}

}  // namespace

// int32 words of scratch a call with k lanes needs.
extern "C" long long port_scatter_scratch_words(int k) {
  return k <= 0 ? 1 : layout(k).words;
}

// dst, out: (n,) float32 (out written whole); idx: (k,) int32 or int64
// (idx64) targets; src: (k,) float32 terms; live: (k,) bool or NULL (every
// lane live); scratch: port_scatter_scratch_words(k) int32 words.
extern "C" int port_scatter_add_ordered(const float* dst, float* out, int n, const void* idx,
                                        int idx64, const float* src, const uint8_t* live, int k,
                                        int* scratch, cudaStream_t stream) {
  if (k < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (k == 0)
    return static_cast<int>(cudaMemcpyAsync(out, dst, sizeof(float) * static_cast<size_t>(n),
                                            cudaMemcpyDeviceToDevice, stream));
  const Layout L = layout(k);
  int bits = 0;
  while (bits < 31 && (n >> bits) != 0) ++bits;   // the keys are at most n
  const int passes = (bits + 7) / 8;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(small_route, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMALL_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(digit_move, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MOVE_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* misc = scratch;
  int* tile_live = scratch + L.tile_live;
  int* hist = scratch + L.hist;
  int* group = scratch + L.group;
  int* keys_a = scratch + L.keys_a;
  float* vals_a = reinterpret_cast<float*>(scratch + L.vals_a);
  int* keys_b = scratch + L.keys_b;
  float* vals_b = reinterpret_cast<float*>(scratch + L.vals_b);
  const bool aligned = (reinterpret_cast<uintptr_t>(live) & 15u) == 0u;
  const int copy_blocks = static_cast<int>(
      std::min((static_cast<long long>(n) + 2047) / 2048, static_cast<long long>(4 * sms)));
  flag_count<<<std::max(L.tiles, copy_blocks), FLAG_THREADS, 0, stream>>>(
      live, aligned, k, L.tile, L.tiles, dst, out, n, tile_live, misc);
  if (idx64)
    compact<long long><<<L.tiles, FLAG_THREADS, 0, stream>>>(
        live, aligned, static_cast<const long long*>(idx), src, k, L.tile, L.tiles, n, tile_live,
        keys_a, vals_a, misc);
  else
    compact<int><<<L.tiles, FLAG_THREADS, 0, stream>>>(
        live, aligned, static_cast<const int*>(idx), src, k, L.tile, L.tiles, n, tile_live,
        keys_a, vals_a, misc);
  small_route<<<1, SMALL_THREADS, SMALL_SMEM, stream>>>(keys_a, vals_a, out, n, passes, misc);
  if (k > SMALL_MAX) {   // else the live lanes always fit the small route
    const int grid = static_cast<int>(std::min(L.sort_cap, static_cast<long long>(4 * sms)));
    int* kin = keys_a;
    float* vin = vals_a;
    int* kout = keys_b;
    float* vout = vals_b;
    for (int pass = 0; pass < passes; ++pass) {
      digit_count<<<grid, SORT_THREADS, 0, stream>>>(kin, 8 * pass, hist, group, misc);
      digit_move<<<grid, SORT_THREADS, MOVE_SMEM, stream>>>(kin, vin, kout, vout, 8 * pass, hist,
                                                            group, misc);
      int* tk = kin;
      kin = kout;
      kout = tk;
      float* tv = vin;
      vin = vout;
      vout = tv;
    }
    const int chain_grid = static_cast<int>(
        std::min((static_cast<long long>(k) + CHAIN_THREADS - 1) / CHAIN_THREADS,
            static_cast<long long>(8 * sms)));
    chains<<<chain_grid, CHAIN_THREADS, 0, stream>>>(kin, vin, out, n, misc);
  }
  return static_cast<int>(cudaGetLastError());
}
