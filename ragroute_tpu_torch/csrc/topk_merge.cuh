// Running sorted top-k lists, the rank merge of a warp's candidate buffer
// into its list (merge_buffer: arrival order does not matter) and the merge
// of per-split lists, shared by the fused scoring kernel (fused_topk.cu) and
// the streaming kernel over stored gains (stream_topk.cu).
//
// Order everywhere: gain descending, then index ascending. A candidate is
// inserted only when it is strictly greater than the list's last entry, and
// it lands after every entry that is >= it, so among equal gains the one
// seen first (the lower index: callers stream in ascending index order)
// stays ahead. -inf and NaN are never greater than anything and never enter.
// An unfilled list slot carries gain -inf and index 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int KMAX = 160;                   // deepest list a warp maintains
constexpr int KSHALLOW = 64;                // lists up to here: 2 entries a lane
constexpr int SLOTS_SHALLOW = KSHALLOW / 32;
constexpr int SLOTS_DEEP = (KMAX + 31) / 32;  // list entries per lane
constexpr int MERGE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Insert (x, id) into a sorted list (rg, ri) of length K <= 32 * SLOTS in
// shared memory, after every entry whose gain is >= x. Called by a whole
// warp with warp-uniform arguments; x beats rg[K-1]. SLOTS is a template
// argument so that the serving depths (k <= 64) keep the two-entry code
// and only deep lists pay for five entries a lane.
template <int SLOTS>
__device__ __forceinline__ void warp_insert(float* rg, int* ri, int K, float x,
                                            int id, int lane) {
  float e[SLOTS];
  int ix[SLOTS];
  int pos = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int at = lane + 32 * s;
    const bool has = at < K;
    e[s] = has ? rg[at] : neg_inf();
    ix[s] = has ? ri[at] : 0;
    pos += __popc(__ballot_sync(FULL, has && e[s] >= x));
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int at = lane + 32 * s;
    if (at >= pos && at + 1 < K) { rg[at + 1] = e[s]; ri[at + 1] = ix[s]; }
  }
  if (lane == 0) { rg[pos] = x; ri[pos] = id; }
  __syncwarp();
}

// Fold one value per lane (lane order = ascending index, `id0 + lane`) into
// the warp's list. `thr` is the caller's copy of rg[K-1], kept current.
template <int SLOTS>
__device__ __forceinline__ void warp_fold(float* rg, int* ri, int K, float v,
                                          int id0, int lane, float& thr) {
  unsigned m = __ballot_sync(FULL, v > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float x = __shfl_sync(FULL, v, src);
    if (x > thr) {
      warp_insert<SLOTS>(rg, ri, K, x, id0 + src, lane);
      thr = rg[K - 1];
    }
  }
}

// (a, ia) comes before (b, ib): the lists' order, gain desc then index asc
__device__ __forceinline__ bool precedes(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// One warp merges a row's candidate buffer (n <= 32 entries, any order) into
// the row's sorted list of K: each entry's new place is its rank in the
// union under the lists' order, found by counting, so no entry is inserted
// one at a time; places past K fall off. A list entry's rank counts the
// candidates before it (a pass over the candidates, shuffled to every lane);
// a candidate's counts the candidates before it in the same pass and the
// list entries before it by a binary search of the sorted list. An unfilled
// list slot is (-inf, 0) and comes after every candidate.
template <int SLOTS>
__device__ __forceinline__ void merge_buffer(float* rg, int* ri,
                                             const float* bg, const int* bi,
                                             int K, int n, int lane) {
  float e[SLOTS];
  int ix[SLOTS], rl[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int at = lane + 32 * s;
    e[s] = at < K ? rg[at] : neg_inf();
    ix[s] = at < K ? ri[at] : 0;
    rl[s] = 0;
  }
  const bool mine = lane < n;
  const float bx = mine ? bg[lane] : neg_inf();
  const int bid = mine ? bi[lane] : 0;
  int rb = 0;
  for (int j = 0; j < n; ++j) {
    const float xj = __shfl_sync(FULL, bx, j);
    const int ij = __shfl_sync(FULL, bid, j);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) rl[s] += precedes(xj, ij, e[s], ix[s]);
    rb += precedes(xj, ij, bx, bid);
  }
  int lo = 0, hi = K;  // list entries before my candidate: a prefix
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (precedes(rg[mid], ri[mid], bx, bid)) lo = mid + 1; else hi = mid;
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int at = lane + 32 * s, to = at + rl[s];
    if (at < K && to < K) { rg[to] = e[s]; ri[to] = ix[s]; }
  }
  if (mine && rb + lo < K) { rg[rb + lo] = bx; ri[rb + lo] = bid; }
  __syncwarp();
}

// (g, i, s) beats (bg, bi, bs): higher gain, then lower index, then lower
// split; s < 0 marks "no candidate".
__device__ __forceinline__ bool beats(float g, int i, int s, float bg, int bi, int bs) {
  if (s < 0) return false;
  if (bs < 0) return true;
  if (g != bg) return g > bg;
  if (i != bi) return i < bi;
  return s < bs;
}

// One block per row merges the row's `splits` sorted lists part_g/part_i
// [rows, splits, K] into out_g/out_i [rows, K]. -inf entries of a list never
// win against a real one and come out as (-inf, 0).
template <typename IndexT>
__global__ void __launch_bounds__(MERGE_THREADS) merge_splits_kernel(
    const float* __restrict__ part_g, const int* __restrict__ part_i,
    float* __restrict__ out_g, IndexT* __restrict__ out_i, int splits, int K) {
  extern __shared__ int heads[];  // next unread entry of each split's list
  __shared__ float red_g[MERGE_THREADS / 32];
  __shared__ int red_i[MERGE_THREADS / 32];
  __shared__ int red_s[MERGE_THREADS / 32];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pg = part_g + (size_t)row * splits * K;
  const int* pi = part_i + (size_t)row * splits * K;
  for (int s = tid; s < splits; s += MERGE_THREADS) heads[s] = 0;
  __syncthreads();
  for (int out = 0; out < K; ++out) {
    float bg = 0.0f;
    int bi = 0, bs = -1;
    for (int s = tid; s < splits; s += MERGE_THREADS) {
      const int h = heads[s];
      if (h < K) {
        const float g = pg[s * K + h];
        const int i = pi[s * K + h];
        // an exhausted list (its head is an unfilled -inf slot) is out
        if (g > neg_inf() && beats(g, i, s, bg, bi, bs)) { bg = g; bi = i; bs = s; }
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float og = __shfl_down_sync(FULL, bg, off);
      const int oi = __shfl_down_sync(FULL, bi, off);
      const int os = __shfl_down_sync(FULL, bs, off);
      if (beats(og, oi, os, bg, bi, bs)) { bg = og; bi = oi; bs = os; }
    }
    if (lane == 0) { red_g[warp] = bg; red_i[warp] = bi; red_s[warp] = bs; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < MERGE_THREADS / 32; ++w)
        if (beats(red_g[w], red_i[w], red_s[w], bg, bi, bs)) {
          bg = red_g[w]; bi = red_i[w]; bs = red_s[w];
        }
      out_g[(size_t)row * K + out] = bs >= 0 ? bg : neg_inf();
      out_i[(size_t)row * K + out] = bs >= 0 ? (IndexT)bi : (IndexT)0;
      if (bs >= 0) heads[bs] += 1;
    }
    __syncthreads();
  }
}

}  // namespace topk
