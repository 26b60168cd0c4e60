// Exact top-k lists of any depth, shared by the three top-k kernels of the
// port: the streaming top-k over stored gains (stream_topk.cu), the fused
// scoring top-k (fused_topk.cu) and the probed coarse scan's rank-capped
// winners (grouped_pair_topk.cu). Their shallow paths keep a sorted list
// per row in a warp or a thread; past 160 entries that list does not fit,
// so a deep list is built from gains written to device memory instead:
//
//   * select_sort_kernel: one block of 256 threads a (row, run of at most
//     RUN_MAX positions). The run is read once into shared memory as
//     order-preserving uint32 keys, the kr-th largest key T is found by
//     radix select (four 8-bit passes of a histogram), every key > T and
//     the keys == T at the lowest positions are collected in position
//     order (ballots and a scan over warps that own contiguous ranges),
//     and the winners are sorted by a bitonic sort in shared memory. A
//     winner travels as one 64-bit word, key << 32 | ~position: larger
//     words are better, equal keys order by the lower position, and the
//     word 0 (key 0: -inf or NaN, never taken) pads a list.
//   * merge_kernel: sorted lists of a row merged in pairs and cut to k. A
//     thread takes one entry and finds its rank in the other list by binary
//     search (entries are distinct but for the 0 pads), so the merge is
//     one pass with no barrier.
//   * emit_kernel: a sorted list written out as (gain, index); the gain is
//     read back from the stored gains where the caller has them, else
//     decoded from the key. A pad comes out as (-inf, 0).
//
// reduce_rows() chains them: every run of a row gives its kr best, then
// merge levels halve the lists until one remains. The order is the plain
// versions' everywhere: gain descending, then position ascending.
//
// What bounds it: the gains cross device memory once in each direction
// (the select reads each once); the histogram passes run over shared
// memory. A row of M positions at list depth k costs M / RUN_MAX select
// blocks and ceil(log2(M / RUN_MAX)) merge launches.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace deep {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // == RADIX: one histogram bin a thread
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int RUN_MAX = 8192;  // positions a select block holds (32 KB of keys)

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Order-preserving key: larger gain, larger key. -inf and NaN map to 0 (no
// finite gain or +inf does: the smallest, -FLT_MAX, maps to 0x00800000);
// -0 maps as +0, since the two compare equal and tie by position.
__device__ __forceinline__ uint32_t order_key(float x) {
  if (!(x > neg_inf())) return 0u;
  const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The gain of a key > 0 (-0 comes back as +0).
__device__ __forceinline__ float key_gain(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Inclusive sum of v over the block's threads in thread order; `total` gets
// the block's sum. Two barriers; `scratch` holds WARPS ints.
__device__ __forceinline__ int block_inclusive_sum(int v, int* scratch,
                                                   int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = scratch[w];
    base += w < warp ? s : 0;
    tot += s;
  }
  __syncthreads();  // scratch may be written again
  total = tot;
  return v + base;
}

// Shared state of one select block (static shared memory).
struct SelectShared {
  int hist[RADIX];
  int scratch[WARPS];
  int warp_gt[WARPS], warp_eq[WARPS];
  uint32_t sel_digit;
  int sel_above;
};

// Radix select over keys[0, n) in shared memory, whose top bytes are
// already counted in sh.hist: returns T, the want-th largest key (1 <= want
// <= n), and in `need` how many keys equal to T are among the want largest.
// Leaves sh.hist zeroed.
__device__ __forceinline__ uint32_t radix_select(const uint32_t* keys, int n,
                                                 int want, SelectShared& sh,
                                                 int& need_out) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0u;
  int need = want;
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (pass > 0) {
      const uint32_t hi = 0xffffffffu << (shift + 8);
      for (int e = tid; e < n; e += THREADS) {
        const uint32_t key = keys[e];
        if ((key & hi) == prefix) atomicAdd(&sh.hist[(key >> shift) & 0xff], 1);
      }
      __syncthreads();
    }
    // thread t holds bin 255 - t: the inclusive sum counts keys in bins >= it
    const int c = sh.hist[RADIX - 1 - tid];
    int total;
    const int at_or_above = block_inclusive_sum(c, sh.scratch, total);
    if (at_or_above >= need && at_or_above - c < need) {
      sh.sel_digit = (uint32_t)(RADIX - 1 - tid);
      sh.sel_above = at_or_above - c;
    }
    __syncthreads();
    sh.hist[tid] = 0;
    prefix |= sh.sel_digit << shift;
    need -= sh.sel_above;
    __syncthreads();
  }
  need_out = need;
  return prefix;
}

// Writes every key > T and the first take_eq keys == T of keys[0, n) to
// cand as (key << 32 | ~(pos0 + position)), the keys > T first, each group
// in position order; returns how many (block-uniform). Warp w owns the
// positions [w * seg, (w + 1) * seg). Ends with a barrier.
__device__ __forceinline__ int collect(const uint32_t* keys, int n, uint32_t T,
                                       int take_eq, int pos0, u64* cand,
                                       SelectShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = ((n + WARPS - 1) / WARPS + 31) & ~31;
  const int w_lo = warp * seg, w_hi = min(n, w_lo + seg);
  int n_gt = 0, n_eq = 0;
  for (int p0 = w_lo; p0 < w_hi; p0 += 32) {
    const int p = p0 + lane;
    const uint32_t key = p < w_hi ? keys[p] : 0u;
    n_gt += __popc(__ballot_sync(FULL, p < w_hi && key > T));
    n_eq += __popc(__ballot_sync(FULL, p < w_hi && key == T));
  }
  if (lane == 0) { sh.warp_gt[warp] = n_gt; sh.warp_eq[warp] = n_eq; }
  __syncthreads();
  int at_gt = 0, at_eq = 0, all_gt = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    at_gt += w < warp ? sh.warp_gt[w] : 0;
    at_eq += w < warp ? sh.warp_eq[w] : 0;
    all_gt += sh.warp_gt[w];
  }
  const unsigned lt = (1u << lane) - 1u;
  for (int p0 = w_lo; p0 < w_hi; p0 += 32) {
    const int p = p0 + lane;
    const uint32_t key = p < w_hi ? keys[p] : 0u;
    const bool gt = p < w_hi && key > T, eq = p < w_hi && key == T;
    const unsigned bg = __ballot_sync(FULL, gt), be = __ballot_sync(FULL, eq);
    const u64 pk = ((u64)key << 32) | (uint32_t)~(pos0 + p);
    if (gt) cand[at_gt + __popc(bg & lt)] = pk;
    if (eq) {
      const int r = at_eq + __popc(be & lt);
      if (r < take_eq) cand[all_gt + r] = pk;
    }
    at_gt += __popc(bg);
    at_eq += __popc(be);
  }
  __syncthreads();
  return all_gt + take_eq;
}

// Sorts v[0, P) descending, P a power of two. Ends with a barrier.
__device__ __forceinline__ void bitonic_desc(u64* v, int P) {
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool desc = (lo & size) == 0;  // the last merge: all descending
        const u64 a = v[lo], b = v[hi];
        if ((a < b) == desc) { v[lo] = b; v[hi] = a; }
      }
      __syncthreads();
    }
}

// Whether `row` (of a launch that starts at row0) is past the live rows:
// *live units of `unit` rows each (the probed scan's real blocks), or none.
__device__ __forceinline__ bool dead_row(const int* live, int unit, long long row) {
  return live != nullptr && row >= (long long)(*live) * unit;
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Dynamic shared memory of a select block over runs of `run` positions
// with lists of kr: the run's keys, then the winners padded to a power of two.
inline int select_smem(int run, int kr) {
  return align16(run * 4) + 8 * pow2_at_least(kr < run ? kr : run);
}

// One block a (row, run): grid rows * splits. Run s of a row covers the
// positions [s * run, min((s + 1) * run, M)) of its gains (row stride ld).
// Its kr best (gain desc, position asc) go out sorted: as words to
// lists + row * list_ld + s * kr, padded with 0; or, with EMIT (one run a
// row, pos0 == 0), as (gain, position) to out_g / out_i [rows, kr], padded
// with (-inf, 0). Positions are reported as pos0 + the position in the row.
template <bool EMIT, typename IndexT>
__global__ void __launch_bounds__(THREADS) select_sort_kernel(
    const float* __restrict__ gains, long long ld, int M, int run, int splits,
    int kr, int pos0, u64* __restrict__ lists, long long list_ld,
    float* __restrict__ out_g, IndexT* __restrict__ out_i,
    const int* __restrict__ live, int unit, long long row0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ SelectShared sh;
  const long long row = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  if (dead_row(live, unit, row0 + row)) return;  // block-uniform
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  u64* cand = reinterpret_cast<u64*>(smem + align16(run * 4));
  const int tid = threadIdx.x;
  const int begin = split * run;
  const int n = min(run, M - begin);
  const float* g = gains + row * ld + begin;

  sh.hist[tid] = 0;
  __syncthreads();
  for (int e = tid; e < n; e += THREADS) {
    const uint32_t key = order_key(g[e]);
    keys[e] = key;
    atomicAdd(&sh.hist[key >> 24], 1);
  }
  __syncthreads();
  int need;
  const uint32_t T = radix_select(keys, n, min(kr, n), sh, need);
  const int count = collect(keys, n, T, T ? need : 0, pos0 + begin, cand, sh);
  const int P = pow2_at_least(count);
  for (int i = count + tid; i < P; i += THREADS) cand[i] = 0ull;
  __syncthreads();
  bitonic_desc(cand, P);

  if constexpr (EMIT) {
    for (int s = tid; s < kr; s += THREADS) {
      float v = neg_inf();
      int pos = 0;
      if (s < count) {
        pos = (int)~(uint32_t)cand[s];
        v = g[pos - pos0 - begin];
      }
      out_g[row * kr + s] = v;
      out_i[row * kr + s] = (IndexT)pos;
    }
  } else {
    u64* o = lists + row * list_ld + (long long)split * kr;
    for (int s = tid; s < kr; s += THREADS) o[s] = s < count ? cand[s] : 0ull;
  }
}

// Number of entries of v[0, L) (sorted descending) above x, or at or above.
__device__ __forceinline__ int rank_in(const u64* v, int L, u64 x, bool or_equal) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const u64 m = v[mid];
    if (m > x || (or_equal && m == x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merges lists 2p and 2p + 1 of each row (A of La entries, B of Lb, both
// sorted descending; B absent when 2p + 1 == n_lists) into list p of the
// output, cut to Lo <= La + Lb entries (past the inputs, 0). Grid
// (rows * pairs, ceil((La + Lb) / THREADS)).
__global__ void __launch_bounds__(THREADS) merge_kernel(
    const u64* __restrict__ in, long long in_ld, int list_stride, int La, int Lb,
    int n_lists, u64* __restrict__ out, long long out_ld, int Lo, int pairs,
    const int* __restrict__ live, int unit, long long row0) {
  const long long row = blockIdx.x / pairs;
  const int p = blockIdx.x % pairs;
  if (dead_row(live, unit, row0 + row)) return;
  const int t = blockIdx.y * THREADS + threadIdx.x;
  const u64* a = in + row * in_ld + (long long)(2 * p) * list_stride;
  const u64* b = a + list_stride;
  const bool has_b = 2 * p + 1 < n_lists;
  u64* o = out + row * out_ld + (long long)p * Lo;
  if (t < La) {
    const u64 x = a[t];
    const int at = t + (has_b ? rank_in(b, Lb, x, false) : 0);
    if (at < Lo) o[at] = x;
  } else if (t < La + Lb) {
    const int j = t - La;
    if (has_b) {  // equal words (the 0 pads) go after A's
      const u64 x = b[j];
      const int at = j + rank_in(a, La, x, true);
      if (at < Lo) o[at] = x;
    } else if (t < Lo) {
      o[t] = 0ull;
    }
  }
}

// Writes the sorted lists [rows, L] (row stride list_ld) out as (gain,
// index) [rows, K], K >= L: the gain read from src (row stride src_ld) at
// the entry's position, or decoded from its key when src is null; the
// pads and the slots past L as (-inf, 0).
template <typename IndexT>
__global__ void __launch_bounds__(THREADS) emit_kernel(
    const u64* __restrict__ lists, long long list_ld, int L,
    const float* __restrict__ src, long long src_ld, float* __restrict__ out_g,
    IndexT* __restrict__ out_i, int K, long long rows,
    const int* __restrict__ live, int unit, long long row0) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= rows * K) return;
  const long long row = e / K;
  const int s = (int)(e - row * K);
  if (dead_row(live, unit, row0 + row)) return;
  const u64 w = s < L ? lists[row * list_ld + s] : 0ull;
  const uint32_t key = (uint32_t)(w >> 32);
  float v = neg_inf();
  int pos = 0;
  if (key) {
    pos = (int)~(uint32_t)w;
    v = src ? src[row * src_ld + pos] : key_gain(key);
  }
  out_g[e] = v;
  out_i[e] = (IndexT)pos;
}

// A failed deep launch reports which step failed beside the CUDA error, as
// step * 1000 + error (the wrappers raise with both).
enum Step {
  STEP_ARGS = 1,         // arguments the launcher does not take
  STEP_SELECT_ATTR = 2,  // the select's shared memory request
  STEP_SELECT = 3,
  STEP_MERGE = 4,
  STEP_EMIT = 5,
  STEP_GAINS = 6,        // the caller's gain kernel (K1, K4)
  STEP_MEMSET = 7,
  STEP_RUNNING = 8,      // K1: the chunk's list into the running list
};

inline int fail(Step step, cudaError_t err) { return 1000 * step + (int)err; }

// Asks for the dynamic shared memory of a select launch above the default
// (48 KB a block, static shared memory included).
template <bool EMIT, typename IndexT>
inline cudaError_t select_attr(int smem) {
  if (smem + (int)sizeof(SelectShared) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(select_sort_kernel<EMIT, IndexT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launches merge_kernel over `rows` rows (see there).
inline cudaError_t merge(const u64* in, long long in_ld, int list_stride, int La,
                         int Lb, int n_lists, u64* out, long long out_ld, int Lo,
                         long long rows, const int* live, int unit,
                         long long row0, cudaStream_t st) {
  const int pairs = (n_lists + 1) / 2;
  const dim3 grid((unsigned)(rows * pairs), (unsigned)((La + Lb + THREADS - 1) / THREADS));
  merge_kernel<<<grid, THREADS, 0, st>>>(in, in_ld, list_stride, La, Lb, n_lists,
                                         out, out_ld, Lo, pairs, live, unit, row0);
  return cudaGetLastError();
}

// Reduces each of `rows` rows of gains (row stride ld; positions [0, M),
// reported as pos0 + position) to one sorted list: the kr best of every run
// of `run` positions, merged in pairs and cut to k after each level. The
// final list goes to dst (row stride dst_ld) and its length to *len; the
// levels before it ping-pong between ws_a and ws_b, each of rows x
// list_entries(ceil(M / run), kr, k) words (ops/deep_topk.py). Rows past
// the live ones (see dead_row) are skipped. Launches only.
inline int reduce_rows(const float* gains, long long ld, long long rows, int M,
                       int run, int kr, int k, int pos0, u64* ws_a, u64* ws_b,
                       u64* dst, long long dst_ld, int* len, const int* live,
                       int unit, long long row0, cudaStream_t st) {
  const int splits = (M + run - 1) / run;
  const int smem = select_smem(run, kr);
  cudaError_t err = select_attr<false, int>(smem);
  if (err != cudaSuccess) return fail(STEP_SELECT_ATTR, err);
  u64* cur = splits == 1 ? dst : ws_a;
  long long cur_ld = splits == 1 ? dst_ld : (long long)splits * kr;
  select_sort_kernel<false, int><<<(unsigned)(rows * splits), THREADS, smem, st>>>(
      gains, ld, M, run, splits, kr, pos0, cur, cur_ld, nullptr, nullptr, live,
      unit, row0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return fail(STEP_SELECT, err);
  int n = splits, L = kr;
  u64* other = ws_b;
  while (n > 1) {
    const int pairs = (n + 1) / 2;
    const int Lo = 2 * L < k ? 2 * L : k;
    u64* target = pairs == 1 ? dst : other;
    const long long target_ld = pairs == 1 ? dst_ld : (long long)pairs * Lo;
    err = merge(cur, cur_ld, L, L, L, n, target, target_ld, Lo, rows, live, unit,
                row0, st);
    if (err != cudaSuccess) return fail(STEP_MERGE, err);
    other = cur;
    cur = target;
    cur_ld = target_ld;
    n = pairs;
    L = Lo;
  }
  *len = L;
  return 0;
}

template <typename IndexT>
inline cudaError_t emit(const u64* lists, long long list_ld, int L,
                        const float* src, long long src_ld, float* out_g,
                        IndexT* out_i, int K, long long rows, const int* live,
                        int unit, long long row0, cudaStream_t st) {
  const long long total = rows * K;
  emit_kernel<IndexT><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      lists, list_ld, L, src, src_ld, out_g, out_i, K, rows, live, unit, row0);
  return cudaGetLastError();
}

}  // namespace deep
