// Exact top-k over a stored gain matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/pallas_topk.py::pallas_stream_topk
// (body _stream_kernel, merge _merge_gains_tile). For gains [B, M] f32 it
// returns, per row, the k best (gain, position) ordered by gain descending,
// then position ascending; -inf (and NaN) entries never enter a list, and a
// list slot nothing filled comes back as (-inf, 0). The cluster-probed search
// uses it to collect each query's winners from its gathered [B, P * S] gains,
// the probed coarse scan to collect k' = 128 from [B, 512 * 8] kept gains.
//
// What bounds it on an H100 SXM: bytes. The function reads B * M * 4 bytes
// once and does one comparison an entry: 8.4 MB at the probed collect (B =
// 512, M = 4,096; 2.7 us at 3.35 TB/s, under one launch), 268 MB at the ivf
// collect (B = 512, M = 131,072; 80 us). What held the first design back was
// not the bytes but a serial insert into a sorted list for every value that
// beats the list's last entry: at k = 128 over 1,024-value splits that is
// hundreds of inserts a warp, one at a time. The paths, chosen by the
// wrapper from (B, M, k) (ops/stream_topk.py::plan):
//
//   * select_topk_kernel (short rows or deep lists): one block of 256 threads
//     a (row, split) of at most 8,192 positions. It reads its run once with
//     coalesced loads into shared memory as order-preserving uint32 keys
//     (-inf and NaN map to 0, below every gain, and are never taken), finds
//     the k-th largest key T by radix select (four 8-bit passes of a
//     shared-memory histogram and a block-wide scan), takes every key > T
//     and then the keys == T in ascending position (ballots and a scan over
//     warps that own contiguous ranges, so ties go to the lower position),
//     and ranks the <= k winners by counting: a winner's slot is the number
//     of winners with a larger (key, -position). No serial insertion. A row
//     that fits one run needs no merge: one launch. Runs of a row cut into
//     splits are merged by merge_splits_kernel (topk_merge.cuh).
//   * collect_kernel (long rows, k <= 64: the ivf collect): persistent
//     blocks, 4 an SM, whose warps walk (row, split) items planned as whole
//     waves of the resident warps; 16-byte loads, 8 a lane in flight (128
//     KB an SM); each round of 1,024 values is held against the list's k-th
//     best with one __any_sync and the few that pass go to the warp's buffer
//     by ballot, merged into its list by rank (topk_merge.cuh merge_buffer);
//     the warp that finishes a row's last split merges the row's split lists
//     in the same launch (a counter a row in device memory, after a fence),
//     so the path is one launch. It replaced the first design's warp path (a
//     warp a (row, split), 4-byte loads, serial inserts, a merge launch).
//
// The select path takes k <= 160, the collect k <= 64. A
// deeper list (any k <= M, as the TPU kernel takes) goes through
// deep_topk.cuh: runs of at most 8,192 positions selected and sorted in
// shared memory, one launch for a row of one run (the probed collect at k' =
// 256), else the runs' sorted lists merged in pairs and written out
// (stream_topk_deep_launch).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py kernels,
// torch.profiler device time): the probed collect 0.014 ms (the first
// design's serial inserts took 0.27 to 0.31 ms by CUDA events), about 5x its
// byte bound and under a few launch latencies; the ivf collect 0.11 ms on
// the collect, 72% of its 0.080 ms bound (0.16 on the warp path it replaced:
// 1 KB in flight a warp, a second wave a fifth full and a second launch to
// merge the splits); torch.amax reads the same gains in 0.095 ms.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "deep_topk.cuh"
#include "topk_merge.cuh"

namespace {

using topk::FULL;
using topk::merge_buffer;
using topk::neg_inf;

// ---- the collect path: persistent warps, 16-byte loads, one launch ----

constexpr int C_WARPS = 8;                 // warps a block
constexpr int C_THREADS = C_WARPS * 32;
constexpr int C_BLOCKS_PER_SM = 4;         // resident: 64 registers a thread
constexpr int C_UNROLL = 8;                // 16-byte loads a lane has in flight
constexpr int C_CAP = 32;                  // a warp's candidate buffer

// A warp's running list (rg, ri: K slots in shared memory) and candidate
// buffer (bg, bi), and the threshold a value must reach to be a candidate:
// the list's K-th best, at least the lowest finite gain, so -inf and NaN
// never enter.
template <int SLOTS>
struct WarpList {
  float* rg;
  int* ri;
  float* bg;
  int* bi;
  int K, lane, n;
  float thr;

  __device__ __forceinline__ void reset() {
    for (int e = lane; e < K; e += 32) { rg[e] = neg_inf(); ri[e] = 0; }
    n = 0;
    thr = -FLT_MAX;
    __syncwarp();
  }
  __device__ __forceinline__ void flush() {
    if (n == 0) return;
    merge_buffer<SLOTS>(rg, ri, bg, bi, K, n, lane);
    n = 0;
    thr = fmaxf(rg[K - 1], -FLT_MAX);
  }
  // every lane offers (x, id): those at the threshold go to the buffer,
  // placed by a prefix of the ballot (no atomics); a buffer that could not
  // take them is merged first
  __device__ __forceinline__ void offer(float x, int id) {
    const unsigned m = __ballot_sync(FULL, x >= thr);
    if (!m) return;
    const int c = __popc(m);
    if (n + c > C_CAP) flush();
    if ((m >> lane) & 1u) {
      const int at = n + __popc(m & ((1u << lane) - 1u));
      bg[at] = x;
      bi[at] = id;
    }
    n += c;
    __syncwarp();
  }
};

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// A lower bound on the k-th best (k <= 32) of the values a warp holds, each
// lane's max one of them: the k-th largest of the 32 lanes' maxima, which
// are distinct elements (ties ranked by lane); -inf where fewer than k
// lanes hold a finite value.
__device__ __forceinline__ float kth_of_maxima(float mx, int k, int lane) {
  int rank = 0;
  for (int j = 0; j < 32; ++j) {
    const float o = __shfl_sync(FULL, mx, j);
    rank += o > mx || (o == mx && j < lane);
  }
  const unsigned at = __ballot_sync(FULL, rank == k - 1);
  return at ? __shfl_sync(FULL, mx, __ffs(at) - 1) : neg_inf();
}

// Persistent blocks of C_WARPS warps, every warp an independent worker that
// takes the (row, split) items gw, gw + warps, .. (row-major; split s covers
// positions [s * chunk, (s + 1) * chunk)). A warp streams its item with
// C_UNROLL 16-byte loads a lane in flight (its 16-byte aligned body; the at
// most 3 + 3 positions before and after it one a lane), holds each value
// against its list's threshold (raised at the item's first round, for k <=
// 32, to the k-th largest of the lanes' maxima: a bound, so the first
// round does not offer every finite value), one __any_sync a round of
// 1,024 positions when nothing passes; when something does, the round goes to
// the warp's stage in shared memory and each lane offers its passing values
// one a ballot, read back by index (as many ballots as the most a lane
// holds, the values re-tested against a threshold that a merge may have
// raised meanwhile). A row cut into splits is
// finished in the same launch: each warp writes its item's list to part_g /
// part_i [B, splits, K], fences and counts the row in done[row]; the warp
// that counts last merges the row's `splits` lists (its own included, read
// through L2) into out_g / out_i and sets done[row] back to 0, so the
// counters are zero again for the next launch.
template <int SLOTS>
__global__ void __launch_bounds__(C_THREADS, C_BLOCKS_PER_SM) collect_kernel(
    const float* __restrict__ gains, float* __restrict__ part_g,
    int* __restrict__ part_i, float* __restrict__ out_g,
    int* __restrict__ out_i, unsigned* __restrict__ done, int B, int M, int K,
    int splits, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // each warp's stage of a round: 1,024 floats, float4 u of lane l at 32 u + l
  float4* stage = reinterpret_cast<float4*>(smem) + warp * 32 * C_UNROLL;
  WarpList<SLOTS> L;
  unsigned char* lists = smem + C_WARPS * 32 * C_UNROLL * 16;
  L.rg = reinterpret_cast<float*>(lists) + warp * K;
  L.ri = reinterpret_cast<int*>(lists + C_WARPS * K * 4) + warp * K;
  L.bg = reinterpret_cast<float*>(lists + C_WARPS * K * 8) + warp * C_CAP;
  L.bi = reinterpret_cast<int*>(lists + C_WARPS * (K * 8 + C_CAP * 4)) +
         warp * C_CAP;
  L.K = K;
  L.lane = lane;
  const long long items = (long long)B * splits;
  for (long long item = (long long)blockIdx.x * C_WARPS + warp; item < items;
       item += (long long)gridDim.x * C_WARPS) {
    const int row = (int)(item / splits), split = (int)(item % splits);
    const int begin = split * chunk, end = min(begin + chunk, M);
    const float* g = gains + (size_t)row * M;
    L.reset();
    // the body [a0, a1) starts on a 16-byte boundary and holds whole float4s
    const int mis = (int)((reinterpret_cast<uintptr_t>(g + begin) >> 2) & 3);
    const int a0 = min(end, begin + ((4 - mis) & 3));
    const int a1 = a0 + ((end - a0) & ~3);
    {
      int p = -1;
      if (lane < a0 - begin) p = begin + lane;
      else if (lane >= 4 && lane - 4 < end - a1) p = a1 + lane - 4;
      L.offer(p >= 0 ? g[p] : neg_inf(), p);
    }
    for (int p0 = a0; p0 < a1; p0 += 128 * C_UNROLL) {
      float4 v[C_UNROLL];
#pragma unroll
      for (int u = 0; u < C_UNROLL; ++u) {
        const int p = p0 + 128 * u + 4 * lane;
        v[u] = p < a1 ? __ldcs(reinterpret_cast<const float4*>(g + p))
                      : make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
      }
      if (p0 == a0 && K <= 32) {
        float mx = neg_inf();
#pragma unroll
        for (int u = 0; u < C_UNROLL; ++u)
          mx = fmaxf(mx, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
        L.thr = fmaxf(L.thr, kth_of_maxima(mx, K, lane));
      }
      unsigned mask = 0;
#pragma unroll
      for (int u = 0; u < C_UNROLL; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mask |= (comp(v[u], c) >= L.thr ? 1u : 0u) << (4 * u + c);
      if (!__any_sync(FULL, mask)) continue;
#pragma unroll
      for (int u = 0; u < C_UNROLL; ++u) stage[32 * u + lane] = v[u];
      __syncwarp();
      const float* st = reinterpret_cast<const float*>(stage);
      while (__any_sync(FULL, mask)) {
        const int q = mask ? __ffs(mask) - 1 : 0;
        const float x = mask ? st[4 * (32 * (q >> 2) + lane) + (q & 3)]
                             : neg_inf();
        mask &= mask - 1;
        L.offer(x, p0 + 128 * (q >> 2) + 4 * lane + (q & 3));
      }
      __syncwarp();   // the stage is read before the next round writes it
    }
    L.flush();
    if (splits == 1) {
      for (int e = lane; e < K; e += 32) {
        out_g[(size_t)row * K + e] = L.rg[e];
        out_i[(size_t)row * K + e] = L.ri[e];
      }
      continue;
    }
    const size_t o = ((size_t)row * splits + split) * K;
    for (int e = lane; e < K; e += 32) {
      part_g[o + e] = L.rg[e];
      part_i[o + e] = L.ri[e];
    }
    __threadfence();
    __syncwarp();
    unsigned last = 0;
    if (lane == 0) {
      __threadfence();
      last = atomicAdd(&done[row], 1u) == (unsigned)(splits - 1);
    }
    if (!__shfl_sync(FULL, last, 0)) continue;
    // the row's last warp: every split's list into an empty one, at a
    // threshold of the best of the splits' k-th bests (each split holds k
    // gains at least that large, so the row's k-th best is too)
    __threadfence();
    L.reset();
    const float* pg = part_g + (size_t)row * splits * K;
    const int* pi = part_i + (size_t)row * splits * K;
    float kth = neg_inf();
    for (int sp = lane; sp < splits; sp += 32)
      kth = fmaxf(kth, __ldcg(pg + (size_t)sp * K + K - 1));
#pragma unroll
    for (int off = 16; off; off >>= 1)
      kth = fmaxf(kth, __shfl_xor_sync(FULL, kth, off));
    L.thr = fmaxf(L.thr, kth);
    const int entries = splits * K;
    for (int e0 = 0; e0 < entries; e0 += 32 * C_UNROLL) {
      float x[C_UNROLL];
      int id[C_UNROLL];
#pragma unroll
      for (int u = 0; u < C_UNROLL; ++u) {
        const int e = e0 + 32 * u + lane;
        x[u] = e < entries ? __ldcg(pg + e) : neg_inf();
        id[u] = e < entries ? __ldcg(pi + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < C_UNROLL; ++u) L.offer(x[u], id[u]);
    }
    L.flush();
    for (int e = lane; e < K; e += 32) {
      out_g[(size_t)row * K + e] = L.rg[e];
      out_i[(size_t)row * K + e] = L.ri[e];
    }
    if (lane == 0) done[row] = 0;
  }
}

// ---- the select path: radix select over one run held in shared memory ----

constexpr int SEL_THREADS = deep::THREADS;  // == RADIX: one histogram bin a thread
constexpr int SEL_CHUNK_MAX = deep::RUN_MAX;  // keys of one run: 32 KB of shared memory

// One block a (row, split): grid B * splits. Writes the run's sorted list of
// K <= KMAX to out_g / out_i at ((row * splits + split) * K), padded with
// (-inf, 0). The radix select and the collection are deep_topk.cuh's; the
// <= KMAX winners are ranked by counting.
__global__ void __launch_bounds__(SEL_THREADS) select_topk_kernel(
    const float* __restrict__ gains, float* __restrict__ out_g,
    int* __restrict__ out_i, int M, int K, int splits, int chunk) {
  extern __shared__ __align__(16) uint32_t keys[];  // [chunk]
  __shared__ deep::SelectShared sh;
  __shared__ unsigned long long cand[topk::KMAX];
  const int tid = threadIdx.x;
  const int row = blockIdx.x / splits, split = blockIdx.x % splits;
  const int begin = split * chunk;
  const int n = min(chunk, M - begin);
  const float* g = gains + (size_t)row * M + begin;

  sh.hist[tid] = 0;
  __syncthreads();
  for (int e = tid; e < n; e += SEL_THREADS) {
    const uint32_t key = deep::order_key(g[e]);
    keys[e] = key;
    atomicAdd(&sh.hist[key >> 24], 1);
  }
  __syncthreads();
  int need;
  const uint32_t T = deep::radix_select(keys, n, min(K, n), sh, need);
  // keys == T to take, lowest position first
  const int count = deep::collect(keys, n, T, T ? need : 0, begin, cand, sh);

  // a winner's slot is the number of winners ahead of it: (key, -position)
  // pairs are distinct, so the slots are a permutation of [0, count)
  const size_t o = ((size_t)row * splits + split) * K;
  if (tid < count) {
    const unsigned long long mine = cand[tid];
    int slot = 0;
    for (int j = 0; j < count; ++j) slot += cand[j] > mine;
    const int pos = (int)~(uint32_t)mine;
    out_g[o + slot] = g[pos - begin];
    out_i[o + slot] = pos;
  } else if (tid < K) {
    out_g[o + tid] = neg_inf();
    out_i[o + tid] = 0;
  }
}

}  // namespace

// The select path on `stream`. gains is [B, M] f32 contiguous; out_g / out_i
// are [B, K] f32 / i32; part_g / part_i are [B, splits, K] f32 / i32
// scratch, used when splits > 1. Split s covers positions [s * chunk, (s +
// 1) * chunk), chunk <= 8,192. Returns the CUDA error code of the launches
// (0 on success).
extern "C" int stream_topk_launch(const void* gains, void* part_g, void* part_i,
                                  void* out_g, void* out_i, int B, int M, int K,
                                  int splits, int chunk, void* stream) {
  if (B < 1 || M < 1 || K < 1 || K > topk::KMAX || splits < 1 ||
      chunk < 1 || (long long)splits * chunk < M ||
      (long long)(splits - 1) * chunk >= M || chunk > SEL_CHUNK_MAX ||
      (long long)B * splits > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gains);
  float* og = static_cast<float*>(splits > 1 ? part_g : out_g);
  int* oi = static_cast<int*>(splits > 1 ? part_i : out_i);
  select_topk_kernel<<<B * splits, SEL_THREADS, chunk * sizeof(uint32_t), st>>>(
      g, og, oi, M, K, splits, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  topk::merge_splits_kernel<int>
      <<<B, topk::MERGE_THREADS, splits * (int)sizeof(int), st>>>(
          static_cast<const float*>(part_g), static_cast<const int*>(part_i),
          static_cast<float*>(out_g), static_cast<int*>(out_i), splits, K);
  return (int)cudaGetLastError();
}

// The collect path (long rows, K <= KSHALLOW): collect_kernel on `grid`
// persistent blocks (at most C_BLOCKS_PER_SM an SM: ops/stream_topk.py::
// plan). gains is [B, M] f32 contiguous (4-byte aligned), out_g / out_i
// [B, K] f32 / i32; part_g / part_i [B, splits, K] f32 / i32 scratch and
// done [B] u32 counters, zero on entry and left zero, both used when
// splits > 1. Split s covers positions [s * chunk, (s + 1) * chunk). One
// launch: the rows' split lists are merged in it. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int stream_topk_collect_launch(const void* gains, void* part_g,
                                          void* part_i, void* out_g,
                                          void* out_i, void* done, int B,
                                          int M, int K, int splits, int chunk,
                                          int grid, void* stream) {
  if (B < 1 || M < 1 || K < 1 || K > topk::KSHALLOW || splits < 1 ||
      chunk < 1 || (long long)splits * chunk < M ||
      (long long)(splits - 1) * chunk >= M || grid < 1 ||
      reinterpret_cast<uintptr_t>(gains) % 4 ||
      (splits > 1 && (part_g == nullptr || part_i == nullptr ||
                      done == nullptr)))
    return (int)cudaErrorInvalidValue;
  collect_kernel<topk::SLOTS_SHALLOW>
      <<<grid, C_THREADS, C_WARPS * (32 * C_UNROLL * 16 + (K + C_CAP) * 8),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(gains), static_cast<float*>(part_g),
          static_cast<int*>(part_i), static_cast<float*>(out_g),
          static_cast<int*>(out_i), static_cast<unsigned*>(done), B, M, K,
          splits, chunk);
  return (int)cudaGetLastError();
}

// Deep lists: any K <= M (the shallow launch above stops at KMAX). Rows go in
// slices of slice_rows. A row of one run (M <= run) is one select launch that
// writes the outputs; a longer row is cut into runs of `run` positions whose
// sorted lists merge in pairs (deep_topk.cuh), and the last list is written
// out with the stored gains. ws_a / ws_b hold slice_rows x list_entries words
// and dst slice_rows x K (ops/deep_topk.py); all three are unused (null) for
// one run. Returns 0, or deep::fail's code of the step that failed.
extern "C" int stream_topk_deep_launch(const void* gains, void* ws_a, void* ws_b,
                                       void* dst, void* out_g, void* out_i, int B,
                                       int M, int K, int run, int slice_rows,
                                       void* stream) {
  const int splits = (M + run - 1) / run;
  if (B < 1 || M < 1 || K < 1 || K > M || run < 1 || run > deep::RUN_MAX ||
      slice_rows < 1 ||
      (splits > 1 && (ws_a == nullptr || ws_b == nullptr || dst == nullptr)))
    return deep::fail(deep::STEP_ARGS, cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kr = min(K, run);
  for (int r0 = 0; r0 < B; r0 += slice_rows) {
    const int rows = min(slice_rows, B - r0);
    const float* g = static_cast<const float*>(gains) + (size_t)r0 * M;
    float* og = static_cast<float*>(out_g) + (size_t)r0 * K;
    int* oi = static_cast<int*>(out_i) + (size_t)r0 * K;
    if (splits == 1) {
      const int smem = deep::select_smem(M, K);
      cudaError_t err = deep::select_attr<true, int>(smem);
      if (err != cudaSuccess) return deep::fail(deep::STEP_SELECT_ATTR, err);
      deep::select_sort_kernel<true, int><<<rows, deep::THREADS, smem, st>>>(
          g, M, M, M, 1, K, 0, nullptr, 0, og, oi, nullptr, 0, 0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return deep::fail(deep::STEP_SELECT, err);
      continue;
    }
    auto* d = static_cast<deep::u64*>(dst);
    int len = 0;
    const int code = deep::reduce_rows(g, M, rows, M, run, kr, K, 0,
                                       static_cast<deep::u64*>(ws_a),
                                       static_cast<deep::u64*>(ws_b), d, K, &len,
                                       nullptr, 0, 0, st);
    if (code) return code;
    const cudaError_t err =
        deep::emit<int>(d, K, len, g, M, og, oi, K, rows, nullptr, 0, 0, st);
    if (err != cudaSuccess) return deep::fail(deep::STEP_EMIT, err);
  }
  return 0;
}

