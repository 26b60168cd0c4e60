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
// hundreds of inserts a warp, one at a time. Two paths now, chosen by the
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
//     that fits one run needs no merge: one launch.
//   * stream_partial_kernel (long rows, k <= 64: the ivf collect): a warp
//     owns one (row, split) and streams its range in ascending position,
//     UNROLL coalesced 128-byte loads in flight; each 32-wide group is held
//     against the list's k-th best with one ballot, and the few values that
//     pass are inserted after equal gains (topk_merge.cuh). Past the first
//     tiles almost nothing passes, so the loads bound it.
//
// Runs of a row that is cut into splits are merged by merge_splits_kernel
// (topk_merge.cuh) under the same order. Both paths take k <= 160. A deeper
// list (any k <= M, as the TPU kernel takes) goes through deep_topk.cuh:
// runs of at most 8,192 positions selected and sorted in shared memory, one
// launch for a row of one run (the probed collect at k' = 256), else the
// runs' sorted lists merged in pairs and written out (stream_topk_deep_launch).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py kernels,
// torch.profiler device time): the probed collect 0.014 ms (the first
// design's serial inserts took 0.27 to 0.31 ms by CUDA events), about 5x its
// byte bound and under a few launch latencies; the ivf collect 0.16 ms on
// the warp path (twice its bound; the ballot rejects almost every value).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deep_topk.cuh"
#include "topk_merge.cuh"

namespace {

using topk::FULL;
using topk::neg_inf;

constexpr int WARPS = 4;  // (row, split) pairs per block
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 8;  // 32-wide groups loaded before any is folded

template <int SLOTS>
__global__ void __launch_bounds__(THREADS) stream_partial_kernel(
    const float* __restrict__ gains, float* __restrict__ part_g,
    int* __restrict__ part_i, int B, int M, int K, int splits, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  const int split = blockIdx.y;
  if (row >= B) return;  // warp-uniform; no block-wide barrier below
  float* rg = reinterpret_cast<float*>(smem) + warp * K;
  int* ri = reinterpret_cast<int*>(smem + WARPS * K * 4) + warp * K;
  for (int e = lane; e < K; e += 32) { rg[e] = neg_inf(); ri[e] = 0; }
  __syncwarp();

  const float* g = gains + (size_t)row * M;
  const int begin = split * chunk;
  const int end = min(begin + chunk, M);
  float thr = neg_inf();
  for (int p0 = begin; p0 < end; p0 += 32 * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + 32 * u + lane;
      v[u] = p < end ? g[p] : neg_inf();
    }
    // groups in ascending position: u, then lane
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      topk::warp_fold<SLOTS>(rg, ri, K, v[u], p0 + 32 * u, lane, thr);
  }
  const size_t o = ((size_t)row * splits + split) * K;
  for (int e = lane; e < K; e += 32) { part_g[o + e] = rg[e]; part_i[o + e] = ri[e]; }
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

// Launch on `stream`. gains is [B, M] f32 contiguous; out_g / out_i are
// [B, K] f32 / i32; part_g / part_i are [B, splits, K] f32 / i32 scratch,
// used when splits > 1. Split s covers positions [s * chunk, (s + 1) *
// chunk). path 0 is the warp-streaming kernel (any chunk), path 1 the
// select kernel (chunk <= 8,192). Returns the CUDA error code of the
// launches (0 on success).
extern "C" int stream_topk_launch(const void* gains, void* part_g, void* part_i,
                                  void* out_g, void* out_i, int B, int M, int K,
                                  int splits, int chunk, int path, void* stream) {
  if (B < 1 || M < 1 || K < 1 || K > topk::KMAX || splits < 1 ||
      chunk < 1 || (long long)splits * chunk < M ||
      (long long)(splits - 1) * chunk >= M || (path != 0 && path != 1) ||
      (path == 0 && splits > 65535) ||
      (path == 1 && (chunk > SEL_CHUNK_MAX || (long long)B * splits > INT32_MAX)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gains);
  float* og = static_cast<float*>(splits > 1 ? part_g : out_g);
  int* oi = static_cast<int*>(splits > 1 ? part_i : out_i);
  if (path == 1) {
    select_topk_kernel<<<B * splits, SEL_THREADS, chunk * sizeof(uint32_t), st>>>(
        g, og, oi, M, K, splits, chunk);
  } else {
    const dim3 grid((B + WARPS - 1) / WARPS, splits);
    if (K <= topk::KSHALLOW)
      stream_partial_kernel<topk::SLOTS_SHALLOW>
          <<<grid, THREADS, WARPS * K * 8, st>>>(g, og, oi, B, M, K, splits, chunk);
    else
      stream_partial_kernel<topk::SLOTS_DEEP>
          <<<grid, THREADS, WARPS * K * 8, st>>>(g, og, oi, B, M, K, splits, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  topk::merge_splits_kernel<int>
      <<<B, topk::MERGE_THREADS, splits * (int)sizeof(int), st>>>(
          static_cast<const float*>(part_g), static_cast<const int*>(part_i),
          static_cast<float*>(out_g), static_cast<int*>(out_i), splits, K);
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

