// Exact streaming top-k over a stored gain matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/pallas_topk.py::pallas_stream_topk
// (body _stream_kernel, merge _merge_gains_tile). For gains [B, M] f32 it
// returns, per row, the k best (gain, position) ordered by gain descending,
// then position ascending; -inf (and NaN) entries never enter a list, and a
// list slot nothing filled comes back as (-inf, 0). The cluster-probed search
// uses it to collect each query's winners from its gathered [B, P * S] gains.
//
// Design (simple first, fast later):
//   * stream_partial_kernel: a warp owns one (row, split) pair and streams
//     its contiguous range of the row in ascending position, UNROLL
//     coalesced 128-byte loads in flight. Each 32-wide group is held against
//     the list's k-th best with one ballot; the few values that can enter
//     are inserted after equal gains (topk_merge.cuh), so ties keep the lower
//     position. The sorted list lives in shared memory, K * 8 bytes a warp.
//     M is cut into splits so that B = 8 fills the card as B = 512 does.
//   * merge_splits_kernel (topk_merge.cuh): one block per row merges the
//     per-split lists under the same order.
//
// What bounds it on an H100 SXM: bytes. The function reads B * M * 4 bytes
// once and does no arithmetic to speak of: 268 MB at B = 512, M = 131,072
// is 0.08 ms at 3.35 TB/s. The design streams each byte once with
// coalesced loads and keeps the lists out of device memory; the insertion
// path is serial per warp and is what a later version has to shorten when
// many values beat the threshold (the first tiles of every split).

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// Launch both kernels on `stream`. gains is [B, M] f32 contiguous; part_g /
// part_i are [B, splits, K] f32 / i32 scratch; out_g / out_i are [B, K]
// f32 / i32. Split s covers positions [s * chunk, (s + 1) * chunk). Returns
// the CUDA error code of the launches (0 on success).
extern "C" int stream_topk_launch(const void* gains, void* part_g, void* part_i,
                                  void* out_g, void* out_i, int B, int M, int K,
                                  int splits, int chunk, void* stream) {
  if (B < 1 || M < 1 || K < 1 || K > topk::KMAX || splits < 1 ||
      splits > 65535 || chunk < 1 || (long long)splits * chunk < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pg = static_cast<float*>(part_g);
  int* pi = static_cast<int*>(part_i);
  const dim3 grid((B + WARPS - 1) / WARPS, splits);
  const float* g = static_cast<const float*>(gains);
  if (K <= topk::KSHALLOW)
    stream_partial_kernel<topk::SLOTS_SHALLOW>
        <<<grid, THREADS, WARPS * K * 8, st>>>(g, pg, pi, B, M, K, splits, chunk);
  else
    stream_partial_kernel<topk::SLOTS_DEEP>
        <<<grid, THREADS, WARPS * K * 8, st>>>(g, pg, pi, B, M, K, splits, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk::merge_splits_kernel<int>
      <<<B, topk::MERGE_THREADS, splits * (int)sizeof(int), st>>>(
          pg, pi, static_cast<float*>(out_g), static_cast<int*>(out_i), splits, K);
  return (int)cudaGetLastError();
}
