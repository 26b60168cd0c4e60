// Fused shard scoring + exact streaming top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/pallas_topk.py::pallas_topk
// (body _topk_kernel, merge _merge_gains_tile). For queries q [B, D] and a
// document shard docs [N, D] it returns, per query row, the k best
//
//     gain[b, n] = (q[b] . docs[n]) * scale[n] + bias[n]
//
// ordered by (gain descending, doc index ascending): among equal gains the
// lower doc index wins, as in a FAISS flat index. The [B, N] gain matrix
// never reaches device memory. q is f32 for f32 docs and bf16 for bf16,
// int8 and int4 docs; products accumulate in f32. scale and bias may be
// null. int4 docs are [N, D/2] bytes, two codes each: byte j holds dim j in
// its low nibble and dim j + D/2 in its high nibble. Their scale is per doc
// ([N], applied to the gain like int8's) or per (doc, group) ([N, G]): then
// each D/G slice of the unpacked row is multiplied by its scale, both
// rounded to bf16, before the product, and no scale touches the gain.
//
// Design (simple first, fast later):
//   * partial_topk_kernel: grid (query tiles of 64) x (doc splits). A block
//     streams its split's 64-doc tiles in ascending doc order. Per tile it
//     builds the [64 x 64] gain tile in shared memory (bf16/int8: WMMA
//     m16n16k16 on the tensor cores, int8 converted to bf16 exactly on the
//     load; f32: plain FMA, full f32) and folds it into a running sorted
//     top-k list per query row kept in shared memory. A warp owns a row:
//     one ballot against the row's k-th best finds the few candidates that
//     can enter, and each is inserted after equal gains, so ties keep the
//     lower doc index. Splits let B = 8 fill the 132 SMs as well as B = 512.
//     k goes up to 160 with the query tile kept at 64 rows: the lists then
//     take 64 * 160 * 8 B = 80 KB of dynamic shared memory beside the
//     tiles, which the launch asks for with
//     cudaFuncAttributeMaxDynamicSharedMemorySize. During an insert a lane
//     holds 2 list entries (k <= 64, the serving depths) or 5 (deeper): a
//     template argument, so the shallow code pays nothing for the deep one.
//     Every split fills its own lists by serial inserts, which dominates at
//     deep k: the wrapper then asks for fewer, longer splits.
//   * merge_splits_kernel (topk_merge.cuh): one block per query row merges
//     the per-split sorted lists into [B, k] under the same order.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W limit): at
// B = 512, D = 768, bf16, one batch reads ~1.1 GB of docs for ~0.58 TFLOP,
// ~510 FLOP per byte, above the card's bf16 ridge of ~295 FLOP per byte
// (989 TFLOP/s over 3.35 TB/s): the kernel is compute-bound once the
// product runs on tensor cores. This design does nothing about that yet:
// WMMA from shared memory, no cp.async or TMA pipelining, no wgmma, and the
// query tile is re-read per doc tile. At B = 8 the same shard is read for
// 64x less work and the bound is the ~0.33 ms it takes to read the docs
// once at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using namespace nvcuda;
using topk::FULL;
using topk::neg_inf;

constexpr int TQ = 64;        // query rows per block
constexpr int TD = 64;        // docs per tile
constexpr int BK = 64;        // contraction chunk (elements)
constexpr int THREADS = 128;  // four warps
constexpr int WARPS = THREADS / 32;
constexpr int LDB = BK + 8;   // bf16 tile row stride: 16-byte aligned rows
constexpr int LDF = BK + 1;   // f32 tile row stride: odd, conflict-free
constexpr int LDG = TD + 4;   // gain tile row stride (floats)

// kI4: packed nibbles, scale (if any) per doc; kI4G: packed nibbles with
// per-(doc, group) scales folded in before the product
enum DocType { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3, kI4G = 4 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__host__ __device__ constexpr int tile_region_bytes(int doc_type) {
  // operand tiles (q chunk + doc chunk) share one region with the gain
  // tile: the gains are written only after the last chunk is consumed
  return (doc_type == kF32 ? 2 * TQ * LDF * 4 : 2 * TQ * LDB * 2) > TQ * LDG * 4
             ? (doc_type == kF32 ? 2 * TQ * LDF * 4 : 2 * TQ * LDB * 2)
             : TQ * LDG * 4;
}

// ---- gain tile: bf16 / int8 docs on the tensor cores ----------------------

template <int DT>
__device__ __forceinline__ void load_tiles_bf16(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ docs,
    const float* __restrict__ gscale, int G, __nv_bfloat16* sq,
    __nv_bfloat16* sd, int B, int N, int D, int q0, int j0, int k0, int tid) {
  constexpr int VPR = BK / 8;  // 8-element vectors per tile row
  for (int v = tid; v < TQ * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    const int row = q0 + r, col = k0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < B && col < D)
      val = *reinterpret_cast<const uint4*>(q + (size_t)row * D + col);
    *reinterpret_cast<uint4*>(sq + r * LDB + c) = val;
  }
  for (int v = tid; v < TD * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    const int row = j0 + r, col = k0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < N && col < D) {
      if constexpr (DT == kBF16) {
        val = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(docs) + (size_t)row * D + col);
      } else if constexpr (DT == kI8) {
        // int8 codes in [-127, 127] are exact in bf16
        const uint2 raw = *reinterpret_cast<const uint2*>(
            static_cast<const int8_t*>(docs) + (size_t)row * D + col);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = pack_bf16((float)b[2 * e], (float)b[2 * e + 1]);
        val = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        // packed nibbles: D/2 is a multiple of 8, so the 8 dims of this
        // vector sit in one half of the row: the low nibbles of bytes
        // col.. (col < D/2) or the high nibbles of bytes col - D/2..
        const int h = D >> 1;
        const bool high = col >= h;
        const uint2 raw = *reinterpret_cast<const uint2*>(
            static_cast<const int8_t*>(docs) + (size_t)row * h +
            (high ? col - h : col));
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        float sc = 1.0f;
        if constexpr (DT == kI4G) {
          // the group's scale, rounded to bf16 as the product's operand
          sc = __bfloat162float(__float2bfloat16_rn(
              gscale[(size_t)row * G + col / (D / G)]));
        }
        float c[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int x = b[e];
          // arithmetic shifts sign-extend either nibble
          c[e] = (float)(high ? (x >> 4) : ((int)((unsigned)x << 28) >> 28)) * sc;
        }
        val = make_uint4(pack_bf16(c[0], c[1]), pack_bf16(c[2], c[3]),
                         pack_bf16(c[4], c[5]), pack_bf16(c[6], c[7]));
      }
    }
    *reinterpret_cast<uint4*>(sd + r * LDB + c) = val;
  }
}

template <int DT>
__device__ __forceinline__ void gain_tile_wmma(
    const void* __restrict__ q, const void* __restrict__ docs,
    const float* __restrict__ gscale, int G, unsigned char* smem, float* sg,
    int B, int N, int D, int q0, int j0, int tid, int warp) {
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sd = sq + TQ * LDB;
  const int wr = warp >> 1, wc = warp & 1;  // warp tile: 32 rows x 32 docs
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k0 = 0; k0 < D; k0 += BK) {
    load_tiles_bf16<DT>(static_cast<const __nv_bfloat16*>(q), docs, gscale, G,
                        sq, sd, B, N, D, q0, j0, k0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sq + (wr * 32 + i * 16) * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sd + (wc * 32 + j * 16) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sg + (wr * 32 + i * 16) * LDG + wc * 32 + j * 16,
                              acc[i][j], LDG, wmma::mem_row_major);
  __syncthreads();
}

// ---- gain tile: f32 docs, full f32 FMA -------------------------------------

__device__ __forceinline__ void gain_tile_f32(
    const float* __restrict__ q, const float* __restrict__ docs,
    unsigned char* smem, float* sg, int B, int N, int D, int q0, int j0,
    int tid) {
  float* sq = reinterpret_cast<float*>(smem);
  float* sd = sq + TQ * LDF;
  const int tr = tid >> 4, tc = tid & 15;  // rows tr*8..+8, docs tc+16*j
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  constexpr int VPR = BK / 4;  // float4 vectors per tile row
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int v = tid; v < TQ * VPR; v += THREADS) {
      const int r = v / VPR, c = (v % VPR) * 4;
      const int qrow = q0 + r, drow = j0 + r, col = k0 + c;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (qrow < B && col < D)
        a = *reinterpret_cast<const float4*>(q + (size_t)qrow * D + col);
      if (drow < N && col < D)
        b = *reinterpret_cast<const float4*>(docs + (size_t)drow * D + col);
      float* pa = sq + r * LDF + c;
      float* pb = sd + r * LDF + c;
      pa[0] = a.x; pa[1] = a.y; pa[2] = a.z; pa[3] = a.w;
      pb[0] = b.x; pb[1] = b.y; pb[2] = b.z; pb[3] = b.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sq[(tr * 8 + i) * LDF + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sd[(tc + 16 * j) * LDF + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sg[(tr * 8 + i) * LDG + tc + 16 * j] = acc[i][j];
  __syncthreads();
}

// ---- running top-k ----------------------------------------------------------

template <int DT, int SLOTS>
__global__ void __launch_bounds__(THREADS) partial_topk_kernel(
    const void* __restrict__ q, const void* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    float* __restrict__ part_g, int* __restrict__ part_i, int B, int N, int D,
    int K, int G, int splits, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int n_tiles = (N + TD - 1) / TD;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  constexpr int region = tile_region_bytes(DT);
  float* sg = reinterpret_cast<float*>(smem);
  float* run_g = reinterpret_cast<float*>(smem + region);
  int* run_i = reinterpret_cast<int*>(smem + region + TQ * K * 4);

  for (int e = tid; e < TQ * K; e += THREADS) {
    run_g[e] = neg_inf();
    run_i[e] = 0;
  }

  for (int t = tile_begin; t < tile_end; ++t) {
    const int j0 = t * TD;
    if constexpr (DT == kF32)
      gain_tile_f32(static_cast<const float*>(q), static_cast<const float*>(docs),
                    smem, sg, B, N, D, q0, j0, tid);
    else
      gain_tile_wmma<DT>(q, docs, scale, G, smem, sg, B, N, D, q0, j0, tid, warp);

    for (int r = warp; r < TQ; r += WARPS) {
      if (q0 + r >= B) break;  // warp-uniform; later rows are out too
      float* rg = run_g + r * K;
      int* ri = run_i + r * K;
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, j = j0 + c;
        float x = neg_inf();
        if (j < N) {
          x = sg[r * LDG + c];
          // separate roundings, as the plain version computes them
          if (DT != kI4G && scale) x = __fmul_rn(x, scale[j]);
          if (bias) x = __fadd_rn(x, bias[j]);
        }
        v[h] = x;
      }
      float thr = rg[K - 1];
      // candidates in ascending doc order: lanes of half 0, then half 1
#pragma unroll
      for (int h = 0; h < 2; ++h)
        topk::warp_fold<SLOTS>(rg, ri, K, v[h], j0 + 32 * h, lane, thr);
    }
    __syncthreads();  // the next tile's loads overwrite the gain tile
  }
  __syncthreads();

  for (int e = tid; e < TQ * K; e += THREADS) {
    const int r = e / K, c = e - r * K;
    const int row = q0 + r;
    if (row < B) {
      const size_t o = ((size_t)row * splits + split) * K + c;
      part_g[o] = run_g[e];
      part_i[o] = run_i[e];
    }
  }
}

// ---- launch ------------------------------------------------------------------

template <int DT, int SLOTS>
cudaError_t launch_slots(const void* q, const void* docs, const float* bias,
                         const float* scale, float* part_g, int* part_i, int B,
                         int N, int D, int K, int G, int splits,
                         int tiles_per_split, cudaStream_t stream) {
  const int smem = tile_region_bytes(DT) + TQ * K * 8;
  cudaError_t err = cudaFuncSetAttribute(
      partial_topk_kernel<DT, SLOTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + TQ - 1) / TQ, splits);
  partial_topk_kernel<DT, SLOTS><<<grid, THREADS, smem, stream>>>(
      q, docs, bias, scale, part_g, part_i, B, N, D, K, G, splits,
      tiles_per_split);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_partial(const void* q, const void* docs, const float* bias,
                           const float* scale, float* part_g, int* part_i, int B,
                           int N, int D, int K, int G, int splits,
                           int tiles_per_split, cudaStream_t stream) {
  if (K <= topk::KSHALLOW)
    return launch_slots<DT, topk::SLOTS_SHALLOW>(
        q, docs, bias, scale, part_g, part_i, B, N, D, K, G, splits,
        tiles_per_split, stream);
  return launch_slots<DT, topk::SLOTS_DEEP>(
      q, docs, bias, scale, part_g, part_i, B, N, D, K, G, splits,
      tiles_per_split, stream);
}

}  // namespace

// Launch both kernels on `stream`. part_g / part_i are [B, splits, K] f32 /
// i32 scratch, out_g / out_i are [B, K] f32 / i64. bias is [N] f32 or null;
// scale is [N] f32, or [N, G] f32 for doc_type kI4G, or null. docs is
// [N, D] (f32 / bf16 / int8) or [N, D/2] bytes (kI4, kI4G). Returns the CUDA
// error code of the launches (0 on success).
extern "C" int fused_topk_launch(const void* q, const void* docs,
                                 const void* bias, const void* scale,
                                 void* part_g, void* part_i, void* out_g,
                                 void* out_i, int B, int N, int D, int K,
                                 int G, int splits, int tiles_per_split,
                                 int doc_type, void* stream) {
  if (B < 1 || N < 1 || D < 16 || D % 16 != 0 || K < 1 || K > topk::KMAX ||
      splits < 1 || splits > 65535 || tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  if (doc_type == kI4G && (scale == nullptr || G < 1 || D % G != 0 ||
                           (D / G) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(scale);
  float* pg = static_cast<float*>(part_g);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
#define RAGROUTE_LAUNCH(DT)                                                  \
  err = launch_partial<DT>(q, docs, b, s, pg, pi, B, N, D, K, G, splits,     \
                           tiles_per_split, st)
  switch (doc_type) {
    case kF32: RAGROUTE_LAUNCH(kF32); break;
    case kBF16: RAGROUTE_LAUNCH(kBF16); break;
    case kI8: RAGROUTE_LAUNCH(kI8); break;
    case kI4: RAGROUTE_LAUNCH(kI4); break;
    case kI4G: RAGROUTE_LAUNCH(kI4G); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAGROUTE_LAUNCH
  if (err != cudaSuccess) return (int)err;
  topk::merge_splits_kernel<long long>
      <<<B, topk::MERGE_THREADS, splits * (int)sizeof(int), st>>>(
          pg, pi, static_cast<float*>(out_g), static_cast<long long*>(out_i),
          splits, K);
  return (int)cudaGetLastError();
}
