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
//     It now takes f32 lists of 65 to 160 and int4 rows off the 16-byte
//     grid; the redesigned routes below take every other shape.
//   * Deeper lists (any k, as the TPU kernel takes; fused_topk_deep_launch,
//     now for f32 docs, int4 rows off the 16-byte grid and lists past the
//     deep fold's FOLD_MAX_K; the fold below takes the rest):
//     64 x k lists do not fit beside the tiles past k = 160, and the serial
//     inserts already dominate at k = 128. So the product leaves the kernel:
//     chunk_gains_kernel writes a chunk of docs' gain tiles, formed and
//     rounded as above, to a workspace in device memory, and deep_topk.cuh
//     cuts every run of 8,192 docs to its best k by radix select and a
//     bitonic sort in shared memory, merges the runs' lists in pairs, and
//     merges the chunk's list into the running list of k. The workspace is
//     sized by ops/deep_topk.py from a stated cap, in chunks of docs and, at
//     large batch and depth, slices of query rows. Its cost is the gains'
//     round trip through device memory: 4 bytes a (query, doc) written and
//     read once, which at B = 512 over 734,003 coarse rows is 1.5 GB.
//
// What bounds it on an H100 SXM (data-sheet peaks at its 700 W limit): at
// B = 512, D = 768, bf16, one batch reads ~1.1 GB of docs for ~0.58 TFLOP,
// ~510 FLOP per byte, above the card's bf16 ridge of ~295 FLOP per byte
// (989 TFLOP/s over 3.35 TB/s): the scan is compute-bound once the product
// runs on tensor cores. At B = 8 the same shard is read for 64x less work
// and the bound is the ~0.33 ms it takes to read the docs once.
//
// bf16, int8 and int4 docs with k <= KSHALLOW take a mainloop for that
// (wgmma_topk_kernel, chosen by ops/fused_topk.py::_plan):
//   * one producer warp keeps a ring of 2 to 4 stages in flight by TMA, each
//     the [128 query rows x 64] and [192 docs x 64] bf16 chunks (128-byte
//     swizzle; zeros past B, D and the valid rows), so no thread copies an
//     operand and the query tile is not re-read through registers;
//   * two consumer warp groups, 64 query rows each, run wgmma m64n192k16
//     from the ring into f32 registers (96 a thread), releasing each stage
//     as soon as its products are done;
//   * the fold stays in registers: each gain gets its scale and bias (the
//     tile's, staged in shared memory under the products; -inf past the
//     valid rows) and one compare with its row's current k-th best, with no
//     branch; only the few that pass go to the row's candidate buffer in
//     shared memory, and a buffer that may not take another step's is
//     merged into the row's sorted list by rank (merge_buffer: a warp ranks
//     up to 32 candidates at once in the lists' full order, gain desc then
//     index asc, so arrival order does not matter); lists past KSHALLOW
//     take the deep fold below (in one consumer group of 64 rows with its
//     lists in shared memory they lost to it, and to the deep launch, at
//     every shard and width measured: PERF.md).
// Grid (query tiles) x (doc splits) with the query tile fastest, so that the
// blocks reading one doc range run together and the docs cross HBM about
// once; what bounds it now is the fold, which the two groups run at the same
// time while the tensor cores wait, and the query chunk's re-read from L2
// for every doc tile.
//
// int8 and int4 docs keep that mainloop and fold; only the doc operand
// changes. The queries are wgmma's A (the fold is per query row, so query
// rows are M) and the docs its B, which is read from shared memory, so the
// codes become bf16 there: TMA brings a [192 docs x 64 bytes] raw box into
// a ring of its own, and the producer group's four warps convert it into
// the stage's bf16 doc tile in the 128-byte swizzle (codes.cuh: an int8
// code under an f32 exponent of 2^23, a nibble ^ 8 under a bf16 exponent of
// 128; both exact), fence it for the tensor cores and arrive on the stage's
// barrier beside the query chunk's TMA bytes. kI4G's scales multiply
// the codes there, both in bf16 and rounded once, as the plain version's
// dequant does; per-doc scales stay in the fold. Choices:
//   * shared memory: the bf16 ring keeps as many stages as fit beside a raw
//     ring of 2 stages of 12 KB, and the raw ring takes what is left
//     (w_smem_bytes: 3 + 2 at k <= 32, the serving depth; 2 + 3 at k = 64).
//     Measured against 2 bf16 stages with 4 raw ones, the third bf16 stage
//     gained more (readings in PERF.md): raw loads are issued the moment a
//     slot is free, so their latency is hidden by the raw ring's depth;
//   * the conversion competes with the fold for issue slots, so the whole
//     producer group converts: the query chunks are loaded by the consumer
//     groups themselves, each its own half as it releases a stage; kI4G's
//     group scales are loaded a chunk ahead, with the two group indices a
//     thread's units share computed once a chunk (an integer division for
//     every unit cost more than the conversion itself, as PERF.md reads);
//   * int4's layout (byte j holds dim j low, dim j + D/2 high): the ring
//     walks the packed row twice, each raw box feeding two chunks in a row,
//     its low nibbles against the query chunk at dims 64 p .. and its high
//     nibbles against the one at D/2 + 64 p .., so every stage pairs one
//     query chunk with one doc chunk as bf16's do and a box is read once;
//   * TMA needs a row stride of a multiple of 16 bytes: D % 16 for int8
//     (always, as the kernel takes it) and D % 32 for int4; other int4
//     widths keep partial_topk_kernel (the plan's choice). f32 docs do not
//     take the tensor cores: TF32 would change answers that the plain
//     version forms in f32 (below).
// The producer group keeps its registers when it converts (no setmaxnreg:
// every thread keeps what the launch bounds give it).
//
// f32 docs with k <= KSHALLOW take f32_topk_kernel (fused_topk_f32_launch,
// ops/fused_topk.py's "f32"): full f32 FMA on the CUDA cores, f32_tile.cuh's
// product over 128 query rows x 128 docs a tile (8 x 8 accumulators a
// thread), the operands' [128 x 32] boxes brought by a producer warp's TMA
// into a ring of 4 to 6 stages, and the fold above (branch-free compares
// with each row's k-th best in registers, candidates to a row's buffer in
// shared memory, merge_buffer by rank, split lists merged by topk_merge.cuh).
// A warp owns 16 rows whole, so it merges their buffers alone, and the
// consumer warps wait on the ring's barriers, not on each other, so one
// warp's fold runs beside the others' products. What bounds it is f32 FMA
// at 67 TFLOP/s (8.6 ms at B = 512 over 734,003 x 768; it runs at about 60%
// of that, PERF.md). f32 lists past KSHALLOW keep partial_topk_kernel to
// KMAX and the deep launch past it.
//
// f32 docs at small batch (ops/fused_topk.py's "f32_small": up to 64 query
// rows, k <= KSHALLOW; f32_scan_pays sets the crossover) take
// f32_small_kernel (fused_topk_f32_small_launch). There the docs are read
// once for little arithmetic (4 FLOP a byte at B = 8), so what bounds it is
// the bytes: 2.255 GB over 734,003 x 768, 0.673 ms at 3.35 TB/s, and from
// about 40 rows the f32 FMA (1.077 ms at B = 64). Its design: a query tile
// sized to the batch (a template argument, TQ = 8, 32 or 64, so the
// batcher's buckets 1, 8 and 32 compute no padded row past their tile);
// [256 docs x 32] boxes and the [TQ x 32] query box by a producer warp's
// TMA into a ring of 4 to 6 stages (128 to 192 KB of docs in flight an SM);
// every consumer warp holds all TQ rows for its docs, so a doc value read
// from shared memory feeds every row; the fold keeps each row's k-th best
// in registers and sends the few passing gains to the row's buffer, merged
// by rank only when a buffer fills (two reducing barriers a tile among the
// consumers: no gain tile in shared memory). One template serves 1 to 64
// rows only at the cost of a 64-row tile's arithmetic at B = 1 and of its
// 8 x 8 register tile, so three instantiations exist (8, 32, 64 rows).
//
// Lists past KSHALLOW over the docs the scan takes go to the same kernel
// with its deep fold (DEEP; fused_topk_fold_launch, ops/fused_topk.py's
// "fold"), which makes no round trip of gains through device memory:
//   * two consumer groups again (128 query rows a block): no list lives in
//     shared memory. Each row keeps a lower bound T on its final k-th best
//     in a register; each gain costs one compare with it, gain >= T (a
//     step's row maxima first: most steps end there);
//   * a gain that passes goes to the row's buffer for its split in device
//     memory (cap words of order_key(gain) << 32 | ~position, 4k or 8k,
//     ops/deep_topk.py::fold_cap), each lane of the row's quad at places of
//     its own (lane t's j-th word at 4 j + t: no counting across lanes, no
//     atomics) by predicated stores, no branch;
//   * a buffer that could not take another step's is cut by its row's
//     warp (fold_cut, in the warp's room in shared memory: a pass for the
//     bytes all words share, then radix passes of a shared-memory
//     histogram) to its k best and up to k / 2 more, and T rises to the
//     least word kept (a buffer of fewer than k words, one lane near its
//     quarter, is only packed, its lanes' shares balanced: no T rises);
//   * T is shared by a row's splits: seed[row] in device memory holds the
//     largest word any of them has shown to have k words at or above it
//     (every cut raises it by a 64-bit atomicMax), and each split reads it
//     at every doc tile. It is seeded before the scan: a block first scans
//     a strided sample of the shard (FoldState::sample_tiles tiles) for
//     the rows it owns (r % splits == split: each row has one owner, a
//     block a few), keeps their finite gains in device memory and publishes
//     each one's k-th best of the sample. A row with fewer than k finite
//     gains there publishes nothing, and T stays at the lowest finite
//     gain. Exact: T never exceeds the k-th best of a subset of the row's
//     docs, which never exceeds its final k-th best; a T from other
//     splits' docs may tie a gain of this split at a lower position, so
//     the compare admits ties (gain >= T), and the lists' order is settled
//     by the words;
//   * after the scan every row's words at or above its shared bound are cut
//     to at most k and sorted by its warp (a bitonic sort in the ring's
//     shared memory, free by then; k <= FOLD_MAX_K), and merged in the
//     same launch into the row's running list in device memory (run, k
//     words): under a lock a row, the entries that beat the running list's
//     last are placed by rank, and the new last is published as the row's
//     bound, so that later splits bring fewer words, most of them none
//     (they take no lock). The split that counts the row last writes it
//     out and leaves its count, lock and bound at zero for the next
//     launch. Each warp takes its 16 rows from a place set by its split,
//     so the splits' merges of one row spread out in time.
// What bounds it (PERF.md): the seed leaves a (row, split) few candidates
// and no cut in the scan; a cut would stall its consumer group at the next
// wgmma and, through the shared ring, the other group. What remains is
// the sample, each row's final cut and sort, and the merges.

#include <cuda_bf16.h>
#include <float.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "codes.cuh"
#include "deep_topk.cuh"
#include "f32_tile.cuh"
#include "hopper.cuh"
#include "topk_merge.cuh"

namespace {

using namespace nvcuda;
using topk::FULL;
using topk::merge_buffer;
using topk::neg_inf;
using topk::precedes;

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

// ---- bf16, int8 and int4 docs: wgmma fed by a TMA ring -------------------

constexpr int WK = 64;            // contraction chunk: 128-byte bf16 rows
constexpr int WTD = 192;          // docs a tile (the wgmma's N)
constexpr int W_STEP = 8;         // accumulators a thread folds a step
constexpr int W_CAP = 32;         // a row's candidate buffer
constexpr int W_MAX_STAGES = 4;
// int8 / int4 docs: the raw ring (TMA boxes of [192 docs x 64 bytes], plain
// row-major; 2 to 4 stages) and the producer group's threads that convert
// it, 6 units of 16 raw bytes a thread a chunk
constexpr int W_MIN_RAW = 2;
constexpr int W_MAX_RAW = 4;
constexpr int W_RAW_BYTES = WTD * 64;
constexpr int W_CONV = 128;
constexpr int W_UNITS = WTD * 4 / W_CONV;
// the deep fold (lists past KSHALLOW): a consumer warp's radix histogram,
// the deepest list it takes (a warp sorts a row's list of up to this many
// in the ring's shared memory after the scan) and the candidate slots a
// row gets past its list, at least
constexpr int W_HIST = 256;
constexpr int FOLD_MAX_K = 1024;
constexpr int FOLD_SLACK = 32;
// a consumer warp's room in shared memory to cut a row's buffer of up to
// W_CUT_WORDS (larger ones are cut in place in device memory), and to hold
// a row's running list while a split's list merges into it
constexpr int W_CUT_WORDS = 1024;
static_assert(FOLD_MAX_K <= W_CUT_WORDS,
              "a buffer of fewer than K words is packed in the cut room");
constexpr int W_BATCH = 8;   // words a lane loads at once in the deep fold

__host__ __device__ constexpr int w_stage_bytes(int nwg) {
  return (64 * nwg + WTD) * WK * 2;
}

// Shared memory of a block of NWG consumer groups (64 query rows each) at
// depth K with `raw` raw stages: the ring (stages of a [64 NWG x 64] query
// chunk and a [192 x 64] bf16 doc chunk, 1024-aligned), the raw stages, the
// rows' lists, candidate buffers and buffer counts, each group's doc tile
// bias and scale (two tiles, in turn), the barriers; plus 1024 bytes to
// align the ring.
__host__ __device__ constexpr int w_smem_bytes(int nwg, int stages, int K,
                                               int raw, bool deep = false) {
  return stages * w_stage_bytes(nwg) + raw * W_RAW_BYTES +
         (deep ? 64 * nwg * 24 + nwg * 4 * (W_HIST * 4 + W_CUT_WORDS * 8)
               : 64 * nwg * ((K + W_CAP) * 8 + 4)) +
         nwg * 4 * WTD * 4 + (2 * stages + raw) * 8 + 1024;
}

// The deep fold's device memory (null for the scan at k <= KSHALLOW): each
// (row, split)'s candidate words cand [B, splits, cap]; each row's sample
// words samp [B, samp_cap] (its owner's candidates from the sample's
// tiles); each row's running list run [B, K] words, its shared lower bound
// seed [B] (a word, 0 for none), its count of finished splits and its lock
// ([B] each; the three are zero on entry and left zero: the lock is 1 while
// held, 2 once the running list holds a split's list); the outputs [B, K];
// the sample's tiles.
struct FoldState {
  deep::u64* cand;
  deep::u64* samp;
  deep::u64* run;
  deep::u64* seed;
  int* count;
  int* lock;
  float* out_g;
  long long* out_i;
  int cap;
  int sample_tiles;
  int samp_cap;
};

// The gain a shared lower bound admits (gain >= it): the word's, or the
// lowest finite gain for none (-inf and NaN never pass).
__device__ __forceinline__ float seed_gain(deep::u64 w) {
  return w ? deep::key_gain((uint32_t)(w >> 32)) : -FLT_MAX;
}

// Raise a row's threshold to t; NaN marks a row that takes nothing (past B,
// or not one the block samples) and stays so.
__device__ __forceinline__ float raise_thr(float thr, float t) {
  return thr != thr ? thr : fmaxf(thr, t);
}

// A row's lock in the deep fold's merge: a compare-and-swap with acquire
// semantics and a release store (the warp's other lanes are ordered behind
// lane 0's by the warp barriers around them).
__device__ __forceinline__ int cas_acquire(int* p, int cmp, int val) {
  int old;
  asm volatile("atom.acquire.gpu.global.cas.b32 %0, [%1], %2, %3;"
               : "=r"(old) : "l"(p), "r"(cmp), "r"(val) : "memory");
  return old;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// A store of w to p where `take` holds, as one predicated instruction (a
// C++ `if` around it compiles to a branch and its convergence barrier).
__device__ __forceinline__ void store_if(deep::u64* p, deep::u64 w,
                                         bool take) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n"
      "@q st.global.u64 [%0], %1;\n}\n" ::"l"(p),
      "l"(w), "r"((unsigned)take)
      : "memory");
}

// How many of the descending words v[0, n) are larger than x.
__device__ __forceinline__ int count_above(const deep::u64* v, int n,
                                           deep::u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Fold step S of a doc tile: the gains x[8] of accumulators 8 S .. + 8
// (u = 4 cc + v: doc 16 S + 8 cc + 2 tig + (v & 1) of the tile, row r0 +
// 8 (v >> 1)) formed as the plain version forms them from the tile's scale
// and bias staged in shared memory (ts, tb: the bias 0 where there is none,
// -inf past N), and the mask of those that reach their row's threshold
// (its k-th best, at least the lowest finite gain). No branch: the step's
// eight gains are independent work for the scheduler.
template <int S, int NACC, bool EARLY>
__device__ __forceinline__ unsigned fold_step(const float (&acc)[NACC],
                                              float (&x)[W_STEP],
                                              const float* tb, const float* ts,
                                              bool has_scale, int tig,
                                              float thr0, float thr1) {
  if constexpr (EARLY) {
    // the deep fold: a step where no lane's row maximum passes (the common
    // case once the bounds have risen) costs the gains, six maxima and two
    // compares; the mask is built only when one does
    fold_step<S, NACC, false>(acc, x, tb, ts, has_scale, tig,
                              __int_as_float(0x7f800000),
                              __int_as_float(0x7f800000));
    const float m0 = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[4], x[5]));
    const float m1 = fmaxf(fmaxf(x[2], x[3]), fmaxf(x[6], x[7]));
    if (!__any_sync(FULL, m0 >= thr0 || m1 >= thr1)) return 0u;
    unsigned m = 0;
#pragma unroll
    for (int u = 0; u < W_STEP; ++u)
      m |= x[u] >= (u & 2 ? thr1 : thr0) ? 1u << u : 0u;
    return m;
  }
  unsigned m = 0;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int jt = 16 * S + 8 * cc + 2 * tig;  // the tile's doc of v = 0, 2
    const float2 bs = *reinterpret_cast<const float2*>(tb + jt);
    float2 sc = make_float2(1.0f, 1.0f);
    if (has_scale) sc = *reinterpret_cast<const float2*>(ts + jt);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const bool odd = v & 1;
      float g = acc[8 * S + 4 * cc + v];
      // separate roundings, as the plain version computes them
      if (has_scale) g = __fmul_rn(g, odd ? sc.y : sc.x);
      g = __fadd_rn(g, odd ? bs.y : bs.x);
      x[4 * cc + v] = g;
      const float t = v & 2 ? thr1 : thr0;
      m |= g >= t ? 1u << (4 * cc + v) : 0u;
    }
  }
  return m;
}

// The deep fold's candidates are 64-bit words, order_key(gain) << 32 |
// ~position (csrc/deep_topk.cuh): larger words come first in the lists'
// order (gain desc, position asc), and no two words of a row are equal.

// One warp cuts a row's candidate words[0, n) (n > K) to its K largest, in
// place at the front, by radix select over the words' bytes from the top: a
// first pass finds the bytes every word shares (from the least and the
// greatest word), then a histogram of 256 bins in shared memory a byte,
// until the bin that holds the K-th word holds at most `slack` words past
// it; every word at or above that bin is kept (K of them with no slack).
// Returns the smallest word kept; `kept` gets their count.
__device__ __forceinline__ deep::u64 fold_cut(deep::u64* words, int n, int K,
                                              int slack, int* hist, int lane,
                                              int& kept) {
  deep::u64 lo = ~0ull, hi = 0ull;
#pragma unroll 4
  for (int e = lane; e < n; e += 32) {
    const deep::u64 w = words[e];
    lo = w < lo ? w : lo;
    hi = w > hi ? w : hi;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const deep::u64 a = __shfl_xor_sync(FULL, lo, off);
    const deep::u64 b = __shfl_xor_sync(FULL, hi, off);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  // the leading bytes all words share (the words are distinct: lo < hi)
  const int common = __clzll(lo ^ hi) >> 3;
  deep::u64 mask = common ? ~0ull << (64 - 8 * common) : 0ull;
  deep::u64 prefix = hi & mask;
  int need = K;
  for (int shift = 56 - 8 * common; shift >= 0; shift -= 8) {
    for (int b = lane; b < W_HIST; b += 32) hist[b] = 0;
    __syncwarp();
#pragma unroll 4
    for (int base = 0; base < n; base += 32) {
      const int e = base + lane;
      const deep::u64 w = e < n ? words[e] : 0ull;
      const bool in = e < n && (w & mask) == prefix;
      if (in) atomicAdd(&hist[(int)(w >> shift) & 255], 1);
    }
    __syncwarp();
    // lane l counts bins 255 - 8 l down to 248 - 8 l; the bin where the
    // count from the top reaches `need` is the next byte
    int c[8], local = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[255 - 8 * lane - j];
      local += c[j];
    }
    int incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    int run = incl - local, digit = -1, above = 0, cnt = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (digit < 0 && run < need && run + c[j] >= need) {
        digit = 255 - 8 * lane - j;
        above = run;
        cnt = c[j];
      }
      run += c[j];
    }
    const int src = __ffs(__ballot_sync(FULL, digit >= 0)) - 1;
    digit = __shfl_sync(FULL, digit, src);
    above = __shfl_sync(FULL, above, src);
    cnt = __shfl_sync(FULL, cnt, src);
    prefix |= (deep::u64)digit << shift;
    mask |= (deep::u64)0xff << shift;
    need -= above;
    __syncwarp();
    if (cnt - need <= slack) break;  // every word of this prefix is kept
  }
  // the kept words are those >= prefix (K of them and at most `slack` more,
  // all distinct)
  const unsigned lt = (1u << lane) - 1u;
  deep::u64 least = ~0ull;
  int out = 0;
#pragma unroll 4
  for (int base = 0; base < n; base += 32) {
    const int e = base + lane;
    const deep::u64 w = e < n ? words[e] : 0ull;
    const bool keep = e < n && w >= prefix;
    const unsigned b = __ballot_sync(FULL, keep);
    if (keep) {  // every lane has read its word: out + rank <= e
      words[out + __popc(b & lt)] = w;
      least = w < least ? w : least;
    }
    out += __popc(b);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const deep::u64 o = __shfl_xor_sync(FULL, least, off);
    least = o < least ? o : least;
  }
  __syncwarp();
  kept = out;
  return least;
}

// One warp sorts v[0, P) descending, P a power of two.
__device__ __forceinline__ void warp_bitonic_desc(deep::u64* v, int P,
                                                  int lane) {
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < P / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool desc = (lo & size) == 0;  // the last merge: all descending
        const deep::u64 a = v[lo], b = v[hi];
        if ((a < b) == desc) { v[lo] = b; v[hi] = a; }
      }
      __syncwarp();
    }
}

// Contraction chunk c of a doc tile: the query columns it pairs with and the
// byte column of the docs' raw box it converts. int8: chunk c is bytes 64 c
// ..; int4: the ring walks the packed row twice, chunk 2 p the low nibbles
// of bytes 64 p .. (dims 64 p ..) and chunk 2 p + 1 their high nibbles (dims
// D/2 + 64 p ..), so a raw box feeds two chunks in a row.
template <int DT>
__device__ __forceinline__ int w_q_col(int c, int D) {
  if constexpr (DT == kI4 || DT == kI4G)
    return (c & 1 ? D / 2 : 0) + (c >> 1) * WK;
  return c * WK;
}

// kI4G: the group scales (as bf16) of a converter thread's units of chunk c
// of the doc tile at j0, unit j taking codes 0..7 and 8..15 of its 16 raw
// bytes; zero where the codes are past the row's bytes (the raw box's zero
// fill) or the doc past N. Loaded before the chunk's barrier waits, so that
// their latency hides under them.
template <int DT>
__device__ __forceinline__ void w_group_scales(__nv_bfloat16 (&sc)[W_UNITS][2],
                                               int c, int ctid,
                                               const float* __restrict__ gscale,
                                               int G, int N, int D, int j0) {
  if constexpr (DT == kI4G) {
    // a thread's units share their 16 raw bytes' place in the row (W_CONV is
    // a multiple of 4), so their two groups are the same: two divisions
    const int h = D >> 1, per = D / G;
    const int col = (c >> 1) * WK + (ctid & 3) * 16, dim = (c & 1 ? h : 0) + col;
    const int g0 = dim / per, g1 = (dim + 8) / per;
    const bool in0 = col < h, in1 = col + 8 < h;
#pragma unroll
    for (int j = 0; j < W_UNITS; ++j) {
      const int doc = j0 + ((ctid + W_CONV * j) >> 2);
      const float* sg = gscale + (size_t)doc * G;
      const bool in = doc < N;
      sc[j][0] = __float2bfloat16_rn(in && in0 ? __ldg(sg + g0) : 0.0f);
      sc[j][1] = __float2bfloat16_rn(in && in1 ? __ldg(sg + g1) : 0.0f);
    }
  }
}

// One raw chunk (docs j0 .. j0 + 192 of the raw box `src`) into the stage's
// bf16 doc tile `dst` (K-major, 128-byte swizzle), by the W_CONV converter
// threads: a thread takes W_UNITS units of 16 raw bytes of a doc row (16
// codes of int8, or the low or high nibbles of 16 packed bytes), all
// unrolled so that their loads and conversions overlap, and writes their 16
// bf16 each (two 16-byte chunks of the row). kI4G: each 8 codes times their
// group's scale (w_group_scales), both in bf16, rounded once (the plain
// version's dequant).
template <int DT>
__device__ __forceinline__ void w_convert(const unsigned char* src,
                                          unsigned char* dst, int c, int ctid,
                                          const __nv_bfloat16 (&sc)[W_UNITS][2]) {
  const bool high = (DT == kI4 || DT == kI4G) && (c & 1);
#pragma unroll
  for (int j = 0; j < W_UNITS; ++j) {
    const int u = ctid + W_CONV * j, row = u >> 2, piece = u & 3;
    const uint4 w = *reinterpret_cast<const uint4*>(src + row * 64 + piece * 16);
    uint2 a, b, e, f;
    if constexpr (DT == kI8) {
      a = codes::int8x4_bf16(w.x);
      b = codes::int8x4_bf16(w.y);
      e = codes::int8x4_bf16(w.z);
      f = codes::int8x4_bf16(w.w);
    } else {
      a = codes::nibbles4_bf16(w.x, high);
      b = codes::nibbles4_bf16(w.y, high);
      e = codes::nibbles4_bf16(w.z, high);
      f = codes::nibbles4_bf16(w.w, high);
    }
    if constexpr (DT == kI4G) {
      a.x = codes::scale_bf16x2(a.x, sc[j][0]);
      a.y = codes::scale_bf16x2(a.y, sc[j][0]);
      b.x = codes::scale_bf16x2(b.x, sc[j][0]);
      b.y = codes::scale_bf16x2(b.y, sc[j][0]);
      e.x = codes::scale_bf16x2(e.x, sc[j][1]);
      e.y = codes::scale_bf16x2(e.y, sc[j][1]);
      f.x = codes::scale_bf16x2(f.x, sc[j][1]);
      f.y = codes::scale_bf16x2(f.y, sc[j][1]);
    }
    unsigned char* line = dst + row * 128;
    *reinterpret_cast<uint4*>(line + (((2 * piece) ^ (row & 7)) << 4)) =
        make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(line + (((2 * piece + 1) ^ (row & 7)) << 4)) =
        make_uint4(e.x, e.y, f.x, f.y);
  }
}

// Grid (query tiles of 64 NWG, doc splits), the query tile fastest. The
// producer warp group's first thread walks the split's doc tiles of 192 and,
// for each, the contraction chunks of 64, loading each chunk of the query
// tile and of the doc tile into the ring. bf16 docs arrive by TMA as they
// are. int8 and int4 docs arrive by TMA as raw bytes in a ring of their own
// (`raw` stages), and the whole producer group converts each chunk into the
// ring's bf16 doc tile (w_convert), fences it for the tensor cores and
// arrives on the stage's barrier; its first thread loads the raw boxes, the
// next as soon as the group is done with a slot (a named barrier), and each
// consumer group loads its own half of the query chunk into a stage as it
// releases it (so that the loads run ahead of use by the ring's depth and no
// producer thread waits on the consumers). Consumer group wg
// owns query rows q0 + 64 wg .. + 64: per doc tile it runs wgmma m64n192k16
// over the chunks into f32 registers, releasing each stage once its products
// are done, then folds the [64 x 192] gains: each gain is formed (x scale,
// + bias, -inf past N) in registers and compared with its row's current k-th
// best; the few that pass go to the row's buffer in shared memory, and a
// buffer that may not take another block of candidates is merged into the
// row's list (merge_buffer), as are all of them after the last tile. kI4G's scales are applied by the converters, so `scale` is null
// there and `gscale` holds them.
template <int NWG, int DT, bool DEEP>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) wgmma_topk_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap dmap, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ gscale,
    float* __restrict__ part_g, int* __restrict__ part_i, FoldState fs,
    int B, int N, int D, int K, int G, int splits, int tiles_per_split,
    int stages, int raw_stages) {
  constexpr bool RAW = DT != kBF16;
  constexpr int TQ = 64 * NWG;
  constexpr int QT = TQ * WK * 2;        // query chunk bytes
  constexpr int STAGE = w_stage_bytes(NWG);
  constexpr int NACC = WTD / 2;          // accumulators a thread
  static_assert(NACC / W_STEP == 12, "the fold's switch has 12 steps");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring on a 1024-byte boundary, as an offset from the shared array
  // (so that the compiler keeps shared-memory loads and stores)
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* raw = smem + stages * STAGE;
  const int n_raw = RAW ? raw_stages : 0;
  // the shallow fold: the rows' lists and candidate buffers; the deep fold:
  // each row's lower bound and staged count, a histogram a consumer warp
  // and the rows' staging (their buffers are in device memory); both: the
  // buffers' counts
  float* run_g = reinterpret_cast<float*>(raw + n_raw * W_RAW_BYTES);
  int* run_i = reinterpret_cast<int*>(run_g + (DEEP ? 0 : TQ * K));
  float* buf_g = reinterpret_cast<float*>(run_i + (DEEP ? 0 : TQ * K));
  int* buf_i = reinterpret_cast<int*>(buf_g + (DEEP ? 0 : TQ * W_CAP));
  int* buf_n = buf_i + (DEEP ? 0 : TQ * W_CAP);
  float* row_t = reinterpret_cast<float*>(buf_n + TQ);
  int* cnt4 = reinterpret_cast<int*>(row_t + (DEEP ? TQ : 0));
  int* hist = cnt4 + (DEEP ? 4 * TQ : 0);
  deep::u64* cut_words =
      reinterpret_cast<deep::u64*>(hist + (DEEP ? NWG * 4 * W_HIST : 0));
  float* tile_v = reinterpret_cast<float*>(
      cut_words + (DEEP ? NWG * 4 * W_CUT_WORDS : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(tile_v + NWG * 4 * WTD);
  uint64_t* empty = full + stages;
  uint64_t* raw_full = empty + stages;
  const int wg = threadIdx.x >> 7;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y;
  const int n_tiles = (N + WTD - 1) / WTD;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  // int4: the packed row walked twice, as many chunks as its bytes take
  const int chunks = RAW && DT != kI8 ? 2 * ((D / 2 + WK - 1) / WK)
                                      : (D + WK - 1) / WK;
  // the deep fold: the rows the block samples for (owned_row: each row has
  // one owner, r % splits == split); a block that owns one scans the
  // sample's tiles first (distinct, strided over the shard), then its
  // split's
  const int rows_here = min(TQ, B - q0);
  auto owned_row = [&](int r) { return r < rows_here && r % splits == split; };
  const int n_samp =
      DEEP && split < rows_here ? min(fs.sample_tiles, n_tiles) : 0;
  const int samp_stride = n_samp ? n_tiles / n_samp : 1;
  auto tile_at = [&](int j) {
    return j < n_samp ? j * samp_stride : tile_begin + j - n_samp;
  };
  const int n_seq = n_samp + max(0, tile_end - tile_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // the TMA's arrival; int8 / int4: one a consumer group's query half
      // and one a converter thread
      hopper::mbar_init(&full[s], RAW ? NWG + W_CONV : 1);
      hopper::mbar_init(&empty[s], 4 * NWG);  // one arrival a consumer warp
    }
    for (int r = 0; r < n_raw; ++r) hopper::mbar_init(&raw_full[r], 1);
    hopper::fence_barrier_init();
  }
  if constexpr (!DEEP) {
    for (int e = threadIdx.x; e < TQ * K; e += blockDim.x) {
      run_g[e] = neg_inf();
      run_i[e] = 0;
    }
  }
  for (int e = threadIdx.x; e < TQ; e += blockDim.x) {
    buf_n[e] = 0;
    if constexpr (DEEP) row_t[e] = -FLT_MAX;
  }
  __syncthreads();

  if (wg == NWG) {  // ---- producer ----
    // bf16: one thread issues the loads and the group gives up registers to
    // the consumers; int8 / int4 keep them, the converters use them
    if constexpr (!RAW) hopper::setmaxnreg_dec<40>();
    const int ptid = threadIdx.x - 128 * NWG;
    const int total = n_seq * chunks;
    if constexpr (!RAW) {
      if (ptid != 0) return;
      hopper::prefetch_tmap(&qmap);
      hopper::prefetch_tmap(&dmap);
      for (int i = 0; i < total; ++i) {
        const int s = i % stages;
        const int t = tile_at(i / chunks), c = i % chunks;
        unsigned char* st = smem + s * STAGE;
        hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], STAGE);
        hopper::tma_load_2d(st, &qmap, &full[s], c * WK, q0);
        hopper::tma_load_2d(st + QT, &dmap, &full[s], c * WK, t * WTD);
      }
    } else {
      const int ctid = ptid;
      // raw box p: chunk p (int8) or chunks 2 p, 2 p + 1 (int4)
      const int per_box = DT == kI8 ? 1 : 2, boxes = total / per_box;
      auto load_box = [&](int p) {
        const int i = p * per_box, r = p % n_raw;
        const int t = tile_at(i / chunks), c = i % chunks;
        hopper::mbar_arrive_expect_tx(&raw_full[r], W_RAW_BYTES);
        hopper::tma_load_2d(raw + r * W_RAW_BYTES, &dmap, &raw_full[r],
                            DT == kI8 ? c * WK : (c >> 1) * WK, t * WTD);
      };
      if (ctid == 0) {
        hopper::prefetch_tmap(&dmap);
        for (int p = 0; p < min(n_raw, boxes); ++p) load_box(p);
      }
      // kI4G: each chunk's group scales are loaded a chunk ahead
      __nv_bfloat16 sc[W_UNITS][2], next[W_UNITS][2];
      if (total > 0)
        w_group_scales<DT>(sc, 0, ctid, gscale, G, N, D, tile_at(0) * WTD);
      for (int i = 0; i < total; ++i) {
        const int s = i % stages;
        const int c = i % chunks;
        const int p = i / per_box, r = p % n_raw;
        if (i + 1 < total)
          w_group_scales<DT>(next, (i + 1) % chunks, ctid, gscale, G, N, D,
                             tile_at((i + 1) / chunks) * WTD);
        hopper::mbar_wait(&raw_full[r], (p / n_raw) & 1);
        hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        w_convert<DT>(raw + r * W_RAW_BYTES, smem + s * STAGE + QT, c, ctid,
                      sc);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
        if ((i + 1) % per_box == 0) {  // the box's last chunk: its slot is free
          hopper::named_barrier(1 + NWG, W_CONV);
          if (ctid == 0 && p + n_raw < boxes) load_box(p + n_raw);
        }
        if constexpr (DT == kI4G) {
#pragma unroll
          for (int j = 0; j < W_UNITS; ++j) {
            sc[j][0] = next[j][0];
            sc[j][1] = next[j][1];
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (!RAW) hopper::setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // accumulator 4c + v holds row r0 + 8 (v >> 1), doc 8c + 2 tig + (v & 1)
  // of the tile; this warp's rows are wr .. wr + 16 of the block's
  const int wr = 64 * wg + 16 * warp, r0 = wr + gid;
  float* g0 = run_g + r0 * K;
  float* g1 = run_g + (r0 + 8) * K;
  // a gain passes at its row's threshold: the row's k-th best, and at
  // least the lowest finite gain (-inf never enters); rows past B (zero
  // queries) take nothing
  // the deep fold: a gain passes at its row's lower bound T, which only
  // rises (at least the lowest finite gain: -inf and NaN never pass); in
  // the sample's tiles only the rows the block samples for take gains, the
  // others (and rows past B) have a NaN bound, which nothing reaches
  const float pinf = __int_as_float(0x7f800000),
              none = __int_as_float(0x7fffffff);
  auto first_thr = [&](int r) {
    if (q0 + r >= B) return DEEP ? none : pinf;
    return DEEP && n_samp && !owned_row(r) ? none : -FLT_MAX;
  };
  float thr0 = first_thr(r0);
  float thr1 = first_thr(r0 + 8);
  int* whist = hist + (wg * 4 + warp) * W_HIST;
  deep::u64* wcut = cut_words + (wg * 4 + warp) * W_CUT_WORDS;
  // a row's candidate words in device memory: [B, splits, cap]
  const int cap = fs.cap;
  auto row_words = [&](int row) {
    return fs.cand + ((size_t)(q0 + row) * splits + split) * cap;
  };
  // a row's words from the sample's tiles (its owner's): [B, samp_cap]
  auto samp_words = [&](int row) {
    return fs.samp + (size_t)(q0 + row) * fs.samp_cap;
  };
  // a (row, split)'s buffer holds its quad's four lanes' words interleaved
  // (lane t's j-th at 4 j + t; cnt4[4 row + t] of them): its words, packed
  // in order into dst (dst may be the buffer itself: a word never moves up)
  const unsigned lt = (1u << lane) - 1u;
  // (a lane loads W_BATCH words before it stores any: the stores may alias
  // the loads, so the compiler would not overlap them otherwise)
  auto gather = [&](const deep::u64* words, int row, deep::u64* dst,
                    deep::u64 floor_w) {
    const int* c = cnt4 + 4 * row;
    const int span = 4 * max(max(c[0], c[1]), max(c[2], c[3]));
    const int mine = c[lane & 3];
    int n = 0;
    for (int base = 0; base < span; base += 32 * W_BATCH) {
      deep::u64 w[W_BATCH];
#pragma unroll
      for (int u = 0; u < W_BATCH; ++u) {
        const int e = base + 32 * u + lane;
        w[u] = e < span ? words[e] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < W_BATCH; ++u) {
        const int e = base + 32 * u + lane;
        const bool keep = e < span && (e >> 2) < mine && w[u] >= floor_w;
        const unsigned b = __ballot_sync(FULL, keep);
        if (keep) dst[n + __popc(b & lt)] = w[u];
        n += __popc(b);
      }
    }
    __syncwarp();
    return n;
  };
  // cut a row's candidates to its K best and up to `slack` more and raise
  // its lower bound, and the row's shared one, to the least kept (at or
  // below the K-th best of a subset of its docs, which never exceeds the
  // final K-th best); a buffer that fits the warp's cut room is read once
  // into it, cut there and written back, a larger one packed and cut in
  // place. The kept words land at the front, which is the interleaved
  // layout with (kept - t + 3) / 4 words for lane t. A buffer of fewer
  // than K words (one lane of the quad near its quarter while the others
  // hold few: passing gains only at some docs of a step) bounds nothing: it
  // is only packed so, its lanes' shares balanced, and no bound rises.
  auto cut_row = [&](int row, int slack) {
    deep::u64* words = row_words(row);
    const int* c = cnt4 + 4 * row;
    const int n = c[0] + c[1] + c[2] + c[3];
    deep::u64 least;
    int kept;
    if (n < K) {   // K <= FOLD_MAX_K = W_CUT_WORDS
      gather(words, row, wcut, 0ull);
#pragma unroll 8
      for (int e = lane; e < n; e += 32) words[e] = wcut[e];
      if (lane < 4) cnt4[4 * row + lane] = (n - lane + 3) / 4;
      __syncwarp();
      return;
    }
    if (n <= W_CUT_WORDS) {
      gather(words, row, wcut, 0ull);
      least = fold_cut(wcut, n, K, slack, whist, lane, kept);
#pragma unroll 8
      for (int e = lane; e < kept; e += 32) words[e] = wcut[e];
    } else {
      gather(words, row, words, 0ull);
      least = fold_cut(words, n, K, slack, whist, lane, kept);
    }
    if (lane < 4) cnt4[4 * row + lane] = (kept - lane + 3) / 4;
    if (lane == 0) {
      row_t[row] = deep::key_gain((uint32_t)(least >> 32));
      atomicMax(fs.seed + q0 + row, least);
    }
    __syncwarp();
  };
  auto merge_row = [&](int row) {
    merge_buffer<topk::SLOTS_SHALLOW>(run_g + row * K, run_i + row * K,
                                      buf_g + row * W_CAP,
                        buf_i + row * W_CAP, K, buf_n[row], lane);
    if (lane == 0) buf_n[row] = 0;
    __syncwarp();
  };
  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.0f;
  int n0 = 0, n1 = 0;   // the deep fold: rows r0's and r0 + 8's buffer count

  // int8 / int4: this group's half of query chunk j into its stage, by the
  // group's first thread, once the group is done with the stage
  const int total = n_seq * chunks;
  const bool q_loader = RAW && warp == 0 && lane == 0;
  auto load_q = [&](int j) {
    if (j >= total) return;
    const int s = j % stages;
    hopper::mbar_arrive_expect_tx(&full[s], QT / NWG);
    hopper::tma_load_2d(smem + s * STAGE + wg * (64 * 128), &qmap, &full[s],
                        w_q_col<DT>(j % chunks, D), q0 + 64 * wg);
  };
  if (q_loader) {
    hopper::prefetch_tmap(&qmap);
    for (int j = 0; j < stages; ++j) load_q(j);
  }

  // the end of the sample: each owned row with K finite gains there or more
  // publishes its K-th best (its dense sample words, 0 for -inf, cut to
  // exactly K), and the split's own docs start from empty buffers
  const int samp_sub = n_samp * (NACC / W_STEP) * 4;   // a lane's words
  auto end_sample = [&]() {
    n0 += __shfl_xor_sync(FULL, n0, 1);
    n0 += __shfl_xor_sync(FULL, n0, 2);
    n1 += __shfl_xor_sync(FULL, n1, 1);
    n1 += __shfl_xor_sync(FULL, n1, 2);
    if (tig == 0) {
      buf_n[r0] = n0;
      buf_n[r0 + 8] = n1;
    }
    __syncwarp();
    // the finite words packed into the warp's cut room, cut back to K
    // whenever the next batch of 32 W_BATCH might not fit (the host plans
    // no sample past K = W_CUT_WORDS / 2)
    unsigned rows = __ballot_sync(FULL, lane < 16 && buf_n[wr + lane] >= K);
    for (; rows; rows &= rows - 1) {
      const int r = wr + __ffs(rows) - 1;
      const deep::u64* words = samp_words(r);
      const int total = 4 * samp_sub;
      int n = 0, kept;
      for (int base = 0; base < total; base += 32 * W_BATCH) {
        deep::u64 w[W_BATCH];
#pragma unroll
        for (int u = 0; u < W_BATCH; ++u) {
          const int e = base + 32 * u + lane;
          w[u] = e < total ? words[e] : 0ull;
        }
        if (n > W_CUT_WORDS - 32 * W_BATCH)
          fold_cut(wcut, n, K, 0, whist, lane, n);
#pragma unroll
        for (int u = 0; u < W_BATCH; ++u) {
          const unsigned b = __ballot_sync(FULL, w[u] != 0ull);
          if (w[u]) wcut[n + __popc(b & lt)] = w[u];
          n += __popc(b);
        }
        __syncwarp();
      }
      const deep::u64 least = fold_cut(wcut, n, K, 0, whist, lane, kept);
      if (lane == 0) atomicMax(fs.seed + q0 + r, least);
    }
    __syncwarp();
    n0 = n1 = 0;
    thr0 = q0 + r0 < B ? -FLT_MAX : none;
    thr1 = q0 + r0 + 8 < B ? -FLT_MAX : none;
  };
  const bool own0 = DEEP && n_samp && owned_row(r0);
  const bool own1 = DEEP && n_samp && owned_row(r0 + 8);
  const int tid = threadIdx.x & 127;
  const bool real0 = q0 + r0 < B, real1 = q0 + r0 + 8 < B;
  deep::u64 seed0 = 0ull, seed1 = 0ull;
  for (int jt = 0, i = 0; jt < n_seq; ++jt) {
    const int t = tile_at(jt);
    const int j0 = t * WTD;
    if constexpr (DEEP) {
      if (n_samp && jt == n_samp) end_sample();
      // the row's shared bound: what its other splits have shown so far,
      // read a tile ahead (its load's latency under a tile's work), and
      // at the split's first tile as it stands
      if (jt >= n_samp) {
        if (jt == n_samp) {
          seed0 = real0 ? __ldcg(fs.seed + q0 + r0) : 0ull;
          seed1 = real1 ? __ldcg(fs.seed + q0 + r0 + 8) : 0ull;
        }
        if (real0) thr0 = fmaxf(thr0, seed_gain(seed0));
        if (real1) thr1 = fmaxf(thr1, seed_gain(seed1));
        seed0 = real0 ? __ldcg(fs.seed + q0 + r0) : 0ull;
        seed1 = real1 ? __ldcg(fs.seed + q0 + r0 + 8) : 0ull;
      }
    }
    // the tile's bias and scale, loaded under the products, staged below
    float v[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + tid + 128 * h;
      const bool in = tid + 128 * h < WTD && j < N;
      v[h] = !in ? neg_inf() : bias ? __ldg(bias + j) : 0.0f;
      v[2 + h] = scale && in ? __ldg(scale + j) : 1.0f;
    }
    for (int c = 0; c < chunks; ++c, ++i) {
      const int s = i % stages;
      const unsigned char* st = smem + s * STAGE;
      hopper::mbar_wait(&full[s], (i / stages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
        hopper::wgmma_m64n192k16_ss(
            acc, hopper::desc_sw128(st + wg * (64 * 128) + 32 * kk),
            hopper::desc_sw128(st + QT + 32 * kk), c > 0 || kk > 0);
      hopper::wgmma_commit();
      // the chunk before this one is done: its slot goes back to the ring
      hopper::wgmma_wait<1>();
      if (c > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % stages]);
      if (c > 0 && q_loader) load_q(i - 1 + stages);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_accumulators<NACC>(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % stages]);
    if (q_loader) load_q(i - 1 + stages);

    // ---- fold the [64 x 192] gain tile, 8 accumulators a step ----
    // (a loop over a switch: each case is one step's own registers, and
    // the rarer merges below are one copy of code, not one a step)
    float* tb = tile_v + ((jt & 1) * NWG + wg) * 2 * WTD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (tid + 128 * h < WTD) {
        tb[tid + 128 * h] = v[h];
        tb[WTD + tid + 128 * h] = v[2 + h];
      }
    }
    hopper::named_barrier(1 + wg, 128);
    for (int step = 0; step < NACC / W_STEP; ++step) {
      float x[W_STEP];
      unsigned m = 0;
      switch (step) {
#define RAGROUTE_FOLD(S)                                                   \
  case S:                                                                  \
    m = fold_step<S, NACC, DEEP>(acc, x, tb, tb + WTD, scale, tig, thr0,   \
                                 thr1);                                    \
                                                                           \
    break;
        RAGROUTE_FOLD(0) RAGROUTE_FOLD(1) RAGROUTE_FOLD(2) RAGROUTE_FOLD(3)
        RAGROUTE_FOLD(4) RAGROUTE_FOLD(5) RAGROUTE_FOLD(6) RAGROUTE_FOLD(7)
        RAGROUTE_FOLD(8) RAGROUTE_FOLD(9) RAGROUTE_FOLD(10) RAGROUTE_FOLD(11)
#undef RAGROUTE_FOLD
      }
      if constexpr (DEEP) {
        // the sample's tiles: an owned row's every gain to its dense words
        // (a lane's 4 a step, 0 for -inf or NaN), counting the finite ones
        if (jt < n_samp) {
          const int base = j0 + 16 * step + 2 * tig;
          const int at = (jt * (NACC / W_STEP) + step) * 4;
          auto word = [&](float g, int pos) {
            return g >= -FLT_MAX
                       ? ((deep::u64)deep::order_key(g) << 32) | (uint32_t)~pos
                       : 0ull;
          };
          deep::u64* v0 = samp_words(r0) + tig * samp_sub + at;
          deep::u64* v1 = samp_words(r0 + 8) + tig * samp_sub + at;
          store_if(v0, word(x[0], base), own0);
          store_if(v0 + 1, word(x[1], base + 1), own0);
          store_if(v0 + 2, word(x[4], base + 8), own0);
          store_if(v0 + 3, word(x[5], base + 9), own0);
          store_if(v1, word(x[2], base), own1);
          store_if(v1 + 1, word(x[3], base + 1), own1);
          store_if(v1 + 2, word(x[6], base + 8), own1);
          store_if(v1 + 3, word(x[7], base + 9), own1);
          n0 += own0 ? __popc(m & 0x33u) : 0;
          n1 += own1 ? __popc(m & 0xCCu) : 0;
          continue;
        }
      }
      if (!__any_sync(FULL, m)) continue;
      if constexpr (DEEP) {
        // each lane's candidates of rows r0 and r0 + 8 go straight to its
        // own places in the rows' buffers in device memory (interleaved:
        // no counting across the quad), by predicated stores: no branch
        deep::u64* w0 = row_words(r0) + tig;
        deep::u64* w1 = row_words(r0 + 8) + tig;
        const uint32_t pos0 = ~(uint32_t)(j0 + 16 * step + 2 * tig);
#pragma unroll
        for (int u = 0; u < W_STEP; ++u) {
          const bool take = (m >> u) & 1u;
          // ~(p + o) = ~p - o
          const deep::u64 word =
              ((deep::u64)deep::order_key(x[u]) << 32) |
              (uint32_t)(pos0 - (8 * (u >> 2) + (u & 1)));
          if (u & 2) {
            store_if(w1 + 4 * n1, word, take);
            n1 += take;
          } else {
            store_if(w0 + 4 * n0, word, take);
            n0 += take;
          }
        }
        m = 0;
      }
      // append this lane's candidates to their rows' buffers (x is picked
      // by a select chain, not a runtime index, to stay in registers)
      for (; m; m &= m - 1) {
        const int u = __ffs(m) - 1;
        float g = x[0];
#pragma unroll
        for (int w = 1; w < W_STEP; ++w) g = u == w ? x[w] : g;
        const int row = r0 + (u & 2 ? 8 : 0);
        const int pos = j0 + 16 * step + 8 * (u >> 2) + 2 * tig + (u & 1);
        const int at = row * W_CAP + atomicAdd(&buf_n[row], 1);
        buf_g[at] = g;
        buf_i[at] = pos;
      }
      // (the deep fold's words went to device memory at places of their
      // own: a barrier here would wait for the stores to land, every step)
      if constexpr (!DEEP) __syncwarp();
      // a row takes at most 16 candidates a step (2 docs x 2 columns from
      // each of its 4 lanes): buffers past their capacity less 16 are
      // merged (cut, in the deep fold; the sample's words have room for
      // every doc of the sample) now
      if constexpr (DEEP) {
        // a lane adds at most 4 words a step to a row: a row with a lane
        // near its quarter of the buffer is cut now
        const int sub = cap / 4;
        if (__any_sync(FULL, n0 > sub - 4 || n1 > sub - 4)) {
          cnt4[4 * r0 + tig] = n0;
          cnt4[4 * (r0 + 8) + tig] = n1;
          __syncwarp();
          const int* c = cnt4 + 4 * (wr + lane);
          unsigned rows = __ballot_sync(
              FULL, lane < 16 && max(max(c[0], c[1]), max(c[2], c[3])) > sub - 4);
          for (; rows; rows &= rows - 1) cut_row(wr + __ffs(rows) - 1, K / 2);
          thr0 = raise_thr(thr0, row_t[r0]);
          thr1 = raise_thr(thr1, row_t[r0 + 8]);
          n0 = cnt4[4 * r0 + tig];
          n1 = cnt4[4 * (r0 + 8) + tig];
        }
      } else {
        unsigned rows =
            __ballot_sync(FULL, lane < 16 && buf_n[wr + lane] > W_CAP - 16);
        for (; rows; rows &= rows - 1) merge_row(wr + __ffs(rows) - 1);
        if (q0 + r0 < B) thr0 = fmaxf(g0[K - 1], -FLT_MAX);
        if (q0 + r0 + 8 < B) thr1 = fmaxf(g1[K - 1], -FLT_MAX);
      }
    }
  }
  __syncwarp();
  if constexpr (DEEP) {
    // a split of no docs of its own has only the sample's candidates: gone
    if (n_samp && n_seq == n_samp) end_sample();

    // every row's candidates at or above the row's shared bound are cut to
    // its K best and sorted by its warp in the ring's shared memory, free
    // once both groups are past the scan, then merged into the row's running
    // list
    cnt4[4 * r0 + tig] = n0;
    cnt4[4 * (r0 + 8) + tig] = n1;
    __syncwarp();
    hopper::named_barrier(2 + NWG, 128 * NWG);
    // each warp's share of the ring: a row's candidates are read into it
    // once, cut there, and its list sorted there (a buffer larger than the
    // share is cut in device memory first); the running list's entries are
    // read into the warp's cut room
    const int room = stages * STAGE / 8 / (4 * NWG);
    deep::u64* sorted =
        reinterpret_cast<deep::u64*>(smem) + (size_t)(wg * 4 + warp) * room;
    for (int i = 0; i < 16; ++i) {
      const int r = wr + ((i + split) & 15);
      const int row = q0 + r;
      if (row >= B) continue;
      const int* c = cnt4 + 4 * r;
      if (4 * max(max(c[0], c[1]), max(c[2], c[3])) > room) cut_row(r, 0);
      // below the row's shared bound no word is among its K best
      int len = gather(row_words(r), r, sorted, __ldcg(fs.seed + row));
      int* lock = fs.lock + row;
      if (len > 0) {
        if (len > K) fold_cut(sorted, len, K, 0, whist, lane, len);
        const int P = deep::pow2_at_least(len < 2 ? 2 : len);
        for (int e = len + lane; e < P; e += 32) sorted[e] = 0ull;
        __syncwarp();
        warp_bitonic_desc(sorted, P, lane);
      }
      // the row's lock (0 free with no list yet, 2 free with one), taken by
      // every split: under it the split counts the row and its entries that
      // beat the running list's last go in by rank (the words are distinct
      // but for the 0 pads, which come last), or the first list is the
      // running list as it is; the writer of its last entry publishes it as
      // the row's bound; the split that counts last writes the row out and
      // leaves its state zero
      int filled = 0;
      if (lane == 0) {
        for (;;) {
          if (cas_acquire(lock, 0, 1) == 0) break;
          if (cas_acquire(lock, 2, 1) == 2) { filled = 1; break; }
          __nanosleep(32);
        }
      }
      filled = __shfl_sync(FULL, filled, 0);
      __syncwarp();
      deep::u64* run = fs.run + (size_t)row * K;
      const int counted = __ldcg(fs.count + row);
      const bool last = counted == splits - 1;
      if (len > 0 && !filled) {
        for (int e = lane; e < K; e += 32) {
          const deep::u64 w = e < len ? sorted[e] : 0ull;
          run[e] = w;
          if (e == K - 1 && w && !last) atomicMax(fs.seed + row, w);
        }
        filled = 1;
      } else if (len > 0) {
        for (int base = 0; base < K; base += 32 * W_BATCH) {
          deep::u64 w[W_BATCH];
#pragma unroll
          for (int u = 0; u < W_BATCH; ++u) {
            const int e = base + 32 * u + lane;
            w[u] = e < K ? __ldcg(run + e) : 0ull;
          }
#pragma unroll
          for (int u = 0; u < W_BATCH; ++u)
            if (base + 32 * u + lane < K) wcut[base + 32 * u + lane] = w[u];
        }
        __syncwarp();
        const int m = count_above(sorted, len, wcut[K - 1]);
        for (int e = lane; m > 0 && e < K; e += 32) {
          const deep::u64 w = wcut[e];
          const int to = e + count_above(sorted, m, w);
          if (to < K) run[to] = w;
          if (to == K - 1 && w && !last) atomicMax(fs.seed + row, w);
        }
        for (int e = lane; e < m; e += 32) {
          const deep::u64 w = sorted[e];
          const int to = e + count_above(wcut, K, w);
          if (to < K) run[to] = w;
          if (to == K - 1 && !last) atomicMax(fs.seed + row, w);
        }
      }
      __syncwarp();
      if (last) {
        for (int e = lane; e < K; e += 32) {
          const deep::u64 w = filled ? __ldcg(run + e) : 0ull;
          const uint32_t key = (uint32_t)(w >> 32);
          fs.out_g[(size_t)row * K + e] = key ? deep::key_gain(key) : neg_inf();
          fs.out_i[(size_t)row * K + e] = key ? (long long)~(uint32_t)w : 0;
        }
        if (lane == 0) {
          fs.count[row] = 0;
          fs.seed[row] = 0ull;
        }
      } else if (lane == 0) {
        fs.count[row] = counted + 1;
      }
      __syncwarp();
      if (lane == 0) store_release(lock, last ? 0 : filled ? 2 : 0);
      __syncwarp();
    }
    return;
  }
  unsigned rows = __ballot_sync(FULL, lane < 16 && buf_n[wr + lane] > 0);
  for (; rows; rows &= rows - 1) merge_row(wr + __ffs(rows) - 1);

  // each warp writes out its own 16 rows
  for (int r = wr; r < wr + 16; ++r) {
    const int row = q0 + r;
    if (row >= B) break;
    for (int c = lane; c < K; c += 32) {
      const size_t o = ((size_t)row * splits + split) * K + c;
      part_g[o] = run_g[r * K + c];
      part_i[o] = run_i[r * K + c];
    }
  }
}

template <int NWG, int DT, bool DEEP = false>
cudaError_t launch_wgmma(const void* q, const void* docs, const float* bias,
                         const float* scale, float* part_g, int* part_i,
                         int B, int N, int D, int K, int G, int splits,
                         int tiles_per_split, cudaStream_t stream,
                         FoldState fs = FoldState{}) {
  constexpr bool RAW = DT != kBF16;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  // the bf16 ring as deep as fits (beside two raw stages for int8 / int4),
  // then the raw ring as deep as fits beside it
  int raw = RAW ? W_MIN_RAW : 0, stages = 2;
  while (stages < W_MAX_STAGES &&
         w_smem_bytes(NWG, stages + 1, K, raw, DEEP) <= optin)
    ++stages;
  while (RAW && raw < W_MAX_RAW &&
         w_smem_bytes(NWG, stages, K, raw + 1, DEEP) <= optin)
    ++raw;
  const int smem = w_smem_bytes(NWG, stages, K, raw, DEEP);
  if (smem > optin) return cudaErrorInvalidValue;
  // the deep fold sorts its warps' lists in the ring
  if (DEEP && 4 * NWG * 8 * deep::pow2_at_least(K) >
                  stages * w_stage_bytes(NWG))
    return cudaErrorInvalidValue;
  CUtensorMap qmap, dmap;
  // int8 / int4: each consumer group loads its own 64 query rows
  err = hopper_host::make_tmap_2d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                  2, B, D, D, RAW ? 64 : 64 * NWG, WK);
  if (err != cudaSuccess) return err;
  if constexpr (RAW) {
    // raw bytes: int8 rows of D, int4 rows of D / 2, boxes of 64 bytes
    const int cols = DT == kI8 ? D : D / 2;
    err = hopper_host::make_tmap_2d(&dmap, docs, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                    1, N, cols, cols, WTD, 64, false);
  } else {
    err = hopper_host::make_tmap_2d(&dmap, docs,
                                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, D,
                                    D, WTD, WK);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wgmma_topk_kernel<NWG, DT, DEEP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 64 * NWG - 1) / (64 * NWG), splits);
  // per-group int4 scales are the converters'; the fold takes per-doc ones
  const float* fold_scale = DT == kI4G ? nullptr : scale;
  const float* gscale = DT == kI4G ? scale : nullptr;
  wgmma_topk_kernel<NWG, DT, DEEP>
      <<<grid, 128 * (NWG + 1), smem, stream>>>(
          qmap, dmap, bias, fold_scale, gscale, part_g, part_i, fs, B, N, D,
          K, G, splits, tiles_per_split, stages, raw);
  return cudaGetLastError();
}


// ---- f32 docs at k <= KSHALLOW: a register-blocked scan (f32_topk_kernel) --

constexpr int F_TQ = 128;        // query rows a block
constexpr int F_TD = 128;        // docs a tile
constexpr int F_BK = 32;         // contraction chunk (floats): 128-byte rows
constexpr int F_TILE = 128 * F_BK * 4;   // a [128 x 32] f32 box, 16 KB
constexpr int F_STAGE = 2 * F_TILE;      // a query box and a doc box
constexpr int F_MAX_STAGES = 6;

// Shared memory at depth K with `stages` ring stages: the ring (1024-byte
// aligned), the rows' lists, candidate buffers and buffer counts, the
// barriers.
__host__ __device__ constexpr int f_smem_bytes(int stages, int K) {
  return stages * F_STAGE + F_TQ * ((K + W_CAP) * 8 + 4) + 2 * stages * 8 +
         1024;
}

// Grid (query tiles of 128, doc splits), the query tile fastest. The block's
// 8 consumer warps stream the split's doc tiles of 128 in ascending order,
// each over the contraction in chunks of 32 that a producer warp (the
// ninth) brings by TMA into a ring of `stages`: a [128 x 32] box of the
// queries and one of the docs, 128-byte rows in the 128-byte swizzle, zeros
// past B, N and D. A consumer waits on the stage's barrier and frees it
// when done (no block-wide barrier, so one warp's fold runs beside the
// others' products); thread (ty, tx) = (2 warp + lane / 16, lane % 16) keeps
// the 8 x 8 f32 gains of rows ty + 16 i and docs tx + 16 j (f32_tile.cuh's
// product, reading the swizzled boxes), so that a warp owns 16 rows whole.
// After a tile the fold of the wgmma scan follows, 8 gains a step (doc j of
// the thread's 8 rows): each formed as the plain version forms it (x
// scale, + bias, -inf past N) and compared with its row's current k-th best
// with no branch; the few that pass go to the row's buffer in shared
// memory, and a buffer that may not take another step's 16 is merged into
// the row's sorted list by rank (merge_buffer).
template <int SLOTS>
__global__ void __launch_bounds__(288, 1) f32_topk_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap dmap, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ part_g,
    int* __restrict__ part_i, int B, int N, int D, int K, int splits,
    int tiles_per_split, int stages) {
  constexpr int TM = 8;                  // rows a thread: ty + TY i
  constexpr int TY = F_TQ / TM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* run_g = reinterpret_cast<float*>(smem + stages * F_STAGE);
  int* run_i = reinterpret_cast<int*>(run_g + F_TQ * K);
  float* buf_g = reinterpret_cast<float*>(run_i + F_TQ * K);
  int* buf_i = reinterpret_cast<int*>(buf_g + F_TQ * W_CAP);
  int* buf_n = buf_i + F_TQ * W_CAP;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf_n + F_TQ);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * F_TQ, split = blockIdx.y;
  const int n_tiles = (N + F_TD - 1) / F_TD;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const int chunks = (D + F_BK - 1) / F_BK;
  const int total = max(0, tile_end - tile_begin) * chunks;

  for (int e = tid; e < F_TQ * K; e += blockDim.x) {
    run_g[e] = neg_inf();
    run_i[e] = 0;
  }
  for (int e = tid; e < F_TQ; e += blockDim.x) buf_n[e] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);    // the TMA's arrival
      hopper::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer ----
    if (lane == 0) {
      hopper::prefetch_tmap(&qmap);
      hopper::prefetch_tmap(&dmap);
      for (int i = 0; i < total; ++i) {
        const int s = i % stages;
        unsigned char* st = smem + s * F_STAGE;
        hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], F_STAGE);
        const int k0 = (i % chunks) * F_BK;
        hopper::tma_load_2d(st, &qmap, &full[s], k0, q0);
        hopper::tma_load_2d(st + F_TILE, &dmap, &full[s], k0,
                            (tile_begin + i / chunks) * F_TD);
      }
    }
    return;
  }

  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;
  // a gain passes at its row's threshold: the row's k-th best, and at least
  // the lowest finite gain (-inf never enters); rows past B take nothing
  const float pinf = __int_as_float(0x7f800000), low = -FLT_MAX;
  float thr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) thr[i] = q0 + ty + TY * i < B ? low : pinf;
  // the warp's 2 TM rows: lane l < 2 TM names row 2 warp + (l & 1) + TY
  // (l >> 1)
  const int my_row = 2 * warp + (lane & 1) + TY * ((lane >> 1) % TM);
  auto row_of = [&](int l) { return 2 * warp + (l & 1) + TY * (l >> 1); };
  auto merge_row = [&](int row) {
    merge_buffer<SLOTS>(run_g + row * K, run_i + row * K, buf_g + row * W_CAP,
                        buf_i + row * W_CAP, K, buf_n[row], lane);
    if (lane == 0) buf_n[row] = 0;
    __syncwarp();
  };
  float acc[TM][8];

  for (int t = tile_begin, i = 0; t < tile_end; ++t) {
    const int j0 = t * F_TD;
    // the tile's bias and scale of this thread's docs, loaded under the
    // products
    float bs[8], sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int doc = j0 + tx + 16 * j;
      bs[j] = doc >= N ? neg_inf() : bias ? __ldg(bias + doc) : 0.0f;
      sc[j] = scale && doc < N ? __ldg(scale + doc) : 1.0f;
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
    for (int c = 0; c < chunks; ++c, ++i) {
      const int s = i % stages;
      const float* sq = reinterpret_cast<const float*>(smem + s * F_STAGE);
      hopper::mbar_wait(&full[s], (i / stages) & 1);
      f32tile::fma_nt<TM, TY, 16>(acc, sq, sq + F_TQ * F_BK, ty, tx);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // ---- fold the [128 x 128] gain tile, doc j of the thread's rows a step
    // (a loop, not unrolled: the rarer merges below are one copy of code)
    // the gains, formed with separate roundings as the plain version forms
    // them
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float g = acc[r][j];
        if (scale) g = __fmul_rn(g, sc[j]);
        acc[r][j] = __fadd_rn(g, bs[j]);
      }
    for (int j = 0; j < 8; ++j) {
      float x[TM];
      unsigned m = 0;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        // picked by a select chain, not a runtime index, to stay in
        // registers
        float g = acc[r][0];
#pragma unroll
        for (int w = 1; w < 8; ++w) g = j == w ? acc[r][w] : g;
        x[r] = g;
        m |= g >= thr[r] ? 1u << r : 0u;
      }
      if (!__any_sync(FULL, m)) continue;
      const int doc = j0 + tx + 16 * j;
      for (; m; m &= m - 1) {
        const int u = __ffs(m) - 1;
        float g = x[0];
#pragma unroll
        for (int w = 1; w < TM; ++w) g = u == w ? x[w] : g;
        const int row = ty + TY * u;
        const int at = row * W_CAP + atomicAdd(&buf_n[row], 1);
        buf_g[at] = g;
        buf_i[at] = doc;
      }
      __syncwarp();
      // a row takes at most 16 candidates a step (one from each of its 16
      // lanes): buffers past their capacity less 16 are merged now
      unsigned rows =
          __ballot_sync(FULL, lane < 2 * TM && buf_n[my_row] > W_CAP - 16);
      if (!rows) continue;
      for (; rows; rows &= rows - 1) merge_row(row_of(__ffs(rows) - 1));
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int row = ty + TY * r;
        if (q0 + row < B) thr[r] = fmaxf(run_g[row * K + K - 1], low);
      }
    }
  }
  __syncwarp();
  unsigned rows = __ballot_sync(FULL, lane < 2 * TM && buf_n[my_row] > 0);
  for (; rows; rows &= rows - 1) merge_row(row_of(__ffs(rows) - 1));

  // each warp writes out its own rows
  for (int l = 0; l < 2 * TM; ++l) {
    const int r = row_of(l), row = q0 + r;
    if (row >= B) continue;
    for (int c = lane; c < K; c += 32) {
      const size_t o = ((size_t)row * splits + split) * K + c;
      part_g[o] = run_g[r * K + c];
      part_i[o] = run_i[r * K + c];
    }
  }
}

// ---- f32 docs at <= 64 query rows: a small-batch scan (f32_small_kernel) ---

constexpr int S_TD = 256;                    // docs a tile (the doc box's rows)
constexpr int S_DOC_BOX = S_TD * F_BK * 4;   // a [256 x 32] f32 box, 32 KB
constexpr int S_CAP = 64;                    // a row's candidate buffer
constexpr int S_MAX_STAGES = 6;
constexpr int S_CONSUMERS = 256;             // 8 consumer warps

// A stage: the doc box, then the [TQ x 32] query box (both 1024-aligned).
__host__ __device__ constexpr int s_stage_bytes(int tq) {
  return S_DOC_BOX + tq * F_BK * 4;
}

// Shared memory at TQ query rows, depth K and `stages` ring stages: the
// ring, the rows' lists, candidate buffers and buffer counts, the barriers,
// 1024 bytes to align the ring.
__host__ __device__ constexpr int s_smem_bytes(int tq, int stages, int K) {
  return stages * s_stage_bytes(tq) + tq * ((K + S_CAP) * 8 + 4) +
         2 * stages * 8 + 1024;
}

// Grid (query tiles of TQ = 8, 32 or 64, doc splits). A producer warp (the
// ninth) brings each contraction chunk of 32 by TMA into a ring of `stages`:
// a [256 docs x 32] box and the [TQ x 32] query box, 128-byte rows in the
// 128-byte swizzle, zeros past B, N and D. Thread (ty, tx) = (lane % 8,
// 4 warp + lane / 8) of the 8 consumer warps keeps the TM x 8 gains of rows
// ty + 8 i (i < TM = TQ / 8) and docs tx + 32 j (f32tile::fma_nt): every
// warp holds all TQ rows, so a doc value read from shared memory (one
// address a quad of lanes, a broadcast) feeds every query row of the tile,
// and the doc box crosses shared memory once a block. After a tile each
// gain is formed as the plain version forms it (x scale, + bias, -inf past
// N) and held against its row's threshold in a register (its k-th best, at
// least the lowest finite gain; +inf on rows past B) with no branch; one
// barrier that also reduces tells whether the block has any candidate. Only
// then a step a doc slot j: the passing gains go to their row's buffer
// (shared atomics: a row takes at most 32 a step, one from each thread of
// its ty), and a second reducing barrier asks whether a buffer might not
// take another step's; if so, warp w merges rows w, w + 8, .. by rank
// (merge_buffer) and, after a barrier, every thread reads its rows' new
// thresholds. The ring is not waited on by the fold: the producer keeps
// `stages` chunks in flight through it.
template <int TQ, int SLOTS>
__global__ void __launch_bounds__(288, 1) f32_small_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap dmap, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ part_g,
    int* __restrict__ part_i, int B, int N, int D, int K, int splits,
    int tiles_per_split, int stages) {
  constexpr int TM = TQ / 8;
  constexpr int STAGE = s_stage_bytes(TQ);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* run_g = reinterpret_cast<float*>(smem + stages * STAGE);
  int* run_i = reinterpret_cast<int*>(run_g + TQ * K);
  float* buf_g = reinterpret_cast<float*>(run_i + TQ * K);
  int* buf_i = reinterpret_cast<int*>(buf_g + TQ * S_CAP);
  int* buf_n = buf_i + TQ * S_CAP;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf_n + TQ);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y;
  const int n_tiles = (N + S_TD - 1) / S_TD;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const int chunks = (D + F_BK - 1) / F_BK;
  const int total = max(0, tile_end - tile_begin) * chunks;

  for (int e = tid; e < TQ * K; e += blockDim.x) {
    run_g[e] = neg_inf();
    run_i[e] = 0;
  }
  for (int e = tid; e < TQ; e += blockDim.x) buf_n[e] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);    // the TMA's arrival
      hopper::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // ---- producer ----
    if (lane == 0) {
      hopper::prefetch_tmap(&qmap);
      hopper::prefetch_tmap(&dmap);
      for (int i = 0; i < total; ++i) {
        const int s = i % stages;
        unsigned char* st = smem + s * STAGE;
        hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], STAGE);
        const int k0 = (i % chunks) * F_BK;
        hopper::tma_load_2d(st, &dmap, &full[s], k0,
                            (tile_begin + i / chunks) * S_TD);
        hopper::tma_load_2d(st + S_DOC_BOX, &qmap, &full[s], k0, q0);
      }
    }
    return;
  }

  const int ty = lane & 7, tx = 4 * warp + (lane >> 3);
  const float pinf = __int_as_float(0x7f800000), low = -FLT_MAX;
  float thr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) thr[i] = q0 + ty + 8 * i < B ? low : pinf;
  auto refresh = [&] {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ty + 8 * i;
      if (q0 + row < B) thr[i] = fmaxf(run_g[row * K + K - 1], low);
    }
  };
  // every non-empty buffer into its row's list, warp w taking rows w + 8 r
  auto merge_rows = [&] {
    for (int r = warp; r < TQ; r += 8) {
      const int n = buf_n[r];
      for (int o = 0; o < n; o += 32)
        merge_buffer<SLOTS>(run_g + r * K, run_i + r * K,
                            buf_g + r * S_CAP + o, buf_i + r * S_CAP + o, K,
                            min(32, n - o), lane);
      if (lane == 0) buf_n[r] = 0;
    }
  };
  float acc[TM][8];

  for (int t = tile_begin, i = 0; t < tile_end; ++t) {
    const int j0 = t * S_TD;
    // the tile's bias and scale of this thread's docs, loaded under the
    // products
    float bs[8], sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int doc = j0 + tx + 32 * j;
      bs[j] = doc >= N ? neg_inf() : bias ? __ldg(bias + doc) : 0.0f;
      sc[j] = scale && doc < N ? __ldg(scale + doc) : 1.0f;
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
    for (int c = 0; c < chunks; ++c, ++i) {
      const int s = i % stages;
      const unsigned char* st = smem + s * STAGE;
      hopper::mbar_wait(&full[s], (i / stages) & 1);
      f32tile::fma_nt<TM, 8, 32>(acc,
                                 reinterpret_cast<const float*>(st + S_DOC_BOX),
                                 reinterpret_cast<const float*>(st), ty, tx);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // the gains, formed with separate roundings as the plain version forms
    // them, and whether any reaches its row's threshold
    bool any = false;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float g = acc[r][j];
        if (scale) g = __fmul_rn(g, sc[j]);
        g = __fadd_rn(g, bs[j]);
        acc[r][j] = g;
        any |= g >= thr[r];
      }
    if (!hopper::named_barrier_any(1, S_CONSUMERS, any)) continue;
    // doc slot j of every thread a step (a loop, not unrolled: the rarer
    // merges below are one copy of code)
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      float x[TM];
      unsigned m = 0;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        // picked by a select chain, not a runtime index, to stay in
        // registers
        float g = acc[r][0];
#pragma unroll
        for (int w = 1; w < 8; ++w) g = j == w ? acc[r][w] : g;
        x[r] = g;
        m |= g >= thr[r] ? 1u << r : 0u;
      }
      const int doc = j0 + tx + 32 * j;
      bool over = false;
      for (; m; m &= m - 1) {
        const int u = __ffs(m) - 1;
        float g = x[0];
#pragma unroll
        for (int w = 1; w < TM; ++w) g = u == w ? x[w] : g;
        const int row = ty + 8 * u;
        const int at = atomicAdd(&buf_n[row], 1);
        buf_g[row * S_CAP + at] = g;
        buf_i[row * S_CAP + at] = doc;
        over |= at >= S_CAP - 32;
      }
      if (!hopper::named_barrier_any(1, S_CONSUMERS, over)) continue;
      merge_rows();
      hopper::named_barrier(1, S_CONSUMERS);
      refresh();
    }
  }
  hopper::named_barrier(1, S_CONSUMERS);
  merge_rows();
  hopper::named_barrier(1, S_CONSUMERS);
  for (int e = tid; e < TQ * K; e += S_CONSUMERS) {
    const int r = e / K, c = e - r * K, row = q0 + r;
    if (row < B) {
      const size_t o = ((size_t)row * splits + split) * K + c;
      part_g[o] = run_g[e];
      part_i[o] = run_i[e];
    }
  }
}

template <int TQ>
cudaError_t launch_f32_small(const CUtensorMap& qmap, const CUtensorMap& dmap,
                             const float* bias, const float* scale,
                             float* part_g, int* part_i, int B, int N, int D,
                             int K, int splits, int tiles_per_split,
                             int stages, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      f32_small_kernel<TQ, topk::SLOTS_SHALLOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  f32_small_kernel<TQ, topk::SLOTS_SHALLOW>
      <<<dim3((B + TQ - 1) / TQ, splits), 288, smem, stream>>>(
          qmap, dmap, bias, scale, part_g, part_i, B, N, D, K, splits,
          tiles_per_split, stages);
  return cudaGetLastError();
}

// ---- deep lists (k > KMAX): a doc chunk's gains in device memory ------------

// One block a (query tile, doc tile) of the chunk [c0, c_end): the [TQ x TD]
// gain tile and its epilogue exactly as partial_topk_kernel forms them,
// written to ws[row * ld + doc - c0] for the rows < B.
template <int DT>
__global__ void __launch_bounds__(THREADS) chunk_gains_kernel(
    const void* __restrict__ q, const void* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    float* __restrict__ ws, int B, int N, int D, int G, int c0, int c_end,
    int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int j0 = c0 + blockIdx.y * TD;
  float* sg = reinterpret_cast<float*>(smem);
  if constexpr (DT == kF32)
    gain_tile_f32(static_cast<const float*>(q), static_cast<const float*>(docs),
                  smem, sg, B, N, D, q0, j0, tid);
  else
    gain_tile_wmma<DT>(q, docs, scale, G, smem, sg, B, N, D, q0, j0, tid, warp);
  // consecutive threads on consecutive docs of a row: coalesced stores
  for (int e = tid; e < TQ * TD; e += THREADS) {
    const int r = e / TD, c = e - r * TD, j = j0 + c;
    if (q0 + r >= B || j >= c_end) continue;
    float x = sg[r * LDG + c];
    if (DT != kI4G && scale) x = __fmul_rn(x, scale[j]);
    if (bias) x = __fadd_rn(x, bias[j]);
    ws[(size_t)(q0 + r) * ld + (j - c0)] = x;
  }
}

template <int DT>
cudaError_t launch_chunk(const void* q, const void* docs, const float* bias,
                         const float* scale, float* ws, int B, int N, int D,
                         int G, int c0, int c_end, int ld, cudaStream_t stream) {
  const dim3 grid((B + TQ - 1) / TQ, (c_end - c0 + TD - 1) / TD);
  chunk_gains_kernel<DT><<<grid, THREADS, tile_region_bytes(DT), stream>>>(
      q, docs, bias, scale, ws, B, N, D, G, c0, c_end, ld);
  return cudaGetLastError();
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

// Deep lists: any K (the launch above stops at KMAX). Query rows go in slices
// of slice_rows, docs in chunks of `chunk` (<= RUN_MAX, or a multiple of it).
// Per chunk: chunk_gains_kernel writes the slice's gains to ws_g [slice_rows,
// chunk]; deep::reduce_rows cuts every run of RUN_MAX docs to its best
// min(K, RUN_MAX) and merges the runs to one list of <= K; that list merges
// into the slice's running list of K, which ping-pongs between run0 and run1
// ([slice_rows, 2K] words each: the running list, then the chunk's). Last,
// the running list is written out with each gain decoded from its key. ws_a /
// ws_b hold slice_rows x list_entries words (ops/deep_topk.py::fused_plan).
// Arguments otherwise as fused_topk_launch. Returns 0, or deep::fail's code
// of the step that failed.
extern "C" int fused_topk_deep_launch(const void* q, const void* docs,
                                      const void* bias, const void* scale,
                                      void* ws_g, void* ws_a, void* ws_b,
                                      void* run0, void* run1, void* out_g,
                                      void* out_i, int B, int N, int D, int K,
                                      int G, int doc_type, int slice_rows,
                                      int chunk, void* stream) {
  if (B < 1 || N < 1 || D < 16 || D % 16 != 0 || K < 1 || slice_rows < 1 ||
      chunk < 1 || (chunk > deep::RUN_MAX && chunk % deep::RUN_MAX != 0) ||
      (chunk + TD - 1) / TD > 65535 || ws_g == nullptr || run0 == nullptr ||
      run1 == nullptr ||
      (chunk > deep::RUN_MAX && (ws_a == nullptr || ws_b == nullptr)) ||
      doc_type < kF32 || doc_type > kI4G ||
      (doc_type == kI4G && (scale == nullptr || G < 1 || D % G != 0 ||
                            (D / G) % 8 != 0)))
    return deep::fail(deep::STEP_ARGS, cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(scale);
  float* wg = static_cast<float*>(ws_g);
  auto* wa = static_cast<deep::u64*>(ws_a);
  auto* wb = static_cast<deep::u64*>(ws_b);
  const size_t q_row = (size_t)D * (doc_type == kF32 ? 4 : 2);
  const int kr = min(K, deep::RUN_MAX);
  const long long run_ld = 2LL * K;
  for (int r0 = 0; r0 < B; r0 += slice_rows) {
    const int rows = min(slice_rows, B - r0);
    const void* qs = static_cast<const char*>(q) + (size_t)r0 * q_row;
    auto* cur = static_cast<deep::u64*>(run0);
    auto* other = static_cast<deep::u64*>(run1);
    cudaError_t err = cudaMemsetAsync(cur, 0, (size_t)rows * run_ld * 8, st);
    if (err != cudaSuccess) return deep::fail(deep::STEP_MEMSET, err);
    for (int c0 = 0; c0 < N; c0 += chunk) {
      const int c_end = min(N, c0 + chunk);
#define RAGROUTE_CHUNK(DT) \
  err = launch_chunk<DT>(qs, docs, b, s, wg, rows, N, D, G, c0, c_end, chunk, st)
      switch (doc_type) {
        case kF32: RAGROUTE_CHUNK(kF32); break;
        case kBF16: RAGROUTE_CHUNK(kBF16); break;
        case kI8: RAGROUTE_CHUNK(kI8); break;
        case kI4: RAGROUTE_CHUNK(kI4); break;
        default: RAGROUTE_CHUNK(kI4G); break;
      }
#undef RAGROUTE_CHUNK
      if (err != cudaSuccess) return deep::fail(deep::STEP_GAINS, err);
      // the first chunk's list is the running list (zero past its end)
      int len = 0;
      const int code = deep::reduce_rows(
          wg, chunk, rows, c_end - c0, deep::RUN_MAX, kr, K, c0, wa, wb,
          c0 == 0 ? cur : cur + K, run_ld, &len, nullptr, 0, 0, st);
      if (code) return code;
      if (c0 > 0) {
        err = deep::merge(cur, run_ld, K, K, len, 2, other, run_ld, K, rows,
                          nullptr, 0, 0, st);
        if (err != cudaSuccess) return deep::fail(deep::STEP_RUNNING, err);
        auto* t = cur;
        cur = other;
        other = t;
      }
    }
    err = deep::emit<long long>(cur, run_ld, K, nullptr, 0,
                                static_cast<float*>(out_g) + (size_t)r0 * K,
                                static_cast<long long*>(out_i) + (size_t)r0 * K,
                                K, rows, nullptr, 0, 0, st);
    if (err != cudaSuccess) return deep::fail(deep::STEP_EMIT, err);
  }
  return 0;
}


// bf16, int8 or int4 docs (doc_type kBF16, kI8, kI4, kI4G; int4 needs D a
// multiple of 32, so that a packed row is a whole number of 16 bytes) and
// bf16 queries [B, D] (16-byte aligned bases), k <= KSHALLOW, through
// wgmma_topk_kernel (query tiles of 128), then merge_splits_kernel;
// tiles_per_split counts doc tiles of 192 (ops/fused_topk.py::_plan).
// Arguments otherwise as fused_topk_launch.
extern "C" int fused_topk_wgmma_launch(const void* q, const void* docs,
                                       const void* bias, const void* scale,
                                       void* part_g, void* part_i,
                                       void* out_g, void* out_i, int B, int N,
                                       int D, int K, int G, int splits,
                                       int tiles_per_split, int doc_type,
                                       void* stream) {
  const bool int4 = doc_type == kI4 || doc_type == kI4G;
  if (B < 1 || N < 1 || D < 16 || D % 16 != 0 || K < 1 ||
      K > topk::KSHALLOW || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 || doc_type < kBF16 || doc_type > kI4G ||
      (int4 && D % 32 != 0) ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(docs) % 16)
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
#define RAGROUTE_WGMMA(DT)                                                   \
  err = launch_wgmma<2, DT>(q, docs, b, s, pg, pi, B, N, D, K, G, splits,    \
                            tiles_per_split, st)
  switch (doc_type) {
    case kBF16: RAGROUTE_WGMMA(kBF16); break;
    case kI8: RAGROUTE_WGMMA(kI8); break;
    case kI4: RAGROUTE_WGMMA(kI4); break;
    default: RAGROUTE_WGMMA(kI4G); break;
  }
#undef RAGROUTE_WGMMA
  if (err != cudaSuccess) return (int)err;
  topk::merge_splits_kernel<long long>
      <<<B, topk::MERGE_THREADS, splits * (int)sizeof(int), st>>>(
          pg, pi, static_cast<float*>(out_g), static_cast<long long*>(out_i),
          splits, K);
  return (int)cudaGetLastError();
}

// The deep fold: bf16, int8 or int4 docs as fused_topk_wgmma_launch takes
// them, lists of KSHALLOW < K <= FOLD_MAX_K, in one launch of
// wgmma_topk_kernel with two consumer groups (128 query rows a block): the
// blocks that own rows first scan `sample_tiles` tiles of the shard for
// them (their words in samp, u64 [B, sample_tiles * 192]) and publish each
// one's K-th best in seed, then every block scans its split with each
// row's bound read from seed at every tile; its rows keep their candidates
// in cand (u64 [B, splits, cap] words, cap >= K + FOLD_SLACK), cut to the K
// best whenever a row's fill away from cap could not take another step's;
// after the scan each (row, split)'s list merges into run (u64 [B, K]
// words) and the last split writes out_g / out_i [B, K] f32 / i64. seed
// (u64 [B]), count and lock (int [B]) are zero on entry and left zero.
// Returns the CUDA error code (0 on success).
extern "C" int fused_topk_fold_launch(const void* q, const void* docs,
                                      const void* bias, const void* scale,
                                      void* cand, void* samp, void* run,
                                      void* seed, void* count, void* lock,
                                      void* out_g,
                                      void* out_i, int B, int N, int D, int K,
                                      int G, int splits, int tiles_per_split,
                                      int cap, int sample_tiles, int doc_type,
                                      void* stream) {
  const bool int4 = doc_type == kI4 || doc_type == kI4G;
  if (B < 1 || N < 1 || D < 16 || D % 16 != 0 || K <= topk::KSHALLOW ||
      K > FOLD_MAX_K || cap < K + FOLD_SLACK || cand == nullptr ||
      run == nullptr || seed == nullptr || count == nullptr ||
      lock == nullptr || sample_tiles < 0 ||
      (sample_tiles > 0 && samp == nullptr) ||
      splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      doc_type < kBF16 || doc_type > kI4G || (int4 && D % 32 != 0) ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return (int)cudaErrorInvalidValue;
  if (doc_type == kI4G && (scale == nullptr || G < 1 || D % G != 0 ||
                           (D / G) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(scale);
  FoldState fs;
  fs.cand = static_cast<deep::u64*>(cand);
  fs.samp = static_cast<deep::u64*>(samp);
  fs.run = static_cast<deep::u64*>(run);
  fs.seed = static_cast<deep::u64*>(seed);
  fs.count = static_cast<int*>(count);
  fs.lock = static_cast<int*>(lock);
  fs.out_g = static_cast<float*>(out_g);
  fs.out_i = static_cast<long long*>(out_i);
  fs.cap = cap;
  fs.sample_tiles = sample_tiles;
  fs.samp_cap = sample_tiles * WTD;
  cudaError_t err;
#define RAGROUTE_FOLD_LAUNCH(DT)                                             \
  err = launch_wgmma<2, DT, true>(q, docs, b, s, nullptr, nullptr, B, N, D,  \
                                  K, G, splits, tiles_per_split, st, fs)
  switch (doc_type) {
    case kBF16: RAGROUTE_FOLD_LAUNCH(kBF16); break;
    case kI8: RAGROUTE_FOLD_LAUNCH(kI8); break;
    case kI4: RAGROUTE_FOLD_LAUNCH(kI4); break;
    default: RAGROUTE_FOLD_LAUNCH(kI4G); break;
  }
#undef RAGROUTE_FOLD_LAUNCH
  return (int)err;
}

// f32 docs (doc_type kF32) and f32 queries [B, D] (16-byte aligned bases), k
// <= KSHALLOW, through f32_topk_kernel (query tiles of 128, doc tiles of 128,
// a ring of `stages`: ops/fused_topk.py::f32_stages), then
// merge_splits_kernel. Arguments otherwise as fused_topk_launch.
extern "C" int fused_topk_f32_launch(const void* q, const void* docs,
                                     const void* bias, const void* scale,
                                     void* part_g, void* part_i, void* out_g,
                                     void* out_i, int B, int N, int D, int K,
                                     int splits, int tiles_per_split,
                                     int stages, void* stream) {
  if (B < 1 || N < 1 || D < 16 || D % 16 != 0 || K < 1 ||
      K > topk::KSHALLOW || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 || stages < 2 || stages > F_MAX_STAGES ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = f_smem_bytes(stages, K);
  if (smem > optin) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, dmap;
  err = hopper_host::make_tmap_2d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                  B, D, D, F_TQ, F_BK);
  if (err != cudaSuccess) return (int)err;
  err = hopper_host::make_tmap_2d(&dmap, docs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                  4, N, D, D, F_TD, F_BK);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pg = static_cast<float*>(part_g);
  int* pi = static_cast<int*>(part_i);
  err = cudaFuncSetAttribute(f32_topk_kernel<topk::SLOTS_SHALLOW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  f32_topk_kernel<topk::SLOTS_SHALLOW>
      <<<dim3((B + F_TQ - 1) / F_TQ, splits), 288, smem, st>>>(
          qmap, dmap, static_cast<const float*>(bias),
          static_cast<const float*>(scale), pg, pi, B, N, D, K, splits,
          tiles_per_split, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk::merge_splits_kernel<long long>
      <<<B, topk::MERGE_THREADS, splits * (int)sizeof(int), st>>>(
          pg, pi, static_cast<float*>(out_g), static_cast<long long*>(out_i),
          splits, K);
  return (int)cudaGetLastError();
}

// f32 docs (doc_type kF32) and f32 queries [B, D] (16-byte aligned bases), k
// <= KSHALLOW, through f32_small_kernel (query tiles of tq = 8, 32 or 64,
// doc tiles of 256, a ring of `stages`: ops/fused_topk.py::f32_small_stages),
// then merge_splits_kernel. Arguments otherwise as fused_topk_launch.
extern "C" int fused_topk_f32_small_launch(const void* q, const void* docs,
                                           const void* bias, const void* scale,
                                           void* part_g, void* part_i,
                                           void* out_g, void* out_i, int B,
                                           int N, int D, int K, int tq,
                                           int splits, int tiles_per_split,
                                           int stages, void* stream) {
  if (B < 1 || N < 1 || D < 16 || D % 16 != 0 || K < 1 ||
      K > topk::KSHALLOW || (tq != 8 && tq != 32 && tq != 64) || splits < 1 ||
      splits > 65535 || tiles_per_split < 1 || stages < 2 ||
      stages > S_MAX_STAGES || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = s_smem_bytes(tq, stages, K);
  if (smem > optin) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, dmap;
  err = hopper_host::make_tmap_2d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                  B, D, D, tq, F_BK);
  if (err != cudaSuccess) return (int)err;
  err = hopper_host::make_tmap_2d(&dmap, docs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                  4, N, D, D, S_TD, F_BK);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(scale);
  float* pg = static_cast<float*>(part_g);
  int* pi = static_cast<int*>(part_i);
  switch (tq) {
    case 8:
      err = launch_f32_small<8>(qmap, dmap, b, s, pg, pi, B, N, D, K, splits,
                                tiles_per_split, stages, smem, st);
      break;
    case 32:
      err = launch_f32_small<32>(qmap, dmap, b, s, pg, pi, B, N, D, K, splits,
                                 tiles_per_split, stages, smem, st);
      break;
    default:
      err = launch_f32_small<64>(qmap, dmap, b, s, pg, pi, B, N, D, K, splits,
                                 tiles_per_split, stages, smem, st);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  topk::merge_splits_kernel<long long>
      <<<B, topk::MERGE_THREADS, splits * (int)sizeof(int), st>>>(
          pg, pi, static_cast<float*>(out_g), static_cast<long long*>(out_i),
          splits, K);
  return (int)cudaGetLastError();
}
