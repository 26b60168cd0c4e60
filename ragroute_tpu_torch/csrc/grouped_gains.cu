// Grouped GEMM of cluster-aligned (query, probed cluster) pair blocks, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/ivf_topk.py::_grouped_gains (body
// _grouped_kernel). The sorted pairs of a batch are laid out in blocks of 64
// rows, every block belonging to one cluster; block i multiplies its 64
// query rows by the slab of cluster blk_cluster[i]:
//
//     out[i * 64 + r, s] = (q[row(i, r)] . docs[c, :, s]) * scale[c, s] + bias[c, s]
//
// docs is stored [C, D, S] (contraction on the middle axis, S contiguous):
// f32, bf16, int8, or int4 as [C, D/2, S] bytes where byte row j holds dim j
// in its low nibble and dim j + D/2 in its high nibble. q is f32 for f32
// slabs and bf16 otherwise; products accumulate in f32; scale may be null;
// bias carries -inf on empty slots. The scale multiply and the bias add are
// two separately rounded operations, in that order. S is any multiple of 8.
//
// row(i, r) is rows[i * 64 + r] when a row table is given (the kernel then
// gathers the query rows itself and the [Ep, D] copy of them never exists),
// else i * 64 + r. When n_real is given, blocks at or past *n_real (the
// padding up to the static bound on the block count) are skipped and their
// output rows left unwritten; nothing collects those rows.
//
// What bounds it on an H100 SXM: at the medrag pubmed shape (B = 512, 512
// probes, about 6,000 real blocks over the 4,096 clusters, D = 768, S =
// 256, bf16) every probed slab read once is about 1.6 GB and the output 0.4
// GB: 0.6 ms at 3.35 TB/s, against 0.15 TFLOP (0.16 ms at 989 TFLOP/s).
// The kernel is bound by the bytes of the slabs.
//
// Three kernels (ops/grouped_gains.py::_plan names one):
//
// grouped_wgmma_kernel, bf16, int8 and int4 slabs: a persistent grid of one
// block an SM walks the (pair block, pass of up to 256 columns) items in
// block order, so the blocks of one cluster run together and its slab is
// read from device memory about once. A producer warp group keeps a ring of
// 2 to 8 stages in flight, each a 64-deep chunk of the contraction: the
// block's 64 query rows, gathered through the row table by cp.async into
// wgmma's 128-byte swizzle (TMA has no row gather), and the slab's [64 x
// up to 256] chunk. bf16 slabs arrive by TMA in boxes of [64 dims x 64
// columns] of the 3-D [C, D, S] view, so a box never reads past its
// cluster's rows. int8 and int4 slabs arrive by cp.async as raw bytes in a
// ring of their own (S is a multiple of 8, not always of 16, so TMA's row
// stride does not always hold) and each producer thread turns its own bytes
// into bf16 (codes.cuh, exact); an int4 chunk of byte rows feeds two stages,
// its low nibbles against the query chunk at dims 64 p .. and its high ones
// against the chunk at D/2 + 64 p ... The slab is MN-major (S contiguous),
// so the B operand takes wgmma's transpose bit: no thread transposes it. One
// consumer warp group runs m64nNk16 (N = 64 to 256, one instruction a k16
// step) into f32 registers, releases each stage when its products are done,
// and forms and stores the item's gains while the producer fills the ring
// with the next item's chunks; the item's bias and scale come with its last
// chunk's stage, which goes back to the ring after the epilogue.
//
// grouped_f32_kernel, f32 slabs (f32_tile.cuh, full f32 FMA): one block of
// 128 threads a (pair block, 128 columns), 8 x 8 accumulators a thread, the
// query rows gathered and the slab's chunk copied by cp.async into a ring
// of 3 stages.
//
// grouped_gains_kernel, the first design, reachable by name for the
// measurements: one block of four warps a (pair block, S tile of 64), WMMA
// m16n16k16 from shared memory (bf16 / int8 / int4; int8 cast and nibble
// unpack on the load path) or plain FMA (f32), synchronous loads with a
// barrier a 64-deep chunk, the output through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "codes.cuh"
#include "f32_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int TE = 64;        // pair rows per block (the layout's group size)
constexpr int TS = 64;        // slab columns per tile
constexpr int BK = 64;        // contraction chunk (elements)
constexpr int THREADS = 128;  // four warps
constexpr int LDA = BK + 8;   // bf16 query tile row stride
constexpr int LDS = TS + 8;   // bf16 slab tile row stride
constexpr int LDAF = BK + 1;  // f32 query tile row stride
constexpr int LDSF = TS + 4;  // f32 slab tile row stride (16-byte rows)
constexpr int LDG = TS + 4;   // output tile row stride (floats)

enum DocType { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM_BF16 = cmax((TE * LDA + BK * LDS) * 2, TE * LDG * 4);
constexpr int SMEM_F32 = cmax((TE * LDAF + BK * LDSF) * 4, TE * LDG * 4);

__device__ __forceinline__ int pair_row(const int* __restrict__ rows, int r) {
  return rows ? rows[r] : r;
}

// ---- bf16 / int8 / int4 slabs on the tensor cores --------------------------

template <int DT>
__device__ __forceinline__ void tile_wmma(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ slab,
    const int* __restrict__ rows, unsigned char* smem, float* sg, int D, int S,
    int e0, int s0, int tid, int warp) {
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + TE * LDA;
  const int wr = warp >> 1, wc = warp & 1;  // warp tile: 32 rows x 32 columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int h = D >> 1;
  for (int k0 = 0; k0 < D; k0 += BK) {
    // query rows [TE, BK], 8 bf16 a vector
    for (int v = tid; v < TE * (BK / 8); v += THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int col = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (col < D)
        val = *reinterpret_cast<const uint4*>(
            q + (size_t)pair_row(rows, e0 + r) * D + col);
      *reinterpret_cast<uint4*>(sa + r * LDA + c) = val;
    }
    // slab rows [BK, TS], 8 columns a vector; S % 8 == 0 keeps a vector
    // inside the row and aligned
    for (int v = tid; v < BK * (TS / 8); v += THREADS) {
      const int kk = v / (TS / 8), c = (v % (TS / 8)) * 8;
      const int dim = k0 + kk, col = s0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (dim < D && col < S) {
        if constexpr (DT == kBF16) {
          val = *reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(slab) + (size_t)dim * S + col);
        } else {
          // int8 codes, or the nibbles of byte row dim (low) / dim - D/2
          // (high); both are exact in bf16
          const bool high = DT == kI4 && dim >= h;
          const int brow = DT == kI4 ? (high ? dim - h : dim) : dim;
          const uint2 raw = *reinterpret_cast<const uint2*>(
              static_cast<const int8_t*>(slab) + (size_t)brow * S + col);
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
          float x[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int w = b[e];
            if constexpr (DT == kI4)
              x[e] = (float)(high ? (w >> 4) : ((int)((unsigned)w << 28) >> 28));
            else
              x[e] = (float)w;
          }
          val = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                           pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
        }
      }
      *reinterpret_cast<uint4*>(sb + kk * LDS + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (wr * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sb + kk * LDS + wc * 32 + j * 16, LDS);
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

// ---- f32 slabs, full f32 FMA -------------------------------------------------

__device__ __forceinline__ void tile_f32(
    const float* __restrict__ q, const float* __restrict__ slab,
    const int* __restrict__ rows, unsigned char* smem, float* sg, int D, int S,
    int e0, int s0, int tid) {
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + TE * LDAF;
  const int tr = tid >> 4, tc = tid & 15;  // rows tr*8..+8, columns tc+16*j
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int v = tid; v < TE * (BK / 4); v += THREADS) {
      const int r = v / (BK / 4), c = (v % (BK / 4)) * 4;
      const int col = k0 + c;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < D)
        a = *reinterpret_cast<const float4*>(
            q + (size_t)pair_row(rows, e0 + r) * D + col);
      float* pa = sa + r * LDAF + c;
      pa[0] = a.x; pa[1] = a.y; pa[2] = a.z; pa[3] = a.w;
    }
    for (int v = tid; v < BK * (TS / 4); v += THREADS) {
      const int kk = v / (TS / 4), c = (v % (TS / 4)) * 4;
      const int dim = k0 + kk, col = s0 + c;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dim < D && col < S)
        b = *reinterpret_cast<const float4*>(slab + (size_t)dim * S + col);
      *reinterpret_cast<float4*>(sb + kk * LDSF + c) = b;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sa[(tr * 8 + i) * LDAF + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[kk * LDSF + tc + 16 * j];
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

template <int DT>
__global__ void __launch_bounds__(THREADS) grouped_gains_kernel(
    const void* __restrict__ q, const void* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ out, int C, int D,
    int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s_tiles = (S + TS - 1) / TS;
  const int blk = blockIdx.x / s_tiles;
  if (n_real && blk >= *n_real) return;  // block-uniform
  const int tid = threadIdx.x, warp = tid >> 5;
  const int s0 = (blockIdx.x % s_tiles) * TS, e0 = blk * TE;
  const int c = min(max(blk_cluster[blk], 0), C - 1);
  float* sg = reinterpret_cast<float*>(smem);
  const int drows = DT == kI4 ? D / 2 : D;
  const size_t esize = DT == kF32 ? 4 : (DT == kBF16 ? 2 : 1);
  const unsigned char* slab =
      static_cast<const unsigned char*>(docs) + (size_t)c * drows * S * esize;
  if constexpr (DT == kF32)
    tile_f32(static_cast<const float*>(q), reinterpret_cast<const float*>(slab),
             rows, smem, sg, D, S, e0, s0, tid);
  else
    tile_wmma<DT>(static_cast<const __nv_bfloat16*>(q), slab, rows, smem, sg, D,
                  S, e0, s0, tid, warp);
  // epilogue: scale, then bias, each rounded on its own; coalesced along S
  const float* brow = bias + (size_t)c * S;
  const float* srow = scale ? scale + (size_t)c * S : nullptr;
  for (int e = tid; e < TE * TS; e += THREADS) {
    const int r = e / TS, cc = e % TS, col = s0 + cc;
    if (col < S) {
      float x = sg[r * LDG + cc];
      if (srow) x = __fmul_rn(x, srow[col]);
      x = __fadd_rn(x, brow[col]);
      out[(size_t)(e0 + r) * S + col] = x;
    }
  }
}

template <int DT>
cudaError_t launch(const void* q, const void* docs, const float* bias,
                   const float* scale, const int* blk_cluster, const int* rows,
                   const int* n_real, float* out, int G, int C, int D, int S,
                   cudaStream_t stream) {
  constexpr int smem = DT == kF32 ? SMEM_F32 : SMEM_BF16;
  const long long blocks = (long long)((S + TS - 1) / TS) * G;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  grouped_gains_kernel<DT><<<grid, THREADS, smem, stream>>>(
      q, docs, bias, scale, blk_cluster, rows, n_real, out, C, D, S);
  return cudaGetLastError();
}

// ---- bf16, int8 and int4 slabs: wgmma fed by a ring (grouped_wgmma_kernel) --

constexpr int GW_K = 64;                  // contraction chunk (dims)
constexpr int GW_COLS = 64;               // slab columns a B tile
constexpr int GW_A_BYTES = TE * 128;      // 64 rows x 64 bf16, K-major
constexpr int GW_B_TILE = GW_K * 128;     // 64 dims x 64 bf16, MN-major
constexpr int GW_THREADS = 256;           // a consumer and a producer group
constexpr int GW_MAX_STAGES = 8;
constexpr int GW_MAX_STAGING = 8;

__host__ __device__ constexpr int gw_stage_bytes(int nt) {
  return GW_A_BYTES + nt * GW_B_TILE;
}

// int8 / int4: one slot of the staging ring, a chunk as it arrives: the
// query rows' pieces, the raw slab bytes (64 byte rows x 64 nt), the item's
// bias and scale columns
__host__ __device__ constexpr int gw_staging_bytes(int nt) {
  return GW_A_BYTES + GW_K * GW_COLS * nt + 2 * GW_COLS * nt * 4;
}

// Shared memory of a block at NT B tiles a pass, `stages` ring stages and
// `staging` staging slots (int8 / int4): the ring, each stage's bias and
// scale columns, the staging ring, the barriers, and 1024 bytes to align
// the ring.
__host__ __device__ constexpr int gw_smem_bytes(int nt, int stages,
                                                int staging) {
  return stages * (gw_stage_bytes(nt) + 2 * GW_COLS * nt * 4) +
         staging * gw_staging_bytes(nt) + 2 * stages * 8 + 1024;
}

// A persistent block walks items it = blockIdx.x + n gridDim.x, item =
// (pair block blk, pass) with blk < min(G, *n_real), the pass of NT x 64
// columns fastest; chunk i of the block's walk is the item's contraction
// chunk i % chunks (int4: chunk 2 p the low nibbles of byte rows 64 p ..,
// 2 p + 1 their high nibbles) in ring stage i % stages. Each producer thread
// copies its own share of chunk i (the query rows' 16-byte pieces, the raw
// bytes of its slab units, the item's bias and scale with its last chunk;
// one thread: bf16's TMA boxes) and publishes it: its own copies landed,
// (int8 / int4) its units converted, a fence for the tensor cores, an
// arrival on the stage's barrier.
//   * bf16: the copies go straight into the stage, `stages - 2` chunks
//     before their publication (issuing chunk i + ahead waits for the stage
//     of chunk i + ahead - stages, which the consumer frees once it is done
//     with the chunk after that one: it must be published by then);
//   * int8 / int4: the copies go to a staging ring of `staging` slots,
//     `staging - 1` chunks ahead, and no thread waits for another to reuse
//     a slot (each reads back only what it copied); the publication waits
//     for the stage, moves the query pieces into it and converts the raw
//     units, and only then loads the next chunk into the slot just read
//     (an int4 chunk of byte rows feeds two stages from its even chunk's
//     slot, which the odd chunk's publication reads last).
template <int NT, int DT>
__global__ void __launch_bounds__(GW_THREADS, 1) grouped_wgmma_kernel(
    const __grid_constant__ CUtensorMap smap,
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ out, int G, int C,
    int D, int S, int stages, int staging) {
  constexpr bool RAW = DT != kBF16;
  constexpr bool I4 = DT == kI4;
  constexpr int N = NT * GW_COLS;         // columns a pass
  constexpr int STAGE = gw_stage_bytes(NT);
  constexpr int SLOT = gw_staging_bytes(NT);
  constexpr int RAW_BYTES = GW_K * N;     // a raw chunk: 64 byte rows x N
  constexpr int UNITS = GW_K * (N / 8) / 128;  // raw 8-byte units a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* side = reinterpret_cast<float*>(ring + stages * STAGE);
  unsigned char* stg = reinterpret_cast<unsigned char*>(side + stages * 2 * N);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + (RAW ? staging : 0) * SLOT);
  uint64_t* empty = full + stages;
  const int wg = threadIdx.x >> 7;
  const int ds = I4 ? D / 2 : D;          // the slab's rows
  const int chunks = I4 ? 2 * ((ds + GW_K - 1) / GW_K) : (D + GW_K - 1) / GW_K;
  const int passes = (S + N - 1) / N;
  const int nb = n_real ? min(G, max(*n_real, 0)) : G;
  const int items = nb * passes;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // every producer thread's publication; bf16: and the TMA's bytes
      hopper::mbar_init(&full[s], 128 + (RAW ? 0 : 1));
      hopper::mbar_init(&empty[s], 4);   // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 1) {  // ---- producer ----
    const int ptid = threadIdx.x - 128;
    // chunk i's item, contraction chunk, cluster and first column
    struct Chunk { int blk, c, cl, n0; };
    auto chunk_of = [&](int i) {
      const int it = (int)blockIdx.x + (i / chunks) * (int)gridDim.x;
      Chunk k;
      k.blk = it / passes;
      k.c = i % chunks;
      k.cl = min(max(__ldg(blk_cluster + k.blk), 0), C - 1);
      k.n0 = (it - k.blk * passes) * N;
      return k;
    };
    // this thread's 4 pieces of the query rows (64 rows x 8 pieces of 8
    // dims): piece v = ptid + 128 j into dst(v); zeros past the columns
    // the chunk covers (int4: its half of the row)
    auto copy_rows = [&](const Chunk& k, auto dst) {
      const int local0 = (I4 ? k.c >> 1 : k.c) * GW_K;
      const int qbase = I4 && (k.c & 1) ? ds : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = ptid + 128 * j, r = v >> 3, local = local0 + 8 * (v & 7);
        const int row = rows ? __ldg(rows + k.blk * TE + r) : k.blk * TE + r;
        const bool valid = local < ds;
        f32tile::cp_async16(dst(v), valid ? q + (size_t)row * D + qbase + local
                                          : q, valid);
      }
    };
    // the item's bias and scale columns (with its last chunk), threads
    // 0 .. N / 2 - 1, 16 bytes each, into dst[0, 2 N)
    auto copy_side = [&](const Chunk& k, float* dst) {
      if (k.c == chunks - 1 && ptid < 2 * (N / 4)) {
        const int which = ptid / (N / 4), p = ptid % (N / 4);
        const int col = k.n0 + 4 * p;
        const float* src = which ? scale : bias;
        const bool valid = src != nullptr && col < S;
        f32tile::cp_async16(dst + which * N + 4 * p,
                            valid ? src + (size_t)k.cl * S + col : bias, valid);
      }
    };
    if constexpr (!RAW) {
      if (ptid == 0) hopper::prefetch_tmap(&smap);
      const int ahead = stages - 2;
      auto issue = [&](int i) {
        if (i < total) {
          const Chunk k = chunk_of(i);
          const int s = i % stages;
          unsigned char* st = ring + s * STAGE;
          hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
          copy_rows(k, [&](int v) {
            const int r = v >> 3;
            return st + r * 128 + (((v & 7) ^ (r & 7)) << 4);
          });
          copy_side(k, side + s * 2 * N);
          if (ptid == 0) {
            hopper::mbar_arrive_expect_tx(&full[s], NT * GW_B_TILE);
#pragma unroll
            for (int t = 0; t < NT; ++t)
              hopper::tma_load_3d(st + GW_A_BYTES + t * GW_B_TILE, &smap,
                                  &full[s], k.n0 + GW_COLS * t, k.c * GW_K,
                                  k.cl);
          }
        }
        f32tile::cp_async_commit();   // empty past the end: the count holds
      };
      for (int i = 0; i < ahead; ++i) issue(i);
      for (int i = 0; i < total; ++i) {
        issue(i + ahead);
        f32tile::cp_async_wait(ahead);   // chunk i's copies (this thread's)
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[i % stages]);
      }
    } else {
      const int8_t* base = static_cast<const int8_t*>(docs);
      auto slot = [&](int i) { return stg + (i % staging) * SLOT; };
      // raw chunk rc (int4: one for two chunks) sits in the slot of the
      // chunk that loaded it
      auto raw_of = [&](int i) {
        return slot(I4 ? i & ~1 : i) + GW_A_BYTES;
      };
      auto load = [&](int i) {
        if (i < total) {
          const Chunk k = chunk_of(i);
          unsigned char* sl = slot(i);
          copy_rows(k, [&](int v) { return sl + 16 * v; });
          copy_side(k, reinterpret_cast<float*>(sl + GW_A_BYTES + RAW_BYTES));
          if (!I4 || (k.c & 1) == 0) {
            // this thread's raw units: byte row r, columns 8 p8 ..
            const int local0 = (I4 ? k.c >> 1 : k.c) * GW_K;
            const int8_t* slab = base + (size_t)k.cl * ds * S;
            unsigned char* rb = sl + GW_A_BYTES;
#pragma unroll
            for (int j = 0; j < UNITS; ++j) {
              const int u = ptid + 128 * j, r = u / (N / 8), p8 = u % (N / 8);
              const int drow = local0 + r, col = k.n0 + 8 * p8;
              const bool valid = drow < ds && col < S;
              f32tile::cp_async8(rb + r * N + 8 * p8,
                                 valid ? slab + (size_t)drow * S + col : slab,
                                 valid);
            }
          }
        }
        f32tile::cp_async_commit();
      };
      for (int i = 0; i < staging - 1; ++i) load(i);
      for (int i = 0; i < total; ++i) {
        f32tile::cp_async_wait(staging - 2);   // chunk i's copies landed
        const int c = i % chunks, s = i % stages;
        unsigned char* st = ring + s * STAGE;
        const unsigned char* sl = slot(i);
        hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {    // the query pieces, swizzled
          const int v = ptid + 128 * j, r = v >> 3;
          *reinterpret_cast<uint4*>(st + r * 128 + (((v & 7) ^ (r & 7)) << 4)) =
              *reinterpret_cast<const uint4*>(sl + 16 * v);
        }
        if (c == chunks - 1 && ptid < 2 * (N / 4))
          *reinterpret_cast<float4*>(side + s * 2 * N + 4 * ptid) =
              *reinterpret_cast<const float4*>(sl + GW_A_BYTES + RAW_BYTES +
                                               16 * ptid);
        const unsigned char* rb = raw_of(i);
        unsigned char* bt = st + GW_A_BYTES;
        const bool high = I4 && (c & 1);
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
          const int u = ptid + 128 * j, r = u / (N / 8), p8 = u % (N / 8);
          const uint2 w = *reinterpret_cast<const uint2*>(rb + r * N + 8 * p8);
          uint2 a, b;
          if constexpr (I4) {
            a = codes::nibbles4_bf16(w.x, high);
            b = codes::nibbles4_bf16(w.y, high);
          } else {
            a = codes::int8x4_bf16(w.x);
            b = codes::int8x4_bf16(w.y);
          }
          // row r of B tile p8 / 8, its 16-byte piece p8 % 8, swizzled
          *reinterpret_cast<uint4*>(bt + (p8 >> 3) * GW_B_TILE + r * 128 +
                                    (((p8 & 7) ^ (r & 7)) << 4)) =
              make_uint4(a.x, a.y, b.x, b.y);
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
        // into the slot of chunk i - 1, published (int4: the raw bytes of
        // chunk i - 1 were chunk i's, converted just now)
        load(i + staging - 1);
      }
    }
    return;
  }

  // ---- consumer ----
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // accumulator 4 g + v holds row r0 + 8 (v >> 1), column 8 g + 2 tig +
  // (v & 1) of the pass
  const int r0 = 16 * warp + gid;
  constexpr int NACC = N / 2;
  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.0f;
  for (int i = 0, n = 0; n < mine; ++n) {
    const int it = (int)blockIdx.x + n * (int)gridDim.x;
    const int blk = it / passes, n0 = (it - blk * passes) * N;
    for (int c = 0; c < chunks; ++c, ++i) {
      const int s = i % stages;
      const unsigned char* st = ring + s * STAGE;
      hopper::mbar_wait(&full[s], (i / stages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GW_K / 16; ++kk)
        hopper::wgmma_m64nk16_ss_tb<N>(
            acc, hopper::desc_sw128(st + 32 * kk),
            hopper::desc_sw128_mn(st + GW_A_BYTES + 2048 * kk, GW_B_TILE),
            c > 0 || kk > 0);
      hopper::wgmma_commit();
      // the chunk before this one is done: its stage goes back to the ring
      hopper::wgmma_wait<1>();
      if (c > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % stages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_accumulators<NACC>(acc);
    // scale, then bias, each rounded on its own; the last chunk's stage
    // holds the item's columns and goes back to the ring after
    const int sl = (i - 1) % stages;
    const float* sb = side + sl * 2 * N;
    const float* ss = sb + N;
    float* o0 = out + (size_t)(blk * TE + r0) * S + n0;
    float* o1 = o0 + (size_t)8 * S;
#pragma unroll
    for (int g = 0; g < N / 8; ++g) {
      const int col = 8 * g + 2 * tig;
      if (n0 + col < S) {
        const float2 b = *reinterpret_cast<const float2*>(sb + col);
        float x[4] = {acc[4 * g], acc[4 * g + 1], acc[4 * g + 2],
                      acc[4 * g + 3]};
        if (scale) {
          const float2 sc = *reinterpret_cast<const float2*>(ss + col);
          x[0] = __fmul_rn(x[0], sc.x);
          x[1] = __fmul_rn(x[1], sc.y);
          x[2] = __fmul_rn(x[2], sc.x);
          x[3] = __fmul_rn(x[3], sc.y);
        }
        *reinterpret_cast<float2*>(o0 + col) =
            make_float2(__fadd_rn(x[0], b.x), __fadd_rn(x[1], b.y));
        *reinterpret_cast<float2*>(o1 + col) =
            make_float2(__fadd_rn(x[2], b.x), __fadd_rn(x[3], b.y));
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[sl]);
  }
}

template <int NT, int DT>
cudaError_t launch_wgmma(const void* q, const void* docs, const float* bias,
                         const float* scale, const int* blk_cluster,
                         const int* rows, const int* n_real, float* out,
                         int G, int C, int D, int S, int grid, int stages,
                         int staging, cudaStream_t stream) {
  constexpr bool RAW = DT != kBF16;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (RAW && (staging < 1 || staging > GW_MAX_STAGING))
    return cudaErrorInvalidValue;
  const int smem = gw_smem_bytes(NT, stages, RAW ? staging : 0);
  if (smem > optin) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap smap{};
  if constexpr (!RAW) {
    err = hopper_host::make_tmap_3d(&smap, docs,
                                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C, D,
                                    S, GW_K, GW_COLS);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(grouped_wgmma_kernel<NT, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  grouped_wgmma_kernel<NT, DT><<<grid, GW_THREADS, smem, stream>>>(
      smap, static_cast<const __nv_bfloat16*>(q), docs, bias, scale,
      blk_cluster, rows, n_real, out, G, C, D, S, stages, staging);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_wgmma_nt(const void* q, const void* docs,
                            const float* bias, const float* scale,
                            const int* blk_cluster, const int* rows,
                            const int* n_real, float* out, int G, int C,
                            int D, int S, int grid, int stages, int staging,
                            cudaStream_t stream) {
  const int tiles = (S + GW_COLS - 1) / GW_COLS;
#define RAGROUTE_GW(NT)                                                    \
  return launch_wgmma<NT, DT>(q, docs, bias, scale, blk_cluster, rows,     \
                              n_real, out, G, C, D, S, grid, stages,       \
                              staging, stream)
  switch (tiles) {
    case 1: RAGROUTE_GW(1);
    case 2: RAGROUTE_GW(2);
    case 3: RAGROUTE_GW(3);
    default: RAGROUTE_GW(4);   // passes of 256 columns past 256
  }
#undef RAGROUTE_GW
}

// ---- f32 slabs: f32_tile.cuh on the CUDA cores (grouped_f32_kernel) --------

constexpr int GF_THREADS = 128;
constexpr int GF_COLS = 128;              // slab columns a block
constexpr int GF_STAGE = (TE * f32tile::LDK + f32tile::BK * GF_COLS) * 4;

__host__ __device__ constexpr int gf_smem_bytes(int stages) {
  return stages * GF_STAGE;
}

// One block a (pair block, 128 columns), the columns fastest: thread (ty, tx)
// = (tid / 16, tid % 16) keeps rows ty + 8 i and columns 4 tx .. + 4, 64 +
// 4 tx .. + 4; the query rows (gathered through the row table) and the
// slab's [32 x 128] chunk reach a ring of `stages` by cp.async.
__global__ void __launch_bounds__(GF_THREADS) grouped_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ out, int C, int D,
    int S, int stages) {
  using f32tile::BK;
  using f32tile::LDK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int passes = (S + GF_COLS - 1) / GF_COLS;
  const int blk = blockIdx.x / passes;
  if (n_real && blk >= *n_real) return;  // block-uniform
  const int s0 = (blockIdx.x - blk * passes) * GF_COLS, e0 = blk * TE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = min(max(blk_cluster[blk], 0), C - 1);
  const float* slab = docs + (size_t)c * D * S;
  const int chunks = (D + BK - 1) / BK;
  auto issue = [&](int k) {
    if (k < chunks) {
      float* sa = reinterpret_cast<float*>(smem + (k % stages) * GF_STAGE);
      float* sb = sa + TE * LDK;
      const int k0 = k * BK;
      f32tile::load_k_rows<TE, GF_THREADS>(
          sa, [&](int r) { return q + (size_t)pair_row(rows, e0 + r) * D; },
          k0, D, q, tid);
#pragma unroll
      for (int j = 0; j < BK * (GF_COLS / 4) / GF_THREADS; ++j) {
        const int v = tid + GF_THREADS * j, kk = v / (GF_COLS / 4);
        const int p = v % (GF_COLS / 4), dim = k0 + kk, col = s0 + 4 * p;
        const bool valid = dim < D && col < S;
        f32tile::cp_async16(sb + kk * GF_COLS + 4 * p,
                   valid ? slab + (size_t)dim * S + col : docs, valid);
      }
    }
    f32tile::cp_async_commit();
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k = 0; k < stages - 1; ++k) issue(k);
  for (int k = 0; k < chunks; ++k) {
    f32tile::cp_async_wait(stages - 2);   // chunk k's copies (this thread's)
    __syncthreads();             // everyone's; and chunk k - 1 is consumed
    issue(k + stages - 1);
    const float* sa = reinterpret_cast<const float*>(smem + (k % stages) * GF_STAGE);
    f32tile::fma_nn<8>(acc, sa, sa + TE * LDK, GF_COLS, ty, 4 * tx);
  }
  // scale, then bias, each rounded on its own; four columns a store
  const float* brow = bias + (size_t)c * S;
  const float* srow = scale ? scale + (size_t)c * S : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = s0 + 64 * h + 4 * tx;
    if (col >= S) continue;
    const float4 b = *reinterpret_cast<const float4*>(brow + col);
    const float4 sc = srow ? *reinterpret_cast<const float4*>(srow + col)
                           : make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* a = acc[i] + 4 * h;
      float4 x = make_float4(a[0], a[1], a[2], a[3]);
      if (srow) {
        x.x = __fmul_rn(x.x, sc.x);
        x.y = __fmul_rn(x.y, sc.y);
        x.z = __fmul_rn(x.z, sc.z);
        x.w = __fmul_rn(x.w, sc.w);
      }
      x = make_float4(__fadd_rn(x.x, b.x), __fadd_rn(x.y, b.y),
                      __fadd_rn(x.z, b.z), __fadd_rn(x.w, b.w));
      *reinterpret_cast<float4*>(out + (size_t)(e0 + ty + 8 * i) * S + col) = x;
    }
  }
}

}  // namespace

// The first design (grouped_gains_kernel), on `stream`. q is [*, D] (f32
// for doc_type 0, bf16 otherwise); docs
// [C, D, S] (or [C, D/2, S] bytes for doc_type 3); bias [C, S] f32; scale
// [C, S] f32 or null; blk_cluster [G] i32; rows [G * 64] i32 or null; n_real
// a device i32 or null; out [G * 64, S] f32. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int grouped_gains_launch(const void* q, const void* docs,
                                    const void* bias, const void* scale,
                                    const void* blk_cluster, const void* rows,
                                    const void* n_real, void* out, int G, int C,
                                    int D, int S, int doc_type, void* stream) {
  if (G < 1 || C < 1 || D < 16 || D % 16 != 0 || S < 8 ||
      S % 8 != 0 || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(scale);
  const int* bc = static_cast<const int*>(blk_cluster);
  const int* rw = static_cast<const int*>(rows);
  const int* nr = static_cast<const int*>(n_real);
  float* o = static_cast<float*>(out);
  switch (doc_type) {
    case kF32: return (int)launch<kF32>(q, docs, b, s, bc, rw, nr, o, G, C, D, S, st);
    case kBF16: return (int)launch<kBF16>(q, docs, b, s, bc, rw, nr, o, G, C, D, S, st);
    case kI8: return (int)launch<kI8>(q, docs, b, s, bc, rw, nr, o, G, C, D, S, st);
    case kI4: return (int)launch<kI4>(q, docs, b, s, bc, rw, nr, o, G, C, D, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16, int8 or int4 slabs (doc_type 1 to 3) through grouped_wgmma_kernel on
// `grid` persistent blocks (at most one an SM: the ring takes its shared
// memory) with a ring of `stages` and, for int8 / int4, a staging ring of
// `staging` slots (ops/grouped_gains.py::_plan); q bf16 and docs 16-byte
// aligned. Arguments otherwise as grouped_gains_launch.
extern "C" int grouped_gains_wgmma_launch(
    const void* q, const void* docs, const void* bias, const void* scale,
    const void* blk_cluster, const void* rows, const void* n_real, void* out,
    int G, int C, int D, int S, int doc_type, int grid, int stages,
    int staging, void* stream) {
  if (G < 1 || C < 1 || D < 16 || D % 16 != 0 || S < 8 || S % 8 != 0 ||
      bias == nullptr || grid < 1 || stages < 2 || stages > GW_MAX_STAGES ||
      doc_type < kBF16 || doc_type > kI4 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(scale);
  const int* bc = static_cast<const int*>(blk_cluster);
  const int* rw = static_cast<const int*>(rows);
  const int* nr = static_cast<const int*>(n_real);
  float* o = static_cast<float*>(out);
  switch (doc_type) {
    case kBF16:
      return (int)launch_wgmma_nt<kBF16>(q, docs, b, s, bc, rw, nr, o, G, C, D,
                                         S, grid, stages, staging, st);
    case kI8:
      return (int)launch_wgmma_nt<kI8>(q, docs, b, s, bc, rw, nr, o, G, C, D,
                                       S, grid, stages, staging, st);
    default:
      return (int)launch_wgmma_nt<kI4>(q, docs, b, s, bc, rw, nr, o, G, C, D,
                                       S, grid, stages, staging, st);
  }
}

// f32 slabs through grouped_f32_kernel: one block a (pair block, 128
// columns) with a ring of `stages`; q f32 and docs 16-byte aligned.
// Arguments otherwise as grouped_gains_launch.
extern "C" int grouped_gains_f32_launch(const void* q, const void* docs,
                                        const void* bias, const void* scale,
                                        const void* blk_cluster,
                                        const void* rows, const void* n_real,
                                        void* out, int G, int C, int D, int S,
                                        int stages, void* stream) {
  if (G < 1 || C < 1 || D < 16 || D % 16 != 0 || S < 8 || S % 8 != 0 ||
      bias == nullptr || stages < 2 || stages > 8 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((S + GF_COLS - 1) / GF_COLS) * G;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = gf_smem_bytes(stages);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  grouped_f32_kernel<<<(unsigned)blocks, GF_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(docs),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const int*>(blk_cluster), static_cast<const int*>(rows),
      static_cast<const int*>(n_real), static_cast<float*>(out), C, D, S,
      stages);
  return (int)cudaGetLastError();
}
