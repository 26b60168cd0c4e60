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
// padding up to the static bound on the block count) return at once and
// leave their output rows unwritten; nothing collects those rows.
//
// Design (simple first, fast later): one CUDA block per (pair block, S tile
// of 64), flattened on the grid's x axis. Its four warps build one [64 x 64]
// output tile over D in chunks of 64: bf16 / int8 / int4 on the tensor cores (WMMA m16n16k16, int8 cast and
// nibble unpack on the load path, both exact in bf16), f32 by plain FMA in
// full f32. The S tile index runs fastest, so the tiles of one pair block
// run together and share its query rows in L2.
//
// What bounds it on an H100 SXM: at the medrag pubmed shape (B = 512, 512
// probes, about 6,100 real blocks, D = 768, S = 256, bf16) the product is
// ~0.15 TFLOP (0.16 ms at 989 TFLOP/s) and the output alone is ~0.4 GB
// (0.12 ms at 3.35 TB/s), with the probed slabs (0.39 MB each, mostly read
// from L2 after the first block of a cluster) on top: bytes and operations
// are within a factor of two of each other. This design does nothing clever
// about either: WMMA from shared memory without cp.async or TMA, no wgmma,
// and the output goes through shared memory once for the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

}  // namespace

// Launch on `stream`. q is [*, D] (f32 for doc_type 0, bf16 otherwise); docs
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
