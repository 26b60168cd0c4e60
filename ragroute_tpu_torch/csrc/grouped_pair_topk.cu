// Grouped GEMM of cluster-aligned (query, probed cluster) pair blocks with a
// rank-capped top extraction fused in, for Hopper (sm_90a).
//
// Replaces the TPU kernel ragroute_tpu/ops/grouped_topk.py::_grouped_pair_topk
// (body _grouped_topk_kernel). The pairs of a batch are laid out in blocks of
// 256 rows, every block belonging to one cluster; block i scores its rows
// against the int8 coarse slab of cluster blk_cluster[i]:
//
//     gain[r, s] = (q[row(i, r)] . docs[c, :, s]) * scale[c, s] + bias[c, s]
//
// docs is [C, R, S] int8 (contraction on the middle axis, S contiguous), q is
// bf16, the product sums in f32, and the scale multiply and the bias add are
// two separately rounded operations, in that order. bias carries -inf on empty
// slots. The gains are never written to device memory. Instead the slot axis
// is cut into tiles of `tds` slots (a multiple of 64); per (row, tile) the
// `ranks` largest gains, ties to the lowest slot, are offered best first to
// the row's sorted list of kw = ranks * ceil(S / tds) entries, tiles in
// ascending order. An offer lands after the entries equal to it; -inf never
// enters. The list can hold every offer, so what comes out is the stable
// descending sort of the offers; unfilled entries read (-inf, 0).
//
// row(i, r) is rows[i * 256 + r] when a row table is given (the kernel gathers
// the query rows itself), else i * 256 + r. When n_real is given, blocks at or
// past *n_real (the padding up to the static bound on the block count) return
// at once and leave their output rows unwritten; nothing collects those rows.
//
// Design (simple first, fast later). The TPU kernel holds a [256, 1024] f32
// gain tile in its 1 MB of VMEM; an SM has 227 KB. So one CUDA block of 256
// threads takes one pair block and walks the slab in sub-tiles of 64 slots:
// its eight warps build a [256 x 64] gain sub-tile on the tensor cores (WMMA
// m16n16k16, int8 codes cast to bf16 on the load path, which is exact) and
// store it column-major in shared memory; then thread t scans row t of the
// sub-tile in ascending slot order (consecutive threads read consecutive
// words: no bank conflicts), applies scale and bias, and keeps the tile's
// `ranks` best so far in registers (a sorted list of RT >= ranks entries,
// insertion after equals; a rank cap above 16, which only a caller that opens
// the cap asks for, keeps the list in local memory instead). At a tile's end
// the thread offers those to its running list, which lives in the row's
// output entries (kw is about 8).
// The query rows of the block stay in shared memory for the whole slab when
// the depth fits one chunk of 128 (the serving rank); deeper slabs reload
// them per sub-tile.
//
// A per-tile list deeper than RMAX = 160 (ranks = ceil(kappa / n_tiles) is
// uncapped in the TPU kernel: an open cap, kappa >= k', asks for 256 and
// more) does not fit a thread. For those, grouped_pair_topk_deep_launch
// writes the sub-tiles' scaled and biased gains of a chunk of pair blocks to
// device memory (pair_gains_kernel, the same products and roundings), and
// deep_topk.cuh selects each (row, tile)'s `ranks` best by radix select and
// a bitonic sort in shared memory and merges a row's tiles to kw, the plain
// version's order (gain descending, slot ascending).
//
// What bounds it on an H100 SXM: at the serving shape (B = 512, 512 probes of
// 4,096 clusters, R = 128, S = 1,584) every probed slab read once is about
// 0.83 GB (0.25 ms at 3.35 TB/s); the product over the blocks' rows is 0.11
// TFLOP when the blocks are full and 0.43 TFLOP (0.43 ms at 989 TFLOP/s) when
// every cluster holds one block a quarter full, as evenly spread probes leave
// them. Bytes and operations are within a factor of two of each other. This
// design is far from both (7.2 ms at that shape on an H100 80GB HBM3 at 700
// W): one block of eight warps an SM (155 KB of shared memory), WMMA from
// shared memory without cp.async or TMA, three barriers a sub-tile, and a
// scalar scan of every gain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "deep_topk.cuh"

namespace {

using namespace nvcuda;

constexpr int TE = 256;       // pair rows per block (the layout's group size)
constexpr int TS = 64;        // slab columns per sub-tile
constexpr int BK = 128;       // contraction chunk (elements)
constexpr int THREADS = 256;  // eight warps; thread t owns pair row t
constexpr int LDA = BK + 8;   // bf16 query tile row stride
constexpr int LDB = TS + 8;   // bf16 slab tile row stride
constexpr int LDG = TE + 4;   // gain sub-tile column stride (floats)
constexpr int SMEM_A = TE * LDA * 2;
constexpr int SMEM_B = BK * LDB * 2;
constexpr int SMEM_G = TS * LDG * 4;
constexpr int SMEM = SMEM_A + SMEM_B + SMEM_G + 2 * TS * 4;
constexpr int RREG = 16;      // deepest per-tile list kept in registers
constexpr int RMAX = 160;     // deepest per-tile list (local memory past RREG)

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Insert (x, slot) into the sorted list (tg, ti) after every entry >= x; the
// last entry falls off. The caller has checked that x beats the last entry.
// Lists of up to RREG entries are fully unrolled, so they stay in registers;
// deeper ones (RT == RMAX, `len` entries in use) shift in local memory.
template <int RT>
__device__ __forceinline__ void tile_insert(float (&tg)[RT], int (&ti)[RT], float x,
                                            int slot, int len) {
  if constexpr (RT <= RREG) {
    bool ins = false;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      if (ins || x > tg[j]) {
        const float og = tg[j];
        const int oi = ti[j];
        tg[j] = x;
        ti[j] = slot;
        x = og;
        slot = oi;
        ins = true;
      }
    }
  } else {
    int pos = len - 1;
    while (pos > 0 && tg[pos - 1] < x) {
      tg[pos] = tg[pos - 1];
      ti[pos] = ti[pos - 1];
      --pos;
    }
    tg[pos] = x;
    ti[pos] = slot;
  }
}

// The [TE x TS] gain sub-tile of slots [s0, s0 + TS) of the block's slab
// (before scale and bias) into sg column-major (sg[col * LDG + row]), and
// the sub-tile's bias and scale into sbias / sscale. The query rows are
// loaded at the first sub-tile and, when the depth takes more than one
// chunk, again for every sub-tile. Ends with a barrier.
__device__ __forceinline__ void gain_subtile(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ slab,
    const float* __restrict__ brow, const float* __restrict__ srow,
    const int* __restrict__ rows, int e0, int R, int S, int s0,
    unsigned char* smem, int tid, int warp) {
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_A);
  float* sg = reinterpret_cast<float*>(smem + SMEM_A + SMEM_B);
  float* sbias = sg + TS * LDG;
  float* sscale = sbias + TS;
  const int n_k = (R + BK - 1) / BK;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int kc = 0; kc < n_k; ++kc) {
    const int k0 = kc * BK;
    const int kmax = min(BK, R - k0);  // a multiple of 16
    if (n_k > 1 || s0 == 0) {
      // query rows [TE, BK], 8 bf16 a vector
      for (int v = tid; v < TE * (BK / 8); v += THREADS) {
        const int r = v / (BK / 8), cc = (v % (BK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (cc < kmax) {
          const int row = rows ? rows[e0 + r] : e0 + r;
          val = *reinterpret_cast<const uint4*>(q + (size_t)row * R + k0 + cc);
        }
        *reinterpret_cast<uint4*>(sa + r * LDA + cc) = val;
      }
    }
    // slab rows [BK, TS] int8 -> bf16, 8 columns a vector; S % 8 == 0 keeps
    // a vector inside the row and aligned
    for (int v = tid; v < BK * (TS / 8); v += THREADS) {
      const int kk = v / (TS / 8), cc = (v % (TS / 8)) * 8;
      const int col = s0 + cc;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kk < kmax && col < S) {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(slab + (size_t)(k0 + kk) * S + col);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        val = make_uint4(pack_bf16((float)b[0], (float)b[1]),
                         pack_bf16((float)b[2], (float)b[3]),
                         pack_bf16((float)b[4], (float)b[5]),
                         pack_bf16((float)b[6], (float)b[7]));
      }
      *reinterpret_cast<uint4*>(sb + kk * LDB + cc) = val;
    }
    if (kc == 0 && tid < TS) {
      const int col = s0 + tid;
      sbias[tid] = col < S ? brow[col] : neg_inf();
      sscale[tid] = col < S ? srow[col] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kmax; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (warp * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], sb + kk * LDB + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next chunk (or sub-tile) overwrites sa / sb
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sg + (j * 16) * LDG + warp * 32 + i * 16, acc[i][j],
                              LDG, wmma::mem_col_major);
  __syncthreads();
}

template <int RT>
__global__ void __launch_bounds__(THREADS) grouped_pair_topk_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ out_g,
    int* __restrict__ out_i, int C, int R, int S, int tds, int ranks, int kw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = blockIdx.x;
  if (n_real && blk >= *n_real) return;  // block-uniform
  const float* sg = reinterpret_cast<const float*>(smem + SMEM_A + SMEM_B);
  const float* sbias = sg + TS * LDG;
  const float* sscale = sbias + TS;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int e0 = blk * TE;
  const int c = min(max(blk_cluster[blk], 0), C - 1);
  const int8_t* slab = docs + (size_t)c * R * S;
  const float* brow = bias + (size_t)c * S;
  const float* srow = scale + (size_t)c * S;

  // the row's running list lives in its output entries
  float* lg = out_g + (size_t)(e0 + tid) * kw;
  int* li = out_i + (size_t)(e0 + tid) * kw;
  for (int j = 0; j < kw; ++j) {
    lg[j] = neg_inf();
    li[j] = 0;
  }
  int filled = 0;
  float tg[RT];
  int ti[RT];
  const int len = RT <= RREG ? RT : ranks;  // list entries in use
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    tg[j] = neg_inf();
    ti[j] = 0;
  }

  for (int s0 = 0; s0 < S; s0 += TS) {
    gain_subtile(q, slab, brow, srow, rows, e0, R, S, s0, smem, tid, warp);

    // thread t scans row t in ascending slot order: scale, then bias, each
    // rounded on its own
    const int ncols = min(TS, S - s0);
    for (int cc = 0; cc < ncols; ++cc) {
      float x = __fmul_rn(sg[cc * LDG + tid], sscale[cc]);
      x = __fadd_rn(x, sbias[cc]);
      if (x > tg[len - 1]) tile_insert<RT>(tg, ti, x, s0 + cc, len);
    }
    if ((s0 + TS) % tds == 0 || s0 + TS >= S) {
      // the tile's end: offer its winners, best first, to the running list
      auto offer = [&](int j) {
        const float x = tg[j];
        if (j < ranks && x > neg_inf() && filled < kw) {
          int pos = filled;
          while (pos > 0 && lg[pos - 1] < x) {
            lg[pos] = lg[pos - 1];
            li[pos] = li[pos - 1];
            --pos;
          }
          lg[pos] = x;
          li[pos] = ti[j];
          ++filled;
        }
        tg[j] = neg_inf();
        ti[j] = 0;
      };
      if constexpr (RT <= RREG) {
#pragma unroll
        for (int j = 0; j < RT; ++j) offer(j);
      } else {
        for (int j = 0; j < len; ++j) offer(j);
      }
    }
    __syncthreads();  // the next sub-tile overwrites sg / sbias / sscale
  }
}

// Deep ranks (ranks > RMAX): one block a pair block of the chunk that starts
// at block b0 writes its rows' scaled and biased gains, each rounded on its
// own as above, to ws[(blockIdx.x * TE + row) * S + slot].
__global__ void __launch_bounds__(THREADS) pair_gains_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ docs,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const int* __restrict__ blk_cluster, const int* __restrict__ rows,
    const int* __restrict__ n_real, float* __restrict__ ws, int C, int R,
    int S, int b0) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = b0 + blockIdx.x;
  if (n_real && blk >= *n_real) return;  // block-uniform
  const float* sg = reinterpret_cast<const float*>(smem + SMEM_A + SMEM_B);
  const float* sbias = sg + TS * LDG;
  const float* sscale = sbias + TS;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c = min(max(blk_cluster[blk], 0), C - 1);
  const int8_t* slab = docs + (size_t)c * R * S;
  float* out = ws + (size_t)blockIdx.x * TE * S;
  for (int s0 = 0; s0 < S; s0 += TS) {
    gain_subtile(q, slab, bias + (size_t)c * S, scale + (size_t)c * S, rows,
                 blk * TE, R, S, s0, smem, tid, warp);
    // consecutive threads on consecutive slots of a row: coalesced stores
    const int ncols = min(TS, S - s0);
    for (int e = tid; e < TE * TS; e += THREADS) {
      const int r = e / TS, cc = e - r * TS;
      if (cc < ncols) {
        float x = __fmul_rn(sg[cc * LDG + r], sscale[cc]);
        x = __fadd_rn(x, sbias[cc]);
        out[(size_t)r * S + s0 + cc] = x;
      }
    }
    __syncthreads();  // the next sub-tile overwrites sg / sbias / sscale
  }
}

template <int RT>
cudaError_t launch(const __nv_bfloat16* q, const int8_t* docs, const float* bias,
                   const float* scale, const int* blk_cluster, const int* rows,
                   const int* n_real, float* out_g, int* out_i, int G, int C, int R,
                   int S, int tds, int ranks, int kw, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(grouped_pair_topk_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  grouped_pair_topk_kernel<RT><<<dim3((unsigned)G), THREADS, SMEM, stream>>>(
      q, docs, bias, scale, blk_cluster, rows, n_real, out_g, out_i, C, R, S, tds,
      ranks, kw);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q is [*, R] bf16; docs [C, R, S] int8; bias and scale
// [C, S] f32; blk_cluster [G] i32; rows [G * 256] i32 or null; n_real a device
// i32 or null; out_g [G * 256, kw] f32 and out_i [G * 256, kw] i32. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int grouped_pair_topk_launch(const void* q, const void* docs,
                                        const void* bias, const void* scale,
                                        const void* blk_cluster, const void* rows,
                                        const void* n_real, void* out_g, void* out_i,
                                        int G, int C, int R, int S, int tds, int ranks,
                                        int kw, void* stream) {
  if (G < 1 || C < 1 || R < 16 || R % 16 != 0 || S < 8 || S % 8 != 0 ||
      tds < TS || tds % TS != 0 || ranks < 1 || ranks > RMAX ||
      kw != ranks * ((S + tds - 1) / tds) || q == nullptr || docs == nullptr ||
      bias == nullptr || scale == nullptr || blk_cluster == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const int8_t* dd = static_cast<const int8_t*>(docs);
  const float* bb = static_cast<const float*>(bias);
  const float* ss = static_cast<const float*>(scale);
  const int* bc = static_cast<const int*>(blk_cluster);
  const int* rw = static_cast<const int*>(rows);
  const int* nr = static_cast<const int*>(n_real);
  float* og = static_cast<float*>(out_g);
  int* oi = static_cast<int*>(out_i);
#define GPT_LAUNCH(RT) \
  return (int)launch<RT>(qq, dd, bb, ss, bc, rw, nr, og, oi, G, C, R, S, tds, ranks, kw, st)
  if (ranks <= 1) GPT_LAUNCH(1);
  if (ranks <= 2) GPT_LAUNCH(2);
  if (ranks <= 4) GPT_LAUNCH(4);
  if (ranks <= 8) GPT_LAUNCH(8);
  if (ranks <= RREG) GPT_LAUNCH(RREG);
  GPT_LAUNCH(RMAX);
#undef GPT_LAUNCH
}

// Deep ranks: any ranks (the launch above stops at RMAX). Pair blocks go in
// chunks of chunk_blocks: pair_gains_kernel writes a chunk's gains to ws_g
// [chunk_blocks * 256, S]; deep::reduce_rows cuts every tile of tds slots to
// its `ranks` best (ties to the lower slot) and merges the tiles' sorted
// lists to kw; the list is written out with the stored gains, (-inf, 0) past
// the offers. Rows of blocks at or past *n_real are skipped and left
// unwritten. ws_a / ws_b hold chunk_blocks * 256 x list_entries words, dst
// chunk_blocks * 256 x kw (ops/deep_topk.py::pair_plan). Arguments otherwise
// as grouped_pair_topk_launch. Returns 0, or deep::fail's code of the step
// that failed.
extern "C" int grouped_pair_topk_deep_launch(
    const void* q, const void* docs, const void* bias, const void* scale,
    const void* blk_cluster, const void* rows, const void* n_real, void* ws_g,
    void* ws_a, void* ws_b, void* dst, void* out_g, void* out_i, int G, int C,
    int R, int S, int tds, int ranks, int kw, int chunk_blocks, void* stream) {
  if (G < 1 || C < 1 || R < 16 || R % 16 != 0 || S < 8 || S % 8 != 0 ||
      tds < TS || tds % TS != 0 || tds > deep::RUN_MAX || ranks < 1 ||
      kw != ranks * ((S + tds - 1) / tds) || chunk_blocks < 1 || q == nullptr ||
      docs == nullptr || bias == nullptr || scale == nullptr ||
      blk_cluster == nullptr || ws_g == nullptr || dst == nullptr ||
      (S > tds && (ws_a == nullptr || ws_b == nullptr)))
    return deep::fail(deep::STEP_ARGS, cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      pair_gains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return deep::fail(deep::STEP_GAINS, err);
  const int* nr = static_cast<const int*>(n_real);
  float* wg = static_cast<float*>(ws_g);
  auto* d = static_cast<deep::u64*>(dst);
  for (int b0 = 0; b0 < G; b0 += chunk_blocks) {
    const int nb = min(chunk_blocks, G - b0);
    const long long rows0 = (long long)b0 * TE, n_rows = (long long)nb * TE;
    pair_gains_kernel<<<nb, THREADS, SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(docs),
        static_cast<const float*>(bias), static_cast<const float*>(scale),
        static_cast<const int*>(blk_cluster), static_cast<const int*>(rows), nr,
        wg, C, R, S, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return deep::fail(deep::STEP_GAINS, err);
    int len = 0;
    const int code = deep::reduce_rows(wg, S, n_rows, S, tds, ranks, kw, 0,
                                       static_cast<deep::u64*>(ws_a),
                                       static_cast<deep::u64*>(ws_b), d, kw,
                                       &len, nr, TE, rows0, st);
    if (code) return code;
    err = deep::emit<int>(d, kw, len, wg, S,
                          static_cast<float*>(out_g) + rows0 * kw,
                          static_cast<int*>(out_i) + rows0 * kw, kw, n_rows, nr,
                          TE, rows0, st);
    if (err != cudaSuccess) return deep::fail(deep::STEP_EMIT, err);
  }
  return 0;
}

